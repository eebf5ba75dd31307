"""ScanContext place recognition — batched, query-vs-database as one op.

Re-design of `LoopDetection/src/RING_ros/pr_methods/ScanContext.py` and
`main_SC.py`: descriptor = polar max-height matrix (rings x sectors);
retrieval key = per-ring mean (ring key); matching = cosine distance
minimized over all circular column shifts. The reference loops Python
over candidates and shifts; here the whole (Q x D x S) shift-distance
tensor is one einsum.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops.pointcloud import PointCloud
from . import bev


class SCParams(NamedTuple):
    n_rings: int = 20
    n_sectors: int = 60
    r_max: float = 80.0


def describe(pc: PointCloud, params: SCParams = SCParams()) -> jax.Array:
    """(n_rings, n_sectors) ScanContext of a body-frame keyframe cloud."""
    return bev.polar_max_height(
        pc, params.n_rings, params.n_sectors, params.r_max
    )


def ring_key(sc: jax.Array) -> jax.Array:
    """(..., n_rings) retrieval key: per-ring occupancy mean
    (`ScanContext.py:44-50`)."""
    return jnp.mean(sc, axis=-1)


@jax.jit
def distance(query: jax.Array, database: jax.Array):
    """Min-over-shift cosine distance between one query (R, S) and a
    database (D, R, S).

    Returns (dists (D,), best_shift (D,)). Column-shift-invariant:
    dist(q, db) = 1 - max_s mean_cols cos(q[:, c - s], db[:, c]).
    The (D, S) score tensor is a single einsum over all shifts.
    """
    S = query.shape[-1]
    # q_shift[s, r, c] = query[r, (c - s) mod S]: all circular shifts
    idx = (jnp.arange(S)[None, :] - jnp.arange(S)[:, None]) % S  # (S_shift, C)
    q_shift = jnp.moveaxis(query[:, idx], 1, 0)  # (S_shift, R, C)
    qn = q_shift / jnp.maximum(
        jnp.linalg.norm(q_shift, axis=-2, keepdims=True), 1e-9
    )
    dn = database / jnp.maximum(
        jnp.linalg.norm(database, axis=-2, keepdims=True), 1e-9
    )
    # column-wise cosine then mean over columns, for every (db, shift)
    sims = jnp.einsum("krc,drc->dk", qn, dn) / S
    best = jnp.argmax(sims, axis=-1)
    return 1.0 - jnp.max(sims, axis=-1), best


@jax.jit
def retrieve(query_key: jax.Array, db_keys: jax.Array, db_mask: jax.Array):
    """Ring-key nearest neighbours: distances (D,) with invalid entries
    +inf (`main_SC.py:160` KDTree retrieval, sans tree)."""
    d = jnp.linalg.norm(db_keys - query_key[None, :], axis=-1)
    return jnp.where(db_mask, d, jnp.inf)
