"""Fixed-capacity masked point clouds and PCL-filter equivalents.

The reference leans on PCL everywhere: VoxelGrid downsampling
(`global_manager.cpp:1687-1700`, `LIO_Publisher.cpp:146`), PassThrough
crops (`mapUpdate` ground strip z in [-1, 30]), and box crops around loop
keyframes (`mergeNearestKeyframes`, x/y +-60 m). Dynamic point counts do
not jit, so every cloud here is a fixed-capacity `(N, 3)` buffer with a
validity mask; filters write masked results of the *same* capacity and
compaction happens via sort-by-validity, never by dynamic reshape.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp


class PointCloud(NamedTuple):
    """xyz: (N, 3) float32; mask: (N,) bool — True where the slot holds a
    real point. Invalid slots hold the sentinel coordinate (stays finite
    so downstream math never sees NaN/inf)."""

    xyz: jax.Array
    mask: jax.Array

    @property
    def capacity(self) -> int:
        return self.xyz.shape[-2]

    def count(self) -> jax.Array:
        return jnp.sum(self.mask, axis=-1)


SENTINEL = 1e6  # parked coordinate for invalid slots


def make(xyz: jax.Array, mask: jax.Array | None = None) -> PointCloud:
    if mask is None:
        mask = jnp.ones(xyz.shape[:-1], dtype=bool)
    return park(PointCloud(xyz.astype(jnp.float32), mask))


def park(pc: PointCloud) -> PointCloud:
    """Move invalid points to the far-away sentinel so they can never be
    nearest neighbours / fall into real voxels."""
    xyz = jnp.where(pc.mask[..., None], pc.xyz, SENTINEL)
    return PointCloud(xyz, pc.mask)


def pad_to(pc: PointCloud, capacity: int) -> PointCloud:
    """Grow (or shrink, keeping valid-first order) to a fixed capacity."""
    n = pc.xyz.shape[-2]
    if n == capacity:
        return pc
    if n < capacity:
        pad = capacity - n
        xyz = jnp.concatenate(
            [pc.xyz, jnp.full((*pc.xyz.shape[:-2], pad, 3), SENTINEL, pc.xyz.dtype)],
            axis=-2,
        )
        mask = jnp.concatenate(
            [pc.mask, jnp.zeros((*pc.mask.shape[:-1], pad), bool)], axis=-1
        )
        return PointCloud(xyz, mask)
    pc = compact(pc)
    return PointCloud(pc.xyz[..., :capacity, :], pc.mask[..., :capacity])


def compact(pc: PointCloud) -> PointCloud:
    """Stable-sort valid points to the front (same capacity)."""
    order = jnp.argsort(~pc.mask, stable=True, axis=-1)
    xyz = jnp.take_along_axis(pc.xyz, order[..., None], axis=-2)
    mask = jnp.take_along_axis(pc.mask, order, axis=-1)
    return PointCloud(xyz, mask)


def crop_box(pc: PointCloud, lo, hi) -> PointCloud:
    """PassThrough/CropBox equivalent: keep lo <= xyz <= hi (per-axis).
    Use +-inf entries to leave an axis unconstrained."""
    lo = jnp.asarray(lo, pc.xyz.dtype)
    hi = jnp.asarray(hi, pc.xyz.dtype)
    inside = jnp.all((pc.xyz >= lo) & (pc.xyz <= hi), axis=-1)
    return park(PointCloud(pc.xyz, pc.mask & inside))


def crop_radius(pc: PointCloud, center, radius: float) -> PointCloud:
    d2 = jnp.sum((pc.xyz - jnp.asarray(center, pc.xyz.dtype)) ** 2, axis=-1)
    return park(PointCloud(pc.xyz, pc.mask & (d2 <= radius * radius)))


def transform(pc: PointCloud, pose) -> PointCloud:
    """Rigid transform of valid points (sentinels re-parked)."""
    xyz = jnp.einsum(
        "...ij,...nj->...ni", pose.R, pc.xyz,
        precision=jax.lax.Precision.HIGHEST,
    ) + pose.t[..., None, :]
    return park(PointCloud(xyz, pc.mask))


@partial(jax.jit, static_argnames=("leaf", "capacity", "bounds"))
def voxel_downsample(
    pc: PointCloud,
    leaf: float,
    capacity: int,
    bounds: tuple = ((-200.0, -200.0, -200.0), (200.0, 200.0, 200.0)),
) -> PointCloud:
    """Exact centroid voxel-grid downsample (PCL VoxelGrid semantics).

    Lexicographically sort points by their integer voxel coordinate
    triple (no packed key — exact for any volume/leaf), segment-reduce
    coordinates, emit one centroid per occupied voxel into a
    fixed-capacity output. Points outside `bounds` are dropped (callers
    crop first, as the reference pipeline does — `Tools/Filters`,
    `RING_ros/util.py:91-112`). O(N log N) sort — XLA-native, no trees.
    """
    lo, hi = (jnp.asarray(b, jnp.float32) for b in bounds)
    ijk = jnp.floor((pc.xyz - lo) / leaf).astype(jnp.int32)
    dims = jnp.ceil((hi - lo) / leaf).astype(jnp.int32) + 1
    valid = pc.mask & jnp.all((ijk >= 0) & (ijk < dims), axis=-1)
    big = jnp.int32(2**31 - 1)
    ijk = jnp.where(valid[:, None], ijk, big)  # invalids sort last
    # lexsort: last key is primary
    order = jnp.lexsort((ijk[:, 2], ijk[:, 1], ijk[:, 0]))
    skey = ijk[order]
    sxyz = pc.xyz[order]
    svalid = valid[order]
    # Segment starts: first element of each run of equal coord triples.
    changed = jnp.any(skey[1:] != skey[:-1], axis=-1)
    first = jnp.concatenate([jnp.array([True]), changed]) & svalid
    seg_id = jnp.cumsum(first) - 1  # index of output voxel per point
    seg_id = jnp.where(svalid, seg_id, capacity)  # park invalids
    sums = jnp.zeros((capacity + 1, 3), jnp.float32).at[seg_id].add(
        jnp.where(svalid[:, None], sxyz, 0.0)
    )
    cnts = jnp.zeros((capacity + 1,), jnp.float32).at[seg_id].add(
        svalid.astype(jnp.float32)
    )
    out_mask = cnts[:capacity] > 0
    centroids = sums[:capacity] / jnp.maximum(cnts[:capacity, None], 1.0)
    return park(PointCloud(centroids, out_mask))


@partial(jax.jit, static_argnames=("k",))
def knn(query: jax.Array, pc: PointCloud, k: int):
    """Brute-force k-NN of query (M, 3) against a masked cloud (N, 3).

    Distance matrix as one matmul: |q - p|^2 = |q|^2 + |p|^2 - 2 q.p.
    Replaces kd-tree searches for moderate N (the loop-verification
    clouds); odometry-scale search uses the voxel-grid path instead
    (`ops/voxel_grid.py`).

    Returns (dists (M, k), idx (M, k)); masked points get +inf distance.
    """
    q2 = jnp.sum(query * query, axis=-1, keepdims=True)
    p2 = jnp.sum(pc.xyz * pc.xyz, axis=-1)
    d2 = q2 + p2[None, :] - 2.0 * query @ pc.xyz.T
    d2 = jnp.where(pc.mask[None, :], d2, jnp.inf)
    neg_top, idx = jax.lax.top_k(-d2, k)
    return jnp.maximum(-neg_top, 0.0), idx


def covariances_knn(pc: PointCloud, k: int = 10):
    """Per-point neighbourhood mean/covariance via brute-force kNN —
    the GICP preprocessing (fast_gicp computes per-point covariances the
    same way). Returns (means (N,3), covs (N,3,3), valid (N,))."""
    d2, idx = knn(pc.xyz, pc, k)
    neigh = pc.xyz[idx]  # (N, k, 3)
    w = jnp.isfinite(d2)
    wn = jnp.maximum(jnp.sum(w, axis=-1, keepdims=True), 1)
    mean = jnp.sum(jnp.where(w[..., None], neigh, 0.0), axis=-2) / wn
    d = jnp.where(w[..., None], neigh - mean[:, None, :], 0.0)
    cov = jnp.einsum("nki,nkj->nij", d, d) / jnp.maximum(wn[..., None] - 1, 1)
    return mean, cov, pc.mask & (wn[..., 0] >= 3)
