"""Distributed pose-graph optimization over a device mesh.

The reference's distributed-mapper exchanges linearized neighbor poses
between robots and runs Gauss-Seidel sweeps until the rotation/pose
change drops below a flag threshold (`distributed_mapper_utils.cpp:
482+`, `distributed_mapper.cpp:117-305`). The scheme here keeps
the same two-stage chordal math but solves each linear system *jointly*
with conjugate gradients whose matvec is data-parallel over EDGES:

  * node state (poses, (N, 6) CG vectors) is replicated on every device
    — pose-graph nodes are tiny (a few thousand poses) compared to the
    point-cloud payloads, so replication costs nothing;
  * edges are sharded over the mesh axis (each robot's device owns its
    odometry edges; inter-robot edges land on the lower-id owner);
  * every H@x / gradient / diagonal assembly scatter-adds its local
    edges into the replicated node vector and `psum`s across the axis —
    one collective per matvec, riding ICI.

Gauss-Seidel converges linearly and needed flagged-initialization
ordering; joint PCG needs no ordering, no flagging, and produces the
*centralized* solution (`centralizedGNEstimation`) exactly, so the
distributed and single-chip paths share all numerics in `chordal.py`.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ..geometry.se3 import Pose
from . import chordal
from .factor_graph import FactorGraph
from ..precision import accurate

AXIS = "robot"


def shard_edges(g: FactorGraph, n_shards: int, scheme: str = "round_robin") -> FactorGraph:
    """Reorder + pad edge arrays so edge e belongs to shard e % n_shards
    (round-robin keeps shards load-balanced; 'owner' assigns edges to
    their lower endpoint's robot for locality). Node arrays untouched."""
    E = g.edge_capacity
    pad = (-E) % n_shards
    if pad:
        import numpy as np

        def pad_edge(x):
            widths = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
            return jnp.pad(x, widths)

        g = g._replace(
            edge_i=pad_edge(g.edge_i),
            edge_j=pad_edge(g.edge_j),
            edge_meas=Pose(pad_edge(g.edge_meas.R), pad_edge(g.edge_meas.t)),
            edge_kind=pad_edge(g.edge_kind),
            edge_w_rot=pad_edge(g.edge_w_rot),
            edge_w_trans=pad_edge(g.edge_w_trans),
            edge_valid=pad_edge(g.edge_valid),
        )
    return g


def edge_specs() -> FactorGraph:
    """PartitionSpecs: edges sharded over AXIS, nodes replicated."""
    return FactorGraph(
        poses=Pose(P(), P()),
        node_robot=P(),
        node_valid=P(),
        n_nodes=P(),
        edge_i=P(AXIS),
        edge_j=P(AXIS),
        edge_meas=Pose(P(AXIS), P(AXIS)),
        edge_kind=P(AXIS),
        edge_w_rot=P(AXIS),
        edge_w_trans=P(AXIS),
        edge_valid=P(AXIS),
        n_edges=P(),
    )


@accurate
@partial(jax.jit, static_argnames=("config", "mesh"))
def optimize(
    g: FactorGraph,
    anchors: jax.Array,
    mesh: jax.sharding.Mesh,
    config: chordal.PGOConfig = chordal.PGOConfig(),
) -> Pose:
    """Distributed two-stage chordal PGO over `mesh` axis 'robot'.

    Numerically identical to `chordal.optimize` (joint CG); the edge set
    is partitioned across devices and every reduction is a psum.
    """
    n_shards = mesh.shape[AXIS]
    g = shard_edges(g, n_shards)

    fn = jax.shard_map(
        lambda gs, a: chordal.optimize(gs, a, config, axis_name=AXIS),
        mesh=mesh,
        in_specs=(edge_specs(), P()),
        out_specs=Pose(P(), P()),
        check_vma=False,
    )
    return fn(g, anchors)
