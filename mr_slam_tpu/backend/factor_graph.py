"""Array-native multi-robot pose graph.

The reference keeps one gtsam `NonlinearFactorGraph` + `Values` per
robot, merges them for optimization (`readFullGraph`,
`global_manager.cpp:1484-1535`, with O(N^2) factor dedup), and encodes
node identity as char('a'+robot) << 56 | index
(`global_manager.cpp:2587-2609`). Here the graph is one pytree of fixed
capacity arrays; the key codec is kept for g2o artifact parity.

Edge kinds mirror the reference's factor kinds:
  ODOM       sequential BetweenFactor (`mapUpdate` :1805-1819)
  INTRA_LOOP same-robot loop (`detectLoopClosure` odometry-space path)
  INTER_LOOP cross-robot loop (`performLoopClosure`, `/loop_info`)
  PRIOR      anchor (first pose per robot, noise 1e-15 — :99-109)
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import se3
from ..geometry.se3 import Pose

ODOM = 0
INTRA_LOOP = 1
INTER_LOOP = 2
PRIOR = 3


class FactorGraph(NamedTuple):
    """Fixed-capacity pose graph.

    Nodes: poses (N,), node_robot (N,), node_valid (N,), n_nodes ().
    Edges: (E,) arrays — endpoints i/j index the node arrays directly.
    Edge weights are scalar information weights for rotation and
    translation (the reference's diagonal noise models: odom 1.0,
    loop [1e-1 rot, 1e-2 trans] inverted — `global_manager.cpp:99-109`).
    """

    poses: Pose
    node_robot: jax.Array
    node_valid: jax.Array
    n_nodes: jax.Array
    edge_i: jax.Array
    edge_j: jax.Array
    edge_meas: Pose
    edge_kind: jax.Array
    edge_w_rot: jax.Array
    edge_w_trans: jax.Array
    edge_valid: jax.Array
    n_edges: jax.Array

    @property
    def node_capacity(self) -> int:
        return self.node_robot.shape[0]

    @property
    def edge_capacity(self) -> int:
        return self.edge_i.shape[0]


def init(node_capacity: int, edge_capacity: int) -> FactorGraph:
    return FactorGraph(
        poses=se3.identity((node_capacity,)),
        node_robot=jnp.zeros((node_capacity,), jnp.int32),
        node_valid=jnp.zeros((node_capacity,), bool),
        n_nodes=jnp.int32(0),
        edge_i=jnp.zeros((edge_capacity,), jnp.int32),
        edge_j=jnp.zeros((edge_capacity,), jnp.int32),
        edge_meas=se3.identity((edge_capacity,)),
        edge_kind=jnp.zeros((edge_capacity,), jnp.int32),
        edge_w_rot=jnp.zeros((edge_capacity,), jnp.float32),
        edge_w_trans=jnp.zeros((edge_capacity,), jnp.float32),
        edge_valid=jnp.zeros((edge_capacity,), bool),
        n_edges=jnp.int32(0),
    )


@jax.jit
def add_node(g: FactorGraph, pose: Pose, robot: jax.Array):
    """Append a node (no-op when full). Returns (graph, node_index)."""
    idx = jnp.minimum(g.n_nodes, g.node_capacity - 1)
    ok = g.n_nodes < g.node_capacity
    g2 = g._replace(
        poses=Pose(
            g.poses.R.at[idx].set(jnp.where(ok, pose.R, g.poses.R[idx])),
            g.poses.t.at[idx].set(jnp.where(ok, pose.t, g.poses.t[idx])),
        ),
        node_robot=g.node_robot.at[idx].set(
            jnp.where(ok, robot, g.node_robot[idx])
        ),
        node_valid=g.node_valid.at[idx].set(g.node_valid[idx] | ok),
        n_nodes=g.n_nodes + ok.astype(jnp.int32),
    )
    return g2, idx


@jax.jit
def add_edge(
    g: FactorGraph,
    i: jax.Array,
    j: jax.Array,
    meas: Pose,
    kind: jax.Array,
    w_rot: jax.Array,
    w_trans: jax.Array,
):
    """Append an edge (no-op when full). Returns (graph, edge_index)."""
    idx = jnp.minimum(g.n_edges, g.edge_capacity - 1)
    ok = g.n_edges < g.edge_capacity
    sel = lambda new, old: jnp.where(ok, new, old)
    g2 = g._replace(
        edge_i=g.edge_i.at[idx].set(sel(i, g.edge_i[idx])),
        edge_j=g.edge_j.at[idx].set(sel(j, g.edge_j[idx])),
        edge_meas=Pose(
            g.edge_meas.R.at[idx].set(sel(meas.R, g.edge_meas.R[idx])),
            g.edge_meas.t.at[idx].set(sel(meas.t, g.edge_meas.t[idx])),
        ),
        edge_kind=g.edge_kind.at[idx].set(sel(kind, g.edge_kind[idx])),
        edge_w_rot=g.edge_w_rot.at[idx].set(sel(w_rot, g.edge_w_rot[idx])),
        edge_w_trans=g.edge_w_trans.at[idx].set(sel(w_trans, g.edge_w_trans[idx])),
        edge_valid=g.edge_valid.at[idx].set(g.edge_valid[idx] | ok),
        n_edges=g.n_edges + ok.astype(jnp.int32),
    )
    return g2, idx


def add_nodes_batch(g: FactorGraph, poses: Pose, robots: jax.Array):
    """Append a BATCH of nodes with one scatter (the vectorized
    `readFullGraph` build — no per-node dispatch). Overflowing entries
    are dropped (indices >= capacity scatter with mode='drop'); the
    caller sees them as returned indices >= node_capacity.

    Returns (graph, idx (B,))."""
    B = robots.shape[0]
    idx = g.n_nodes + jnp.arange(B, dtype=jnp.int32)
    wrote = jnp.minimum(jnp.maximum(g.node_capacity - g.n_nodes, 0), B)
    g2 = g._replace(
        poses=Pose(
            g.poses.R.at[idx].set(poses.R, mode="drop"),
            g.poses.t.at[idx].set(poses.t, mode="drop"),
        ),
        node_robot=g.node_robot.at[idx].set(robots, mode="drop"),
        node_valid=g.node_valid.at[idx].set(True, mode="drop"),
        n_nodes=g.n_nodes + wrote.astype(jnp.int32),
    )
    return g2, idx


def add_edges_batch(
    g: FactorGraph,
    i: jax.Array,
    j: jax.Array,
    meas: Pose,
    kind: jax.Array,
    w_rot: jax.Array,
    w_trans: jax.Array,
):
    """Append a BATCH of edges with one scatter. Scalar kind/weights
    broadcast. Overflowing entries are dropped. Returns (graph,
    idx (B,))."""
    B = i.shape[0]
    bc = lambda x: jnp.broadcast_to(jnp.asarray(x), (B,))
    idx = g.n_edges + jnp.arange(B, dtype=jnp.int32)
    wrote = jnp.minimum(jnp.maximum(g.edge_capacity - g.n_edges, 0), B)
    g2 = g._replace(
        edge_i=g.edge_i.at[idx].set(i, mode="drop"),
        edge_j=g.edge_j.at[idx].set(j, mode="drop"),
        edge_meas=Pose(
            g.edge_meas.R.at[idx].set(meas.R, mode="drop"),
            g.edge_meas.t.at[idx].set(meas.t, mode="drop"),
        ),
        edge_kind=g.edge_kind.at[idx].set(bc(kind), mode="drop"),
        edge_w_rot=g.edge_w_rot.at[idx].set(
            bc(w_rot).astype(jnp.float32), mode="drop"
        ),
        edge_w_trans=g.edge_w_trans.at[idx].set(
            bc(w_trans).astype(jnp.float32), mode="drop"
        ),
        edge_valid=g.edge_valid.at[idx].set(True, mode="drop"),
        n_edges=g.n_edges + wrote.astype(jnp.int32),
    )
    return g2, idx


def robot_id_to_key(robot: int, index: int) -> int:
    """gtsam-compatible key: char('a' + robot) << 56 | index
    (`global_manager.cpp:2587-2596`; mirrored in `RING_ros/util.py:
    253-260`). Used only for g2o import/export."""
    return ((ord("a") + robot) << 56) | index


def key_to_robot_id(key: int) -> tuple[int, int]:
    """(robot, index) from a gtsam-style key (`Key2robotID`)."""
    return (key >> 56) - ord("a"), key & ((1 << 56) - 1)


def interrobot_edges_mask(g: FactorGraph) -> jax.Array:
    """(E,) bool — edges whose endpoints live on different robots (the
    'separator' edges of distributed-mapper)."""
    return (
        g.edge_valid
        & (g.node_robot[g.edge_i] != g.node_robot[g.edge_j])
    )


def connected_robots(g: FactorGraph, n_robots: int) -> jax.Array:
    """(R,) bool — robots having at least one inter-robot edge; the
    reference excludes unconnected robots from optimization and passes
    their poses through (`global_manager.cpp:1259-1266`)."""
    inter = interrobot_edges_mask(g)
    # invalid edges park in an overflow slot
    ri = jnp.where(inter, g.node_robot[g.edge_i], n_robots)
    rj = jnp.where(inter, g.node_robot[g.edge_j], n_robots)
    seen = jnp.zeros((n_robots + 1,), bool)
    seen = seen.at[ri].set(True)
    seen = seen.at[rj].set(True)
    return seen[:n_robots]
