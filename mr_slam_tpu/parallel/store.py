"""Sharded multi-robot map store — the array-native `RobotHandle`.

The reference's GlobalManager keeps a vector of mutex-guarded
`RobotHandle`s (submaps, trajectories, descriptor databases, kd-trees —
`global_manager.h:108-137`) fed by ROS subscribers. Here the whole
multi-robot state is ONE pytree with a leading robot axis, sharded over
the mesh's `robot` axis:

  * per-robot keyframe clouds/poses/stamps (a batched KeyframeStore),
  * per-robot descriptor databases (batched (K, ...) arrays),
  * writes are functional scatter updates, reads are gathers or
    collectives (all_gather replaces topic discovery + subscription).

Cross-robot queries (loop retrieval) run as: all_gather the compact
descriptor database across the robot axis, correlate the local query
batch against everything — one collective + one einsum instead of the
hub-and-spoke message fan (SURVEY.md §5.8).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..frontend import keyframes as kf
from ..geometry import se3
from ..geometry.se3 import Pose
from . import mesh as mesh_lib


class MultiRobotStore(NamedTuple):
    """All per-robot state, robot-major. Every leaf has leading dim R.

    `descriptors` is either a flat (R, K, D) array (the layout
    `cross_robot_distances`' one-einsum retrieval consumes) or ANY
    pytree with (R, K, ...) leaves (the structured per-method
    descriptors — RING sinograms, ScanContext matrices — that
    `runtime/loopstage.retrieve` consumes). `ingest` handles both."""

    stores: kf.KeyframeStore       # batched over robots
    descriptors: jax.Array         # (R, K, ...) array or pytree of them
    desc_valid: jax.Array          # (R, K)

    @property
    def n_robots(self) -> int:
        return self.desc_valid.shape[0]

    @property
    def kf_capacity(self) -> int:
        return self.desc_valid.shape[1]

    def robot_view(self, row):
        """Single-robot (KeyframeStore, descriptors) view of row `row`
        — what the per-pair loop stage consumes."""
        return (
            jax.tree.map(lambda a: a[row], self.stores),
            jax.tree.map(lambda a: a[row], self.descriptors),
        )


def init(
    n_robots: int,
    kf_capacity: int,
    points_per_kf: int,
    desc_dim: int | None = None,
    desc_template=None,
) -> MultiRobotStore:
    """`desc_dim`: flat (R, K, D) descriptor layout. `desc_template`:
    alternatively, one un-batched descriptor pytree (from
    `pipeline.describe_one`) — buffers become (R, K, *leaf.shape)."""
    single = kf.init(kf_capacity, points_per_kf)
    stores = jax.tree.map(
        lambda x: jnp.broadcast_to(x[None], (n_robots, *x.shape)).copy(), single
    )
    if desc_template is not None:
        descs = jax.tree.map(
            lambda a: jnp.zeros((n_robots, kf_capacity) + a.shape, a.dtype),
            desc_template,
        )
    else:
        descs = jnp.zeros((n_robots, kf_capacity, desc_dim or 0), jnp.float32)
    return MultiRobotStore(
        stores=stores,
        descriptors=descs,
        desc_valid=jnp.zeros((n_robots, kf_capacity), bool),
    )


@jax.jit
def ingest(
    store: MultiRobotStore,
    robot: jax.Array,
    cloud_xyz: jax.Array,
    cloud_mask: jax.Array,
    pose: Pose,
    stamp: jax.Array,
    descriptor,
) -> MultiRobotStore:
    """Append one (already keyframe-gated, already voxelized) keyframe +
    descriptor for `robot` — the SubMap+DiSCO ingestion
    (`mapUpdate`/`discoUpdate`) as a pure scatter. `descriptor` matches
    the store's layout (flat array or pytree)."""
    s = store.stores
    k = jnp.minimum(s.count[robot], store.kf_capacity - 1)
    ok = s.count[robot] < store.kf_capacity
    upd = lambda arr, val: arr.at[robot, k].set(jnp.where(ok, val, arr[robot, k]))
    new_stores = kf.KeyframeStore(
        xyz=upd(s.xyz, cloud_xyz),
        mask=upd(s.mask, cloud_mask),
        poses=Pose(upd(s.poses.R, pose.R), upd(s.poses.t, pose.t)),
        stamps=upd(s.stamps, stamp),
        count=s.count.at[robot].add(ok.astype(jnp.int32)),
        last_pose=Pose(
            s.last_pose.R.at[robot].set(pose.R),
            s.last_pose.t.at[robot].set(pose.t),
        ),
    )
    return MultiRobotStore(
        stores=new_stores,
        descriptors=jax.tree.map(upd, store.descriptors, descriptor),
        desc_valid=store.desc_valid.at[robot, k].set(
            store.desc_valid[robot, k] | ok
        ),
    )


@partial(jax.jit, static_argnames=("dist_thresh", "leaf"))
def gate_and_add(
    store: MultiRobotStore,
    robot: jax.Array,
    cloud: "object",
    pose: Pose,
    stamp: jax.Array,
    dist_thresh: float,
    leaf: float,
):
    """Distance-gate + voxelize + append one frame for `robot` — the
    batched-store twin of `keyframes.maybe_add` (`LIO_Publisher.cpp:
    128-152`), ONE dispatch per frame. The descriptor slot is written
    by a follow-up `write_descriptor` once the caller has described the
    stored cloud. Returns (store, added bool, slot index)."""
    s = store.stores
    dist = jnp.linalg.norm(pose.t - s.last_pose.t[robot])
    ok = (dist > dist_thresh) & (s.count[robot] < store.kf_capacity)
    k = jnp.minimum(s.count[robot], store.kf_capacity - 1)
    from ..ops import pointcloud as pcl

    ds = pcl.voxel_downsample(
        cloud, leaf, s.xyz.shape[2],
        bounds=((-150.0, -150.0, -150.0), (150.0, 150.0, 150.0)),
    )
    upd = lambda arr, val: arr.at[robot, k].set(jnp.where(ok, val, arr[robot, k]))
    upd_p = lambda arr, val: arr.at[robot].set(jnp.where(ok, val, arr[robot]))
    new_stores = kf.KeyframeStore(
        xyz=upd(s.xyz, ds.xyz),
        mask=upd(s.mask, ds.mask),
        poses=Pose(upd(s.poses.R, pose.R), upd(s.poses.t, pose.t)),
        stamps=upd(s.stamps, stamp),
        count=s.count.at[robot].add(ok.astype(jnp.int32)),
        last_pose=Pose(
            upd_p(s.last_pose.R, pose.R), upd_p(s.last_pose.t, pose.t)
        ),
    )
    return store._replace(stores=new_stores), ok, k


@jax.jit
def write_descriptor(
    store: MultiRobotStore, robot: jax.Array, k: jax.Array, descriptor
) -> MultiRobotStore:
    """Scatter one descriptor (tree or flat) into slot (robot, k) —
    the incremental `discoUpdate` append (`global_manager.cpp:
    1867-1888`)."""
    upd = lambda arr, val: arr.at[robot, k].set(val)
    return store._replace(
        descriptors=jax.tree.map(upd, store.descriptors, descriptor),
        desc_valid=store.desc_valid.at[robot, k].set(True),
    )


def cross_robot_distances(
    store: MultiRobotStore, queries: jax.Array, axis_name: str | None = None
):
    """All-pairs descriptor distances: queries (R, Q, D) per robot
    against EVERY robot's database.

    Under `shard_map` over the robot axis, the local database is
    all-gathered across the axis (the collective replacing per-topic
    subscription); single-device callers get the plain einsum.

    Returns (R_local, Q, R_total, K) squared L2 distances with invalid
    entries +inf.
    """
    db = store.descriptors
    valid = store.desc_valid
    if axis_name is not None:
        db = jax.lax.all_gather(db, axis_name, axis=0, tiled=True)
        valid = jax.lax.all_gather(valid, axis_name, axis=0, tiled=True)
    # |q - d|^2 = |q|^2 + |d|^2 - 2 q.d ; one batched contraction
    q2 = jnp.sum(queries * queries, axis=-1)[..., None, None]
    d2 = jnp.sum(db * db, axis=-1)[None, None]
    qd = jnp.einsum("rqd,skd->rqsk", queries, db)
    dist = q2 + d2 - 2.0 * qd
    return jnp.where(valid[None, None], jnp.maximum(dist, 0.0), jnp.inf)
