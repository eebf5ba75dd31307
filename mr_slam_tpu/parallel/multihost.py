"""Multi-host (multi-process) runtime over a robot-axis mesh.

This replaces the reference's multi-process topology — one ROS node set
per robot plus a hub manager discovering peers through the ROS master
and exchanging SubMap/DiSCO/Loops messages over TCPROS
(`global_manager.cpp:287-442`, SURVEY.md §5.8) — with the standard JAX
multi-controller design:

  * every process calls `initialize()` (`jax.distributed.initialize`)
    and sees the GLOBAL device set; a 1-D `Mesh` over axis "robot" spans
    all hosts and follows the robot axis only (the cards of one host
    reach each other all to all over NVLink, so no device order is
    preferred);
  * each host FEEDS the robots whose mesh devices are local
    (`feed_global`: per-process shards assembled into one global array —
    the host-feeder replacing rosbag playback into per-robot topics);
  * the per-robot front-end (odometry `lax.scan` + keyframe gating) runs
    SPMD under `shard_map` over the robot axis — the dominant compute,
    fully parallel, zero cross-robot traffic (`frontend_spmd`);
  * keyframe stores/descriptors are then replicated to every process
    (one all-gather — the collective replacing per-topic subscription)
    and the small back-end (retrieval, verification, per-pair PCM) runs
    REDUNDANTLY on every process with identical inputs — replicated
    control, the standard SPMD pattern for host-driven stages;
  * pose-graph optimization runs edge-sharded over the same mesh with
    psum reductions (`backend/distributed.py`).

Single-process simulation: N virtual CPU devices
(`--xla_force_host_platform_device_count=N`) exercise the identical
program; true multi-process runs only change `initialize()` arguments.
"""
from __future__ import annotations

import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..geometry import se3
from ..geometry.se3 import Pose
from ..ops import pointcloud as pcl

ROBOT_AXIS = "robot"


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """`jax.distributed.initialize` wrapper with env-var fallbacks
    (MRSLAM_COORDINATOR / MRSLAM_NUM_PROCESSES / MRSLAM_PROCESS_ID).
    No-op for single-process runs (nothing configured)."""
    coordinator_address = coordinator_address or os.environ.get("MRSLAM_COORDINATOR")
    if num_processes is None and "MRSLAM_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["MRSLAM_NUM_PROCESSES"])
    if process_id is None and "MRSLAM_PROCESS_ID" in os.environ:
        process_id = int(os.environ["MRSLAM_PROCESS_ID"])
    if coordinator_address is None or num_processes in (None, 1):
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def robot_mesh(n_robots: int | None = None) -> Mesh:
    """1-D mesh over the GLOBAL device set (all processes). n_robots
    must divide into the devices used; defaults to all devices."""
    devices = jax.devices()
    n = n_robots if n_robots is not None else len(devices)
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    return Mesh(np.array(devices[:n]), (ROBOT_AXIS,))


def local_robot_ids(mesh: Mesh) -> list[int]:
    """Robot (mesh-position) indices whose device is owned by THIS
    process — the robots this host feeds."""
    pid = jax.process_index()
    return [
        int(i) for i, d in enumerate(mesh.devices.ravel())
        if d.process_index == pid
    ]


def feed_global(local_blocks: dict[int, object], mesh: Mesh):
    """Host feeder: assemble a robot-major GLOBAL array pytree from this
    process's per-robot blocks (`local_blocks[robot] = pytree` without
    the robot axis). Every process calls this with ITS robots; the
    result is one global sharded array spanning all hosts."""
    sharding = NamedSharding(mesh, P(ROBOT_AXIS))
    ids = sorted(local_blocks)
    stacked = jax.tree.map(lambda *xs: np.stack(xs), *[local_blocks[i] for i in ids])
    n = mesh.devices.size

    def build(leaf):
        global_shape = (n,) + leaf.shape[1:]
        dev_of = {i: d for i, d in enumerate(mesh.devices.ravel())}
        arrays = [
            jax.device_put(leaf[k : k + 1], dev_of[i])
            for k, i in enumerate(ids)
        ]
        return jax.make_array_from_single_device_arrays(
            global_shape, sharding, arrays
        )

    return jax.tree.map(build, stacked)


@partial(jax.jit, static_argnames=("cfg",))
def _frontend_vmapped(scans, cfg, origins):
    from ..runtime import pipeline as pl

    return jax.vmap(lambda s, o: pl._frontend_fused(s, cfg, o))(scans, origins)


# Bounded LRU of jitted shard_map programs: every distinct (cfg, mesh,
# tree-structure) triple pins a compiled executable, so an unbounded
# dict leaks in long-lived processes that sweep configs/meshes.
_SPMD_CACHE: "dict" = {}
_SPMD_CACHE_MAX = 16


def frontend_spmd(scans, cfg, origins: Pose, mesh: Mesh):
    """Per-robot front-ends SPMD over the robot axis: scans (R, T, P, *)
    robot-sharded, one odometry `lax.scan` per device. Returns
    (poses (R, T), stores (R, ...), added (R, T)) robot-sharded.

    The jitted shard_map program is memoized on (cfg, mesh, tree
    structure) — a fresh `jax.jit` wrapper per call would defeat the
    trace cache and re-trace every invocation."""
    from ..runtime import pipeline as pl

    key = (cfg, mesh, jax.tree.structure((scans, origins)))
    fn = _SPMD_CACHE.get(key)
    if fn is None:
        spec = lambda tree: jax.tree.map(lambda _: P(ROBOT_AXIS), tree)

        def body(scans_blk, origins_blk):
            return jax.vmap(
                lambda s, o: pl._frontend_fused.__wrapped__(s, cfg, o)
            )(scans_blk, origins_blk)

        fn = jax.jit(
            jax.shard_map(
                body,
                mesh=mesh,
                in_specs=(spec(scans), spec(origins)),
                out_specs=P(ROBOT_AXIS),
                check_vma=False,
            )
        )
        if len(_SPMD_CACHE) >= _SPMD_CACHE_MAX:
            _SPMD_CACHE.pop(next(iter(_SPMD_CACHE)))  # evict oldest
        _SPMD_CACHE[key] = fn
    else:
        _SPMD_CACHE[key] = _SPMD_CACHE.pop(key)  # refresh LRU order
    return fn(scans, origins)


def _replicate_to_hosts(tree):
    """Gather a robot-sharded pytree to every process as host numpy —
    the all-gather replacing the reference's hub-and-spoke SubMap fan-in.
    Single-process: plain device fetch."""
    if jax.process_count() == 1:
        return jax.tree.map(np.asarray, tree)
    from jax.experimental import multihost_utils

    return multihost_utils.process_allgather(tree, tiled=True)


def run_multihost(scans, cfg, origins: Pose, mesh: Mesh):
    """Full multi-robot SLAM across hosts: SPMD front-ends -> replicate
    keyframe products -> redundant back-end on every process (identical
    inputs => identical results) -> edge-sharded PGO over `mesh`.

    `scans`/`origins` are GLOBAL robot-sharded arrays (see
    `feed_global`). Returns the `SlamResult` (every process gets the
    same one)."""
    from ..runtime import pipeline as pl

    poses, stores, added = frontend_spmd(scans, cfg, origins, mesh)
    poses_h, stores_h, added_h = _replicate_to_hosts((poses, stores, added))
    R = added_h.shape[0]
    robots = []
    for r in range(R):
        store_r = jax.tree.map(lambda a: jnp.asarray(a[r]), stores_h)
        robots.append(
            pl.RobotResult(
                odom_poses=Pose(jnp.asarray(poses_h.R[r]), jnp.asarray(poses_h.t[r])),
                store=store_r,
                kf_frame_idx=np.flatnonzero(added_h[r]),
            )
        )
    return pl.run_backend(robots, cfg, pgo_mesh=mesh)
