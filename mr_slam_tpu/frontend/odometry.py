"""Scan-to-map lidar odometry — one jitted step, `lax.scan` over frames.

The reference runs two pluggable front-ends (A-LOAM: feature odometry +
cube-grid map refinement; FAST-LIO2: IEKF against an ikd-tree map). This
design collapses both into a single functional pipeline:

    downsample -> predict (constant velocity) -> point-to-plane GN
    against a persistent voxel-hash Gaussian map -> insert -> decay

which is the same measurement geometry as FAST-LIO's `h_share_model`
(`laserMapping.cpp:634-766`: 5-NN plane fit + point-to-plane residual,
OpenMP over points) with the voxel grid standing in for ikd-Tree and a
batched einsum Gauss-Newton standing in for the iterated EKF update.
No mutexes, no threads: state is a pytree, the step is a pure function.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import se3
from ..geometry.se3 import Pose
from ..ops import pointcloud as pcl
from ..ops import registration, voxel_grid
from ..precision import accurate


class OdometryConfig(NamedTuple):
    scan_leaf: float = 0.4          # scan downsample for registration
    # Map cells must be coarse enough that a cell+neighbours spans
    # multiple scan rings, else wall cells are collinear and the
    # planarity gate rejects them (tangential sliding).
    map_leaf: float = 1.0           # map voxel size (filter_size_map)
    insert_leaf: float = 0.15       # finer downsample for map insertion
    scan_capacity: int = 4096       # registration scan budget
    insert_capacity: int = 16384    # insertion cloud budget
    table_size: int = 1 << 17       # map hash slots
    map_radius: float = 120.0       # moving-FOV trim radius
    iters: int = 8                  # GN iterations per frame
    max_corr_dist: float = 1.0
    # Map-maintenance cadences: trimming the moving-FOV map every frame
    # is pointless when the robot moves ~1 m/frame against a 120 m
    # radius, and the coarse rescue grid (4x leaf) saturates its cells
    # from every 4th scan.
    decay_every: int = 8            # FOV trim every N frames
    coarse_every: int = 4           # coarse-grid insert every N frames
    # annealed association for the fine register (see
    # registration.point_to_plane_icp `schedule`): early rounds
    # associate a strided subset of points, trading a little accuracy
    # for fewer direct7 gathers and plane fits. Its cost and gain on the
    # GPU are not measured yet.
    anneal: bool = True


class OdometryState(NamedTuple):
    grid: voxel_grid.VoxelGrid
    coarse_grid: voxel_grid.VoxelGrid  # 4x leaf, for wide-basin align
    pose: Pose        # world <- body, current frame
    prev_pose: Pose   # world <- body, previous frame
    frame: jax.Array  # int32 frame counter


def init(config: OdometryConfig, origin: Pose | None = None) -> OdometryState:
    if origin is None:
        origin = se3.identity()
    return OdometryState(
        grid=voxel_grid.empty(config.map_leaf, config.table_size),
        coarse_grid=voxel_grid.empty(
            4.0 * config.map_leaf, config.table_size // 4
        ),
        pose=origin,
        prev_pose=origin,
        frame=jnp.int32(0),
    )


@accurate
@partial(jax.jit, static_argnames=("config", "scan_period", "shed"))
def step(
    state: OdometryState,
    scan: pcl.PointCloud,
    config: OdometryConfig,
    t_rel: jax.Array | None = None,
    scan_period: float = 0.1,
    shed: bool = False,
):
    """Process one lidar frame (body-frame cloud). Returns
    (new_state, diagnostics dict).

    `t_rel`: optional (N,) per-point capture times relative to sweep
    start (from `preprocess.to_range_image` / the loaders). When given,
    the scan is motion-compensated to the sweep-start frame with the
    constant-velocity prediction BEFORE registration — A-LOAM's
    `TransformToStart` (`laserOdometry.cpp:112-123`). Without it the
    scan is treated as instantaneous (synthetic data).

    `shed`: skip the map-refinement half (fine insert + decay) — the
    two-rate / load-shedding mode. A-LOAM's architecture: frame-to-
    frame odometry every frame, map refinement at lower rate, frames
    dropped from mapping under load (`laserMapping.cpp:303`). The pose
    still registers against the existing map; the shed frame's points
    are NOT inserted (its map contribution is dropped, as in the
    reference's frame drops — the map grows again on the next unshed
    frame)."""
    # Constant-velocity prediction: pose * (prev^-1 * pose)
    motion = se3.between(state.prev_pose, state.pose)
    pred = se3.compose(state.pose, motion)
    if t_rel is not None:
        from . import preprocess

        scan = preprocess.undistort_constant_velocity(
            scan, t_rel, motion, scan_period
        )
    ds = pcl.voxel_downsample(
        scan, config.scan_leaf, config.scan_capacity,
        bounds=((-150.0, -150.0, -150.0), (150.0, 150.0, 150.0)),
    )

    def register(_):
        # Coarse stage: 4x-leaf grid with direct27 probes gives a wide
        # convergence basin (several metres) — rescues bootstrap frames
        # and fast motion where the prediction is poor. A 4x-coarser
        # downsample suffices (4 m cells need no density) and cuts the
        # direct27 gather volume, the measured front-end bottleneck;
        # voxel semantics keep the selection content-deterministic
        # (positional slicing of scatter output is hash-layout-dependent
        # and diverges chaotically across jit/shard_map lowerings).
        ds_coarse = pcl.voxel_downsample(
            ds, 2.0 * config.scan_leaf, max(config.scan_capacity // 4, 256),
        )
        coarse = registration.point_to_plane_icp(
            ds_coarse,
            state.coarse_grid,
            pred,
            iters=4,
            max_corr_dist=8.0 * config.map_leaf,
            neighbors="direct27",
            inner=1,  # re-associate every step: the wide-basin stage
                      # must walk its correspondences in; with the 4x
                      # subsample the gather volume stays small
        )
        sched = None
        if config.anneal and config.iters >= 6:
            q = max(config.iters // 4, 1)
            sched = ((q, 4), (q, 2), (config.iters - 2 * q, 1))
        res = registration.point_to_plane_icp(
            ds,
            state.grid,
            coarse.pose,
            iters=config.iters,
            max_corr_dist=config.max_corr_dist,
            neighbors="direct7",
            inner=2,
            schedule=sched,
        )
        return res.pose, res.error, res.num_inliers

    def first_frame(_):
        return pred, jnp.float32(0.0), jnp.float32(0.0)

    new_pose, err, inliers = jax.lax.cond(
        state.frame > 0, register, first_frame, None
    )
    if shed:
        grid, coarse_grid = state.grid, state.coarse_grid
    else:
        # Insert a finer cloud than the registration cloud so map cells
        # carry real covariance structure (several points per cell) — the
        # analogue of FAST-LIO feeding the full-resolution scan to
        # ikd-tree while registering the downsampled one.
        fine = pcl.voxel_downsample(
            scan, config.insert_leaf, config.insert_capacity,
            bounds=((-150.0, -150.0, -150.0), (150.0, 150.0, 150.0)),
        )
        world_pts = pcl.transform(fine, new_pose)
        grid = voxel_grid.insert(state.grid, world_pts)
        # periodic maintenance (single compiled program; lax.cond skips
        # the table passes on off-cadence frames)
        grid = jax.lax.cond(
            state.frame % config.decay_every == config.decay_every - 1,
            lambda g: voxel_grid.decay(g, new_pose.t, config.map_radius),
            lambda g: g,
            grid,
        )

        def refresh_coarse(g):
            g = voxel_grid.insert(g, pcl.transform(ds, new_pose))
            return voxel_grid.decay(g, new_pose.t, config.map_radius)

        coarse_grid = jax.lax.cond(
            (state.frame % config.coarse_every == 0) | (state.frame < 4),
            refresh_coarse,
            lambda g: g,
            state.coarse_grid,
        )
    new_state = OdometryState(
        grid=grid, coarse_grid=coarse_grid, pose=new_pose,
        prev_pose=state.pose, frame=state.frame + 1,
    )
    diag = {"error": err, "inliers": inliers}
    return new_state, diag


@accurate
@partial(jax.jit, static_argnames=("config",))
def run(scans: pcl.PointCloud, config: OdometryConfig, origin: Pose | None = None):
    """Offline batch odometry: scans is a stacked (T, N, 3)/(T, N) cloud
    pytree; returns the (T,) trajectory — the whole front-end as ONE
    compiled `lax.scan` program."""
    state0 = init(config, origin)

    def body(state, frame_scan):
        new_state, diag = step(state, frame_scan, config)
        return new_state, (new_state.pose, diag["error"], diag["inliers"])

    final, (poses, errs, inliers) = jax.lax.scan(body, state0, scans)
    return final, poses, {"error": errs, "inliers": inliers}
