"""End-to-end multi-robot SLAM pipeline — the global manager, functional.

The reference's GlobalManager runs six mutex-guarded threads (discovery,
map composing, loop closing, TF publish, graph publish, geometry check —
`global_manager_node.cpp:45-50`). Here the same dataflow is a
deterministic staged pipeline over array state (SURVEY.md §2.10):

  odometry (lax.scan) -> keyframe gating -> descriptor batch ->
  loop retrieval (one einsum/FFT) -> geometry verification (vmapped
  VGICP over merged submaps) -> PCM -> chordal PGO -> map composing

Host Python only orchestrates stage order and the (tiny) dynamic loop
list; every heavy stage is jit-compiled. The multi-robot case runs the
same stages with a leading robot axis.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ..backend import chordal, factor_graph as fg, pcm
from ..frontend import keyframes as kf
from ..frontend import odometry
from ..geometry import se3, so3
from ..geometry.se3 import Pose
from ..loop import bev, disco, ring, scancontext
from ..ops import pointcloud as pcl
from ..ops import registration, voxel_grid
from ..precision import fast
from .config import SlamConfig


@dataclass
class RobotResult:
    odom_poses: Pose            # (T,) raw odometry
    store: kf.KeyframeStore     # keyframes
    kf_frame_idx: np.ndarray    # (K,) frame index of each keyframe


@dataclass
class SlamResult:
    robots: list[RobotResult]
    graph: fg.FactorGraph
    opt_poses: Pose             # (N,) optimized node poses
    node_of: np.ndarray         # (R, Kmax) node index per robot keyframe
    loops: list[dict]           # accepted loop records
    merged_cloud: pcl.PointCloud | None = None

    def optimized_trajectory(self, robot: int) -> Pose:
        ids = self.node_of[robot]
        ids = ids[ids >= 0]
        return Pose(self.opt_poses.R[ids], self.opt_poses.t[ids])


def _lio_config(cfg: SlamConfig):
    from ..frontend import lio

    o = cfg.odometry
    return lio.LioConfig(
        map_leaf=o.map_leaf, insert_leaf=o.insert_leaf, scan_leaf=o.scan_leaf,
        scan_capacity=o.scan_capacity, insert_capacity=o.insert_capacity,
        table_size=o.table_size, map_radius=o.map_radius,
        estimate_extrinsics=o.estimate_extrinsics,
    )


def _lio_extrinsic(cfg: SlamConfig):
    """OdometryCfg.extrinsic 4x4 tuple -> Pose (or None)."""
    if cfg.odometry.extrinsic is None:
        return None
    T = np.asarray(cfg.odometry.extrinsic, np.float32).reshape(4, 4)
    return Pose(jnp.asarray(T[:3, :3]), jnp.asarray(T[:3, 3]))


@partial(jax.jit, static_argnames=("cfg",))
def _frontend_fused_lio(
    scans: pcl.PointCloud,
    imu,
    cfg: SlamConfig,
    origin: Pose,
    times: jax.Array | None = None,
):
    """LIO odometry + keyframe gating as ONE lax.scan — no per-frame
    host round-trips (SURVEY §7.4 streaming). Returns (poses (T,),
    store, added (T,) bool).

    `times`: optional (T, P) per-point capture times relative to each
    sweep start (loaders/`preprocess.to_range_image`). With them
    `lio.undistort` motion-compensates every point against the
    intra-frame IMU trajectory (`IMU_Processing.hpp:65`'s backward
    pass); without them points are stamped at sweep end (instantaneous
    synthetic scans)."""
    from ..frontend import lio

    gyro, acc, dts = imu
    lcfg = _lio_config(cfg)
    state0 = lio.init(lcfg, origin, extrinsic=_lio_extrinsic(cfg))
    store0 = kf.init(cfg.keyframes.capacity, cfg.keyframes.points_per_kf)
    # frame 0: no update, just gate the first keyframe at the origin
    scan0 = pcl.PointCloud(scans.xyz[0], scans.mask[0])
    store0, added0 = kf.maybe_add(
        store0, scan0, origin, jnp.float32(0.0),
        dist_thresh=cfg.keyframes.dist_thresh, leaf=cfg.keyframes.leaf,
    )
    frame_dt = jnp.sum(dts[0])
    if times is None:
        pt_times = jnp.full(
            (scans.xyz.shape[0] - 1, scans.xyz.shape[1]), frame_dt * 0.999
        )
    else:
        pt_times = jnp.minimum(times[1:], frame_dt * 0.999)

    def body(carry, frame):
        state, store = carry
        scan_xyz, scan_mask, pt_time, g, a, dt, stamp = frame
        scan = pcl.PointCloud(scan_xyz, scan_mask)
        state, _ = lio.step(
            state, scan, pt_time, lio.ImuSample(gyro=g, acc=a, dt=dt), lcfg
        )
        store, added = kf.maybe_add(
            store, scan, state.pose(), stamp,
            dist_thresh=cfg.keyframes.dist_thresh, leaf=cfg.keyframes.leaf,
        )
        return (state, store), (state.pose(), added)

    T = scans.xyz.shape[0]
    stamps = jnp.arange(1, T, dtype=jnp.float32)
    (state, store), (poses, added) = jax.lax.scan(
        body, (state0, store0),
        (scans.xyz[1:], scans.mask[1:], pt_times, gyro, acc, dts, stamps),
    )
    poses = Pose(
        jnp.concatenate([origin.R[None], poses.R]),
        jnp.concatenate([origin.t[None], poses.t]),
    )
    added = jnp.concatenate([added0[None], added])
    return poses, store, added


@partial(jax.jit, static_argnames=("cfg",))
def _frontend_fused(
    scans: pcl.PointCloud,
    cfg: SlamConfig,
    origin: Pose,
    times: jax.Array | None = None,
):
    """Scan-matching odometry + keyframe gating as ONE lax.scan.

    `times`: optional (T, P) per-point sweep-relative capture times —
    with them each scan is constant-velocity undistorted inside
    `odometry.step` (A-LOAM `TransformToStart`)."""
    ocfg = _odometry_config(cfg)
    state0 = odometry.init(ocfg, origin)
    store0 = kf.init(cfg.keyframes.capacity, cfg.keyframes.points_per_kf)

    def body(carry, frame):
        state, store = carry
        if times is None:
            scan_xyz, scan_mask, stamp = frame
            t_rel = None
        else:
            scan_xyz, scan_mask, t_rel, stamp = frame
        scan = pcl.PointCloud(scan_xyz, scan_mask)
        state, _ = odometry.step(state, scan, ocfg, t_rel=t_rel)
        store, added = kf.maybe_add(
            store, scan, state.pose, stamp,
            dist_thresh=cfg.keyframes.dist_thresh, leaf=cfg.keyframes.leaf,
        )
        return (state, store), (state.pose, added)

    T = scans.xyz.shape[0]
    stamps = jnp.arange(T, dtype=jnp.float32)
    xs = (
        (scans.xyz, scans.mask, stamps)
        if times is None
        else (scans.xyz, scans.mask, times, stamps)
    )
    (state, store), (poses, added) = jax.lax.scan(body, (state0, store0), xs)
    return poses, store, added


def _odometry_config(cfg: SlamConfig) -> odometry.OdometryConfig:
    o = cfg.odometry
    return odometry.OdometryConfig(
        scan_leaf=o.scan_leaf, map_leaf=o.map_leaf, insert_leaf=o.insert_leaf,
        scan_capacity=o.scan_capacity, insert_capacity=o.insert_capacity,
        table_size=o.table_size, map_radius=o.map_radius, iters=o.iters,
        max_corr_dist=o.max_corr_dist, decay_every=o.decay_every,
        coarse_every=o.coarse_every, anneal=o.anneal,
    )


def run_frontend(
    scans: pcl.PointCloud,
    cfg: SlamConfig,
    origin: Pose | None = None,
    imu: tuple | None = None,
    times: jax.Array | None = None,
) -> RobotResult:
    """Odometry + keyframe extraction for one robot's scan sequence
    (scans: stacked (T, P, 3)/(T, P) pytree, body frame).

    `imu`: optional (gyro (T-1, S, 3), acc (T-1, S, 3), dt (T-1, S))
    packets; with `cfg.odometry.frontend == 'lio'` the FAST-LIO-style
    inertial front-end runs instead of pure scan matching (the
    reference's pluggable-front-end switch).

    `times`: optional (T, P) per-point sweep-relative capture times —
    enables motion compensation in BOTH front-ends (IMU-interpolated in
    LIO, constant-velocity in scan2map).

    The whole front-end (odometry ticks + keyframe gating) is ONE
    compiled `lax.scan`; the only device->host transfer per sequence is
    the (T,) keyframe mask (SURVEY §7.4 streaming/asynchrony)."""
    from . import observability as obs

    if origin is None:
        origin = se3.identity()
    with obs.tracer.span("frontend"):
        if cfg.odometry.frontend == "lio" and imu is not None:
            # import OUTSIDE the trace: module-level constants
            # (lio.GRAVITY) must not be created inside the jit trace
            from ..frontend import lio  # noqa: F401

            poses, store, added = _frontend_fused_lio(
                scans, imu, cfg, origin, times
            )
        else:
            poses, store, added = _frontend_fused(scans, cfg, origin, times)
        kf_frames = np.flatnonzero(np.asarray(added))
    kf_count = int(store.count)
    if kf_count >= cfg.keyframes.capacity:
        import warnings

        obs.metrics.inc("keyframes.capacity_saturated")
        warnings.warn(
            f"keyframe store full ({cfg.keyframes.capacity}); further "
            "keyframes are silently dropped — raise KeyframeCfg.capacity"
        )
    return RobotResult(
        odom_poses=poses, store=store,
        kf_frame_idx=np.asarray(kf_frames, np.int64),
    )


# --------------------------------------------------------------------------
# descriptors
# --------------------------------------------------------------------------


def describe_one(cloud: pcl.PointCloud, cfg: SlamConfig) -> dict:
    """Describe ONE keyframe cloud. Returns the unbatched dict for
    cfg.loops.method (same keys as `compute_descriptors`)."""
    method = cfg.loops.method
    if method == "scancontext":
        d = scancontext.describe(cloud)
        return {"sc": d, "key": scancontext.ring_key(d)}
    if method == "ring":
        norm = bev.normalize_cloud(cloud, z_min=cfg.loops.bev_z_min)
        occ = bev.cartesian_occupancy(norm)[0]
        d = ring.describe(occ)
        return {"sino": d.sinogram, "tiring": d.tiring}
    if method == "disco":
        g = bev.polar_occupancy(cloud, 40, 120, z_bins=20,
                                z_min=cfg.loops.bev_z_min)
        d = disco.describe(g)
        return {"sig": d.signature, "spec": d.spectrum}
    if method == "ringpp":
        fb = bev.eigen_feature_bev(cloud, 120, 120, k=8)
        d = ring.describe_ringpp(fb)
        return {"sino_pp": d.sinograms, "tiring_pp": d.tirings}
    if method == "m2dp":
        from ..loop import m2dp

        return {"m2dp": m2dp.describe(cloud)}
    if method == "fasthist":
        from ..loop import fast_histogram

        return {"hist": fast_histogram.describe(cloud)}
    raise ValueError(f"unknown loop method {method}")


@fast
def compute_descriptors(store: kf.KeyframeStore, cfg: SlamConfig):
    """Batch-describe every keyframe. Returns a dict of stacked arrays
    (contents depend on cfg.loops.method). Descriptor batches trace
    under hardware-default precision (TF32 on the GPU) — retrieval
    ranking tolerates it (`precision.fast`)."""
    clouds = pcl.PointCloud(store.xyz, store.mask)  # (K, P, ...)
    return jax.vmap(lambda c: describe_one(c, cfg))(clouds)


def _descriptor_distances(desc_q: dict, qi: int, desc_db: dict, cfg: SlamConfig):
    """(D,) distances of query keyframe qi against a database, plus an
    initial yaw guess per database entry (None when unavailable)."""
    m = cfg.loops.method
    if m == "scancontext":
        d, shift = scancontext.distance(
            jax.tree.map(lambda a: a[qi], desc_q["sc"]), desc_db["sc"]
        )
        n_sectors = desc_db["sc"].shape[-1]
        yaw = shift.astype(jnp.float32) * (2 * jnp.pi / n_sectors)
        return d, yaw
    if m == "ring":
        d, shift = ring.correlate(desc_q["tiring"][qi], desc_db["tiring"])
        n_angles = desc_db["tiring"].shape[-2]
        yaw = ring.shift_to_yaw(shift, n_angles)
        return d, yaw
    if m == "disco":
        d = disco.distance(
            desc_q["sig"][qi], desc_db["sig"],
            jnp.ones(desc_db["sig"].shape[0], bool),
        )
        yaws = jax.vmap(
            lambda spec: disco.relative_yaw(desc_q["spec"][qi], spec)[0]
        )(desc_db["spec"])
        return d, yaws
    if m == "ringpp":
        d, shift = ring.correlate_multichannel(
            desc_q["tiring_pp"][qi], desc_db["tiring_pp"]
        )
        n_angles = desc_db["tiring_pp"].shape[-2]
        return d, ring.shift_to_yaw(shift, n_angles)
    if m == "m2dp":
        d = jnp.linalg.norm(desc_db["m2dp"] - desc_q["m2dp"][qi][None], axis=-1)
        return d, jnp.zeros_like(d)
    if m == "fasthist":
        from ..loop import fast_histogram

        d = fast_histogram.distance(desc_q["hist"][qi], desc_db["hist"])
        return d, jnp.zeros_like(d)
    raise ValueError(m)


# --------------------------------------------------------------------------
# loop verification
# --------------------------------------------------------------------------


def _verify_loop(
    store_a: kf.KeyframeStore,
    ia: int,
    store_b: kf.KeyframeStore,
    ib: int,
    yaw_guess: float,
    cfg: SlamConfig,
    same_robot: bool = False,
    descs_a: dict | None = None,
    descs_b: dict | None = None,
):
    """Geometry check (`ICPCheck`, `global_manager.cpp:1945-2084`) for a
    single candidate loop. Thin wrapper: delegates to
    `loopstage.verify_chunk` with a batch of one, so the merge/crop/
    grid-size/seed/fitness core has exactly ONE source of truth (the
    chunked production path); `tests/test_loopstage.py` keeps the
    batch-of-one vs in-batch parity as a regression check. Returns
    (accept, rel_pose (b_kf_frame <- a_kf_frame), fitness)."""
    from . import loopstage

    rel, fit = loopstage.verify_chunk(
        store_a, store_b,
        jnp.asarray([ia], jnp.int32), jnp.asarray([ib], jnp.int32),
        jnp.asarray([yaw_guess], jnp.float32), cfg, same_robot,
        descs_a=descs_a, descs_b=descs_b,
    )
    f = float(fit[0])
    return f < cfg.loops.fitness_thresh, se3.index(rel, 0), f


def odom_space_candidates(
    store: kf.KeyframeStore, qi: int, cfg: SlamConfig
) -> list[int]:
    """Same-robot loop candidates by RADIUS SEARCH over the key-pose
    cloud — the reference's odometry-space loop path
    (`detectLoopClosure`'s 6-D radius search,
    `global_manager.cpp:1029-1094`). Returns past keyframe indices within
    `cfg.loops.odom_radius` metres of keyframe `qi`, excluding the
    temporal window; nearest first, capped at cfg.loops.candidates."""
    L = cfg.loops
    if L.odom_radius <= 0.0:
        return []
    K = int(store.count)
    if K == 0:
        return []
    t = np.asarray(store.poses.t[:K])
    d = np.linalg.norm(t - t[qi], axis=-1)
    ok = (d < L.odom_radius) & (np.abs(np.arange(K) - qi) > L.min_separation)
    idx = np.flatnonzero(ok)
    return [int(i) for i in idx[np.argsort(d[idx])][: L.candidates]]


# --------------------------------------------------------------------------
# PCM gating
# --------------------------------------------------------------------------


def pcm_gate_inter_loops(inter: list[dict], pose_of, cfg: SlamConfig) -> list[dict]:
    """Gate inter-robot loops with PCM **independently per robot pair**,
    as the reference does (`distributed_pcm.cpp:53-58`). Mixing pairs in
    one consistency matrix composes odometry poses expressed in different
    robots' frames — meaningless cycles that sever cross-pair adjacency
    and silently drop valid loops for R>=3.

    `pose_of(robot, kf)` returns that keyframe's odometry pose."""
    if not cfg.loops.use_pcm or len(inter) <= 1:
        return list(inter)
    groups: dict[tuple[int, int], list[dict]] = {}
    for l in inter:
        key = (min(l["robot_a"], l["robot_b"]), max(l["robot_a"], l["robot_b"]))
        groups.setdefault(key, []).append(l)
    kept: list[dict] = []
    for key, ls in groups.items():
        if len(ls) == 1:
            kept.extend(ls)  # singleton: no pair support, keep (reference)
            continue
        # canonical orientation within the pair: robot_a == key[0]
        # (a loop (ra,ia,rb,ib,rel) == (rb,ib,ra,ia,rel^-1))
        def ends(l):
            if l["robot_a"] == key[0]:
                return (l["robot_a"], l["kf_a"]), (l["robot_b"], l["kf_b"]), l["rel"]
            return (l["robot_b"], l["kf_b"]), (l["robot_a"], l["kf_a"]), se3.inverse(l["rel"])

        oriented = [ends(l) for l in ls]
        pa = se3.stack([pose_of(*ea) for ea, _, _ in oriented])
        pb = se3.stack([pose_of(*eb) for _, eb, _ in oriented])
        meas = se3.stack([rel for _, _, rel in oriented])
        keep = pcm.filter_loops(
            pa, pb, meas, np.ones(len(ls), bool),
            threshold=cfg.loops.pcm_threshold,
            # drift-aware cycle covariance (see pcm.consistency_matrix)
            idx_a=np.asarray([ea[1] for ea, _, _ in oriented]),
            idx_b=np.asarray([eb[1] for _, eb, _ in oriented]),
            odo_drift_t=cfg.loops.pcm_odo_drift_t,
            odo_drift_r=cfg.loops.pcm_odo_drift_r,
            step_len=cfg.keyframes.dist_thresh,
        )
        kept.extend(l for l, k in zip(ls, keep) if k)
    return kept


# --------------------------------------------------------------------------
# full pipeline
# --------------------------------------------------------------------------


def run(
    scans_per_robot: list[pcl.PointCloud],
    cfg: SlamConfig,
    origins: list[Pose] | None = None,
    imus: list[tuple] | None = None,
    times_per_robot: list | None = None,
) -> SlamResult:
    """Full multi-robot SLAM: per-robot front-ends, cross/self loop
    search, verification, PCM, chordal PGO.

    Per-robot `cfg.overlays` apply to each robot's front-end; when
    `origins` is None, overlay `init_pose`s are used (the reference's
    `manual_config_dir` initial-pose path). `times_per_robot`: optional
    per-robot (T, P) point-time arrays for motion compensation."""
    R = len(scans_per_robot)
    robots = []
    for r in range(R):
        origin = origins[r] if origins else cfg.init_pose(r)
        imu = imus[r] if imus else None
        times = times_per_robot[r] if times_per_robot else None
        robots.append(
            run_frontend(scans_per_robot[r], cfg.for_robot(r), origin, imu, times)
        )
    return run_backend(robots, cfg)


def build_graph(robots: list[RobotResult], cfg: SlamConfig):
    """Vectorized pose-graph construction: ONE node scatter and ONE
    odometry-edge scatter per robot (the per-keyframe `add_node`/
    `add_edge` host loop this replaces issued O(K) dispatches).

    Returns (graph, node_of (R, Kmax) int64 with -1 padding)."""
    R = len(robots)
    graph = fg.init(cfg.pgo.node_capacity, cfg.pgo.edge_capacity)
    counts = [int(rr.store.count) for rr in robots]
    node_of = -np.ones((R, max(max(counts, default=0), 1)), np.int64)
    for r, rr in enumerate(robots):
        K = counts[r]
        if K == 0:
            continue
        poses = Pose(rr.store.poses.R[:K], rr.store.poses.t[:K])
        graph, idx = fg.add_nodes_batch(
            graph, poses, jnp.full((K,), r, jnp.int32)
        )
        idx_np = np.asarray(idx)
        node_of[r, :K] = np.where(idx_np < cfg.pgo.node_capacity, idx_np, -1)
        if (node_of[r, :K] < 0).any():
            import warnings

            warnings.warn(
                f"pose-graph node capacity {cfg.pgo.node_capacity} "
                f"saturated adding robot {r} ({K} keyframes) — "
                "overflow keyframes dropped from the graph"
            )
        if K > 1:
            meas = se3.between(
                Pose(poses.R[:-1], poses.t[:-1]), Pose(poses.R[1:], poses.t[1:])
            )
            graph, _ = fg.add_edges_batch(
                graph, idx[:-1], idx[1:], meas, fg.ODOM, 1.0, 1.0
            )
    return graph, node_of


def _allgather_loops(
    my_loops: list[tuple[int, dict]], max_loops: int
) -> list[tuple[int, dict]]:
    """Exchange per-process accepted-loop records: each process packs
    its loops into a fixed (max_loops, 19) float32 record block
    [pair_idx, ra, kf_a, rb, kf_b, fitness, desc_dist, R(9), t(3)] +
    count, all-gathers, and unpacks the union (the cross-host `Loops`
    message exchange, array-native)."""
    from jax.experimental import multihost_utils

    block = np.zeros((max_loops, 19), np.float32)
    for i, (pi, l) in enumerate(my_loops[:max_loops]):
        block[i, 0:7] = [
            pi, l["robot_a"], l["kf_a"], l["robot_b"], l["kf_b"],
            float(l["fitness"]), float(l["desc_dist"]),
        ]
        block[i, 7:16] = np.asarray(l["rel"].R).reshape(-1)
        block[i, 16:19] = np.asarray(l["rel"].t)
    count = np.array([min(len(my_loops), max_loops)], np.int32)
    blocks = multihost_utils.process_allgather(block)          # (P, L, 19)
    counts = multihost_utils.process_allgather(count).reshape(-1)
    merged: list[tuple[int, dict]] = []
    for p in range(blocks.shape[0]):
        for i in range(int(counts[p])):
            row = blocks[p, i]
            merged.append((int(row[0]), dict(
                robot_a=int(row[1]), kf_a=int(row[2]),
                robot_b=int(row[3]), kf_b=int(row[4]),
                rel=Pose(jnp.asarray(row[7:16].reshape(3, 3)),
                         jnp.asarray(row[16:19])),
                fitness=float(row[5]), desc_dist=float(row[6]),
            )))
    return merged


def run_backend(
    robots: list[RobotResult],
    cfg: SlamConfig,
    pgo_mesh=None,
) -> SlamResult:
    """Back-end stages on finished front-end products: graph build, loop
    retrieval + verification, per-pair PCM, chordal PGO. Deterministic
    given identical inputs, so multi-host runs execute it redundantly on
    every process (replicated control; see `parallel/multihost.py`).
    `pgo_mesh`: optional device mesh — the optimizer runs edge-sharded
    over it (`backend/distributed.py`) instead of single-device.

    Array-native dispatch budget: O(R) descriptor batches + graph
    scatters, O(R^2) retrievals, O(candidates / CHUNK) verification
    batches — never O(K) host round-trips (see `runtime/loopstage.py`).
    """
    from . import loopstage
    from . import observability as obs

    R = len(robots)
    with obs.tracer.span("backend.prepare"):
        descs = [compute_descriptors(rr.store, cfg) for rr in robots]
        jax.block_until_ready(descs)

    # ---- build graph: odometry chains (vectorized scatters) --------------
    with obs.tracer.span("backend.graph"):
        graph, node_of = build_graph(robots, cfg)

    # ---- loop retrieval + verification (batched, O(R^2) dispatches) ------
    loops: list[dict] = []
    # Each unordered pair once (ra==rb = self). INTER-robot pairs sweep
    # first: they anchor the robots to each other (the whole point of
    # the multi-robot system) and must not be starved of the max_loops
    # budget by dense same-robot revisits on multi-lap runs.
    pairs = sorted(
        ((ra, rb) for ra in range(R) for rb in range(ra + 1)),
        key=lambda p: p[0] == p[1],
    )
    # Multi-process: robot pairs are SHARDED round-robin across
    # processes (each verifies only its pairs — the expensive chunked
    # VGICP stage parallelizes across hosts) and the accepted-loop
    # records are all-gathered; ordering by pair index keeps every
    # process's merged list identical (deterministic replicated
    # control downstream).
    n_proc = jax.process_count()
    pid = jax.process_index()
    with obs.tracer.span("backend.associate"):
        my_loops: list[tuple[int, dict]] = []
        for pi, (ra, rb) in enumerate(pairs):
            if n_proc > 1 and pi % n_proc != pid:
                continue
            found = loopstage.search_pair_loops(
                robots[ra].store, descs[ra], robots[rb].store, descs[rb],
                cfg, same_robot=(ra == rb),
            )
            for l in found:
                my_loops.append((pi, dict(
                    robot_a=ra, kf_a=l["kf_a"], robot_b=rb,
                    kf_b=l["kf_b"], rel=l["rel"],
                    fitness=l["fitness"], desc_dist=l["desc_dist"],
                )))
        if n_proc > 1:
            my_loops = _allgather_loops(my_loops, cfg.loops.max_loops)
        loops = [l for _, l in sorted(my_loops, key=lambda x: x[0])]
    loops = loops[: cfg.loops.max_loops]
    obs.metrics.inc("backend.loops_found", len(loops))

    # ---- PCM gating on inter-robot loops (per robot pair) ----------------
    inter = [l for l in loops if l["robot_a"] != l["robot_b"]]
    intra = [l for l in loops if l["robot_a"] == l["robot_b"]]
    with obs.tracer.span("backend.pcm"):
        kept_inter = pcm_gate_inter_loops(
            inter, lambda r, k: se3.index(robots[r].store.poses, k), cfg
        )
    obs.metrics.inc("backend.pcm_rejected", len(inter) - len(kept_inter))

    accepted = intra + kept_inter
    if accepted:
        # one batched edge scatter for ALL loop edges. rel maps a->b
        # POINTS, i.e. T_b^-1 T_a; edge meas = between(pose_i, pose_j)
        # = T_a^-1 T_b = rel^-1.
        ei = jnp.asarray(
            [int(node_of[l["robot_a"], l["kf_a"]]) for l in accepted], jnp.int32
        )
        ej = jnp.asarray(
            [int(node_of[l["robot_b"], l["kf_b"]]) for l in accepted], jnp.int32
        )
        kinds = jnp.asarray(
            [
                fg.INTRA_LOOP if l["robot_a"] == l["robot_b"] else fg.INTER_LOOP
                for l in accepted
            ],
            jnp.int32,
        )
        meas = se3.inverse(se3.stack([l["rel"] for l in accepted]))
        graph, _ = fg.add_edges_batch(
            graph, ei, ej, meas, kinds,
            jnp.full((len(accepted),), cfg.loops.w_rot, jnp.float32),
            jnp.full((len(accepted),), cfg.loops.w_trans, jnp.float32),
        )

    # ---- optimize --------------------------------------------------------
    anchors = np.zeros(graph.node_capacity, bool)
    for r in range(R):
        if node_of[r, 0] >= 0:
            anchors[int(node_of[r, 0])] = True
    pgo_cfg = chordal.PGOConfig(
        rot_cg_iters=cfg.pgo.rot_cg_iters, gn_iters=cfg.pgo.gn_iters,
        pose_cg_iters=cfg.pgo.pose_cg_iters, robust_delta=cfg.pgo.robust_delta,
    )
    with obs.tracer.span("backend.solve"):
        if pgo_mesh is not None:
            from ..backend import distributed

            opt = distributed.optimize(
                graph, jnp.asarray(anchors), pgo_mesh, pgo_cfg
            )
        else:
            opt = chordal.optimize(graph, jnp.asarray(anchors), pgo_cfg)
        jax.block_until_ready(opt.t)
    return SlamResult(
        robots=robots, graph=graph, opt_poses=opt, node_of=node_of,
        loops=accepted,
    )


def build_elevation(
    result: SlamResult,
    cfg: SlamConfig,
    center=(0.0, 0.0),
    size: int = 600,
):
    """Fuse every optimized keyframe cloud into one global 2.5D
    elevation map + terrain features + costmap — the reference's
    "merged elevation map -> costmap" product (`composeGlobalMap` +
    `pointMap_layer`). `size` cells at cfg.elevation.resolution."""
    from ..mapping import costmap as costmap_mod
    from ..mapping import elevation
    from . import observability as obs

    with obs.tracer.span("backend.compose"):
        emap = elevation.init(
            size=size, resolution=cfg.elevation.resolution, center=center
        )
        for r, rr in enumerate(result.robots):
            K = int(rr.store.count)
            if K == 0:
                continue
            ids = result.node_of[r, :K]
            poses = Pose(result.opt_poses.R[ids], result.opt_poses.t[ids])
            pts = (
                jnp.einsum("kab,kpb->kpa", poses.R, rr.store.xyz[:K])
                + poses.t[:, None, :]
            )
            cloud = pcl.park(
                pcl.PointCloud(pts.reshape(-1, 3), rr.store.mask[:K].reshape(-1))
            )
            var = elevation.sensor_variance(cloud.xyz)
            emap = elevation.fuse(emap, cloud, var)
        feats = elevation.features(emap)
        cm = costmap_mod.from_elevation(
            emap, feats, travers_thresh=cfg.elevation.travers_thresh
        )
        jax.block_until_ready(cm)
    return emap, feats, cm


def compose_map(
    result: SlamResult, leaf: float = 0.5, capacity: int = 1 << 17
) -> pcl.PointCloud:
    """Merged global cloud: every keyframe re-transformed by its
    optimized pose, voxel-merged (`composeGlobalMap`,
    `global_manager.cpp:2090-2236`)."""
    parts_xyz = []
    parts_mask = []
    for r, rr in enumerate(result.robots):
        K = int(rr.store.count)
        if K == 0:
            continue
        ids = result.node_of[r, :K]
        poses = Pose(result.opt_poses.R[ids], result.opt_poses.t[ids])
        pts = (
            jnp.einsum("kab,kpb->kpa", poses.R, rr.store.xyz[:K])
            + poses.t[:, None, :]
        )
        parts_xyz.append(pts.reshape(-1, 3))
        parts_mask.append(rr.store.mask[:K].reshape(-1))
    merged = pcl.park(
        pcl.PointCloud(jnp.concatenate(parts_xyz), jnp.concatenate(parts_mask))
    )
    return pcl.voxel_downsample(merged, leaf, capacity)
