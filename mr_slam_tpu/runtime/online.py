"""Online (streaming) multi-robot SLAM session.

The reference's GlobalManager is callback-driven: six threads racing
over mutex-guarded state (discovery, loop closing @0.1 Hz, geometry
check busy-loop, composing @3 Hz, TF @10 Hz — `global_manager_node.cpp:
45-50`). This runtime replaces that with ONE deterministic scheduler:
`add_frame` ticks odometry (jitted, fixed shapes) and gates keyframes;
every `loop_every` new keyframes the session runs the loop stage
(batched retrieval -> batched verification -> PCM -> incremental PGO).
No locks, no races — state transitions are explicit and replayable
(the §5.2 story: races disappear by construction).

Backing state is the batched `parallel.store.MultiRobotStore` — ONE
robot-major pytree holding every robot's keyframe clouds, poses and
structured descriptor database (the array-native `RobotHandle` vector,
`global_manager.h:108-137`). Keyframe appends and descriptor writes are
single-dispatch scatters (`gate_and_add`/`write_descriptor`, the
`mapUpdate`/`discoUpdate` pair); the whole session state is a pytree +
small manifest, which is what makes `runtime.checkpoint.save_session`
a plain array dump.

Robots register lazily (`register_robot`), mirroring topic discovery;
a robot can join mid-session.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..backend import chordal, factor_graph as fg
from ..frontend import odometry
from ..geometry import se3
from ..geometry.se3 import Pose
from ..ops import pointcloud as pcl
from ..parallel import store as mstore_lib
from . import pipeline as pl
from .config import SlamConfig


class OnlineSlam:
    def __init__(self, cfg: SlamConfig, enable_gem: bool = False):
        self.cfg = cfg
        self.odo_cfg = pl._odometry_config(cfg)
        self.robots: dict[int, dict] = {}    # per-robot odometry/GEM state
        self.rows: dict[int, int] = {}       # robot id -> mstore row
        self.mstore: Optional[mstore_lib.MultiRobotStore] = None
        # `self.graph` holds ONLY the odometry chains; accepted loop
        # edges live in `self.loops` and are composed in as one batched
        # scatter at optimize time (`_graph_with_loops`) — no host-side
        # edge compaction between rounds
        self.graph = fg.init(cfg.pgo.node_capacity, cfg.pgo.edge_capacity)
        self.node_of: dict[tuple[int, int], int] = {}
        self.loops: list[dict] = []
        self._pending_kf: list[tuple[int, int]] = []  # (robot, kf index)
        # (robot_a, robot_b) -> {(kf_a, kf_b)} already verified — the
        # incremental exclude sets (symmetric entries kept both ways)
        self._searched: dict[tuple[int, int], set] = {}
        self._inter_candidates: list[dict] = []  # every verified inter loop
        self.opt_poses: Optional[Pose] = None
        self._opt_n_nodes = -1  # graph size at the last solve
        self.loop_every = cfg.scheduler.loop_every_kf
        self.enable_gem = enable_gem  # per-robot rolling elevation maps
        # scheduler state (stamp-driven cadences + deadline monitor)
        from ..geometry.tf_tree import TransformBuffer

        self.tf = TransformBuffer()
        self.merged_map: Optional[pcl.PointCloud] = None
        self._last_loop_stamp: Optional[float] = None
        self._last_compose_stamp: Optional[float] = None
        self._last_tf_stamp: Optional[float] = None
        self._over_budget_prev = False  # last frame blew the deadline

    # -- batched-store plumbing ----------------------------------------
    def _kf_capacity(self) -> int:
        """Uniform store capacity: the max resolved per-robot keyframe
        capacity (overlays may grow it — rows of smaller robots carry
        padding, the per-robot gate still uses their own threshold)."""
        caps = [self.cfg.keyframes.capacity] + [
            ov.keyframes.capacity
            for ov in self.cfg.overlays
            if ov.keyframes is not None
        ]
        return max(caps)

    def _points_per_kf(self) -> int:
        pts = [self.cfg.keyframes.points_per_kf] + [
            ov.keyframes.points_per_kf
            for ov in self.cfg.overlays
            if ov.keyframes is not None
        ]
        return max(pts)

    def _ensure_row(self, robot: int) -> int:
        """Allocate (or grow) the batched store row for `robot`."""
        if robot in self.rows:
            return self.rows[robot]
        if self.mstore is None:
            # descriptor layout comes from one template describe_one on
            # an empty cloud (shapes are data-independent)
            P = self._points_per_kf()
            dummy = pcl.park(
                pcl.PointCloud(jnp.zeros((P, 3)), jnp.zeros((P,), bool))
            )
            template = pl.describe_one(dummy, self.cfg)
            self.mstore = mstore_lib.init(
                1, self._kf_capacity(), P, desc_template=template
            )
            self.rows[robot] = 0
            return 0
        # Geometric growth: when every allocated row is used, DOUBLE the
        # row count in one realloc (amortized O(1) per joining robot,
        # instead of an O(R * store) realloc per discovery); spare rows
        # sit pre-initialized until claimed.
        row = len(self.rows)
        allocated = self.mstore.desc_valid.shape[0]
        if row >= allocated:
            grow = allocated  # double
            self.mstore = jax.tree.map(
                lambda a: jnp.concatenate(
                    [a, jnp.zeros((grow, *a.shape[1:]), a.dtype)]
                ),
                self.mstore,
            )
            # fresh KeyframeStore rows need their sentinel/identity fields
            spare = mstore_lib.init(
                grow, self._kf_capacity(), self._points_per_kf(), desc_dim=0
            ).stores
            self.mstore = self.mstore._replace(
                stores=jax.tree.map(
                    lambda b, s: b.at[allocated:].set(s),
                    self.mstore.stores, spare,
                )
            )
        self.rows[robot] = row
        return row

    def store_view(self, robot: int):
        """This robot's (KeyframeStore, descriptor-tree) view."""
        return self.mstore.robot_view(self.rows[robot])

    # -- discovery ------------------------------------------------------
    def register_robot(self, robot: int, origin: Pose | None = None) -> None:
        if robot in self.robots:
            return
        if origin is None:
            origin = self.cfg.init_pose(robot)  # overlay T.initPose
        rcfg = self.cfg.for_robot(robot)
        if rcfg.odometry.frontend == "lio":
            # streaming lidar-inertial front-end (the reference's
            # FAST-LIO per-robot node); frames must carry IMU packets
            from ..frontend import lio

            rs = dict(
                frontend="lio",
                odo=lio.init(pl._lio_config(rcfg), origin,
                             extrinsic=pl._lio_extrinsic(rcfg)),
                odo_cfg=pl._lio_config(rcfg),
                kf_cfg=rcfg.keyframes,
                frame=0,
            )
        else:
            rs = dict(
                frontend="scan2map",
                odo=odometry.init(pl._odometry_config(rcfg), origin),
                odo_cfg=pl._odometry_config(rcfg),
                kf_cfg=rcfg.keyframes,
                frame=0,
            )
        if self.enable_gem:
            from ..mapping import elevation

            e = rcfg.elevation
            center = (0.0, 0.0) if origin is None else (
                float(origin.t[0]), float(origin.t[1])
            )
            rs["gem_cfg"] = e
            rs["gem_local"] = elevation.init(
                size=e.size, resolution=e.resolution, center=center
            )
            # flushed grid submaps: (kf index, cloud in that keyframe's
            # body frame) — the SubMap{submap=grid, pose} publish at each
            # keyframe boundary (`ElevationMapping.cpp:653-760`)
            rs["gem_flushed"] = []
        self.robots[robot] = rs
        self._ensure_row(robot)

    # -- per-frame tick -------------------------------------------------
    def add_frame(
        self,
        robot: int,
        scan: pcl.PointCloud,
        stamp: float = 0.0,
        times=None,
        imu=None,
    ) -> Pose:
        """Odometry tick + keyframe gate. Returns the current odometry
        pose estimate for `robot`. `times`: optional (P,) per-point
        sweep-relative capture times — enables constant-velocity
        undistortion in the odometry step (IMU-interpolated in LIO).
        `imu`: (gyro (S, 3), acc (S, 3), dt (S)) packet covering the
        sweep — REQUIRED per frame when the robot runs the LIO
        front-end (`OdometryCfg.frontend == 'lio'`).

        Sync budget: ONE scalar device->host transfer per frame (the
        keyframe-gate bit, needed to schedule the host-side descriptor
        write and loop stage). At 10 Hz x R robots this is O(10R)
        scalar syncs/s — negligible against the per-frame compute; the
        offline path (`pipeline._frontend_fused`) folds even this into
        its lax.scan."""
        import time as _time

        from . import observability as obs

        if robot not in self.robots:
            self.register_robot(robot)
        rs = self.robots[robot]
        row = self.rows[robot]
        sched = self.cfg.scheduler
        # two-rate + load-shed decision (scan2map only; never frame 0 or
        # the frame right after a registered keyframe — map must grow
        # around new keyframes; a shed frame's map contribution is
        # DROPPED, not deferred)
        after_kf = rs["frame"] == rs.get("last_kf_frame", -2) + 1
        shed = (rs["frontend"] == "scan2map" and rs["frame"] > 0
                and not after_kf and (
            (sched.map_every > 1 and rs["frame"] % sched.map_every != 0)
            or (sched.shed and self._over_budget_prev)
        ))
        t_frame0 = _time.perf_counter()
        with obs.tracer.span("online.frontend"):
            if rs["frontend"] == "lio":
                from ..frontend import lio

                if imu is None:
                    if rs["frame"] > 0:
                        raise ValueError(
                            f"robot {robot} runs the LIO front-end; "
                            "add_frame needs an imu=(gyro, acc, dt) "
                            "packet per frame"
                        )
                    # frame 0: no propagation — gate the origin keyframe
                    # (the batch path does the same, `_frontend_fused_lio`)
                else:
                    gyro, acc, dts = imu
                    frame_dt = jnp.sum(dts)
                    pt_time = (
                        jnp.asarray(times)
                        if times is not None
                        else jnp.full((scan.xyz.shape[0],), frame_dt * 0.999)
                    )
                    rs["odo"], _ = lio.step(
                        rs["odo"], scan, pt_time,
                        lio.ImuSample(gyro=gyro, acc=acc, dt=dts),
                        rs["odo_cfg"],
                    )
                pose = rs["odo"].pose()
            else:
                rs["odo"], _ = odometry.step(
                    rs["odo"], scan, rs["odo_cfg"], t_rel=times, shed=shed
                )
                pose = rs["odo"].pose
            self.mstore, added, k = mstore_lib.gate_and_add(
                self.mstore, jnp.int32(row), scan, pose, jnp.float32(stamp),
                dist_thresh=rs["kf_cfg"].dist_thresh, leaf=rs["kf_cfg"].leaf,
            )
            added = bool(added)
        rs["frame"] += 1
        if not added and int(self.mstore.stores.count[row]) >= self._kf_capacity():
            import warnings

            obs.metrics.inc("keyframes.capacity_saturated")
            if obs.metrics.counters["keyframes.capacity_saturated"] == 1:
                warnings.warn(
                    "keyframe store full; further keyframes are dropped — "
                    "raise KeyframeCfg.capacity"
                )
        if self.enable_gem:
            with obs.tracer.span("online.gem"):
                self._gem_tick(rs, scan, pose)
        if shed:
            obs.metrics.inc("frontend.frames_shed")
        if added:
            rs["last_kf_frame"] = rs["frame"] - 1  # frame already advanced
            self._on_keyframe(robot, int(k), stamp)
        # ---- deadline monitor (A-LOAM soft-deadline/drop analogue) ----
        if sched.frame_budget_s > 0.0:
            dt_frame = _time.perf_counter() - t_frame0
            self._over_budget_prev = dt_frame > sched.frame_budget_s
            if self._over_budget_prev:
                obs.metrics.inc("frontend.frames_over_budget")
        # ---- stamp-driven cadences (composing 3 Hz / TF 10 Hz / loop
        # 0.1 Hz in the reference launch) -------------------------------
        if sched.loop_period_s > 0.0 and self._pending_kf:
            if (self._last_loop_stamp is None
                    or stamp - self._last_loop_stamp >= sched.loop_period_s):
                self._last_loop_stamp = stamp
                self.run_loop_stage()
        if sched.tf_period_s > 0.0:
            if (self._last_tf_stamp is None
                    or stamp - self._last_tf_stamp >= sched.tf_period_s):
                self._last_tf_stamp = stamp
                self.publish_tf(stamp)
        if sched.compose_period_s > 0.0:
            if (self._last_compose_stamp is None
                    or stamp - self._last_compose_stamp
                    >= sched.compose_period_s):
                self._last_compose_stamp = stamp
                with obs.tracer.span("online.compose"):
                    self.merged_map = self.compose_map()
                obs.metrics.inc("compose.runs")
        return pose

    # -- cadence products ------------------------------------------------
    def publish_tf(self, stamp: float) -> None:
        """Write the current map->odom correction per robot into the
        session's tf2-analogue buffer (`publishTF`,
        `global_manager.cpp:2242-2276`: /map -> robot_N/odom from
        mapTF[i]). Correction = optimized(latest kf) o odom(latest kf)^-1;
        identity until the first optimization."""
        from . import observability as obs

        for r in self.robots:
            store, _ = self.store_view(r)
            K = int(store.count)
            if K == 0:
                continue
            # correction from the latest keyframe COVERED BY the last
            # solve (a newer node would read zeros from the stale array)
            node = self.node_of.get((r, K - 1))
            k_used = K - 1
            if node is not None and node >= self._opt_n_nodes:
                for k_used in range(K - 2, -1, -1):
                    node = self.node_of.get((r, k_used))
                    if node is None or node < self._opt_n_nodes:
                        break
                else:
                    node = None
            if self.opt_poses is not None and node is not None:
                opt = se3.index(self.opt_poses, node)
                odom = se3.index(store.poses, k_used)
                corr = se3.compose(opt, se3.inverse(odom))
            else:
                corr = se3.identity()
            self.tf.set_transform(
                "map", f"robot_{r}/odom", stamp,
                np.asarray(corr.R), np.asarray(corr.t),
            )
        obs.metrics.inc("tf.publishes")

    def compose_map(
        self, leaf: float = 0.5, capacity: int = 1 << 17
    ) -> pcl.PointCloud:
        """Merged global cloud from the CURRENT session state (keyframes
        re-transformed by optimized poses where available) — the
        composing-thread product (`composeGlobalMap`,
        `global_manager.cpp:2090-2236`)."""
        parts_xyz, parts_mask = [], []
        for r in self.robots:
            store, _ = self.store_view(r)
            K = int(store.count)
            if K == 0:
                continue
            ids = np.asarray(
                [self.node_of.get((r, k), -1) for k in range(K)]
            )
            # only read nodes covered by the LAST solve (later nodes
            # would read zeros from the stale opt array)
            if (self.opt_poses is not None and (ids >= 0).all()
                    and (ids < self._opt_n_nodes).all()):
                poses = Pose(
                    self.opt_poses.R[ids], self.opt_poses.t[ids]
                )
            else:
                poses = se3.index(store.poses, jnp.arange(K))
            pts = (
                jnp.einsum("kab,kpb->kpa", poses.R, store.xyz[:K])
                + poses.t[:, None, :]
            )
            parts_xyz.append(pts.reshape(-1, 3))
            parts_mask.append(store.mask[:K].reshape(-1))
        if not parts_xyz:
            return pcl.park(
                pcl.PointCloud(jnp.zeros((1, 3)), jnp.zeros((1,), bool))
            )
        merged = pcl.park(pcl.PointCloud(
            jnp.concatenate(parts_xyz), jnp.concatenate(parts_mask)
        ))
        return pcl.voxel_downsample(merged, leaf, capacity)

    # -- per-robot rolling GEM -------------------------------------------
    def _gem_tick(self, rs: dict, scan: pcl.PointCloud, pose: Pose) -> None:
        """Shift the rolling local grid to the robot and Kalman-fuse the
        frame — the per-frame half of `ElevationMapping::Callback`
        (`ElevationMapping.cpp:298` -> `G_Clear_map`/`G_fuse`)."""
        from ..mapping import elevation

        m = elevation.shift(rs["gem_local"], pose.t[:2])
        m = elevation.predict(m)
        # motion-induced variance (RobotMotionMapUpdater): odometry drift
        # proportional to motion since the last frame, split into a
        # vertical and a tilt (lever-arm) component
        last = rs.get("gem_last_pose")
        e = rs.get("gem_cfg", self.cfg.elevation)
        if last is not None and (e.drift_z > 0.0 or e.drift_tilt > 0.0):
            dt = float(jnp.linalg.norm(pose.t - last.t))
            drot = float(
                jnp.arccos(jnp.clip(
                    (jnp.trace(last.R.T @ pose.R) - 1.0) / 2.0, -1.0, 1.0
                ))
            )
            m = elevation.motion_update(
                m, pose.t[:2],
                sigma_z=e.drift_z * dt, sigma_tilt=e.drift_tilt * drot,
            )
        rs["gem_last_pose"] = pose
        world = pcl.transform(scan, pose)
        var = elevation.sensor_variance(scan.xyz)  # beam model, body frame
        rs["gem_local"] = elevation.fuse(m, world, var)

    def _gem_flush(self, rs: dict, k: int, pose: Pose) -> None:
        """Keyframe boundary: flush the local grid as a cloud anchored to
        keyframe k's BODY frame (`updateLocalMap`,
        `ElevationMapping.cpp:653-760` publishing SubMap{grid, pose}).
        Anchoring to the keyframe makes re-anchoring after optimization a
        pose substitution, which `global_elevation` applies lazily — the
        `updateGlobalMap`/`optKeyframeCallback` re-transform
        (`ElevationMapping.cpp:592-821`) without grid rewrites."""
        from ..mapping import elevation

        cloud = elevation.to_cloud(rs["gem_local"])       # world frame
        body = pcl.transform(cloud, se3.inverse(pose))
        rs["gem_flushed"].append((k, body))

    def global_elevation(self, size: int = 512, center=(0.0, 0.0)):
        """Compose the global 2.5D map from flushed grid submaps, each
        re-anchored to its keyframe's OPTIMIZED pose (`GetInitMap` +
        `composeGlobalMap`'s elevation product)."""
        from ..mapping import elevation

        e = self.cfg.elevation
        emap = elevation.init(size=size, resolution=e.resolution, center=center)
        for robot, rs in self.robots.items():
            store, _ = self.store_view(robot)
            for k, body in rs.get("gem_flushed", []):
                node = self.node_of.get((robot, k))
                if node is None:
                    continue
                if self.opt_poses is not None and node < self._opt_n_nodes:
                    pose = se3.index(self.opt_poses, node)
                else:
                    pose = se3.index(store.poses, k)
                world = pcl.transform(body, pose)
                var = elevation.sensor_variance(body.xyz)
                emap = elevation.fuse(emap, world, var)
        return emap

    def _on_keyframe(self, robot: int, k: int, stamp: float = 0.0) -> None:
        from . import observability as obs

        rs = self.robots[robot]
        row = self.rows[robot]
        pose = se3.index(
            jax.tree.map(lambda a: a[row], self.mstore.stores.poses), k
        )
        if self.enable_gem:
            self._gem_flush(rs, k, pose)
        self.graph, idx = fg.add_node(self.graph, pose, jnp.int32(robot))
        if int(self.graph.n_nodes) >= self.graph.node_capacity:
            import warnings

            obs.metrics.inc("graph.node_capacity_saturated")
            warnings.warn(
                "pose-graph node capacity reached; further keyframes "
                "cannot enter the graph — raise PGOCfg.node_capacity"
            )
        self.node_of[(robot, k)] = int(idx)
        if k > 0:
            prev = self.node_of[(robot, k - 1)]
            prev_pose = se3.index(
                jax.tree.map(lambda a: a[row], self.mstore.stores.poses), k - 1
            )
            meas = se3.between(prev_pose, pose)
            self.graph, _ = fg.add_edge(
                self.graph, jnp.int32(prev), jnp.int32(int(idx)), meas,
                jnp.int32(fg.ODOM), jnp.float32(1.0), jnp.float32(1.0),
            )
        # incremental descriptor append — O(1) new work per keyframe,
        # like `discoUpdate` (`global_manager.cpp:1867-1888`), straight
        # into the batched store
        store, _ = self.store_view(robot)
        one = pl.describe_one(store.cloud(k), self.cfg)
        self.mstore = mstore_lib.write_descriptor(
            self.mstore, jnp.int32(row), jnp.int32(k), one
        )
        self._pending_kf.append((robot, k))
        if (self.loop_every > 0
                and len(self._pending_kf) >= self.loop_every):
            self._last_loop_stamp = stamp
            self.run_loop_stage()

    # -- loop stage -----------------------------------------------------
    def run_loop_stage(self) -> int:
        """Detect + verify loops for pending keyframes; optimize when
        any loop lands. Returns number of accepted loops this round.

        Batched: per (pending-robot, database-robot) pair this issues
        ONE retrieval dispatch and O(candidates / CHUNK) verification
        dispatches (`runtime/loopstage.py`), not one per keyframe."""
        from . import loopstage
        from . import observability as obs

        cfg = self.cfg
        new_loops = []
        pending, self._pending_kf = self._pending_kf, []
        # each unordered keyframe pair is verified at most once per
        # session, even when BOTH ends are pending this round (the batch
        # pipeline gets this for free from its rb <= ra sweep). Same-
        # robot pairs are additionally deduped by loopstage's strict
        # lower-triangle retrieval mask. `self._searched` keeps the
        # per-robot-pair exclude sets incrementally (O(new loops) per
        # round, not a rebuild over every historical loop).
        by_robot: dict[int, list[int]] = {}
        for ra, ia in pending:
            by_robot.setdefault(ra, []).append(ia)
        for ra, ias in by_robot.items():
            store_a, descs_a = self.store_view(ra)
            # fixed-length query batch -> one compiled retrieval program
            # per (pair, batch-size) instead of one dispatch per query
            Q = max(self.loop_every, len(ias), 1)
            qi = np.full((Q,), -1, np.int64)
            qi[: len(ias)] = ias
            for rb in self.robots:
                store_b, descs_b = self.store_view(rb)
                if int(store_b.count) == 0:
                    continue
                exclude = self._searched.setdefault((ra, rb), set())
                found = loopstage.search_pair_loops(
                    store_a, descs_a, store_b, descs_b, cfg,
                    same_robot=(ra == rb), query_idx=qi, exclude=exclude,
                )
                for l in found:
                    if (l["kf_a"], l["kf_b"]) in exclude:
                        continue
                    exclude.add((l["kf_a"], l["kf_b"]))
                    self._searched.setdefault((rb, ra), set()).add(
                        (l["kf_b"], l["kf_a"])
                    )
                    new_loops.append(
                        dict(robot_a=ra, kf_a=l["kf_a"], robot_b=rb,
                             kf_b=l["kf_b"], rel=l["rel"],
                             fitness=l["fitness"], desc_dist=l["desc_dist"])
                    )
        if not new_loops:
            return 0
        # PCM over ALL inter-robot candidates ever verified (old + new,
        # including previously-rejected ones — consistency can emerge as
        # evidence accumulates), re-gated per robot pair on every
        # optimization round (`distributed_pcm.cpp:53-58`)
        self._inter_candidates.extend(
            l for l in new_loops if l["robot_a"] != l["robot_b"]
        )
        inter = list(self._inter_candidates)
        intra = [
            l for l in self.loops + new_loops
            if l["robot_a"] == l["robot_b"]
        ]

        def pose_of(r, k):
            store, _ = self.store_view(r)
            return se3.index(store.poses, k)

        with obs.tracer.span("online.pcm"):
            kept = pl.pcm_gate_inter_loops(inter, pose_of, cfg)
        obs.metrics.inc("online.pcm_rejected", len(inter) - len(kept))
        self.loops = intra + kept
        with obs.tracer.span("online.solve"):
            self.optimize()
            jax.block_until_ready(self.opt_poses.t)
        return len(new_loops)

    def _graph_with_loops(self) -> fg.FactorGraph:
        """Compose the persistent odometry graph with the currently-
        accepted loop edges — ONE batched device scatter, no host-side
        edge compaction (the persistent graph never holds loop edges,
        so 'rebuilding' them is just not writing the rejected ones)."""
        if not self.loops:
            return self.graph
        ei = jnp.asarray(
            [self.node_of[(l["robot_a"], l["kf_a"])] for l in self.loops],
            jnp.int32,
        )
        ej = jnp.asarray(
            [self.node_of[(l["robot_b"], l["kf_b"])] for l in self.loops],
            jnp.int32,
        )
        kinds = jnp.asarray(
            [
                fg.INTRA_LOOP if l["robot_a"] == l["robot_b"] else fg.INTER_LOOP
                for l in self.loops
            ],
            jnp.int32,
        )
        meas = se3.inverse(se3.stack([l["rel"] for l in self.loops]))
        g, _ = fg.add_edges_batch(
            self.graph, ei, ej, meas, kinds,
            jnp.full((len(self.loops),), self.cfg.loops.w_rot, jnp.float32),
            jnp.full((len(self.loops),), self.cfg.loops.w_trans, jnp.float32),
        )
        return g

    def optimize(self) -> None:
        self._opt_n_nodes = int(self.graph.n_nodes)
        g = self._graph_with_loops()
        anchors = np.zeros(g.node_capacity, bool)
        for r in self.robots:
            if (r, 0) in self.node_of:
                anchors[self.node_of[(r, 0)]] = True
        self.opt_poses = chordal.optimize(
            g, jnp.asarray(anchors),
            chordal.PGOConfig(
                rot_cg_iters=self.cfg.pgo.rot_cg_iters,
                gn_iters=self.cfg.pgo.gn_iters,
                pose_cg_iters=self.cfg.pgo.pose_cg_iters,
                robust_delta=self.cfg.pgo.robust_delta,
            ),
        )

    # -- results --------------------------------------------------------
    def result(self) -> pl.SlamResult:
        if self._pending_kf:
            self.run_loop_stage()  # flush tail keyframes (the revisits!)
        robots = []
        ids = sorted(self.robots)
        counts = {
            r: int(self.mstore.stores.count[self.rows[r]]) for r in ids
        }
        max_k = max(counts.values(), default=0)
        node_of = -np.ones((len(ids), max(max_k, 1)), np.int64)
        for ri, r in enumerate(ids):
            rs = self.robots[r]
            store, _ = self.store_view(r)
            cur_pose = (
                rs["odo"].pose() if rs["frontend"] == "lio" else rs["odo"].pose
            )
            robots.append(
                pl.RobotResult(
                    odom_poses=cur_pose, store=store,
                    kf_frame_idx=np.arange(counts[r]),
                )
            )
            for k in range(counts[r]):
                node_of[ri, k] = self.node_of.get((r, k), -1)
        # re-solve if the graph grew since the last optimize: a stale
        # opt_poses would read ZEROS for nodes added after that solve
        if (self.opt_poses is None
                or self._opt_n_nodes != int(self.graph.n_nodes)):
            self.optimize()
        return pl.SlamResult(
            robots=robots, graph=self._graph_with_loops(),
            opt_poses=self.opt_poses,
            node_of=node_of, loops=self.loops,
        )
