#!/usr/bin/env python
"""Headline benchmark on the GPU: VGICP registrations/s per card, plus
the evidence suite: front-end frames/s + pipeline ATE, the
long-horizon 3-robot run, the 3-seed x 3-regime pose-graph stress grid
vs an independent scipy solver, the evaluate.py-protocol
place-recognition table, loop batching and the real-format chain.
Refuses to run without a GPU; every result names the card.

The BASELINE.json north star asks for >= 5x the reference's CPU/CUDA
registration throughput per chip. The workload mirrors the back-end's
loop-verification registration (`ICPCheck` with FAST_VGICP_CUDA:
resolution 0.5, ~50 iterations, few-thousand-point submaps,
`global_manager.cpp:2416-2462`): a batch of independent (source, target)
pairs registered by vmapped VGICP on one chip, perturbed at the
seed-realistic initial errors production verification starts from, with
CONVERGENCE reported alongside throughput.

Baseline: fast_gicp's own multithreaded benchmark (README of the
upstream project) reports ~30 ms/align for VGICP on a desktop CPU
(~32 registrations/s) at comparable cloud sizes; FAST_VGICP_CUDA is
~3x that. We take 100 reg/s as the CUDA reference point, so
vs_baseline = ours / 100 (assumed, not measured; the derivation is
stated here so the ratio is auditable).

Output protocol: the bench maintains ONE result JSON object and prints
it as one line after EVERY completed stage (and mirrors it to
`BENCH_partial.json`); the LAST line printed is always the most
complete result, so a timeout at any point still leaves every
already-measured number on stdout. The whole suite runs under a
wall-clock self-budget (`BENCH_BUDGET_S`, default 1800 s): cheap
headline stages run first, then heavy extras (longrun at adaptive
FRAMES, pr_recall at adaptive size, multiprocess, virtual-device
scaling) in priority order while budget remains; whatever does not fit
is recorded in `extra.budget.skipped` — no silent truncation. A full
un-budgeted local run is `BENCH_BUDGET_S=86400 python bench.py`
(timed full-suite runs are documented in README "Measured numbers").

Env knobs: BENCH_BUDGET_S (default 1800), LONGRUN_FRAMES (default
120; 0 skips). The stages' `est_s` values reserve budget; they are not
card measurements.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

# budget clock starts at PROCESS start, before jax import and device
# init, so the self-budget bounds the whole process's wall time
_T_PROC0 = time.monotonic()

import jax
import jax.numpy as jnp

BATCH = 64
POINTS = 4096
ITERS = 50
BASELINE_REG_PER_S = 100.0


def bench_frontend_and_ate() -> dict:
    """End-to-end slice on the largest synthetic world at realistic
    scan sizes (32x1024 rays): front-end frames/s (steady-state, fused
    lax.scan) + full-pipeline ATE RMSE vs ground truth."""
    import numpy as np

    from mr_slam_tpu.datasets import synthetic
    from mr_slam_tpu.eval import metrics
    from mr_slam_tpu.geometry import se3
    from mr_slam_tpu.runtime import pipeline as pl
    from mr_slam_tpu.runtime.config import SlamConfig, LoopCfg, OdometryCfg

    # descriptor gate calibrated for this scene (32x1024 rays: genuine
    # revisits score 0.65-0.70, false matches 0.80+); verification's
    # fitness gate does the geometric rejection
    cfg = SlamConfig(
        odometry=OdometryCfg(scan_capacity=8192, insert_capacity=16384),
        loops=LoopCfg(dist_thresh=0.75, min_separation=8, fitness_thresh=0.15),
    )
    world = synthetic.default_world(7, extent=60.0, n_boxes=36)
    T = 40
    traj = synthetic.circle_trajectory(T, radius=22.0, laps=1.1)
    keys = jax.random.split(jax.random.PRNGKey(0), T)
    scans = synthetic.scan_batch(
        world, traj, keys, n_rings=32, n_azimuth=1024
    )
    origin = se3.index(traj, 0)

    # frames/s: fused front-end (odometry + keyframe gating), compiled
    out = pl._frontend_fused(scans, cfg, origin)
    jax.block_until_ready(out)
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        out = pl._frontend_fused(scans, cfg, origin)
    jax.block_until_ready(out)
    fps = T * reps / (time.perf_counter() - t0)

    # ATE of the full pipeline (loops + PGO) on the same sequence; the
    # engine's tracer/metrics capture the per-stage breakdown
    # (§5.1/§5.5 — the reference logs each stage, we report them here).
    # First run warms every compile cache; the breakdown is captured on
    # the SECOND run so stage_ms is steady-state, not compilation.
    from mr_slam_tpu.runtime import observability as obs

    t0 = time.perf_counter()
    pl.run([scans], cfg, origins=[origin])
    cold_s = time.perf_counter() - t0
    obs.tracer.stats.clear()
    obs.metrics.counters.clear()
    t0 = time.perf_counter()
    res = pl.run([scans], cfg, origins=[origin])
    warm_s = time.perf_counter() - t0
    kf_idx = res.robots[0].kf_frame_idx
    true_kf = se3.index(traj, jnp.asarray(kf_idx))
    ate = metrics.ate(res.optimized_trajectory(0), true_kf)
    stage_ms = {
        k: round(v.total_s * 1e3, 1) for k, v in sorted(obs.tracer.stats.items())
    }
    return {
        "frontend_fps": round(float(fps), 2),
        "ate_rmse_m": round(float(ate.rmse), 4),
        # compile-inclusive vs steady-state pipeline wall time (the
        # second run is what stage_ms decomposes)
        "pipeline_cold_s": round(cold_s, 2),
        "pipeline_warm_s": round(warm_s, 2),
        "ate_frames": int(T),
        "ate_loops": len(res.loops),
        "stage_ms": stage_ms,
        "counters": {k: int(v) for k, v in sorted(obs.metrics.counters.items())},
    }


def bench_frontend_stages() -> dict:
    """Sub-stage breakdown of the front-end at its operating point
    (32x1024 scans, steady-state map) — VERDICT-r4 item 8: the tracer
    gives whole-frontend wall time only, so this segmented mode times
    the scan pipeline's pieces as separately-jitted ops on a warmed
    odometry state: downsample / coarse rescue register / fine register
    (associate+GN) / associate-only probe / insert / decay. The next
    front-end optimization round targets the biggest entry."""
    import numpy as np

    from mr_slam_tpu.datasets import synthetic
    from mr_slam_tpu.frontend import odometry
    from mr_slam_tpu.geometry import se3
    from mr_slam_tpu.ops import pointcloud as pcl, registration, voxel_grid
    from mr_slam_tpu.runtime import pipeline as pl
    from mr_slam_tpu.runtime.config import OdometryCfg, SlamConfig

    cfg = SlamConfig(
        odometry=OdometryCfg(scan_capacity=8192, insert_capacity=16384),
    )
    config = pl._odometry_config(cfg)
    world = synthetic.default_world(7, extent=60.0, n_boxes=36)
    T = 6
    traj = synthetic.circle_trajectory(T, radius=22.0, laps=0.15)
    keys = jax.random.split(jax.random.PRNGKey(0), T)
    scans = synthetic.scan_batch(world, traj, keys, n_rings=32,
                                 n_azimuth=1024)
    # steady-state map: run the real step over the warmup frames
    state = odometry.init(config, se3.index(traj, 0))
    step = jax.jit(lambda s, sc: odometry.step(s, sc, config)[0])
    for t in range(T):
        state = step(state, jax.tree.map(lambda a: a[t], scans))
    jax.block_until_ready(state.pose)
    scan = jax.tree.map(lambda a: a[T - 1], scans)
    pred = state.pose

    ds = pcl.voxel_downsample(scan, config.scan_leaf, config.scan_capacity,
                              bounds=((-150.0,) * 3, (150.0,) * 3))
    ds_coarse = pcl.voxel_downsample(
        ds, 2.0 * config.scan_leaf, max(config.scan_capacity // 4, 256))
    fine = pcl.voxel_downsample(scan, config.insert_leaf,
                                config.insert_capacity,
                                bounds=((-150.0,) * 3, (150.0,) * 3))
    world_pts = pcl.transform(fine, pred)

    ops = {
        "downsample": lambda: pcl.voxel_downsample(
            scan, config.scan_leaf, config.scan_capacity,
            bounds=((-150.0,) * 3, (150.0,) * 3)).xyz,
        "coarse_register": lambda: registration.point_to_plane_icp(
            ds_coarse, state.coarse_grid, pred, iters=4,
            max_corr_dist=8.0 * config.map_leaf, neighbors="direct27",
            inner=1).pose.t,
        "fine_register": lambda: registration.point_to_plane_icp(
            ds, state.grid, pred, iters=config.iters,
            max_corr_dist=config.max_corr_dist, neighbors="direct7",
            inner=2).pose.t,
        # the fine register's association half alone (direct7 row
        # gathers, one per outer round) — GN-on-cached-rows is the rest
        "associate_probe": lambda: voxel_grid.lookup_rows(
            state.grid, ds.xyz, "direct7")[0],
        "insert": lambda: voxel_grid.insert(state.grid, world_pts).packed,
        "decay": lambda: voxel_grid.decay(
            state.grid, pred.t, config.map_radius).packed,
        "full_step": lambda: step(state, scan).pose.t,
    }
    out = {}
    for name, fn in ops.items():
        o = fn()
        jax.block_until_ready(o)
        reps = 6
        t0 = time.perf_counter()
        for _ in range(reps):
            o = fn()
        jax.block_until_ready(o)
        out[name + "_ms"] = round(
            (time.perf_counter() - t0) / reps * 1e3, 2)
    out["implied_fps"] = round(1e3 / out["full_step_ms"], 1)
    out["note"] = ("per-op dispatch overhead included; the fused "
                   "lax.scan front-end amortizes it, so the sum exceeds "
                   "the fused per-frame time")
    return out


def bench_loop_batching(K: int = 256) -> dict:
    """Loop retrieval at K keyframes: the round-2 per-query host loop
    (one `_descriptor_distances` dispatch + host transfer per keyframe)
    vs the production batched `loopstage.retrieve` (ONE dispatch + ONE
    (Q, C) transfer per robot pair). The wall-clock ratio is the
    VERDICT-r2 Missing #2 'before/after at K=256'."""
    import numpy as np

    from mr_slam_tpu.frontend import keyframes as kf
    from mr_slam_tpu.runtime import loopstage
    from mr_slam_tpu.runtime import pipeline as pl
    from mr_slam_tpu.runtime.config import KeyframeCfg, LoopCfg, SlamConfig

    cfg = SlamConfig(
        keyframes=KeyframeCfg(capacity=K, points_per_kf=512),
        loops=LoopCfg(method="scancontext", candidates=2, min_separation=10),
    )
    rng = np.random.default_rng(0)
    store = kf.init(K, 512)
    xyz = jnp.asarray(rng.uniform(-40, 40, (K, 512, 3)), jnp.float32)
    store = store._replace(
        xyz=xyz, mask=jnp.ones((K, 512), bool), count=jnp.int32(K),
        poses=store.poses._replace(
            t=jnp.asarray(rng.uniform(-50, 50, (K, 3)), jnp.float32)
        ),
    )
    descs = pl.compute_descriptors(store, cfg)
    qi = jnp.arange(K, dtype=jnp.int32)

    def per_query():
        out = []
        for ia in range(K):
            d, yaw = pl._descriptor_distances(descs, ia, descs, cfg)
            out.append((np.array(d), np.asarray(yaw)))
        return out

    def batched():
        r = loopstage.retrieve(
            descs, qi, store.poses.t, descs, store.poses.t, store.count,
            cfg, True,
        )
        return [np.asarray(x) for x in r]

    per_query()  # warm both compile caches
    batched()
    out = {}
    # the per-query baseline is K dispatches of a compiled program:
    # one rep suffices
    for name, fn, reps_n in (
        ("per_query_ms", per_query, 1), ("batched_ms", batched, 3),
    ):
        t0 = time.perf_counter()
        for _ in range(reps_n):
            fn()
        out[name] = round((time.perf_counter() - t0) / reps_n * 1e3, 1)
    out["speedup"] = round(out["per_query_ms"] / max(out["batched_ms"], 1e-9), 1)
    out["K"] = K
    out["dispatches_per_pair"] = {"per_query": K, "batched": 1}
    return out


def _pcm_gate_graph(g, threshold: float = 5.348,
                    odo_drift_t: float = 0.05, odo_drift_r: float = 0.005,
                    step_len: float = 2.2):
    """The production pre-solve outlier gates at graph level:
    (a) intra-robot loops against the odometry cycle
        (`pcm.intra_cycle_distances` — the reference's odometry-space
        sanity checks, `global_manager.cpp:1029-1094`);
    (b) inter-robot loops through per-pair PCM (`distributed_pcm.cpp:
        37-66`), both under the drift-aware cycle covariance.
    Rejected edges get zero weight. Returns (gated graph, n_rejected).
    `odo_drift_*` must be calibrated to the platform's odometry (the
    per-deployment tuning the reference does through pcm_thresh)."""
    import numpy as np

    from mr_slam_tpu.backend import factor_graph as fg, pcm
    from mr_slam_tpu.geometry import se3 as _se3
    from mr_slam_tpu.geometry.se3 import Pose

    E = int(g.n_edges)
    kind = np.asarray(g.edge_kind[:E])
    ei = np.asarray(g.edge_i[:E])
    ej = np.asarray(g.edge_j[:E])
    robot = np.asarray(g.node_robot)
    w_rot = np.asarray(g.edge_w_rot).copy()
    w_trans = np.asarray(g.edge_w_trans).copy()
    rejected = 0
    # ---- intra-robot loops: single-loop odometry-cycle gate ----------
    intra = np.flatnonzero(kind == fg.INTRA_LOOP)
    if intra.size:
        ia = jnp.asarray(ei[intra])
        ib = jnp.asarray(ej[intra])
        from mr_slam_tpu.geometry.se3 import Pose as _Pose

        d2 = np.asarray(pcm.intra_cycle_distances(
            _se3.index(g.poses, ia), _se3.index(g.poses, ib),
            _se3.index(g.edge_meas, jnp.asarray(intra)),
            ia, ib, odo_drift_t=odo_drift_t, odo_drift_r=odo_drift_r,
            step_len=step_len,
        ))
        bad = intra[d2 > threshold]
        w_rot[bad] = 0.0
        w_trans[bad] = 0.0
        rejected += int(bad.size)
    inter = np.flatnonzero(kind == fg.INTER_LOOP)
    if inter.size <= 1:
        return g._replace(
            edge_w_rot=jnp.asarray(w_rot), edge_w_trans=jnp.asarray(w_trans)
        ), rejected
    pairs = {}
    for e in inter:
        key = tuple(sorted((int(robot[ei[e]]), int(robot[ej[e]]))))
        pairs.setdefault(key, []).append(int(e))
    for key, es in pairs.items():
        if len(es) <= 1:
            continue
        es = np.asarray(es)
        # canonical orientation: endpoint of robot key[0] first
        flip = robot[ei[es]] != key[0]
        ii = np.where(flip, ej[es], ei[es])
        jj = np.where(flip, ei[es], ej[es])
        meas = _se3.index(g.edge_meas, jnp.asarray(es))
        meas_c = Pose(
            jnp.where(jnp.asarray(flip)[:, None, None],
                      jnp.swapaxes(meas.R, -1, -2), meas.R),
            jnp.where(jnp.asarray(flip)[:, None],
                      -jnp.einsum("nba,nb->na", meas.R, meas.t), meas.t),
        )
        keep = pcm.filter_loops(
            _se3.index(g.poses, jnp.asarray(ii)),
            _se3.index(g.poses, jnp.asarray(jj)),
            meas_c, np.ones(len(es), bool), threshold=threshold,
            # node ids are chain positions (contiguous per robot), so
            # index gaps = odometry steps inside the cycle
            idx_a=ii, idx_b=jj,
            odo_drift_t=odo_drift_t, odo_drift_r=odo_drift_r,
            step_len=step_len,
        )
        drop = es[~keep]
        w_rot[drop] = 0.0
        w_trans[drop] = 0.0
        rejected += int((~keep).sum())
    return g._replace(
        edge_w_rot=jnp.asarray(w_rot), edge_w_trans=jnp.asarray(w_trans)
    ), rejected


def bench_ate_vs_reference(n_seeds: int = 3) -> dict:
    """The accuracy north star (BASELINE.md: ATE <= 1.1x the reference
    GTSAM-based optimizer), stressed where optimizers actually diverge:
    a GRID of 3 seeds x {clean, 10% outlier loops, 3x drift} 510-node
    3-robot graphs. Ours runs the production robust path (per-pair PCM
    gate + Cauchy IRLS); the INDEPENDENT scipy TRF SE(3) solver
    (`eval/reference_solver.py`, gtsam's stand-in) runs with its own
    robust loss (soft_l1) on outlier regimes. Reports per-regime and
    worst-case ratios."""
    import numpy as np

    from mr_slam_tpu.backend import chordal
    from mr_slam_tpu.eval import graphgen, reference_solver

    regimes = {
        "clean": {},
        "outliers10": {"outlier_frac": 0.10},
        "drift3x": {"drift_t": 0.15, "drift_r": 0.012},
    }
    # reference-parity optimization budget (~gtsam's 200 GN iterations,
    # `evaluation_utils.cpp:321`)
    full = chordal.PGOConfig(rot_cg_iters=120, gn_iters=30, pose_cg_iters=120)
    seeds = tuple(range(n_seeds))
    out = {"graph": f"multi_robot_graph(3x170, stride12) x seeds{seeds}"}
    worst = 0.0
    for name, kw in regimes.items():
        ratios, a_ours_l, a_ref_l, ours_s, ref_s = [], [], [], 0.0, 0.0
        rejected = 0
        for seed in seeds:
            g, true, anchors, _ = graphgen.multi_robot_graph(
                n_robots=3, nodes_per_robot=170, loop_stride=12, seed=seed,
                **kw,
            )
            N = int(g.n_nodes)

            def ate(t):
                return float(jnp.sqrt(jnp.mean(
                    jnp.sum((t[:N] - true.t) ** 2, -1)
                )))

            t0 = time.perf_counter()
            drift_t = kw.get("drift_t", 0.05)
            drift_r = kw.get("drift_r", 0.004)
            gated, rej = _pcm_gate_graph(
                g, odo_drift_t=drift_t, odo_drift_r=drift_r
            )
            ours_t = chordal.optimize(gated, anchors, full).t
            ours_t.block_until_ready()
            ours_s += time.perf_counter() - t0
            rejected += rej
            t0 = time.perf_counter()
            ref = reference_solver.solve(
                g, anchors,
                loss="soft_l1" if name == "outliers10" else "linear",
            )
            ref_s += time.perf_counter() - t0
            a_o, a_r = ate(ours_t), ate(ref.t)
            a_ours_l.append(a_o)
            a_ref_l.append(a_r)
            ratios.append(a_o / max(a_r, 1e-9))
        worst = max(worst, max(ratios))
        out[name] = {
            "ate_ours_m": [round(a, 4) for a in a_ours_l],
            "ate_reference_m": [round(a, 4) for a in a_ref_l],
            "ratios": [round(r, 3) for r in ratios],
            "pcm_rejected": rejected,
            "ours_s": round(ours_s, 2),
            "reference_s": round(ref_s, 2),
        }
    out["worst_ratio"] = round(worst, 3)
    return out


def bench_pr_recall(n_per_run: int = 170, train_epochs: int = 4,
                    deadline: float | None = None) -> dict:
    """evaluate.py-protocol place-recognition table: 3 runs x
    `n_per_run` keyframes (>= 500 total) through the shared courtyard;
    runs 0+1 are the DATABASE, run 2 the QUERY set (cross-run retrieval
    with pose-distance ground truth — `generating_queries/*.py` +
    `evaluate.py:59-198`). recall@{1,5,25} + top-1% for all six
    descriptor families plus the quadruplet-TRAINED DiSCO (trained on
    database keyframes only)."""
    import numpy as np

    from mr_slam_tpu.datasets import synthetic
    from mr_slam_tpu.eval import metrics, recall_harness
    from mr_slam_tpu.geometry import se3
    from mr_slam_tpu.loop import bev as bev_mod
    from mr_slam_tpu.ops import pointcloud as pcl

    world = synthetic.default_world(7, extent=60.0, n_boxes=36)
    runs = []
    for r in range(3):
        traj = synthetic.circle_trajectory(
            n_per_run, radius=22.0 + 2.0 * r, laps=1.9,
            phase=2.1 * r, ccw=(r % 2 == 0),
        )
        keys = jax.random.split(jax.random.PRNGKey(100 + r), n_per_run)
        clouds = synthetic.scan_batch(
            world, traj, keys, n_rings=16, n_azimuth=512, noise=0.02
        )
        runs.append((clouds, traj.t))
    db_clouds = jax.tree.map(
        lambda a, b: jnp.concatenate([a, b]), runs[0][0], runs[1][0]
    )
    db_pos = jnp.concatenate([runs[0][1], runs[1][1]])
    q_clouds, q_pos = runs[2]

    table = {}
    skipped_methods = []
    ran_any = False
    for m in recall_harness.METHODS:
        # PROJECTED-cost gate: a method that would still be compiling
        # at the deadline must not start (the first method also pays
        # the shared descriptor compiles)
        est_m = 120.0 if ran_any else 300.0
        if deadline is not None and time.monotonic() + est_m > deadline:
            skipped_methods.append(m)
            continue
        ran_any = True
        try:
            res = recall_harness.evaluate_cross(
                m, q_clouds, q_pos, db_clouds, db_pos, radius=5.0, max_n=25
            )
            r = np.asarray(res.recall_at_n)
            table[m] = {
                "r@1": round(float(r[0]), 3),
                "r@5": round(float(r[4]), 3),
                "r@25": round(float(r[24]), 3),
                "top1pct": round(float(res.top1_percent), 3),
            }
        except Exception as e:
            table[m] = {"error": repr(e)[:120]}

    # trained DiSCO: quadruplet training on DATABASE keyframes only;
    # the network needs flax, which not every installation has
    try:
        from mr_slam_tpu.loop import disco_net
    except ImportError as e:
        disco_net = None
        table["disco_trained"] = {"not_run": f"flax unavailable: {e}"}
    if (disco_net is not None and deadline is not None
            and time.monotonic() + 450.0 > deadline):
        skipped_methods.append("disco_trained")
    elif disco_net is not None:
      try:
          bevs_db = jax.lax.map(
              lambda c: bev_mod.polar_occupancy(c, 40, 120, z_bins=8), db_clouds
          )
          bevs_q = jax.lax.map(
              lambda c: bev_mod.polar_occupancy(c, 40, 120, z_bins=8), q_clouds
          )
          D = db_pos.shape[0]
          d_xy = np.linalg.norm(
              np.asarray(db_pos)[:, None, :2] - np.asarray(db_pos)[None, :, :2],
              axis=-1,
          )
          pos_mask = d_xy < 5.0
          np.fill_diagonal(pos_mask, False)
          far_mask = d_xy > 15.0
          model = disco_net.DiscoNet(base=4)
          state, tx = disco_net.create_train_state(
              jax.random.PRNGKey(1), model, bevs_db[0], lr=3e-4
          )
          rng = np.random.default_rng(0)
          anchors = [i for i in range(D)
                     if pos_mask[i].any() and far_mask[i].any()]
          for _ in range(train_epochs):
              for a in rng.permutation(anchors)[:128]:
                  p = int(rng.choice(np.flatnonzero(pos_mask[a])))
                  negs = rng.choice(
                      np.flatnonzero(far_mask[a]), size=4, replace=False
                  )
                  on_pool = np.flatnonzero(far_mask[a] & ~pos_mask[a])
                  on = int(rng.choice(on_pool))
                  state, _ = disco_net.train_step(
                      state, model, tx, bevs_db[a], bevs_db[p],
                      bevs_db[jnp.asarray(negs)], bevs_db[on],
                  )
          sig_db = jax.lax.map(lambda b: model.apply(state.params, b), bevs_db)
          sig_q = jax.lax.map(lambda b: model.apply(state.params, b), bevs_q)
          dists = jnp.linalg.norm(sig_q[:, None] - sig_db[None], axis=-1)
          pos = metrics.make_positives(q_pos, db_pos, radius=5.0)
          res = metrics.recall_at_n(dists, pos, pos.any(1), max_n=25)
          r = np.asarray(res.recall_at_n)
          table["disco_trained"] = {
              "r@1": round(float(r[0]), 3),
              "r@5": round(float(r[4]), 3),
              "r@25": round(float(r[24]), 3),
              "top1pct": round(float(res.top1_percent), 3),
          }
      except Exception as e:
          table["disco_trained"] = {"error": repr(e)[:120]}
    table["_protocol"] = {
        "database_kf": int(db_pos.shape[0]),
        "query_kf": int(q_pos.shape[0]),
        "radius_m": 5.0,
        # every bound the harness imposes on its own coverage, so the
        # evidence tool documents exactly what it measured (VERDICT-r4
        # Weak #6): the RING++ quadratic-KNN point cap and any
        # budget-driven shrink of the run size / training epochs vs the
        # full protocol (170/run, 4 epochs, >= 500 total keyframes).
        "caps": {
            "ringpp_knn_points": 2048,
            "n_per_run": n_per_run,
            "train_epochs": train_epochs,
            "reduced_from_full": bool(n_per_run < 170 or train_epochs < 4),
            "deadline_skipped_methods": skipped_methods,
        },
    }
    return table


def bench_realformat(frames: int = 100, n_rings: int = 64,
                     n_azimuth: int = 1024) -> dict:
    """Real-format end-to-end evidence at production scan size
    (VERDICT-r4 item 4): generate the deterministic NCLT-byte-format
    2-session artifact (`datasets/sequence_artifact.py`), then drive
    bytes -> loaders -> native scanlog -> replay -> OnlineSlam and
    report the full-path optimized-keyframe ATE. `frames` is PER
    SESSION (2 sessions run)."""
    import shutil
    import tempfile

    from mr_slam_tpu.datasets import sequence_artifact as sa

    root = tempfile.mkdtemp(prefix="mrslam_seq_")
    try:
        t0 = time.perf_counter()
        # laps scale with frames: a budget-reduced run keeps the
        # ~1.8 m per-frame arc instead of blowing the odometry basin
        man = sa.generate(root, frames=frames, robots=2,
                          n_rings=n_rings, n_azimuth=n_azimuth,
                          laps=1.25 * frames / 100.0)
        gen_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = sa.run_session(root)
        out.update(
            generate_s=round(gen_s, 1),
            session_s=round(time.perf_counter() - t0, 1),
            scan_shape=[n_rings, n_azimuth],
            digest=man["digest"][:16],
        )
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def device_record() -> dict:
    """The device this run measures: JAX's view plus the card's name and
    power limit from nvidia-smi. Exits non-zero without a GPU."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"bench.py: JAX found no GPU (platform "
                 f"{devs[0].platform!r}); nothing to measure")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "nvidia_smi": card}


def main() -> None:
    device = device_record()
    from mr_slam_tpu import compile_cache
    from mr_slam_tpu.geometry import se3, so3
    from mr_slam_tpu.ops import pointcloud as pcl, registration, voxel_grid

    cache_dir = compile_cache.configure()

    # ---- wall-clock self-budget (VERDICT-r4 Missing #1) ---------------
    budget_s = float(os.environ.get("BENCH_BUDGET_S", "1800"))
    t_bench0 = _T_PROC0

    def remaining() -> float:
        return budget_s - (time.monotonic() - t_bench0)

    key = jax.random.PRNGKey(0)
    ks = jax.random.split(key, BATCH + 2)

    # structured targets: ground + walls + clutter, per pair
    def make_cloud(k):
        k1, k2, k3 = jax.random.split(k, 3)
        n3 = POINTS // 4
        ground = jnp.concatenate(
            [jax.random.uniform(k1, (POINTS - 2 * n3, 2), minval=-25, maxval=25),
             jnp.zeros((POINTS - 2 * n3, 1))], axis=-1)
        wall1 = jnp.concatenate(
            [jax.random.uniform(k2, (n3, 1), minval=-25, maxval=25),
             jnp.full((n3, 1), 12.0),
             jax.random.uniform(k2, (n3, 1), minval=0, maxval=5)], axis=-1)
        wall2 = jnp.concatenate(
            [jnp.full((n3, 1), -10.0),
             jax.random.uniform(k3, (n3, 1), minval=-25, maxval=25),
             jax.random.uniform(k3, (n3, 1), minval=0, maxval=5)], axis=-1)
        xyz = jnp.concatenate([ground, wall1, wall2], axis=0)
        return xyz + 0.01 * jax.random.normal(k1, xyz.shape)

    MAXB = max(BATCH, 128)
    ks = jax.random.split(key, MAXB + 2)
    targets_xyz = jax.vmap(make_cloud)(ks[:MAXB])
    targets = pcl.PointCloud(targets_xyz, jnp.ones((MAXB, POINTS), bool))
    # perturbed sources at SEED-REALISTIC initial errors: loop
    # verification starts from RING/SC SE(2) seeds good to ~0.3 m /
    # ~2-3 deg (`runtime/loopstage.py` dual-yaw seeding); the r3 bench
    # drew 6-dof 0.1*normal (up to ~15 deg) — outside the direct1
    # convergence basin, so half the batch silently diverged while only
    # throughput was reported. Now the workload matches production and
    # convergence is REPORTED.
    xi = jnp.concatenate(
        [0.15 * jax.random.normal(ks[MAXB], (MAXB, 3)),
         0.03 * jax.random.normal(ks[MAXB + 1], (MAXB, 3))], axis=-1
    )
    true = se3.exp(xi)
    sources = jax.vmap(lambda c, p: pcl.transform(c, se3.inverse(p)))(targets, true)

    build = jax.jit(
        jax.vmap(
            lambda c: voxel_grid.build(
                c, 0.5, 1 << 14, min_points=3, regularize="plane"
            )
        )
    )
    # chunked builds bound the (B, H, ...) regularization temporaries
    # of the vmapped grid builds
    grids = jax.tree.map(
        lambda *x: jnp.concatenate(x),
        *[build(jax.tree.map(lambda a: a[i:i + 32], targets))
          for i in range(0, MAXB, 32)],
    )
    grids.mean.block_until_ready()

    # production annealed association schedule (see
    # registration._vgicp_direct1): 3 rounds at strides 4/2/1 — same
    # converged accuracy as the uniform 5 x inner=10 rounds at 2.4x the
    # throughput (gather volume 5N -> 1.75N rows, GN steps 50 -> 30)
    SCHEDULE = ((5, 4), (8, 2), (17, 1))
    run = jax.jit(
        jax.vmap(
            lambda s, g, i: registration.vgicp(
                s, g, i, iters=ITERS, max_corr_dist=1.0,
                schedule=SCHEDULE,
            ).pose.t
        )
    )

    def measure(b, reps=5):
        sub = jax.tree.map(lambda a: a[:b], sources)
        subg = jax.tree.map(lambda a: a[:b], grids)
        subi = se3.identity((b,))
        out = run(sub, subg, subi)
        out.block_until_ready()
        t0 = time.perf_counter()
        for _ in range(reps):
            out = run(sub, subg, subi)
        out.block_until_ready()
        dt = (time.perf_counter() - t0) / reps
        err = jnp.linalg.norm(out - true.t[:b], axis=-1)
        return b / dt, err

    reg_per_s, err = measure(BATCH)
    import numpy as np

    e = np.asarray(err)

    extra = {}
    extra["convergence"] = {
        "median_err_m": round(float(np.median(e)), 4),
        "p90_err_m": round(float(np.percentile(e, 90)), 4),
        "frac_within_10cm": round(float((e < 0.1).mean()), 3),
    }
    gather_rows = sum(POINTS // stride for _, stride in SCHEDULE)
    bytes_per_reg = gather_rows * (64 + 12)
    extra["roofline_vgicp"] = {
        "model": "sum_rounds (N/stride)*(64B row + 12B point), "
                 f"schedule={SCHEDULE}",
        "bytes_per_reg": bytes_per_reg,
        "achieved_gbps": round(bytes_per_reg * reg_per_s / 1e9, 2),
    }
    # batch sweep: registrations/s vs batch size
    sweep = {}
    for b in (1, 8, 16, 32, 64, 128):
        rps, _ = measure(b, reps=3)
        sweep[str(b)] = round(rps, 1)
    extra["batch_sweep_reg_per_s"] = sweep

    # ---- budget-aware stage runner ------------------------------------
    # The result object is COMPLETE from here on; every finished stage
    # re-prints it (last line = most complete) and mirrors it to
    # BENCH_partial.json, so neither a driver timeout nor a stage crash
    # can erase measured numbers.
    result = {
        "metric": "vgicp_registrations_per_s_per_chip",
        "value": round(reg_per_s, 2),
        "unit": (f"reg/s ({POINTS} pts, annealed 30-iter schedule "
                 f"{SCHEDULE}, batch {BATCH})"),
        "vs_baseline": round(reg_per_s / BASELINE_REG_PER_S, 3),
        "device": device,
        "compile_cache": cache_dir,
        "extra": extra,
    }
    skipped: list[dict] = []
    stage_wall: dict[str, float] = {}
    extra["budget"] = {"budget_s": budget_s}

    def emit() -> None:
        extra["budget"].update(
            spent_s=round(time.monotonic() - t_bench0, 1),
            skipped=skipped, stage_wall_s=stage_wall,
        )
        line = json.dumps(result)
        try:
            with open(os.path.join(
                os.path.dirname(os.path.abspath(__file__)),
                "BENCH_partial.json",
            ), "w") as f:
                f.write(line + "\n")
        except OSError:
            pass
        print(line, flush=True)

    def stage(name: str, est_s: float, fn) -> bool:
        """Run one extra if it fits the remaining budget (30 s reserve
        for the final emit); record skips explicitly."""
        if remaining() < est_s + 30.0:
            skipped.append({
                "stage": name, "est_s": est_s,
                "remaining_s": round(remaining(), 1),
            })
            return False
        t0 = time.monotonic()
        try:
            out = fn()
            if out is not None:
                extra[name] = out
        except Exception as e:
            extra[name + "_error"] = repr(e)[:200]
        stage_wall[name] = round(time.monotonic() - t0, 1)
        emit()
        return True

    emit()  # headline + sweep are safe from this point on

    def _frontend():
        extra.update(bench_frontend_and_ate())
    stage("frontend_ate", 240, _frontend)
    stage("frontend_stages", 120, bench_frontend_stages)
    stage("loop_batching", 150, bench_loop_batching)
    # 3 seeds when the budget allows, 2 under pressure (reported in
    # the output's `graph` string either way)
    stage("ate_vs_reference", 300,
          lambda: bench_ate_vs_reference(
              n_seeds=3 if remaining() > 1250 else 2))

    # ---- heavy extras, priority order --------------------------------
    # long-horizon production-scale run (BASELINE.md measurement
    # points / README Quick Demo scale); LONGRUN_FRAMES=0 skips
    frames = int(os.environ.get("LONGRUN_FRAMES", "120"))
    if frames > 0:
        def _longrun():
            sys.path.insert(
                0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "examples"),
            )
            import bench_longrun

            out = bench_longrun.run(frames, 3)
            out["frames"] = frames
            return out
        stage("longrun", 70 + 0.8 * frames, _longrun)
    else:
        skipped.append({"stage": "longrun", "reason": "LONGRUN_FRAMES=0"})

    # real-format sequence artifact end-to-end at production scan
    # size; per-session frames shrink under budget pressure
    rf_frames = 100 if remaining() > 650 else 48
    stage("realformat", 120 + 1.4 * rf_frames,
          lambda: bench_realformat(frames=rf_frames))
    # place-recognition table, deadline-aware per method (compile cost
    # dominates — measured 670 s even at n=64 — so the harness skips
    # whole methods past its deadline and reports them in
    # `_protocol.caps.deadline_skipped_methods`)
    if remaining() > 1100:
        n_pr, ep_pr = 170, 4
    elif remaining() > 700:
        n_pr, ep_pr = 100, 2
    else:
        n_pr, ep_pr = 64, 2
    stage("pr_recall", 330,
          lambda: bench_pr_recall(
              n_pr, ep_pr,
              deadline=time.monotonic() + max(120.0, remaining() - 75.0)))
    emit()


if __name__ == "__main__":
    main()
