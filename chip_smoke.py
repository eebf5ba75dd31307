#!/usr/bin/env python
"""Bring-up check: the multi-robot SLAM main path on the GPU.

    python chip_smoke.py               # one card: phases 0-3
    python chip_smoke.py --four-cards  # four cards: the cross-card path only

Phases, each printing one JSON line:

  0 device     — refuses to run without a GPU; names the card, the
                 versions, the compile-cache directory and whether the
                 native host library was built.
  1 online     — `OnlineSlam` with per-robot GEM, three robots with
                 32x1024 lidars fed frame by frame at 10 Hz stamps,
                 RING loops, deployment-size state; loops, finite poses
                 and per-robot keyframe ATE against ground truth.
  2 map        — `pipeline.build_elevation` at 600x600 cells: finite
                 layers, traversability in [0, 1].
  3 references — `elevation.features` against the float64 NumPy
                 reference, and the RING Radon on the card against the
                 same function on the host CPU backend, then under the
                 TF32 `precision.fast` policy with top-1 retrieval kept.

`--four-cards` runs the robot mesh front-end, edge-sharded PGO and the
halo-sharded terrain features on a 4-card mesh from this one process,
each against its single-card counterpart.

Any failed check raises, so the script exits non-zero. The last line
of standard output is the only result line:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

N_ROBOTS = 3
N_FRAMES = 120
RINGS, AZIMUTH = 32, 1024
RATE_HZ = 10.0
# ring road through the shared courtyard, ~0.64 m of arc per frame
# (the `examples/bench_longrun.py` operating point)
LAPS = 2.3 * N_FRAMES / 500.0
ELEVATION_SIZE = 600
ATE_LIMIT_M = 0.3
FOUR = 4
FOUR_FRAMES = 24        # per robot, on the 4-card front-end mesh
FOUR_MAP = 2048         # rows = cols of the halo-sharded terrain grid


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    jax.block_until_ready(out)
    return out, time.perf_counter() - t0


def timed_twice(fn):
    """(result, [first call s (compile included), second call s])."""
    _, cold = timed(fn)
    out, warm = timed(fn)
    return out, [cold, warm]


# ---------------------------------------------------------------- phase 0
def phase_device(count: int) -> tuple[str, int]:
    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"chip_smoke: JAX found no GPU (platform "
                 f"{devs[0].platform!r}); nothing to check")
    check(len(devs) >= count, f"need {count} GPUs, JAX sees {len(devs)}")
    import jaxlib

    from mr_slam_tpu import compile_cache, native

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    for line in card.splitlines():
        print(line, flush=True)
    emit("device", device_kind=devs[0].device_kind, count=len(devs),
         nvidia_smi=card.splitlines(), jax=jax.__version__,
         jaxlib=jaxlib.__version__, compile_cache=compile_cache.configure(),
         native_library_built=native.load() is not None)
    return devs[0].device_kind, len(devs)


# ---------------------------------------------------------------- phase 1
def slam_config():
    from mr_slam_tpu.runtime.config import (
        KeyframeCfg, LoopCfg, OdometryCfg, PGOCfg, SlamConfig,
    )

    return SlamConfig(
        n_robots=N_ROBOTS,
        odometry=OdometryCfg(scan_capacity=8192, insert_capacity=16384),
        keyframes=KeyframeCfg(capacity=256, points_per_kf=4096),
        loops=LoopCfg(method="ring"),
        # reference-parity optimization budget
        pgo=PGOCfg(rot_cg_iters=120, gn_iters=30, pose_cg_iters=120,
                   node_capacity=1024, edge_capacity=4096),
    )


def make_world(n_robots: int, n_frames: int):
    """Courtyard world, ring-road ground truth and raycast scans per
    robot (phase-offset starts, alternating direction)."""
    from mr_slam_tpu.datasets import synthetic
    from mr_slam_tpu.geometry import se3

    world = synthetic.default_world(7, extent=60.0, n_boxes=36)
    laps = LAPS * n_frames / N_FRAMES
    trajs, scans = [], []
    for r in range(n_robots):
        traj = synthetic.circle_trajectory(
            n_frames, radius=22.0, laps=laps, phase=2 * np.pi * r / n_robots,
            ccw=(r % 2 == 0),
        )
        keys = jax.random.split(jax.random.PRNGKey(r), n_frames)
        chunks = [
            synthetic.scan_batch(
                world, se3.index(traj, slice(i, i + 40)), keys[i:i + 40],
                n_rings=RINGS, n_azimuth=AZIMUTH, noise=0.03,
            )
            for i in range(0, n_frames, 40)
        ]
        trajs.append(traj)
        scans.append(jax.tree.map(lambda *x: jnp.concatenate(x), *chunks))
    return trajs, scans


def run_session(cfg, trajs, scans):
    from mr_slam_tpu.geometry import se3
    from mr_slam_tpu.runtime.online import OnlineSlam

    sess = OnlineSlam(cfg, enable_gem=True)
    for r, traj in enumerate(trajs):
        sess.register_robot(r, se3.index(traj, 0))
    n_frames = scans[0].xyz.shape[0]
    for i in range(n_frames):
        for r in range(len(trajs)):
            sess.add_frame(r, jax.tree.map(lambda a: a[i], scans[r]),
                           stamp=i / RATE_HZ)
    res = sess.result()
    jax.block_until_ready(res.opt_poses)
    return sess, res


def keyframe_ates(sess, res, trajs) -> list[float]:
    from mr_slam_tpu.eval import metrics
    from mr_slam_tpu.geometry import se3

    ates = []
    for r, traj in enumerate(trajs):
        store, _ = sess.store_view(r)
        K = int(store.count)
        frames = np.rint(np.asarray(store.stamps[:K]) * RATE_HZ).astype(int)
        est = res.optimized_trajectory(r)
        check(est.t.shape[0] == K, f"robot {r}: {est.t.shape[0]} optimized "
              f"poses for {K} keyframes")
        true_kf = se3.index(traj, jnp.asarray(frames))
        ates.append(float(metrics.ate(est, true_kf).rmse))
    return ates


def phase_online(cfg):
    from mr_slam_tpu.runtime import observability as obs

    (trajs, scans), gen_s = timed(lambda: make_world(N_ROBOTS, N_FRAMES))
    (sess, res), cold_s = timed(lambda: run_session(cfg, trajs, scans))
    obs.tracer.stats.clear()
    obs.metrics.counters.clear()
    (sess, res), warm_s = timed(lambda: run_session(cfg, trajs, scans))

    inter = sum(1 for l in res.loops if l["robot_a"] != l["robot_b"])
    ates = keyframe_ates(sess, res, trajs)
    emit("online", robots=N_ROBOTS, frames_per_robot=N_FRAMES,
         scan=[RINGS, AZIMUTH], loop_method=cfg.loops.method,
         raycast_s=gen_s, cold_wall_s=cold_s, warm_wall_s=warm_s,
         keyframes=[int(sess.store_view(r)[0].count) for r in range(N_ROBOTS)],
         loops=len(res.loops), inter_robot_loops=inter,
         ate_rmse_m=ates,
         tracer_warm={k: {"count": v.count, "total_s": v.total_s,
                          "max_s": v.max_s}
                      for k, v in sorted(obs.tracer.stats.items())},
         counters={k: v for k, v in sorted(obs.metrics.counters.items())})
    check(inter >= 1, "no verified inter-robot loop")
    check(bool(np.isfinite(np.asarray(res.opt_poses.t)).all())
          and bool(np.isfinite(np.asarray(res.opt_poses.R)).all()),
          "non-finite optimized poses")
    check(max(ates) <= ATE_LIMIT_M,
          f"keyframe ATE {ates} above {ATE_LIMIT_M} m")
    return sess, res


# ---------------------------------------------------------------- phase 2
def phase_map(cfg, res):
    from mr_slam_tpu.runtime import pipeline

    (emap, feats, cm), map_s = timed(
        lambda: pipeline.build_elevation(res, cfg, size=ELEVATION_SIZE))
    layers = {"height": emap.height, **feats._asdict()}
    finite = {k: bool(np.isfinite(np.asarray(v)).all())
              for k, v in layers.items()}
    trav = np.asarray(feats.traversability)
    cost = np.asarray(cm.cost)
    n_valid = int(np.asarray(emap.valid).sum())
    emit("map", size=ELEVATION_SIZE, build_s=map_s, valid_cells=n_valid,
         finite=finite, traversability_range=[float(trav.min()),
                                              float(trav.max())],
         lethal_cells=int((cost == 100).sum()),
         free_cells=int((cost == 0).sum()))
    check(all(finite.values()), f"non-finite map layers: {finite}")
    check(trav.min() >= 0.0 and trav.max() <= 1.0,
          "traversability outside [0, 1]")
    check(n_valid > 0, "empty elevation map")
    check(set(np.unique(cost)) <= {-1, 0, 100}, "unexpected cost values")
    return emap


# ---------------------------------------------------------------- phase 3
# float32 sums of window-relative moments against float64: slope (rad),
# roughness and step (m) agree to well under 1e-4 on every cell; the
# support count decides the masks, so they must match exactly
FEATURE_ATOL = 1e-4
# the same float32 gather-and-sum program on two backends differs only
# in summation order: relative 1e-4 of the sinogram's peak
RADON_RTOL = 1e-4


def keyframe_bevs(sess, cfg):
    from mr_slam_tpu.loop import bev
    from mr_slam_tpu.ops import pointcloud as pcl

    def one(xyz, mask):
        norm = bev.normalize_cloud(pcl.PointCloud(xyz, mask),
                                   z_min=cfg.loops.bev_z_min)
        return bev.cartesian_occupancy(norm)[0]

    out, owner = [], []
    for r in sorted(sess.robots):
        store, _ = sess.store_view(r)
        K = int(store.count)
        out.append(jax.vmap(one)(store.xyz[:K], store.mask[:K]))
        owner += [r] * K
    return jnp.concatenate(out), np.asarray(owner)


def top1(tiring, owner):
    """Best match of every keyframe among the other robots' keyframes."""
    from mr_slam_tpu.loop import ring

    dist = np.stack([np.asarray(ring.correlate(q, tiring)[0])
                     for q in tiring])
    dist[owner[:, None] == owner[None, :]] = np.inf
    return dist.argmin(1)


def phase_references(sess, cfg, emap):
    from mr_slam_tpu.eval import reference_terrain
    from mr_slam_tpu.loop import ring
    from mr_slam_tpu.mapping import elevation

    feats, feat_s = timed(lambda: elevation.features(emap))
    ref = reference_terrain.terrain_features(
        np.asarray(emap.height), np.asarray(emap.valid),
        float(emap.resolution))
    dev = {k: float(np.abs(np.asarray(getattr(feats, k))
                           - getattr(ref, k)).max())
           for k in ("slope", "roughness", "step", "traversability")}
    enough_equal = bool(np.array_equal(np.asarray(feats.support) >= 3,
                                       ref.enough))
    valid_equal = bool(np.array_equal(np.asarray(emap.valid), ref.valid))

    bevs, owner = keyframe_bevs(sess, cfg)
    n_angles = ring.RingParams().n_angles
    radon = jax.jit(jax.vmap(
        lambda b: ring.radon.__wrapped__(b, n_angles)))
    with jax.default_matmul_precision("highest"):
        sino_gpu = np.asarray(radon(bevs))
        sino_cpu = np.asarray(radon(jax.device_put(
            np.asarray(bevs), jax.devices("cpu")[0])))
    radon_rel = float(np.abs(sino_gpu - sino_cpu).max()
                      / np.abs(sino_cpu).max())

    describe_exact = jax.jit(jax.vmap(
        lambda b: ring.describe.__wrapped__(b, n_angles)))
    with jax.default_matmul_precision("highest"):
        d_exact = describe_exact(bevs)
    d_fast = jax.vmap(ring.describe)(bevs)     # production: precision.fast
    fast_dev = float(jnp.abs(d_fast.sinogram - d_exact.sinogram).max())
    top1_exact = top1(d_exact.tiring, owner)
    top1_fast = top1(d_fast.tiring, owner)
    emit("references", map_size=ELEVATION_SIZE, features_ms=feat_s * 1e3,
         features_max_abs_dev=dev, features_atol=FEATURE_ATOL,
         enough_mask_equal=enough_equal, valid_mask_equal=valid_equal,
         radon_keyframes=int(bevs.shape[0]), radon_rel_dev_vs_cpu=radon_rel,
         radon_rtol=RADON_RTOL, radon_fast_max_dev=fast_dev,
         top1_unchanged_under_fast=bool(np.array_equal(top1_exact,
                                                       top1_fast)))
    check(all(v <= FEATURE_ATOL for v in dev.values()),
          f"features off the float64 reference: {dev}")
    check(enough_equal and valid_equal, "feature masks differ")
    check(radon_rel <= RADON_RTOL, f"Radon GPU vs CPU rel dev {radon_rel}")
    check(np.array_equal(top1_exact, top1_fast),
          "RING top-1 retrieval changed under precision.fast")


# --------------------------------------------------------------- 4 cards
# odometry is an iterated registration chain whose ulp-level lowering
# differences can flip discrete events (correspondences, voxel drops),
# so both lowerings must track the truth and agree to odometry quality
FRONTEND_TRUTH_M = 0.5
FRONTEND_AGREE_M = 0.1
# psum over edge shards reorders the PCG reductions of a 510-node graph
PGO_AGREE_M = 1e-3


def phase_four_cards():
    from jax.sharding import Mesh

    from mr_slam_tpu.backend import chordal, distributed
    from mr_slam_tpu.eval import graphgen
    from mr_slam_tpu.geometry import se3
    from mr_slam_tpu.mapping import elevation, sharded_elevation
    from mr_slam_tpu.parallel import multihost as mh

    cfg = slam_config()
    n_frames = FOUR_FRAMES
    trajs, scans = make_world(FOUR, n_frames)
    mesh = mh.robot_mesh(FOUR)
    host = lambda tree: jax.tree.map(np.asarray, tree)
    g_scans = mh.feed_global({r: host(s) for r, s in enumerate(scans)}, mesh)
    g_orig = mh.feed_global(
        {r: host(se3.index(t, 0)) for r, t in enumerate(trajs)}, mesh)
    (poses, _, added), spmd_s = timed_twice(
        lambda: mh.frontend_spmd(g_scans, cfg, g_orig, mesh))
    one = jax.devices()[0]
    stack = lambda xs: jax.device_put(
        jax.tree.map(lambda *a: np.stack(a), *[host(x) for x in xs]), one)
    scans1 = stack(scans)
    orig1 = stack([se3.index(t, 0) for t in trajs])
    (poses1, _, added1), single_s = timed_twice(
        lambda: mh._frontend_vmapped(scans1, cfg, orig1))
    true_t = np.stack([np.asarray(t.t) for t in trajs])
    err_spmd = float(np.linalg.norm(np.asarray(poses.t) - true_t, axis=-1).max())
    err_single = float(np.linalg.norm(np.asarray(poses1.t) - true_t,
                                      axis=-1).max())
    agree = float(np.linalg.norm(np.asarray(poses.t) - np.asarray(poses1.t),
                                 axis=-1).max())
    kf_spmd = np.asarray(added).sum(1).tolist()
    kf_single = np.asarray(added1).sum(1).tolist()
    emit("four_cards.frontend", robots=FOUR, frames=n_frames,
         scan=[RINGS, AZIMUTH], spmd_s=spmd_s, single_card_s=single_s,
         max_err_vs_truth_m=[err_spmd, err_single], max_diff_m=agree,
         keyframes=[kf_spmd, kf_single])
    check(max(err_spmd, err_single) <= FRONTEND_TRUTH_M,
          "front-end drifted from ground truth")
    check(agree <= FRONTEND_AGREE_M, f"mesh vs single-card poses {agree} m")
    check(all(abs(a - b) <= 1 for a, b in zip(kf_spmd, kf_single)),
          "keyframe counts differ")

    g, true, anchors, _ = graphgen.multi_robot_graph(
        n_robots=3, nodes_per_robot=170, loop_stride=12, seed=0)
    pcfg = chordal.PGOConfig(rot_cg_iters=120, gn_iters=30, pose_cg_iters=120)
    pgo_mesh = Mesh(np.array(jax.devices()[:FOUR]), (distributed.AXIS,))
    opt_d, dist_s = timed_twice(
        lambda: distributed.optimize(g, anchors, pgo_mesh, pcfg))
    opt_1, one_s = timed_twice(lambda: chordal.optimize(g, anchors, pcfg))
    N = int(g.n_nodes)
    pgo_diff = float(np.abs(np.asarray(opt_d.t)[:N]
                            - np.asarray(opt_1.t)[:N]).max())
    ate = lambda t: float(np.sqrt(np.mean(np.sum(
        (np.asarray(t)[:N] - np.asarray(true.t)) ** 2, -1))))
    emit("four_cards.pgo", nodes=N, edges=int(g.n_edges), sharded_s=dist_s,
         single_card_s=one_s, max_diff_m=pgo_diff,
         ate_m=[ate(opt_d.t), ate(opt_1.t)])
    check(pgo_diff <= PGO_AGREE_M, f"sharded PGO differs by {pgo_diff} m")

    rng = np.random.default_rng(0)
    H = W = FOUR_MAP
    m = elevation.ElevationMap(
        height=jnp.asarray(rng.normal(0, 1, (H, W)).cumsum(0) * 0.02,
                           jnp.float32),
        variance=jnp.ones((H, W), jnp.float32),
        valid=jnp.asarray(rng.random((H, W)) < 0.8),
        origin=jnp.zeros(2, jnp.float32), resolution=jnp.float32(0.2))
    f_sh, sh_s = timed_twice(lambda: sharded_elevation.features_sharded(
        m, pgo_mesh, axis=distributed.AXIS))
    f_one, one_s = timed_twice(lambda: elevation.features(m))
    # the halo fill reads heights beyond the map as 0, the unsharded
    # grid as -inf: the outer 2 rows of `step` (and so traversability)
    # follow each convention
    inner = np.s_[2:-2]
    diff = {k: float(np.abs(np.asarray(getattr(f_sh, k))[inner]
                            - np.asarray(getattr(f_one, k))[inner]).max())
            for k in f_one._fields}
    emit("four_cards.features", size=H, sharded_s=sh_s, single_card_s=one_s,
         max_abs_diff=diff)
    check(all(v <= FEATURE_ATOL for v in diff.values()),
          f"sharded features differ: {diff}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the cross-card path on a 4-card mesh")
    args = ap.parse_args()
    count = FOUR if args.four_cards else 1
    kind, count = phase_device(count)
    if args.four_cards:
        phase_four_cards()
    else:
        cfg = slam_config()
        sess, res = phase_online(cfg)
        emap = phase_map(cfg, res)
        phase_references(sess, cfg, emap)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
