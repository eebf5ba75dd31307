#!/usr/bin/env python
"""Long-horizon full-pipeline benchmark: >= 500 frames x 3 robots at
64 x 1024 rays with drift-realistic sensor noise — the scale the NCLT
multi-robot demos run at (BASELINE.md measurement points; no NCLT bags
are fetchable in this environment, so this is the controlled
substitute with exact ground truth).

Per robot: a multi-lap ring road through the shared courtyard world
(inter-robot overlap everywhere), 64-ring scans with 3 cm range noise.
Reports front-end frames/s, end-to-end wall time, loop counts and
ATE RMSE of the optimized trajectories vs ground truth, plus the
engine's stage-time breakdown.

Run:  python examples/bench_longrun.py          (env FRAMES/ROBOTS to resize)
"""
from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from mr_slam_tpu.datasets import synthetic
from mr_slam_tpu.eval import metrics
from mr_slam_tpu.geometry import se3
from mr_slam_tpu.runtime import observability as obs
from mr_slam_tpu.runtime import pipeline as pl
from mr_slam_tpu.runtime.config import (
    KeyframeCfg, LoopCfg, OdometryCfg, PGOCfg, SlamConfig,
)


def run(T: int = 500, R: int = 3, rings: int = 64,
        azimuth: int = 1024) -> dict:
    """Execute the long-horizon run; returns the result dict (also the
    `longrun` extra of bench.py)."""
    cfg = SlamConfig(
        n_robots=R,
        odometry=OdometryCfg(scan_capacity=8192, insert_capacity=16384),
        keyframes=KeyframeCfg(dist_thresh=2.0, capacity=256,
                              points_per_kf=4096),
        loops=LoopCfg(dist_thresh=0.75, min_separation=8, candidates=2,
                      fitness_thresh=0.15, max_loops=256),
        # reference-parity optimization budget for production-scale graphs
        pgo=PGOCfg(rot_cg_iters=120, gn_iters=30, pose_cg_iters=120,
                   node_capacity=1024, edge_capacity=4096),
    )
    world = synthetic.default_world(7, extent=60.0, n_boxes=36)
    # laps scale with T so the per-frame arc stays at the 500-frame
    # operating point (~0.64 m/frame) — a budget-reduced T must shrink
    # the route, not blow the odometry convergence basin with 5 m steps
    laps = 2.3 * T / 500.0
    trajs = [
        synthetic.circle_trajectory(
            T, radius=22.0, laps=laps, phase=2 * np.pi * r / R,
            ccw=(r % 2 == 0),
        )
        for r in range(R)
    ]

    print(f"raycasting {R} x {T} frames at {rings}x{azimuth}...", flush=True)
    CHUNK = 50  # frames per raycast dispatch (vs one round trip per frame)
    scans = []
    for r in range(R):
        keys = jax.random.split(jax.random.PRNGKey(r), T)
        chunks = []
        for i in range(0, T, CHUNK):
            j = min(i + CHUNK, T)
            chunks.append(synthetic.scan_batch(
                world, se3.index(trajs[r], slice(i, j)), keys[i:j],
                n_rings=rings, n_azimuth=azimuth, noise=0.03,
            ))
        scans.append(jax.tree.map(lambda *x: jnp.concatenate(x), *chunks))

    obs.tracer.stats.clear()
    obs.metrics.counters.clear()
    t0 = time.perf_counter()
    res = pl.run([scans[r] for r in range(R)], cfg,
                 origins=[se3.index(trajs[r], 0) for r in range(R)])
    wall = time.perf_counter() - t0

    ates = []
    for r in range(R):
        kf_idx = res.robots[r].kf_frame_idx
        true_kf = se3.index(trajs[r], jnp.asarray(kf_idx))
        ates.append(float(metrics.ate(res.optimized_trajectory(r), true_kf).rmse))
    fe_ms = obs.tracer.stats.get("frontend")
    out = {
        "frames": T, "robots": R, "rays": f"{rings}x{azimuth}",
        "laps": round(laps, 2),
        "wall_s": round(wall, 1),
        "frontend_fps": round(
            R * T / fe_ms.total_s, 2
        ) if fe_ms else None,
        "keyframes": [int(rr.store.count) for rr in res.robots],
        "loops": len(res.loops),
        "inter_robot_loops": sum(
            1 for l in res.loops if l["robot_a"] != l["robot_b"]
        ),
        "ate_rmse_m": [round(a, 3) for a in ates],
        "stage_ms": {
            k: round(v.total_s * 1e3, 1)
            for k, v in sorted(obs.tracer.stats.items())
        },
        "counters": {
            k: int(v) for k, v in sorted(obs.metrics.counters.items())
        },
    }
    return out


def main() -> None:
    from mr_slam_tpu import compile_cache

    compile_cache.configure()
    T = int(os.environ.get("FRAMES", "500"))
    R = int(os.environ.get("ROBOTS", "3"))
    print(json.dumps(run(T, R)))


if __name__ == "__main__":
    main()
