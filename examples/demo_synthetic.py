#!/usr/bin/env python
"""End-to-end demo on the synthetic world — the Quick Demo analogue.

Runs a 3-robot SLAM session with loop closures, dumps reference-layout
artifacts (g2o graphs, merged map PCD, keyframe dirs), elevation map +
costmap, and PNG renders:

    python examples/demo_synthetic.py out/          (on the GPU)
    JAX_PLATFORMS=cpu python examples/demo_synthetic.py out/
"""
from __future__ import annotations

import sys

import jax
import jax.numpy as jnp
import numpy as np


def main(out_dir: str = "demo_out") -> None:
    from mr_slam_tpu import compile_cache
    from mr_slam_tpu.datasets import synthetic
    from mr_slam_tpu.eval import metrics, visualize
    from mr_slam_tpu.geometry import se3
    from mr_slam_tpu.runtime import persistence, pipeline
    from mr_slam_tpu.runtime.config import LoopCfg, OdometryCfg, SlamConfig
    from mr_slam_tpu.runtime.observability import tracer

    compile_cache.configure()

    cfg = SlamConfig(
        n_robots=3,
        odometry=OdometryCfg(table_size=1 << 16),
        loops=LoopCfg(dist_thresh=0.3, min_separation=6, fitness_thresh=0.15),
    )
    world = synthetic.default_world(7)
    n = 40
    trajs = [
        synthetic.circle_trajectory(n, radius=22.0, laps=0.55, phase=2 * np.pi * r / 3)
        for r in range(3)
    ]

    print("raycasting scans...")
    scans = []
    with tracer.span("raycast"):
        for r, t in enumerate(trajs):
            keys = jax.random.split(jax.random.PRNGKey(r), n)
            scans.append(synthetic.scan_batch(
                world, t, keys, n_rings=16, n_azimuth=512
            ))

    print("running SLAM...")
    with tracer.span("slam"):
        res = pipeline.run(scans, cfg, origins=[se3.index(t, 0) for t in trajs])

    print(f"loops: {len(res.loops)} "
          f"({sum(1 for l in res.loops if l['robot_a'] != l['robot_b'])} inter-robot)")
    for r in range(3):
        kf_idx = res.robots[r].kf_frame_idx
        true_kf = se3.index(trajs[r], jnp.asarray(kf_idx))
        a = metrics.ate(res.optimized_trajectory(r), true_kf)
        print(f"robot {r}: {len(kf_idx)} keyframes, ATE {float(a.rmse):.3f} m")

    print("writing artifacts...")
    with tracer.span("artifacts"):
        persistence.save_artifacts(out_dir, res)
        visualize.plot_map(f"{out_dir}/map.png", res)
        emap, feats, cm = pipeline.build_elevation(res, cfg, size=700)
        visualize.plot_elevation(f"{out_dir}/elevation.png", emap, feats)
        visualize.plot_costmap(f"{out_dir}/costmap.png", cm)
    print(json_stages := tracer.report())
    print(f"done -> {out_dir}/")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "demo_out")
