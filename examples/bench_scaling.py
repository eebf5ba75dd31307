"""Scaling bench: SPMD front-end frames/s at 1 device vs N devices over
the robot mesh, from one process that drives every visible card.
Prints one JSON line {fps_1, fps_n, n, efficiency}.

Efficiency = throughput(N robots on N devices) /
             (N * throughput(1 robot on 1 device)) — the >=80%-at->=2-
hosts target of BASELINE.md (true multi-process mechanics are
exercised by tests/test_multihost.py and bench_multiprocess.py).

Run:  python examples/bench_scaling.py
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np
from jax.sharding import Mesh

from mr_slam_tpu.datasets import synthetic
from mr_slam_tpu.geometry import se3
from mr_slam_tpu.ops.pointcloud import PointCloud
from mr_slam_tpu.parallel import multihost as mh
from mr_slam_tpu.runtime.config import SlamConfig, OdometryCfg, KeyframeCfg

T = int(os.environ.get("BENCH_FRAMES", "10"))
CFG = SlamConfig(
    odometry=OdometryCfg(table_size=1 << 15, scan_capacity=2048,
                         insert_capacity=8192),
    keyframes=KeyframeCfg(capacity=16, points_per_kf=4096),
)


def inputs(n_robots):
    world = synthetic.default_world(7)
    scans, origins = {}, {}
    for r in range(n_robots):
        traj = synthetic.circle_trajectory(
            T, radius=22.0, laps=0.3, phase=2 * np.pi * r / max(n_robots, 1)
        )
        keys = jax.random.split(jax.random.PRNGKey(r), T)
        xyzs, masks = [], []
        for i in range(T):
            xyz, _, hit = synthetic.scan(
                world, se3.index(traj, i), n_rings=16, n_azimuth=512,
                key=keys[i],
            )
            xyzs.append(np.asarray(xyz.reshape(-1, 3)))
            masks.append(np.asarray(hit.reshape(-1)))
        scans[r] = PointCloud(np.stack(xyzs), np.stack(masks))
        o = se3.index(traj, 0)
        origins[r] = se3.Pose(np.asarray(o.R), np.asarray(o.t))
    return scans, origins


def fps(n_robots, devices):
    mesh = Mesh(np.array(devices[:n_robots]), (mh.ROBOT_AXIS,))
    scans, origins = inputs(n_robots)
    g_scans = mh.feed_global(scans, mesh)
    g_origins = mh.feed_global(origins, mesh)
    out = mh.frontend_spmd(g_scans, CFG, g_origins, mesh)  # compile
    jax.block_until_ready(out)
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        out = mh.frontend_spmd(g_scans, CFG, g_origins, mesh)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / reps
    return n_robots * T / dt


def main():
    from mr_slam_tpu import compile_cache

    compile_cache.configure()
    devs = jax.devices()
    n = len(devs)
    fps_1 = fps(1, devs)
    out = {"fps_1": round(fps_1, 2)}
    if n >= 2:
        fps_2 = fps(2, devs)
        out.update(fps_2=round(fps_2, 2),
                   efficiency_2=round(fps_2 / (2 * fps_1), 3))
    fps_n = fps(n, devs)
    out.update(fps_n=round(fps_n, 2), n=n,
               efficiency=round(fps_n / (n * fps_1), 3),
               platform=devs[0].platform, device_kind=devs[0].device_kind)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
