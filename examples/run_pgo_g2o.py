#!/usr/bin/env python
"""Offline pose-graph runner: read a .g2o file, optimize, write the
optimized graph back out.

The analogue of the reference's offline driver
(`Mapping/src/global_manager/src/distributed_mapper/run_distributed_mapper.cpp`),
which loads a directory of per-robot g2o files and runs the
distributed-mapper scheme. Here one merged g2o file (the format the
manager's `savingPoseGraph` dumps, `global_manager.cpp:188-212`) is
loaded into a FactorGraph; robot membership and edge kinds are
recovered from the gtsam key codec; the first node of every robot is
anchored; then either the centralized two-stage chordal+GN optimizer
or the decentralized Gauss-Seidel scheme runs.

Usage:
    python examples/run_pgo_g2o.py input.g2o [output.g2o]
        [--gauss-seidel] [--gn-iters N] [--no-robust]

Prints one JSON line with pre/post edge-residual chi2 so runs are
scriptable.
"""
from __future__ import annotations

import argparse
import json

import jax.numpy as jnp
import numpy as np


def graph_chi2(g, poses) -> float:
    """Sum of weighted between-residual norms over valid edges."""
    from mr_slam_tpu.geometry import so3

    ei, ej = g.edge_i, g.edge_j
    Ri, ti = poses.R[ei], poses.t[ei]
    Rj, tj = poses.R[ej], poses.t[ej]
    Rij, tij = g.edge_meas.R, g.edge_meas.t
    r_rot = so3.log(
        jnp.einsum("eab,eac->ebc", Rij, jnp.einsum("eba,ebc->eac", Ri, Rj))
    )
    r_t = jnp.einsum("eba,eb->ea", Ri, tj - ti) - tij
    chi = (
        g.edge_w_rot * jnp.sum(r_rot * r_rot, axis=-1)
        + g.edge_w_trans * jnp.sum(r_t * r_t, axis=-1)
    )
    return float(jnp.sum(jnp.where(g.edge_valid, chi, 0.0)))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("input")
    ap.add_argument("output", nargs="?", default=None)
    ap.add_argument("--gauss-seidel", action="store_true",
                    help="decentralized two-stage scheme instead of the "
                         "centralized chordal+GN optimizer")
    ap.add_argument("--gn-iters", type=int, default=12)
    ap.add_argument("--no-robust", action="store_true",
                    help="disable the Cauchy loop-edge weighting")
    args = ap.parse_args()

    from mr_slam_tpu import compile_cache
    from mr_slam_tpu.backend import chordal, factor_graph as fg, gauss_seidel
    from mr_slam_tpu.eval import g2o

    compile_cache.configure()

    g = g2o.import_g2o(args.input)
    n = int(g.n_nodes)
    robots = np.asarray(g.node_robot[:n])
    n_robots = int(robots.max()) + 1 if n else 0

    # anchor each robot's first node (the reference's near-zero-noise
    # prior on every robot's pose 0, `global_manager.cpp:347-357`)
    anchors = np.zeros((g.node_capacity,), bool)
    for r in range(n_robots):
        idx = np.nonzero(robots == r)[0]
        if idx.size:
            anchors[idx[0]] = True
    anchors = jnp.asarray(anchors)

    chi_pre = graph_chi2(g, g.poses)
    if args.gauss_seidel:
        cfg = gauss_seidel.GSConfig()
        opt = gauss_seidel.optimize(g, anchors, max(n_robots, 1), cfg)
    else:
        cfg = chordal.PGOConfig(
            gn_iters=args.gn_iters,
            robust_delta=0.0 if args.no_robust else 1.0,
        )
        opt = chordal.optimize(g, anchors, cfg)
    chi_post = graph_chi2(g, opt)

    if args.output:
        g2o.export_g2o(args.output, g._replace(poses=opt))

    print(json.dumps({
        "nodes": n,
        "edges": int(g.n_edges),
        "robots": n_robots,
        "optimizer": "gauss_seidel" if args.gauss_seidel else "chordal_gn",
        "chi2_pre": round(chi_pre, 6),
        "chi2_post": round(chi_post, 6),
        "output": args.output,
    }))


if __name__ == "__main__":
    main()
