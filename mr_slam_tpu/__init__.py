"""mr_slam_tpu — a multi-robot LiDAR SLAM engine as JAX array programs.

A from-scratch JAX/XLA re-design of the capabilities of
MaverickPeter/MR_SLAM (ROS1/C++/CUDA): scan-matching odometry, pluggable
place recognition (ScanContext / RING / RING++ / DiSCO), VGICP loop
verification, PCM outlier gating, distributed chordal pose-graph
optimization, 2.5D elevation mapping and costmap conversion — all as
functional, jit-compiled array programs over a `jax.sharding.Mesh`
instead of a ROS node graph.

Layout (mirrors SURVEY.md §7 build plan):
  geometry/  SO(3)/SE(3) batched Lie-group math
  ops/       point-cloud substrate, voxel grids, registration, BEV,
             Radon, FFT correlation, LOAM features
  frontend/  scan-matching odometry + keyframe gating
  loop/      place-recognition descriptors and loop detection
  backend/   factor graph, chordal PGO, PCM, distributed optimizer
  mapping/   elevation grid fusion + costmap conversion
  parallel/  mesh helpers + sharded map store
  runtime/   config, end-to-end pipeline, checkpointing
  eval/      ATE / recall metrics, g2o interchange
  datasets/  synthetic multi-robot worlds, NCLT loader
"""

__version__ = "0.1.0"

# SLAM is precision-sensitive end to end: pose chains, GN normal
# equations and CG solves compound reduced-precision matmul rounding
# (TF32 on the GPU's tensor cores) into trajectory error — see
# precision.py. Correctness is the default; throughput-critical
# descriptor batches opt back into the hardware default explicitly via
# `precision.fast`. An embedding application that set its own
# default (jax config API or the JAX_DEFAULT_MATMUL_PRECISION env var)
# keeps it — the SLAM hot paths are protected by their own per-op
# HIGHEST pins and the @accurate wrappers regardless.
import os as _os

import jax as _jax

if (_jax.config.jax_default_matmul_precision is None
        and "JAX_DEFAULT_MATMUL_PRECISION" not in _os.environ):
    _jax.config.update("jax_default_matmul_precision", "float32")
