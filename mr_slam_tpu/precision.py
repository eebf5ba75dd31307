"""Matmul precision policy for accuracy-critical paths.

On an NVIDIA GPU, float32 matmuls, einsums and convolutions under
JAX's "default" precision may run on the tensor cores in TF32, which
keeps a 10-bit mantissa (relative rounding ~5e-4 per product). The
geometry stack (GN normal-equation accumulations, pose-composition
chains, CG iterations) compounds that rounding over hundreds of frames
into trajectory error. The descriptor/BEV side (Radon, all-pairs
correlation einsums, DiSCO convs) only ranks candidates: TF32 leaves its
top-1 answers unchanged (`chip_smoke.py` phase 3 checks this on the
card), so it may take the faster mode.

Policy: the package makes full float32 the global default at import
(`mr_slam_tpu/__init__.py`); accuracy-critical ENTRY POINTS are also
wrapped with `accurate`, which traces them under
`jax.default_matmul_precision("float32")` (the context applies at trace
time, so cached executions pay nothing). Descriptor paths opt into
`fast`.
"""
from __future__ import annotations

import functools

import jax

# Explicit per-op precision for pose/geometry math that must be exact
# regardless of the ambient context: 3x3 rotation chains gain nothing
# from TF32, but compound its rounding into trajectory error when
# composed over hundreds of frames.
HIGHEST = jax.lax.Precision.HIGHEST


def accurate(fn):
    """Trace `fn` under float32 matmul precision. Place ABOVE any
    `jax.jit` decorator so the context is active while tracing.

    Since the package now sets f32 as the GLOBAL default at import
    (`mr_slam_tpu/__init__.py`), this wrapper is belt-and-braces: it
    keeps the entry point correct even if an embedding application
    resets the global default."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with jax.default_matmul_precision("float32"):
            return fn(*args, **kwargs)

    wrapper.__wrapped__ = getattr(fn, "__wrapped__", fn)
    return wrapper


def fast(fn):
    """Trace `fn` under the hardware-default matmul precision (TF32 on
    the GPU's tensor cores) — the explicit opt-in for throughput-critical
    descriptor batches where ranking, not geometry, is the output
    (retrieval einsums, Radon, DiSCO convs). Place ABOVE `jax.jit`."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with jax.default_matmul_precision("default"):
            return fn(*args, **kwargs)

    wrapper.__wrapped__ = getattr(fn, "__wrapped__", fn)
    return wrapper
