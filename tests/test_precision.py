"""Precision-policy regression guards.

The package-wide default matmul precision MUST be float32: reduced-
precision matmul rounding (TF32 on the GPU's tensor cores) compounds
through pose chains, GN normal equations and CG solves into trajectory
error (see mr_slam_tpu/precision.py). Descriptor batches opt back into
the hardware default explicitly via `precision.fast`.
"""
import jax
import jax.numpy as jnp
import numpy as np

import mr_slam_tpu  # noqa: F401 — import sets the global default
from mr_slam_tpu import precision
from mr_slam_tpu.geometry import se3, so3


def test_package_sets_f32_matmul_default():
    assert jax.config.jax_default_matmul_precision == "float32"


def test_geometry_ops_carry_explicit_precision():
    """Pose math must stay exact even if an embedding application
    resets the global default: the geometry ops pin HIGHEST per-op."""
    rng = np.random.default_rng(0)
    w = jnp.asarray(rng.normal(0, 1.0, (64, 3)), jnp.float32)
    t = jnp.asarray(rng.normal(0, 10.0, (64, 3)), jnp.float32)
    a = se3.Pose(so3.exp(w), t)
    b = se3.Pose(so3.exp(-w[::-1]), t[::-1])
    with jax.default_matmul_precision("bfloat16"):
        c = se3.compose(a, b)
        inv = se3.inverse(a)
        rt = so3.project(c.R)
    # f64-ish reference via numpy
    Rn = np.asarray(a.R) @ np.asarray(b.R)
    tn = np.einsum("nij,nj->ni", np.asarray(a.R), np.asarray(b.t)) + np.asarray(a.t)
    assert np.allclose(np.asarray(c.R), Rn, atol=1e-5)
    assert np.allclose(np.asarray(c.t), tn, atol=1e-4)
    assert np.allclose(
        np.einsum("nij,nkj->nik", np.asarray(inv.R), np.asarray(inv.R)),
        np.broadcast_to(np.eye(3), (64, 3, 3)), atol=1e-5,
    )
    assert np.allclose(
        np.einsum("nij,nkj->nik", np.asarray(rt), np.asarray(rt)),
        np.broadcast_to(np.eye(3), (64, 3, 3)), atol=1e-5,
    )


def test_geometry_precision_pins_structural():
    """Structural guard (effective on CPU CI, where the bf16 context is
    a numeric no-op): the lowered HLO of `se3.compose` under a bf16
    default must still carry the HIGHEST per-op precision pin."""
    a = se3.Pose(so3.exp(jnp.ones((4, 3))), jnp.ones((4, 3)))
    with jax.default_matmul_precision("bfloat16"):
        txt = jax.jit(se3.compose).lower(a, a).as_text()
    assert "HIGHEST" in txt, (
        "se3.compose lost its precision=HIGHEST pin — dot ops would run "
        "bf16 whenever an embedding app resets the matmul default"
    )


def test_fast_wrapper_round_trips():
    """`fast` must trace under the hardware default and preserve the
    wrapped function's output structure."""

    @precision.fast
    @jax.jit
    def corr(q, db):
        return jnp.einsum("d,kd->k", q, db)

    q = jnp.ones((8,))
    db = jnp.ones((4, 8))
    out = corr(q, db)
    assert out.shape == (4,)
    assert np.allclose(np.asarray(out), 8.0, rtol=1e-2)
