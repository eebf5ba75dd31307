"""Batched SO(3) operations.

Replaces the scattered Eigen/tf conversions of the reference
(`Mapping/src/global_manager/src/global_manager.cpp:2465-2815`) with one
batched, jit-friendly Lie-group module. All functions broadcast over
leading batch dimensions and are float32.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-8

# Rotation math at explicit f32 matmul precision always — reduced-
# precision rounding compounds over composition chains (see precision.py).
_P = jax.lax.Precision.HIGHEST


def hat(w: jax.Array) -> jax.Array:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([zeros, -wz, wy], axis=-1),
            jnp.stack([wz, zeros, -wx], axis=-1),
            jnp.stack([-wy, wx, zeros], axis=-1),
        ],
        axis=-2,
    )


def vee(W: jax.Array) -> jax.Array:
    """(..., 3, 3) skew -> (..., 3)."""
    return jnp.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], axis=-1)


def exp(w: jax.Array) -> jax.Array:
    """Rodrigues' formula, (..., 3) axis-angle -> (..., 3, 3) rotation.

    Small-angle safe: uses Taylor expansions of sin(t)/t and
    (1-cos(t))/t^2 below sqrt(eps).
    """
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(jnp.maximum(theta2, _EPS))
    small = theta2 < 1e-8
    # sin(t)/t and (1-cos t)/t^2 with Taylor fallbacks.
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2)
    W = hat(w)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * jnp.matmul(
        W, W, precision=_P
    )


def log(R: jax.Array) -> jax.Array:
    """(..., 3, 3) rotation -> (..., 3) axis-angle. Safe near 0 and pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = jnp.arccos(cos_t)
    sin_t = jnp.sin(theta)
    # Generic branch: theta/(2 sin theta) * vee(R - R^T); Taylor near 0.
    generic_scale = jnp.where(
        sin_t < 1e-5,
        0.5 + theta * theta / 12.0,
        theta / jnp.maximum(2.0 * sin_t, _EPS),
    )
    w_generic = generic_scale[..., None] * vee(R - jnp.swapaxes(R, -1, -2))
    # Near pi the antisymmetric part vanishes; use R ~= 2 a a^T - I:
    # pick dominant diagonal k, a_k = sqrt((R_kk + 1)/2),
    # a_j = (R_kj + R_jk) / (4 a_k). Overall sign is arbitrary at pi.
    diag = jnp.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], axis=-1)
    k = jnp.argmax(diag, axis=-1)
    sym = R + jnp.swapaxes(R, -1, -2)
    a_k = jnp.sqrt(jnp.maximum((jnp.max(diag, axis=-1) + 1.0) * 0.5, _EPS))
    row_k = jnp.take_along_axis(
        sym, k[..., None, None].repeat(3, axis=-1), axis=-2
    )[..., 0, :]
    axis = row_k / (4.0 * a_k[..., None])
    axis = jnp.where(
        jax.nn.one_hot(k, 3, dtype=jnp.bool_), a_k[..., None], axis
    )
    axis = axis / jnp.maximum(jnp.linalg.norm(axis, axis=-1, keepdims=True), _EPS)
    w_pi = axis * theta[..., None]
    near_pi = cos_t < -1.0 + 1e-5
    return jnp.where(near_pi[..., None], w_pi, w_generic)


def project(R: jax.Array) -> jax.Array:
    """Project (..., 3, 3) matrices onto SO(3) via SVD (chordal projection).

    Mirrors gtsam's rotation re-orthonormalisation used after the linear
    rotation solve in the two-stage chordal scheme
    (`evaluation_utils.cpp:217-331`).
    """
    U, _, Vt = jnp.linalg.svd(R)
    det = jnp.linalg.det(jnp.matmul(U, Vt, precision=_P))
    D = jnp.concatenate(
        [jnp.ones_like(det)[..., None], jnp.ones_like(det)[..., None], det[..., None]],
        axis=-1,
    )
    return jnp.matmul(U * D[..., None, :], Vt, precision=_P)


def quat_to_rot(q: jax.Array) -> jax.Array:
    """(..., 4) quaternion [w, x, y, z] -> (..., 3, 3)."""
    q = q / jnp.maximum(jnp.linalg.norm(q, axis=-1, keepdims=True), _EPS)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    return jnp.stack(
        [
            jnp.stack([r00, r01, r02], axis=-1),
            jnp.stack([r10, r11, r12], axis=-1),
            jnp.stack([r20, r21, r22], axis=-1),
        ],
        axis=-2,
    )


def rot_to_quat(R: jax.Array) -> jax.Array:
    """(..., 3, 3) -> (..., 4) [w, x, y, z], branch-free (Shepperd)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    # Four candidate constructions; pick the numerically best per element.
    qw = jnp.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22],
        axis=-1,
    )
    qw = jnp.sqrt(jnp.maximum(qw, _EPS)) * 0.5
    case = jnp.argmax(
        jnp.stack([tr, m00, m11, m22], axis=-1), axis=-1
    )
    w0 = qw[..., 0]
    q0 = jnp.stack(
        [w0, (m21 - m12) / (4 * w0), (m02 - m20) / (4 * w0), (m10 - m01) / (4 * w0)],
        axis=-1,
    )
    x1 = qw[..., 1]
    q1 = jnp.stack(
        [(m21 - m12) / (4 * x1), x1, (m01 + m10) / (4 * x1), (m02 + m20) / (4 * x1)],
        axis=-1,
    )
    y2 = qw[..., 2]
    q2 = jnp.stack(
        [(m02 - m20) / (4 * y2), (m01 + m10) / (4 * y2), y2, (m12 + m21) / (4 * y2)],
        axis=-1,
    )
    z3 = qw[..., 3]
    q3 = jnp.stack(
        [(m10 - m01) / (4 * z3), (m02 + m20) / (4 * z3), (m12 + m21) / (4 * z3), z3],
        axis=-1,
    )
    qs = jnp.stack([q0, q1, q2, q3], axis=-2)
    q = jnp.take_along_axis(qs, case[..., None, None].repeat(4, axis=-1), axis=-2)[..., 0, :]
    # Canonical sign: w >= 0.
    return q * jnp.where(q[..., :1] < 0, -1.0, 1.0)


def rpy_to_rot(rpy: jax.Array) -> jax.Array:
    """(..., 3) roll/pitch/yaw (ZYX convention) -> rotation matrix."""
    r, p, y = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr = jnp.cos(r), jnp.sin(r)
    cp, sp = jnp.cos(p), jnp.sin(p)
    cy, sy = jnp.cos(y), jnp.sin(y)
    return jnp.stack(
        [
            jnp.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], axis=-1),
            jnp.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], axis=-1),
            jnp.stack([-sp, cp * sr, cp * cr], axis=-1),
        ],
        axis=-2,
    )


def rot_to_rpy(R: jax.Array) -> jax.Array:
    """(..., 3, 3) -> (..., 3) roll/pitch/yaw (ZYX)."""
    sy = jnp.sqrt(R[..., 0, 0] ** 2 + R[..., 1, 0] ** 2)
    roll = jnp.arctan2(R[..., 2, 1], R[..., 2, 2])
    pitch = jnp.arctan2(-R[..., 2, 0], sy)
    yaw = jnp.arctan2(R[..., 1, 0], R[..., 0, 0])
    return jnp.stack([roll, pitch, yaw], axis=-1)


def yaw_rot(yaw: jax.Array) -> jax.Array:
    """(...,) yaw angle -> (..., 3, 3) rotation about z."""
    c, s = jnp.cos(yaw), jnp.sin(yaw)
    zeros = jnp.zeros_like(c)
    ones = jnp.ones_like(c)
    return jnp.stack(
        [
            jnp.stack([c, -s, zeros], axis=-1),
            jnp.stack([s, c, zeros], axis=-1),
            jnp.stack([zeros, zeros, ones], axis=-1),
        ],
        axis=-2,
    )
