"""Batched SE(3) poses as a (R, t) pytree.

The reference passes poses around as `gtsam::Pose3`, `Eigen::Isometry3d`,
`tf::Transform` and geometry_msgs with ad-hoc converters
(`global_manager.cpp:2512-2585`). Here one batched `Pose` pytree replaces
them all; every op broadcasts over leading dims so whole trajectories are
single array programs.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import so3

# Pose math runs at explicit f32 matmul precision ALWAYS: 3x3 chains
# gain no speed from reduced precision, but its rounding compounds over
# long compositions (see precision.py).
_P = jax.lax.Precision.HIGHEST


class Pose(NamedTuple):
    """Rigid transform: x_world = R @ x_local + t.

    R: (..., 3, 3) rotation, t: (..., 3) translation.
    """

    R: jax.Array
    t: jax.Array

    @property
    def batch_shape(self):
        return self.t.shape[:-1]

    def matrix(self) -> jax.Array:
        """(..., 4, 4) homogeneous matrix."""
        top = jnp.concatenate([self.R, self.t[..., :, None]], axis=-1)
        bottom = jnp.zeros_like(top[..., :1, :]).at[..., 0, 3].set(1.0)
        return jnp.concatenate([top, bottom], axis=-2)


def identity(batch_shape=(), dtype=jnp.float32) -> Pose:
    R = jnp.broadcast_to(jnp.eye(3, dtype=dtype), (*batch_shape, 3, 3))
    t = jnp.zeros((*batch_shape, 3), dtype=dtype)
    return Pose(R, t)


def from_matrix(T: jax.Array) -> Pose:
    return Pose(T[..., :3, :3], T[..., :3, 3])


def from_rt(R: jax.Array, t: jax.Array) -> Pose:
    return Pose(R, t)


def from_quat_trans(q: jax.Array, t: jax.Array) -> Pose:
    """q = (..., 4) [w, x, y, z]."""
    return Pose(so3.quat_to_rot(q), t)


def from_xyzrpy(v: jax.Array) -> Pose:
    """(..., 6) [x, y, z, roll, pitch, yaw] — the reference's
    PointTypePose layout (`typedefs.h` XYZIRPYT)."""
    return Pose(so3.rpy_to_rot(v[..., 3:6]), v[..., 0:3])


def compose(a: Pose, b: Pose) -> Pose:
    """a ∘ b (apply b first, then a)."""
    return Pose(
        jnp.matmul(a.R, b.R, precision=_P),
        jnp.einsum("...ij,...j->...i", a.R, b.t, precision=_P) + a.t,
    )


def inverse(p: Pose) -> Pose:
    Rt = jnp.swapaxes(p.R, -1, -2)
    return Pose(Rt, -jnp.einsum("...ij,...j->...i", Rt, p.t, precision=_P))


def between(a: Pose, b: Pose) -> Pose:
    """a^{-1} ∘ b — gtsam's `Pose3::between`, the odometry/loop factor
    measurement (`global_manager.cpp:1805-1819`)."""
    return compose(inverse(a), b)


def apply(p: Pose, xyz: jax.Array) -> jax.Array:
    """Transform points (..., N, 3) by pose (..., 3, 3)/(..., 3)."""
    return jnp.einsum("...ij,...nj->...ni", p.R, xyz, precision=_P) + p.t[..., None, :]


def exp(xi: jax.Array) -> Pose:
    """se(3) exponential. xi = (..., 6) [rho, phi] (translation, rotation).

    Uses the left Jacobian for the translation part.
    """
    rho, phi = xi[..., 0:3], xi[..., 3:6]
    R = so3.exp(phi)
    theta2 = jnp.sum(phi * phi, axis=-1)
    theta = jnp.sqrt(jnp.maximum(theta2, 1e-12))
    small = theta2 < 1e-8
    W = so3.hat(phi)
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2)
    c = jnp.where(
        small, 1.0 / 6.0 - theta2 / 120.0, (theta - jnp.sin(theta)) / (theta2 * theta)
    )
    eye = jnp.broadcast_to(jnp.eye(3, dtype=xi.dtype), R.shape)
    V = eye + b[..., None, None] * W + c[..., None, None] * jnp.matmul(
        W, W, precision=_P
    )
    return Pose(R, jnp.einsum("...ij,...j->...i", V, rho, precision=_P))


def log(p: Pose) -> jax.Array:
    """SE(3) logarithm -> (..., 6) [rho, phi]."""
    phi = so3.log(p.R)
    theta2 = jnp.sum(phi * phi, axis=-1)
    theta = jnp.sqrt(jnp.maximum(theta2, 1e-12))
    small = theta2 < 1e-8
    W = so3.hat(phi)
    # V^{-1} = I - W/2 + (1/theta^2)(1 - theta sin / (2(1-cos))) W^2
    half_t = theta * 0.5
    cot_term = jnp.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half_t * jnp.cos(half_t) / jnp.maximum(jnp.sin(half_t), 1e-12))
        / jnp.maximum(theta2, 1e-12),
    )
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), W.shape)
    Vinv = eye - 0.5 * W + cot_term[..., None, None] * jnp.matmul(
        W, W, precision=_P
    )
    rho = jnp.einsum("...ij,...j->...i", Vinv, p.t, precision=_P)
    return jnp.concatenate([rho, phi], axis=-1)


def interpolate(a: Pose, b: Pose, alpha: jax.Array) -> Pose:
    """Geodesic interpolation a * exp(alpha * log(a^-1 b)) — replaces the
    per-point slerp undistortion of `laserOdometry.cpp:112-123`."""
    d = log(between(a, b))
    return compose(a, exp(alpha[..., None] * d))


def normalize(p: Pose) -> Pose:
    """Re-orthonormalize rotation (drift control in long compositions)."""
    return Pose(so3.project(p.R), p.t)


def stack(poses: list[Pose]) -> Pose:
    return Pose(
        jnp.stack([p.R for p in poses], axis=0),
        jnp.stack([p.t for p in poses], axis=0),
    )


def index(p: Pose, i) -> Pose:
    return Pose(p.R[i], p.t[i])
