"""Closed-form batched 3x3 symmetric linear algebra.

Registration needs eigen-decompositions and inverses of millions of tiny
covariance matrices (fast_gicp regularizes every voxel covariance to a
plane via eigh; `esti_plane` in FAST-LIO fits planes per point). Batched
tiny LAPACK-style calls lower to per-matrix solver loops, so these are
analytic formulas that lower to pure element-wise code and vmap/jit
cleanly at any batch shape.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-12


def det3(A: jax.Array) -> jax.Array:
    """Determinant of (..., 3, 3)."""
    return (
        A[..., 0, 0] * (A[..., 1, 1] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 1])
        - A[..., 0, 1] * (A[..., 1, 0] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 0])
        + A[..., 0, 2] * (A[..., 1, 0] * A[..., 2, 1] - A[..., 1, 1] * A[..., 2, 0])
    )


def inv3(A: jax.Array) -> jax.Array:
    """Adjugate-based inverse of (..., 3, 3)."""
    c00 = A[..., 1, 1] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 1]
    c01 = A[..., 0, 2] * A[..., 2, 1] - A[..., 0, 1] * A[..., 2, 2]
    c02 = A[..., 0, 1] * A[..., 1, 2] - A[..., 0, 2] * A[..., 1, 1]
    c10 = A[..., 1, 2] * A[..., 2, 0] - A[..., 1, 0] * A[..., 2, 2]
    c11 = A[..., 0, 0] * A[..., 2, 2] - A[..., 0, 2] * A[..., 2, 0]
    c12 = A[..., 0, 2] * A[..., 1, 0] - A[..., 0, 0] * A[..., 1, 2]
    c20 = A[..., 1, 0] * A[..., 2, 1] - A[..., 1, 1] * A[..., 2, 0]
    c21 = A[..., 0, 1] * A[..., 2, 0] - A[..., 0, 0] * A[..., 2, 1]
    c22 = A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]
    det = A[..., 0, 0] * c00 + A[..., 0, 1] * c10 + A[..., 0, 2] * c20
    inv_det = 1.0 / jnp.where(jnp.abs(det) < _EPS, jnp.inf, det)
    adj = jnp.stack(
        [
            jnp.stack([c00, c01, c02], axis=-1),
            jnp.stack([c10, c11, c12], axis=-1),
            jnp.stack([c20, c21, c22], axis=-1),
        ],
        axis=-2,
    )
    return adj * inv_det[..., None, None]


def solve3(A: jax.Array, b: jax.Array) -> jax.Array:
    """Solve (..., 3, 3) @ x = (..., 3)."""
    return jnp.einsum("...ij,...j->...i", inv3(A), b)


def eigvalsh3(A: jax.Array) -> jax.Array:
    """Eigenvalues of symmetric (..., 3, 3), ascending — trigonometric
    closed form (Smith 1961), branch-free."""
    a00, a11, a22 = A[..., 0, 0], A[..., 1, 1], A[..., 2, 2]
    a01, a02, a12 = A[..., 0, 1], A[..., 0, 2], A[..., 1, 2]
    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = (b00 * b00 + b11 * b11 + b22 * b22) / 6.0 + (
        a01 * a01 + a02 * a02 + a12 * a12
    ) / 3.0
    p = jnp.sqrt(jnp.maximum(p2, _EPS))
    # det(B)/2 with B = (A - qI)
    detB = (
        b00 * (b11 * b22 - a12 * a12)
        - a01 * (a01 * b22 - a12 * a02)
        + a02 * (a01 * a12 - b11 * a02)
    )
    r = jnp.clip(detB / (2.0 * p * p * p), -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    e_hi = q + 2.0 * p * jnp.cos(phi)
    e_lo = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)
    e_mid = 3.0 * q - e_hi - e_lo
    return jnp.stack([e_lo, e_mid, e_hi], axis=-1)


def _eigvec(A: jax.Array, lam: jax.Array) -> jax.Array:
    """Eigenvector of symmetric 3x3 for eigenvalue lam via cross products
    of rows of (A - lam I) — picks the most independent pair."""
    B = A - lam[..., None, None] * jnp.eye(3, dtype=A.dtype)
    r0, r1, r2 = B[..., 0, :], B[..., 1, :], B[..., 2, :]
    c01 = jnp.cross(r0, r1)
    c02 = jnp.cross(r0, r2)
    c12 = jnp.cross(r1, r2)
    n01 = jnp.sum(c01 * c01, axis=-1)
    n02 = jnp.sum(c02 * c02, axis=-1)
    n12 = jnp.sum(c12 * c12, axis=-1)
    norms = jnp.stack([n01, n02, n12], axis=-1)
    cands = jnp.stack([c01, c02, c12], axis=-2)
    best = jnp.argmax(norms, axis=-1)
    v = jnp.take_along_axis(
        cands, best[..., None, None].repeat(3, axis=-1), axis=-2
    )[..., 0, :]
    n2 = jnp.sum(v * v, axis=-1, keepdims=True)
    # Repeated eigenvalue: (A - lam I) is (near) rank <= 1, all row cross
    # products vanish — any unit vector in the nullspace works; fall back
    # to a canonical axis (orthogonalized later by the caller). The
    # fallback threshold and the normalizer clamp must agree, else a
    # small-but-accepted v gets divided by the clamp and loses unit norm.
    fallback = jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0], A.dtype), v.shape)
    use_fallback = n2 <= 1e-30
    v = jnp.where(use_fallback, fallback, v)
    n2 = jnp.where(use_fallback, 1.0, n2)
    return v / jnp.sqrt(n2)


def eigh3(A: jax.Array):
    """Eigen-decomposition of symmetric (..., 3, 3).

    Returns (w (..., 3) ascending, V (..., 3, 3) with columns =
    eigenvectors). Degenerate (repeated-eigenvalue) inputs get an
    orthonormal basis via Gram-Schmidt completion.
    """
    w = eigvalsh3(A)
    v0 = _eigvec(A, w[..., 0])
    v2 = _eigvec(A, w[..., 2])
    # For nearly-isotropic matrices the cross-product vectors degenerate;
    # rebuild v2 orthogonal to v0 if needed, then v1 = v2 x v0.
    dot = jnp.sum(v0 * v2, axis=-1, keepdims=True)
    v2o = v2 - dot * v0
    n2 = jnp.sqrt(jnp.maximum(jnp.sum(v2o * v2o, axis=-1, keepdims=True), _EPS))
    # fall back to an arbitrary orthogonal vector when parallel
    alt = jnp.cross(v0, jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0], A.dtype), v0.shape))
    alt_n = jnp.sqrt(jnp.maximum(jnp.sum(alt * alt, axis=-1, keepdims=True), _EPS))
    alt2 = jnp.cross(v0, jnp.broadcast_to(jnp.array([0.0, 1.0, 0.0], A.dtype), v0.shape))
    alt2_n = jnp.sqrt(jnp.maximum(jnp.sum(alt2 * alt2, axis=-1, keepdims=True), _EPS))
    alt = jnp.where(alt_n > 0.1, alt / alt_n, alt2 / alt2_n)
    v2f = jnp.where(n2 > 1e-4, v2o / n2, alt)
    v1 = jnp.cross(v2f, v0)
    V = jnp.stack([v0, v1, v2f], axis=-1)
    return w, V


def plane_fit(points: jax.Array, weights: jax.Array | None = None):
    """Least-squares plane through (..., K, 3) points.

    Returns (normal (..., 3) unit, d (...,), mean (..., 3)) with plane
    n.x + d = 0 — the `esti_plane` primitive of FAST-LIO
    (`laserMapping.cpp:676-691`) and A-LOAM's 5-point surf fit, batched.
    """
    if weights is None:
        weights = jnp.ones(points.shape[:-1], points.dtype)
    wsum = jnp.maximum(jnp.sum(weights, axis=-1, keepdims=True), _EPS)
    mean = jnp.sum(points * weights[..., None], axis=-2) / wsum
    d = (points - mean[..., None, :]) * weights[..., None]
    cov = jnp.einsum("...ki,...kj->...ij", d, points - mean[..., None, :])
    w, V = eigh3(cov)
    normal = V[..., :, 0]  # smallest-eigenvalue direction
    dist = -jnp.sum(normal * mean, axis=-1)
    return normal, dist, mean


def solve_psd(A: jax.Array, b: jax.Array, eps: float = 1e-12) -> jax.Array:
    """Unrolled LDL^T solve of (..., n, n) @ x = (..., n) for SMALL
    static n (Gauss-Newton 6x6, IEKF 15/21x21).

    `jnp.linalg.solve` lowers tiny systems to a batched LU with
    sequential scalar pivoting (the reference spends the equivalent
    time inside Ceres/Eigen on CPU, `laserOdometry.cpp:287-503`). The
    unrolled LDL^T is pure element-wise arithmetic over the batch, fuses
    with the surrounding GN math, and needs no pivoting for the damped
    PSD normal-equation matrices used everywhere here.
    """
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    D = [None] * n
    Dinv = [None] * n
    for j in range(n):
        d = A[..., j, j]
        for k in range(j):
            d = d - L[j][k] * L[j][k] * D[k]
        d = jnp.where(d > eps, d, eps)  # PSD guard (all-masked batches)
        D[j] = d
        Dinv[j] = 1.0 / d
        for i in range(j + 1, n):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k] * D[k]
            L[i][j] = s * Dinv[j]
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i] * Dinv[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s
    return jnp.stack(x, axis=-1)


def inv_psd_scaled(A: jax.Array, eps: float = 1e-20) -> jax.Array:
    """Symmetric-Jacobi-scaled inverse of an SPD matrix: D inv(DAD) D
    with D = diag(A)^-1/2. In f32 a raw `inv` loses the small-eigenvalue
    structure of badly-scaled information matrices (an IEKF H mixes
    ~1e8 point-measurement blocks with ~1e2 prior blocks; cond ~1e6-7);
    scaling to unit diagonal first keeps the cross-covariances that
    carry observability."""
    d = jnp.sqrt(jnp.clip(jnp.diagonal(A, axis1=-2, axis2=-1), eps, None))
    Dinv = 1.0 / d
    As = A * Dinv[..., :, None] * Dinv[..., None, :]
    return jnp.linalg.inv(As) * Dinv[..., :, None] * Dinv[..., None, :]


def solve_psd_scaled(A: jax.Array, b: jax.Array, eps: float = 1e-20):
    """`solve_psd` with the same symmetric Jacobi scaling."""
    d = jnp.sqrt(jnp.clip(jnp.diagonal(A, axis1=-2, axis2=-1), eps, None))
    Dinv = 1.0 / d
    As = A * Dinv[..., :, None] * Dinv[..., None, :]
    return solve_psd(As, b * Dinv) * Dinv
