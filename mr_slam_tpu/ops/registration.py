"""Batched point-cloud registration: point-to-plane ICP and VGICP.

Array-program replacement for the reference's registration zoo
(`global_manager.cpp:2416-2462` selects PCL_ICP / PCL_GICP / FAST_GICP /
FAST_VGICP_CUDA; the RING node refines loops with pygicp FastGICP,
`main_RING.py:81-104`). Instead of per-point kd-tree queries +
OpenMP/CUDA reductions, correspondences come from a `VoxelGrid` gather
and the whole Gauss-Newton iteration is one fused einsum chain:

    residuals (N,3) -> per-point 6x6 outer products -> psum over points
    -> 6x6 solve -> se(3) retract,  iterated under `lax.scan`.

Everything is fixed-shape; invalid points carry zero weight. A batch
axis over (source, target) pairs vmaps for loop-verification workloads
(the "registrations/s per chip" benchmark path).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import se3
from ..geometry.se3 import Pose
from . import linalg3, voxel_grid
from .pointcloud import PointCloud
from ..precision import accurate


class RegistrationResult(NamedTuple):
    pose: Pose                 # refined source->target transform
    num_inliers: jax.Array     # matched points at the final iterate
    error: jax.Array           # mean weighted residual cost
    fitness: jax.Array         # PCL-style fitness (mean sq dist, capped)
    converged: jax.Array       # final update norm below tolerance


def _select_best(best: jax.Array, K: int, *arrays):
    """Select arrays[n, best[n], ...] via a one-hot contraction — avoids
    take_along_axis row gathers over tiny trailing dims; for small K
    the one-hot multiply-add is plain element-wise work."""
    sel = jax.nn.one_hot(best, K, dtype=jnp.float32)  # (N, K)
    out = []
    for a in arrays:
        sub = "nk,nk" + "abcd"[: a.ndim - 2] + "->n" + "abcd"[: a.ndim - 2]
        out.append(jnp.einsum(sub, sel, a))
    return out


def _gn_update(H: jax.Array, b: jax.Array, damping: float) -> jax.Array:
    """Solve (H + lambda diag(H)) dx = b for the 6-dof update."""
    diag = jnp.diagonal(H, axis1=-2, axis2=-1)
    lam = damping * jnp.mean(diag, axis=-1)[..., None, None] + 1e-9
    Hd = H + lam * jnp.eye(6, dtype=H.dtype)
    return linalg3.solve_psd(Hd, b)


# (row, col) order of the 21 upper-triangle entries emitted by
# `_gn_terms_direct1`.
_TRI = [
    (0, 0), (0, 1), (0, 2), (0, 3), (0, 4), (0, 5),
    (1, 1), (1, 2), (1, 3), (1, 4), (1, 5),
    (2, 2), (2, 3), (2, 4), (2, 5),
    (3, 3), (3, 4), (3, 5),
    (4, 4), (4, 5),
    (5, 5),
]


def _gn_terms_direct1(
    tp: jax.Array,        # (N, 3) transformed source points
    mask: jax.Array,      # (N,) bool
    grid: voxel_grid.VoxelGrid,
    max_corr2: jax.Array,
    eps: float = 1e-6,
):
    """One fused VGICP GN accumulation in component form.

    Associates (voxel row gather) and accumulates in one pass. Formulas
    mirror fast_gicp's per-point update: W = (Cv + eps I)^-1 via the
    adjugate, J = [-I | hat(tp)], H += J^T W J, b += -J^T W r. The
    component form avoids (N,3,3)/(N,3,6)/(N,6,6) memory intermediates —
    all per-point work is flat (N,) arithmetic XLA fuses into a couple
    of kernels.

    Returns (H (6,6), b (6,), cost (), inliers ()).
    """
    rows, found = voxel_grid.lookup_rows(grid, tp, "direct1")
    return _gn_terms_from_rows(
        tp, mask, rows[:, 0, :], found[:, 0], max_corr2, eps
    )


def _uncenter(dx_c: jax.Array, center: jax.Array) -> jax.Array:
    """Convert a centered GN update (rho_c, phi) back to the origin
    parameterization: p + rho_c + phi x (p - c) = p + rho + phi x p
    with rho = rho_c + c x phi."""
    rho = dx_c[..., 0:3] + jnp.cross(center, dx_c[..., 3:6])
    return jnp.concatenate([rho, dx_c[..., 3:6]], axis=-1)


def _gn_terms_from_rows(
    tp: jax.Array,        # (N, 3) transformed source points
    mask: jax.Array,      # (N,) bool
    rows: jax.Array,      # (N, 16) cached packed voxel rows
    found: jax.Array,     # (N,) bool
    max_corr2: jax.Array,
    eps: float = 1e-6,
    center: jax.Array | None = None,
):
    """GN accumulation against CACHED correspondences (no gather).

    The per-iteration voxel-row gather (random device-memory access)
    costs far more than the fused GN math. Caching rows across inner
    iterations is the classic ICP split: associate in the outer loop,
    optimize the fixed-correspondence quadratic in the inner loop.

    `center`: optional linearization center c. The rotational update is
    parameterized about c (J = [-I | hat(tp - c)]), which keeps the
    6x6 normal equations well-conditioned in f32 for clouds far from
    the origin (uncentered, the E-block entries grow as |p|^2 and f32
    cancellation can make the accumulated H indefinite). The caller must
    convert the solved update back: rho = rho_c + cross(c, phi)."""
    xr, yr, zr = tp[:, 0], tp[:, 1], tp[:, 2]  # residual coords (world)
    if center is None:
        x, y, z = xr, yr, zr
    else:
        x, y, z = xr - center[0], yr - center[1], zr - center[2]
    mu0, mu1, mu2 = rows[:, 4], rows[:, 5], rows[:, 6]
    cxx = rows[:, 7] + eps
    cyy = rows[:, 8] + eps
    czz = rows[:, 9] + eps
    cxy, cxz, cyz = rows[:, 10], rows[:, 11], rows[:, 12]

    r0, r1, r2 = mu0 - xr, mu1 - yr, mu2 - zr
    d2 = r0 * r0 + r1 * r1 + r2 * r2
    w = jnp.where(found & mask & (d2 < max_corr2), 1.0, 0.0)

    # closed-form symmetric 3x3 inverse (adjugate), weight absorbed
    a00 = cyy * czz - cyz * cyz
    a01 = cxz * cyz - cxy * czz
    a02 = cxy * cyz - cxz * cyy
    a11 = cxx * czz - cxz * cxz
    a12 = cxy * cxz - cxx * cyz
    a22 = cxx * cyy - cxy * cxy
    det = cxx * a00 + cxy * a01 + cxz * a02
    # PSD guard: true det of (cov + eps I) is positive, but f32
    # cancellation can compute a tiny NEGATIVE det for near-singular
    # cells; inverting through it injects +-1e10 negative-definite junk
    # into H. The floor is relative (Hadamard bound scale); cells whose
    # det falls under it are degenerate (thin/few-point) — drop them.
    # ... AND an absolute floor: near-coincident-point cells have
    # proportionate (relative-floor-passing) but TINY dets whose
    # inverses are 1e13-scale weights that swamp the f32 accumulation —
    # cap by dropping them (the old |det| guard's behavior).
    det_floor = jnp.maximum(1e-5 * cxx * cyy * czz, 1e-12)
    w = w * (det > det_floor)  # dropped cells are not inliers
    inv_det = w / jnp.maximum(det, 1e-30)
    w00, w01, w02 = a00 * inv_det, a01 * inv_det, a02 * inv_det
    w11, w12, w22 = a11 * inv_det, a12 * inv_det, a22 * inv_det

    # u = W r
    u0 = w00 * r0 + w01 * r1 + w02 * r2
    u1 = w01 * r0 + w11 * r1 + w12 * r2
    u2 = w02 * r0 + w12 * r1 + w22 * r2

    # D = W hat(tp) columns; E = hat(tp)^T W hat(tp)
    D00 = z * w01 - y * w02
    D10 = z * w11 - y * w12
    D20 = z * w12 - y * w22
    D01 = -z * w00 + x * w02
    D11 = -z * w01 + x * w12
    D21 = -z * w02 + x * w22
    D02 = y * w00 - x * w01
    D12 = y * w01 - x * w11
    D22 = y * w02 - x * w12
    E00 = z * D10 - y * D20
    E01 = z * D11 - y * D21
    E02 = z * D12 - y * D22
    E11 = -z * D01 + x * D21
    E12 = -z * D02 + x * D22
    E22 = y * D02 - x * D12

    terms = jnp.stack(
        [
            # H upper triangle (21), order matches _TRI
            w00, w01, w02, -D00, -D01, -D02,
            w11, w12, -D10, -D11, -D12,
            w22, -D20, -D21, -D22,
            E00, E01, E02,
            E11, E12,
            E22,
            # b (6)
            u0, u1, u2,
            y * u2 - z * u1, z * u0 - x * u2, x * u1 - y * u0,
            # cost, inlier count
            r0 * u0 + r1 * u1 + r2 * u2, w,
        ],
        axis=0,
    )  # (29, N)
    acc = jnp.sum(terms, axis=-1)  # (29,)
    H = jnp.zeros((6, 6))
    for idx, (r, c) in enumerate(_TRI):
        H = H.at[r, c].set(acc[idx])
        if r != c:
            H = H.at[c, r].set(acc[idx])
    return H, acc[21:27], acc[27], acc[28]


@accurate
@partial(jax.jit, static_argnames=("iters", "neighbors", "schedule"))
def vgicp(
    source: PointCloud,
    target: voxel_grid.VoxelGrid,
    init: Pose,
    source_covs: jax.Array | None = None,
    iters: int = 20,
    max_corr_dist: float = 1.0,
    damping: float = 1e-6,
    tol: float = 1e-4,
    neighbors: str = "direct1",
    schedule: tuple | None = None,
) -> RegistrationResult:
    """Voxelized GICP against a Gaussian voxel map.

    Per point p with covariance Cp matched to voxel (mu, Cv):
        r = mu - (R p + t),   W = (Cv + R Cp R^T)^-1
        cost = r^T W r
    Jacobian of r wrt left-mult update exp([rho, phi]) T:
        dr/drho = -I,  dr/dphi = hat(R p + t)
    (fast_gicp's FastVGICPCuda computes the same quantities per point
    with CUDA atomics; here the H/b accumulation is one einsum.)

    The common configuration (no source covariances, direct1 neighbours
    — the loop-verification setup) takes a fused component-wise path;
    the general matrix path covers the rest.
    """
    if source_covs is None and neighbors == "direct1":
        return _vgicp_direct1(
            source, target, init, iters=iters,
            max_corr_dist=max_corr_dist, damping=damping, tol=tol,
            schedule=schedule,
        )
    if source_covs is None:
        source_covs = jnp.zeros((source.xyz.shape[0], 3, 3), jnp.float32)

    def step(carry, _):
        pose, _prev = carry
        tp = se3.apply(pose, source.xyz)  # (N, 3) transformed points
        found, cnt, mu, Cv = voxel_grid.lookup(target, tp, neighbors)
        # Pick the nearest *valid* neighbour cell per point.
        d2 = jnp.sum((mu - tp[:, None, :]) ** 2, axis=-1)
        d2 = jnp.where(found, d2, jnp.inf)
        best = jnp.argmin(d2, axis=-1)
        K = d2.shape[1]
        mu_b, Cv_b = _select_best(best, K, mu, Cv)
        d2_b = jnp.min(d2, axis=-1)
        ok = source.mask & jnp.isfinite(d2_b) & (d2_b < max_corr_dist**2)
        w = ok.astype(jnp.float32)
        # Fused covariance and its inverse.
        RCpRt = jnp.einsum("ij,njk,lk->nil", pose.R, source_covs, pose.R)
        W = linalg3.inv3(Cv_b + RCpRt + 1e-6 * jnp.eye(3))
        r = mu_b - tp
        # J (3x6): [-I | hat(tp)]
        hat_tp = jnp.stack(
            [
                jnp.stack([jnp.zeros_like(tp[:, 0]), -tp[:, 2], tp[:, 1]], -1),
                jnp.stack([tp[:, 2], jnp.zeros_like(tp[:, 0]), -tp[:, 0]], -1),
                jnp.stack([-tp[:, 1], tp[:, 0], jnp.zeros_like(tp[:, 0])], -1),
            ],
            axis=-2,
        )
        J = jnp.concatenate(
            [-jnp.broadcast_to(jnp.eye(3), hat_tp.shape), hat_tp], axis=-1
        )  # (N, 3, 6)
        WJ = jnp.einsum("nij,njk->nik", W, J)
        H = jnp.einsum("nij,nik,n->jk", J, WJ, w)
        b = -jnp.einsum("nij,ni,n->j", WJ, r, w)
        dx = _gn_update(H + 1e-6 * jnp.eye(6), b, damping)
        new_pose = se3.compose(se3.exp(dx), pose)
        cost = jnp.sum(jnp.einsum("ni,nij,nj->n", r, W, r) * w) / jnp.maximum(
            jnp.sum(w), 1.0
        )
        return (new_pose, jnp.linalg.norm(dx)), (cost, jnp.sum(w))

    (pose, last_dx), (costs, inliers) = jax.lax.scan(
        step, (init, jnp.float32(jnp.inf)), None, length=iters
    )
    fit = fitness(source, target, pose, max_range=1.0)
    return RegistrationResult(
        pose=se3.normalize(pose),
        num_inliers=inliers[-1],
        error=costs[-1],
        fitness=fit,
        converged=last_dx < tol,
    )


@accurate
@partial(jax.jit, static_argnames=("iters", "inner", "schedule"))
def _vgicp_direct1(
    source: PointCloud,
    target: voxel_grid.VoxelGrid,
    init: Pose,
    iters: int = 20,
    max_corr_dist: float = 1.0,
    damping: float = 1e-6,
    tol: float = 1e-4,
    inner: int = 10,
    schedule: tuple | None = None,
) -> RegistrationResult:
    """Fused direct1 VGICP with correspondence caching.

    `iters` total GN steps run as ceil(iters/inner) outer re-association
    rounds (voxel row gather — the expensive random-access op) x `inner`
    gather-free GN steps on the cached rows (the classic ICP associate/
    optimize split; fast_gicp re-associates every step, but with a
    quadratic fixed-correspondence cost the extra associations change
    the fixed point only through points that cross voxel boundaries
    mid-round — the next outer round picks those up).

    `schedule`: optional tuple of (inner_iters, source_stride) pairs —
    the ANNEALED association schedule. Early rounds only need a coarse
    pose correction, so they associate (and optimize) a strided subset
    of the source; the final round(s) run the full cloud. Overrides
    `iters`/`inner` when given. ((5, 4), (8, 2), (17, 1)) cuts the
    gather volume from 5N to 1.75N rows and the GN steps from 50 to 30;
    bench.py reports its converged accuracy (`extra.convergence`).

    The per-round row gather dominates; the fused GN steps between
    gathers are cheap, so inner=10 (5 re-associations for iters=50)
    halves the gathers of inner=5 on seed-realistic initials
    (<= 0.3 m / 3 deg — what RING/SC seeding delivers). Its time on the
    GPU is not measured yet."""
    max_corr2 = jnp.float32(max_corr_dist) ** 2
    if schedule is None:
        schedule = tuple(
            (min(inner, iters - k * inner), 1)
            for k in range(-(-iters // inner))
        )
    # Linearization center: masked source centroid (f32 conditioning of
    # the 6x6 normal equations — see _gn_terms_from_rows). Fixed across
    # iterations; the pose moves points by <~ the convergence basin so
    # the init-frame centroid stays representative.
    wm = source.mask.astype(jnp.float32)
    centroid = jnp.sum(source.xyz * wm[:, None], 0) / jnp.maximum(
        jnp.sum(wm), 1.0
    )

    # rounds unroll in python (schedule is static, <= ~5 rounds) so
    # each round can use its own source stride
    pose, last_dx = init, jnp.float32(jnp.inf)
    cost, n_in = jnp.float32(0.0), jnp.float32(0.0)
    for inner_n, stride in schedule:
        sxyz = source.xyz[::stride]
        smask = source.mask[::stride]
        tp0 = se3.apply(pose, sxyz)
        rows, found = voxel_grid.lookup_rows(target, tp0, "direct1")
        rows, found = rows[:, 0, :], found[:, 0]
        c = se3.apply(pose, centroid[None, :])[0]

        def inner_step(icarry, _, sxyz=sxyz, smask=smask, rows=rows,
                       found=found, c=c):
            ipose, _iprev = icarry
            tp = se3.apply(ipose, sxyz)
            H, b, cost, n_in = _gn_terms_from_rows(
                tp, smask, rows, found, max_corr2, center=c
            )
            dx_c = _gn_update(H + 1e-6 * jnp.eye(6), b, damping)
            new_pose = se3.compose(se3.exp(_uncenter(dx_c, c)), ipose)
            return (new_pose, jnp.linalg.norm(dx_c)), (
                cost / jnp.maximum(n_in, 1.0), n_in
            )

        (pose, last_dx), (costs, inliers) = jax.lax.scan(
            inner_step, (pose, last_dx), None, length=inner_n
        )
        cost, n_in = costs[-1], inliers[-1]
    fit = fitness(source, target, pose, max_range=1.0)
    return RegistrationResult(
        pose=se3.normalize(pose),
        num_inliers=n_in,
        error=cost,
        fitness=fit,
        converged=last_dx < tol,
    )


@accurate
@partial(jax.jit, static_argnames=("iters", "neighbors", "inner", "schedule"))
def point_to_plane_icp(
    source: PointCloud,
    target: voxel_grid.VoxelGrid,
    init: Pose,
    iters: int = 20,
    max_corr_dist: float = 1.0,
    damping: float = 1e-6,
    tol: float = 1e-4,
    neighbors: str = "direct7",
    inner: int = 4,
    schedule: tuple | None = None,
) -> RegistrationResult:
    """Point-to-plane ICP: residual n^T (T p - mu) against a local plane
    — the same geometry as FAST-LIO's `esti_plane` measurement model
    (`laserMapping.cpp:634-766`). The reference fits the plane to the
    ikd-tree 5 nearest neighbours; here the plane comes from *pooling
    the Gaussian moments of the matched cell and its neighbour cells*,
    which spans rings/scans the way 5-NN does (a single cell of one
    sparse scan is often collinear and unusable).

    Like `_vgicp_direct1`, `iters` total GN steps run as
    ceil(iters/inner) outer ASSOCIATION rounds (the K-row gather +
    moment pooling + eigh3 plane fits — the measured per-frame cost of
    the whole front-end) x `inner` gather-free GN steps against the
    cached planes (n, mu fixed; residual and Jacobian re-linearized at
    each iterate).

    `schedule`: optional ((inner_iters, source_stride), ...) annealed
    association schedule (same contract as `_vgicp_direct1`): early
    rounds associate a strided subset — the K-row gather + pooling +
    eigh3 are the cost and a coarse correction needs no density — the
    final round runs the full cloud. Overrides iters/inner."""
    if schedule is None:
        schedule = tuple(
            (min(inner, iters - k * inner), 1)
            for k in range(-(-iters // inner))
        )

    def assoc_and_refine(carry, inner_n, stride):
        pose0, _prev = carry
        sxyz = source.xyz[::stride]
        smask = source.mask[::stride]
        tp = se3.apply(pose0, sxyz)
        found, cnt, mu, Cv = voxel_grid.lookup(target, tp, neighbors)
        # Candidate A: pool moments over all found neighbour cells
        # (spans rings/scans like the reference's 5-NN plane fit).
        wk = jnp.where(found, cnt, 0.0)  # (N, K)
        wsum = jnp.sum(wk, axis=-1)
        mu_p = jnp.einsum("nk,nki->ni", wk, mu) / jnp.maximum(wsum[:, None], 1.0)
        M2 = Cv + jnp.einsum("nki,nkj->nkij", mu, mu)
        M2_p = jnp.einsum("nk,nkij->nij", wk, M2) / jnp.maximum(
            wsum[:, None, None], 1.0
        )
        Cp = M2_p - jnp.einsum("ni,nj->nij", mu_p, mu_p)
        # Candidate B: nearest single cell (sparse scenes, where the
        # pooled neighbourhood mixes surfaces but one cell is planar).
        d2k = jnp.where(found, jnp.sum((mu - tp[:, None, :]) ** 2, -1), jnp.inf)
        best = jnp.argmin(d2k, axis=-1)
        K = d2k.shape[1]
        mu_c, Cv_c, cnt_c = _select_best(
            best, K, mu, Cv, jnp.where(found, cnt, 0.0)
        )

        def planarity(C):
            evals, V = linalg3.eigh3(C + 1e-9 * jnp.eye(3))
            return V[..., :, 0], evals[..., 0] < 0.1 * jnp.maximum(evals[..., 1], 1e-9)

        n_p, planar_p = planarity(Cp)
        n_c, planar_c = planarity(Cv_c)
        use_pool = planar_p & (wsum >= 5)
        use_cell = (~use_pool) & planar_c & (cnt_c >= 3)
        n = jnp.where(use_pool[:, None], n_p, n_c)
        mu_b = jnp.where(use_pool[:, None], mu_p, mu_c)
        usable = smask & (use_pool | use_cell)

        def inner_step(icarry, _):
            pose, _p = icarry
            tp_i = se3.apply(pose, sxyz)
            d2_b = jnp.sum((mu_b - tp_i) ** 2, axis=-1)
            w = (usable & (d2_b < max_corr_dist**2)).astype(jnp.float32)
            r = jnp.sum(n * (tp_i - mu_b), axis=-1)  # scalar residual
            # dr/dxi = n^T [I | -hat(tp)] -> (N, 6)
            J = jnp.concatenate([n, jnp.cross(tp_i, n)], axis=-1)
            H = jnp.einsum("ni,nj,n->ij", J, J, w)
            b = -jnp.einsum("ni,n,n->i", J, r, w)
            dx = _gn_update(H + 1e-6 * jnp.eye(6), b, damping)
            new_pose = se3.compose(se3.exp(dx), pose)
            cost = jnp.sum(r * r * w) / jnp.maximum(jnp.sum(w), 1.0)
            return (new_pose, jnp.linalg.norm(dx)), (cost, jnp.sum(w))

        (pose, last_dx), (costs, inliers) = jax.lax.scan(
            inner_step, (pose0, _prev), None, length=inner_n
        )
        return (pose, last_dx), (costs[-1], inliers[-1])

    carry = (init, jnp.float32(jnp.inf))
    cost, n_in = jnp.float32(0.0), jnp.float32(0.0)
    for inner_n, stride in schedule:
        carry, (cost, n_in) = assoc_and_refine(carry, inner_n, stride)
    pose, last_dx = carry
    fit = fitness(source, target, pose, max_range=1.0)
    return RegistrationResult(
        pose=se3.normalize(pose),
        num_inliers=n_in,
        error=cost,
        fitness=fit,
        converged=last_dx < tol,
    )


@accurate
@partial(jax.jit, static_argnames=("iters",))
def loam_icp(
    corners: PointCloud,
    surfs: PointCloud,
    target: voxel_grid.VoxelGrid,
    init: Pose,
    iters: int = 10,
    max_corr_dist: float = 1.0,
    damping: float = 1e-6,
    tol: float = 1e-4,
) -> RegistrationResult:
    """A-LOAM-style feature registration: corner points match LINE
    structures (cell covariance with one dominant eigenvalue; residual =
    perpendicular offset from the line — `laserOdometry.cpp`
    LidarEdgeFactor), surf points match PLANES (point-to-plane —
    LidarPlaneFactor). Both residual families accumulate into one 6x6
    GN system per iteration."""

    def step(carry, _):
        pose, _prev = carry
        # ---- surf -> plane (reuse pooled-plane machinery via cells) --
        tp_s = se3.apply(pose, surfs.xyz)
        found, cnt, mu, Cv = voxel_grid.lookup(target, tp_s, "direct7")
        wk = jnp.where(found, cnt, 0.0)
        wsum = jnp.sum(wk, axis=-1)
        mu_p = jnp.einsum("nk,nki->ni", wk, mu) / jnp.maximum(wsum[:, None], 1.0)
        M2 = Cv + jnp.einsum("nki,nkj->nkij", mu, mu)
        M2_p = jnp.einsum("nk,nkij->nij", wk, M2) / jnp.maximum(
            wsum[:, None, None], 1.0
        )
        Cp = M2_p - jnp.einsum("ni,nj->nij", mu_p, mu_p)
        evals, V = linalg3.eigh3(Cp + 1e-9 * jnp.eye(3))
        n = V[..., :, 0]
        planar = evals[..., 0] < 0.1 * jnp.maximum(evals[..., 1], 1e-9)
        d2s = jnp.sum((mu_p - tp_s) ** 2, axis=-1)
        w_s = (
            surfs.mask & planar & (wsum >= 5) & (d2s < max_corr_dist**2)
        ).astype(jnp.float32)
        r_s = jnp.sum(n * (tp_s - mu_p), axis=-1)
        J_s = jnp.concatenate([n, jnp.cross(tp_s, n)], axis=-1)  # (Ns, 6)
        H = jnp.einsum("ni,nj,n->ij", J_s, J_s, w_s)
        g = -jnp.einsum("ni,n,n->i", J_s, r_s, w_s)

        # ---- corner -> line ------------------------------------------
        tp_c = se3.apply(pose, corners.xyz)
        found_c, cnt_c, mu_c, Cv_c = voxel_grid.lookup(target, tp_c, "direct7")
        wk_c = jnp.where(found_c, cnt_c, 0.0)
        wsum_c = jnp.sum(wk_c, axis=-1)
        mu_cp = jnp.einsum("nk,nki->ni", wk_c, mu_c) / jnp.maximum(
            wsum_c[:, None], 1.0
        )
        M2c = Cv_c + jnp.einsum("nki,nkj->nkij", mu_c, mu_c)
        M2cp = jnp.einsum("nk,nkij->nij", wk_c, M2c) / jnp.maximum(
            wsum_c[:, None, None], 1.0
        )
        Ccp = M2cp - jnp.einsum("ni,nj->nij", mu_cp, mu_cp)
        evc, Vc = linalg3.eigh3(Ccp + 1e-9 * jnp.eye(3))
        d = Vc[..., :, 2]  # line direction = largest-eigenvalue axis
        # linearity: dominant eigenvalue well above the middle one
        linear = evc[..., 2] > 3.0 * jnp.maximum(evc[..., 1], 1e-9)
        d2c = jnp.sum((mu_cp - tp_c) ** 2, axis=-1)
        w_c = (
            corners.mask & linear & (wsum_c >= 4) & (d2c < max_corr_dist**2)
        ).astype(jnp.float32)
        # residual: perpendicular offset r_perp = P (tp - mu), P = I - dd^T
        diff = tp_c - mu_cp
        r_c = diff - d * jnp.sum(d * diff, axis=-1, keepdims=True)  # (Nc, 3)
        # J = P [I | -hat(tp)] (3x6)
        hat_tp = so3_hat(tp_c)
        P = jnp.broadcast_to(jnp.eye(3), Ccp.shape) - jnp.einsum(
            "ni,nj->nij", d, d
        )
        J_c = jnp.concatenate([P, -jnp.einsum("nij,njk->nik", P, hat_tp)], axis=-1)
        H = H + jnp.einsum("nri,nrj,n->ij", J_c, J_c, w_c)
        g = g - jnp.einsum("nri,nr,n->i", J_c, r_c, w_c)

        dx = _gn_update(H + 1e-6 * jnp.eye(6), g, damping)
        new_pose = se3.compose(se3.exp(dx), pose)
        cost = (
            jnp.sum(r_s * r_s * w_s) + jnp.sum(jnp.sum(r_c * r_c, -1) * w_c)
        ) / jnp.maximum(jnp.sum(w_s) + jnp.sum(w_c), 1.0)
        return (new_pose, jnp.linalg.norm(dx)), (cost, jnp.sum(w_s) + jnp.sum(w_c))

    (pose, last_dx), (costs, inliers) = jax.lax.scan(
        step, (init, jnp.float32(jnp.inf)), None, length=iters
    )
    fit = fitness(surfs, target, pose, max_range=1.0)
    return RegistrationResult(
        pose=se3.normalize(pose),
        num_inliers=inliers[-1],
        error=costs[-1],
        fitness=fit,
        converged=last_dx < tol,
    )


@accurate
@partial(jax.jit, static_argnames=("iters",))
def point_to_point_icp(
    source: PointCloud,
    target: PointCloud,
    init: Pose,
    iters: int = 20,
    max_corr_dist: float = 1.0,
    damping: float = 1e-6,
    tol: float = 1e-4,
) -> RegistrationResult:
    """Classic point-to-point ICP — the reference's PCL_ICP option in
    `select_registration_method` (`global_manager.cpp:2416-2462`).
    Correspondences are brute-force nearest neighbours from one
    |q-p|^2 distance matmul, residual = matched offset, closed GN on
    se(3). Intended for the loop-verification cloud sizes (<= ~8k)."""
    from . import pointcloud as _pcl

    def step(carry, _):
        pose, _prev = carry
        tp = se3.apply(pose, source.xyz)
        d2, idx = _pcl.knn(tp, target, 1)
        q = target.xyz[idx[:, 0]]
        ok = source.mask & (d2[:, 0] < max_corr_dist**2)
        w = ok.astype(jnp.float32)
        r = tp - q  # (N, 3)
        # dr/dxi = [I | -hat(tp)]
        J = jnp.concatenate(
            [jnp.broadcast_to(jnp.eye(3), (tp.shape[0], 3, 3)), -so3_hat(tp)],
            axis=-1,
        )  # (N, 3, 6)
        H = jnp.einsum("nai,naj,n->ij", J, J, w)
        b = -jnp.einsum("nai,na,n->i", J, r, w)
        dx = _gn_update(H + 1e-6 * jnp.eye(6), b, damping)
        new_pose = se3.compose(se3.exp(dx), pose)
        cost = jnp.sum(jnp.sum(r * r, -1) * w) / jnp.maximum(jnp.sum(w), 1.0)
        return (new_pose, jnp.linalg.norm(dx)), (cost, jnp.sum(w))

    (pose, last_dx), (costs, inliers) = jax.lax.scan(
        step, (init, jnp.float32(jnp.inf)), None, length=iters
    )
    return RegistrationResult(
        pose=se3.normalize(pose),
        num_inliers=inliers[-1],
        error=costs[-1],
        fitness=costs[-1],
        converged=last_dx < tol,
    )


def _regularized_covs(pc: PointCloud, k: int = 10):
    """fast_gicp's covariance regularisation: per-point neighbourhood
    covariance with eigenvalues snapped to (1, 1, 1e-3) — every local
    surface treated as a plane of uniform confidence."""
    from . import pointcloud as _pcl

    _, cov, valid = _pcl.covariances_knn(pc, k)
    evals, V = linalg3.eigh3(cov + 1e-9 * jnp.eye(3))
    snapped = jnp.broadcast_to(jnp.array([1e-3, 1.0, 1.0]), evals.shape)
    C = jnp.einsum("nij,nj,nkj->nik", V, snapped, V)
    return C, valid


@accurate
@partial(jax.jit, static_argnames=("iters", "corr_k"))
def gicp(
    source: PointCloud,
    target: PointCloud,
    init: Pose,
    iters: int = 20,
    max_corr_dist: float = 1.0,
    damping: float = 1e-6,
    tol: float = 1e-4,
    corr_k: int = 10,
) -> RegistrationResult:
    """Generalized-ICP (plane-to-plane) — the PCL_GICP / FAST_GICP
    options of `select_registration_method` (`global_manager.cpp:
    2435-2446`, 8 OpenMP threads + correspondence randomness 15 there;
    here one fused batched GN). Cost per correspondence:
    d^T (C_b + R C_a R^T)^{-1} d with fast_gicp-regularised
    neighbourhood covariances on both clouds."""
    from . import pointcloud as _pcl

    Ca, va = _regularized_covs(source, corr_k)
    Cb, vb = _regularized_covs(target, corr_k)

    def step(carry, _):
        pose, _prev = carry
        tp = se3.apply(pose, source.xyz)
        d2, idx = _pcl.knn(tp, target, 1)
        j = idx[:, 0]
        q = target.xyz[j]
        ok = source.mask & va & vb[j] & (d2[:, 0] < max_corr_dist**2)
        w = ok.astype(jnp.float32)
        RCaRt = jnp.einsum("ab,nbc,dc->nad", pose.R, Ca, pose.R)
        M = jnp.linalg.inv(
            Cb[j] + RCaRt + 1e-6 * jnp.eye(3)
        )  # (N, 3, 3) mahalanobis weights
        r = tp - q
        J = jnp.concatenate(
            [jnp.broadcast_to(jnp.eye(3), (tp.shape[0], 3, 3)), -so3_hat(tp)],
            axis=-1,
        )  # (N, 3, 6)
        MJ = jnp.einsum("nab,nbi->nai", M, J)
        H = jnp.einsum("nai,naj,n->ij", J, MJ, w)
        b = -jnp.einsum("nai,na,n->i", MJ, r, w)
        dx = _gn_update(H + 1e-6 * jnp.eye(6), b, damping)
        new_pose = se3.compose(se3.exp(dx), pose)
        cost = jnp.einsum("na,nab,nb,n->", r, M, r, w) / jnp.maximum(
            jnp.sum(w), 1.0
        )
        return (new_pose, jnp.linalg.norm(dx)), (cost, jnp.sum(w))

    (pose, last_dx), (costs, inliers) = jax.lax.scan(
        step, (init, jnp.float32(jnp.inf)), None, length=iters
    )
    return RegistrationResult(
        pose=se3.normalize(pose),
        num_inliers=inliers[-1],
        error=costs[-1],
        fitness=costs[-1],
        converged=last_dx < tol,
    )


def so3_hat(v: jax.Array) -> jax.Array:
    """(N, 3) -> (N, 3, 3) skew matrices."""
    from ..geometry import so3

    return so3.hat(v)


@accurate
@jax.jit
def fitness(
    source: PointCloud,
    target: voxel_grid.VoxelGrid,
    pose: Pose,
    max_range: float = 1.0,
    min_match: float = 0.5,
) -> jax.Array:
    """PCL `getFitnessScore(max_range)` analogue — the loop acceptance
    gate (`global_manager.cpp:2058`, threshold 0.10; `main_RING.py:208`).

    PCL measures nearest-*point* distance; against a Gaussian voxel map
    the unbiased surface distance is point-to-plane against the matched
    cell's fitted plane (centroid distance carries an O(leaf/2) floor
    from intra-voxel spread even at perfect alignment). Non-planar cells
    fall back to centroid distance.

    PCL excludes unmatched points from the mean — correct for genuinely
    occluded regions (two viewpoints of the same place never fully
    overlap) but it can reward gross misalignment when only a sliver
    coincides. Compromise: average over matched points, and return the
    `max_range^2` ceiling whenever fewer than `min_match` of the source
    points found a correspondence."""
    tp = se3.apply(pose, source.xyz)
    found, cnt, mu, Cv = voxel_grid.lookup(target, tp, "direct27")
    dc2 = jnp.sum((mu - tp[:, None, :]) ** 2, axis=-1)
    dc2 = jnp.where(found, dc2, jnp.inf)
    best = jnp.argmin(dc2, axis=-1)
    mu_b, Cv_b = _select_best(best, dc2.shape[1], mu, Cv)
    dc2_b = jnp.min(dc2, axis=-1)
    evals, V = linalg3.eigh3(Cv_b + 1e-9 * jnp.eye(3))
    n = V[..., :, 0]
    planar = evals[..., 0] < 0.1 * jnp.maximum(evals[..., 1], 1e-9)
    dp2 = jnp.sum(n * (tp - mu_b), axis=-1) ** 2
    d2 = jnp.where(planar, dp2, dc2_b)
    w = source.mask.astype(jnp.float32)
    matched = (jnp.isfinite(dc2_b) & (d2 < max_range**2)).astype(jnp.float32) * w
    n_matched = jnp.sum(matched)
    mean_matched = jnp.sum(jnp.where(matched > 0, d2, 0.0)) / jnp.maximum(
        n_matched, 1.0
    )
    frac = n_matched / jnp.maximum(jnp.sum(w), 1.0)
    return jnp.where(frac >= min_match, mean_matched, max_range**2)


@accurate
def register_pair(
    source: PointCloud,
    target: PointCloud,
    init: Pose,
    leaf: float = 0.5,
    table_size: int = 1 << 15,
    method: str = "vgicp",
    iters: int = 20,
    max_corr_dist: float = 1.0,
) -> RegistrationResult:
    """Registration selector: what `select_registration_method`
    (`global_manager.cpp:2416-2462`) + `ICPCheck` (`:1945-2084`) do per
    candidate loop, minus the threads. Methods:

      "icp"            -> point-to-point (PCL_ICP)
      "gicp"           -> plane-to-plane GICP (PCL_GICP / FAST_GICP)
      "vgicp"          -> voxelized GICP (FAST_VGICP_CUDA; the
                          production default, launch:51)
      "point_to_plane" -> plane residual against the voxel map
    """
    if method == "icp":
        result = point_to_point_icp(
            source, target, init, iters=iters, max_corr_dist=max_corr_dist
        )
    elif method == "gicp":
        result = gicp(source, target, init, iters=iters, max_corr_dist=max_corr_dist)
    elif method == "vgicp":
        grid = voxel_grid.build(
            target, leaf, table_size, min_points=3, regularize="plane"
        )
        result = vgicp(source, grid, init, iters=iters, max_corr_dist=max_corr_dist)
    else:
        grid = voxel_grid.build(
            target, leaf, table_size, min_points=3, regularize="plane"
        )
        result = point_to_plane_icp(
            source, grid, init, iters=iters, max_corr_dist=max_corr_dist
        )
    # Score against a permissive grid: the registration grid drops
    # sparse (<3 point) cells, which would penalise clutter points that
    # do have a true nearest neighbour. Fitness is a mean — a 4x source
    # subsample scores the same statistics at a quarter of the direct27
    # gather cost (matches `loopstage.verify_chunk`'s scoring).
    fit_grid = voxel_grid.build(target, leaf, table_size, min_points=1)
    sub = PointCloud(source.xyz[::4], source.mask[::4])
    return result._replace(fitness=fitness(sub, fit_grid, result.pose))
