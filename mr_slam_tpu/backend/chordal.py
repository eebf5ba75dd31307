"""Two-stage chordal pose-graph optimization, matrix-free on the device.

The production optimizer of the reference is
`evaluation_utils::centralizedGNEstimation`
(`distributed_mapper/evaluation_utils.cpp:273-331`):
  stage 1 — chordal rotation relaxation: solve the sparse linear system
            over stacked rotation-matrix rows, project to SO(3);
  stage 2 — Gauss-Newton on a BetweenChordalFactor graph (12-d residual
            per edge: rotation chordal error + frame-local translation
            error) for a fixed 200 iterations.

gtsam factors that into sparse Cholesky on CPU. This design
replaces the sparse solve with matrix-free preconditioned conjugate
gradients: every Hx product is a batched gather over edge endpoints, a
dense per-edge (12x6x2) Jacobian contraction, and a scatter-add back to
nodes — no factorization, no dynamic sparsity, batched dense math.

State is the product manifold SO(3)^N x R^{3N} (rotations retract by
left exp; translations add) — the same chart gtsam's chordal stage uses.
Robust m-estimator weights (Cauchy, `global_manager.cpp:640-643`) gate
loop edges by iteratively reweighted least squares.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import se3, so3
from ..geometry.se3 import Pose
from .factor_graph import FactorGraph, PRIOR
from ..precision import accurate


class PGOConfig(NamedTuple):
    rot_cg_iters: int = 60       # stage-1 CG iterations
    gn_iters: int = 12           # stage-2 outer GN iterations
    pose_cg_iters: int = 40      # CG iterations per GN step
    anchor_weight: float = 1e6   # prior strength (ref prior noise 1e-15)
    robust_delta: float = 1.0    # Cauchy scale for loop edges; <=0 off
    damping: float = 1e-5


# ---------------------------------------------------------------------------
# Stage 1: rotation chordal relaxation
# ---------------------------------------------------------------------------


def _edge_weights(g: FactorGraph):
    w = jnp.where(g.edge_valid, 1.0, 0.0)
    return w * g.edge_w_rot, w * g.edge_w_trans


def _preduce(x, axis_name):
    """Sum edge-scatter partials across shards (no-op single-shard)."""
    return x if axis_name is None else jax.lax.psum(x, axis_name)


@accurate
@partial(jax.jit, static_argnames=("iters", "axis_name", "anchor_weight"))
def rotation_init(
    g: FactorGraph,
    anchors: jax.Array,
    iters: int = 60,
    axis_name: str | None = None,
    anchor_weight: float = 1e3,
) -> jax.Array:
    """Solve min sum_e w_e |X_j - X_i Rij|_F^2 (+ anchored rotations)
    over X in R^{N x 3 x 3} by CG on the normal equations; project the
    result to SO(3). `anchors`: (N,) bool — nodes pinned to their
    current rotation (first node per robot).

    `anchor_weight` defaults softer than the pose stage's
    (PGOConfig.anchor_weight): the linear rotation system is solved from
    a warm start in `iters` CG steps, and a 1e6 anchor row makes it so
    ill-conditioned that CG stalls on the anchor residual.

    This is `estimateRotation()`'s linear system
    (`distributed_mapper.cpp:117-189`) solved globally instead of by
    Gauss-Seidel sweeps over robots.
    """
    N = g.node_capacity
    w_rot, _ = _edge_weights(g)
    Rij = g.edge_meas.R
    ei, ej = g.edge_i, g.edge_j
    anchor_R = g.poses.R
    aw = anchors.astype(jnp.float32) * anchor_weight

    def A(X):
        Xi = X[ei]
        Xj = X[ej]
        # residual gradient contributions of |Xj - Xi Rij|^2
        d = Xj - jnp.einsum("eab,ebc->eac", Xi, Rij)
        gi = -jnp.einsum("eab,ecb->eac", d, Rij)  # d * Rij^T with sign
        gj = d
        out = jnp.zeros_like(X)
        out = out.at[ei].add(w_rot[:, None, None] * gi)
        out = out.at[ej].add(w_rot[:, None, None] * gj)
        out = _preduce(out, axis_name)
        return out + aw[:, None, None] * X

    b = aw[:, None, None] * anchor_R
    # CG solve A X = b (A is PSD)
    X0 = anchor_R  # warm start from current estimate

    def cg_step(carry, _):
        X, r, p, rs = carry
        Ap = A(p)
        alpha = rs / jnp.maximum(jnp.sum(p * Ap), 1e-12)
        X = X + alpha * p
        r = r - alpha * Ap
        rs_new = jnp.sum(r * r)
        beta = rs_new / jnp.maximum(rs, 1e-12)
        p = r + beta * p
        return (X, r, p, rs_new), rs_new

    r0 = b - A(X0)
    (X, *_), _ = jax.lax.scan(
        cg_step, (X0, r0, r0, jnp.sum(r0 * r0)), None, length=iters
    )
    return so3.project(X)


# ---------------------------------------------------------------------------
# Stage 2: BetweenChordalFactor Gauss-Newton
# ---------------------------------------------------------------------------


def _hat_cols(M: jax.Array) -> jax.Array:
    """(..., 3, 3) matrix -> (..., 9, 3) stack of -hat(column_k):
    d vec(exp(phi) M) / d phi."""
    cols = jnp.swapaxes(M, -1, -2)  # (..., 3_col, 3): [.., k, :] = column k
    return -so3.hat(cols).reshape(*M.shape[:-2], 9, 3)


def _residuals_and_jac(R: jax.Array, t: jax.Array, g: FactorGraph):
    """Per-edge chordal residual (12,) and Jacobian blocks wrt
    (phi_i, dt_i, phi_j, dt_j), each (E, 12, 3).

    e_R = vec(R_i Rij - R_j)                       (9,)
    e_t = (R_i tij + t_i) - t_j                     (3,)
    Left perturbation: R <- exp(phi) R, t <- t + dt.
    """
    ei, ej = g.edge_i, g.edge_j
    Ri, Rj = R[ei], R[ej]
    ti, tj = t[ei], t[ej]
    Rij, tij = g.edge_meas.R, g.edge_meas.t
    Mi = jnp.einsum("eab,ebc->eac", Ri, Rij)  # R_i Rij
    e_R = (Mi - Rj).swapaxes(-1, -2).reshape(-1, 9)  # vec by columns
    ri_tij = jnp.einsum("eab,eb->ea", Ri, tij)
    e_t = ri_tij + ti - tj
    E = ei.shape[0]
    z93 = jnp.zeros((E, 9, 3))
    z33 = jnp.zeros((E, 3, 3))
    eye3 = jnp.broadcast_to(jnp.eye(3), (E, 3, 3))
    # rotation rows
    J_phi_i_R = _hat_cols(Mi)          # d e_R / d phi_i
    J_phi_j_R = -_hat_cols(Rj)         # d e_R / d phi_j
    # translation rows
    J_phi_i_t = -so3.hat(ri_tij)       # d e_t / d phi_i = -hat(R_i tij)
    J = {
        "phi_i": jnp.concatenate([J_phi_i_R, J_phi_i_t], axis=1),  # (E, 12, 3)
        "dt_i": jnp.concatenate([z93, eye3], axis=1),
        "phi_j": jnp.concatenate([J_phi_j_R, z33], axis=1),
        "dt_j": jnp.concatenate([z93, -eye3], axis=1),
    }
    r = jnp.concatenate([e_R, e_t], axis=1)  # (E, 12)
    return r, J


def _edge_block_weight(g: FactorGraph, r: jax.Array, robust_delta: float):
    """(E, 12) per-row weights: rotation rows w_rot, translation rows
    w_trans, scaled by a Cauchy IRLS factor on loop edges."""
    w_rot, w_trans = _edge_weights(g)
    row_w = jnp.concatenate(
        [jnp.repeat(w_rot[:, None], 9, axis=1), jnp.repeat(w_trans[:, None], 3, axis=1)],
        axis=1,
    )
    if robust_delta > 0:
        # Cauchy weight on the whole residual of non-odometry edges
        e2 = jnp.sum(r * r * row_w, axis=1)
        cw = 1.0 / (1.0 + e2 / (robust_delta**2))
        is_loop = g.edge_kind != 0
        cw = jnp.where(is_loop, cw, 1.0)
        row_w = row_w * cw[:, None]
    return row_w


@accurate
@partial(jax.jit, static_argnames=("config", "axis_name"))
def optimize(
    g: FactorGraph,
    anchors: jax.Array,
    config: PGOConfig = PGOConfig(),
    axis_name: str | None = None,
) -> Pose:
    """Full two-stage chordal optimization. Returns optimized poses
    (invalid nodes keep their input pose).

    `anchors`: (N,) bool — one per connected component (the reference
    anchors each robot's first pose with a near-zero-noise prior).

    `axis_name`: when called under `shard_map` with the EDGE arrays
    sharded over that mesh axis and node arrays replicated, every
    edge-scatter reduction is psum'd — the distributed optimizer
    (subsumes distributed-mapper's Gauss-Seidel message passing,
    `distributed_mapper_utils.cpp:482+`, with a globally-convergent CG).
    """
    N = g.node_capacity
    R = rotation_init(g, anchors, config.rot_cg_iters, axis_name)
    R = jnp.where(g.node_valid[:, None, None], R, g.poses.R)
    t = g.poses.t
    aw = anchors.astype(jnp.float32) * config.anchor_weight
    anchor_R0 = g.poses.R
    anchor_t0 = g.poses.t

    def gn_step(carry, _):
        R, t = carry
        r, J = _residuals_and_jac(R, t, g)
        row_w = _edge_block_weight(g, r, config.robust_delta)

        ei, ej = g.edge_i, g.edge_j

        def Hx(x):
            """x: (N, 6) [phi, dt] -> H x (Gauss-Newton normal matrix)."""
            xi, xj = x[ei], x[ej]
            # per-edge J x
            Jx = (
                jnp.einsum("erc,ec->er", J["phi_i"], xi[:, 0:3])
                + jnp.einsum("erc,ec->er", J["dt_i"], xi[:, 3:6])
                + jnp.einsum("erc,ec->er", J["phi_j"], xj[:, 0:3])
                + jnp.einsum("erc,ec->er", J["dt_j"], xj[:, 3:6])
            )
            WJx = row_w * Jx
            gi = jnp.concatenate(
                [
                    jnp.einsum("erc,er->ec", J["phi_i"], WJx),
                    jnp.einsum("erc,er->ec", J["dt_i"], WJx),
                ],
                axis=1,
            )
            gj = jnp.concatenate(
                [
                    jnp.einsum("erc,er->ec", J["phi_j"], WJx),
                    jnp.einsum("erc,er->ec", J["dt_j"], WJx),
                ],
                axis=1,
            )
            out = jnp.zeros_like(x).at[ei].add(gi).at[ej].add(gj)
            out = _preduce(out, axis_name)
            # anchor prior on both phi and dt + damping
            return out + (aw[:, None] + config.damping) * x

        # gradient b = -J^T W r (+ anchor pull toward initial anchor pose)
        Wr = row_w * r
        bi = jnp.concatenate(
            [
                jnp.einsum("erc,er->ec", J["phi_i"], Wr),
                jnp.einsum("erc,er->ec", J["dt_i"], Wr),
            ],
            axis=1,
        )
        bj = jnp.concatenate(
            [
                jnp.einsum("erc,er->ec", J["phi_j"], Wr),
                jnp.einsum("erc,er->ec", J["dt_j"], Wr),
            ],
            axis=1,
        )
        b = -_preduce(jnp.zeros((N, 6)).at[ei].add(bi).at[ej].add(bj), axis_name)
        # anchor residual pull (keep anchors at their initial pose)
        phi_anchor = so3.log(jnp.einsum("nab,ncb->nac", R, anchor_R0))
        b = b - aw[:, None] * jnp.concatenate([phi_anchor, t - anchor_t0], axis=1)

        # Jacobi-preconditioned CG
        diag = (
            _preduce(_hessian_diag(J, row_w, ei, ej, N), axis_name)
            + aw[:, None]
            + config.damping
        )
        Minv = 1.0 / jnp.maximum(diag, 1e-8)

        def cg_step(c, _):
            x, r_, p, rz = c
            Ap = Hx(p)
            alpha = rz / jnp.maximum(jnp.sum(p * Ap), 1e-12)
            x = x + alpha * p
            r_ = r_ - alpha * Ap
            z = Minv * r_
            rz_new = jnp.sum(r_ * z)
            beta = rz_new / jnp.maximum(rz, 1e-12)
            p = z + beta * p
            return (x, r_, p, rz_new), None

        x0 = jnp.zeros((N, 6))
        r0 = b
        z0 = Minv * r0
        (x, *_), _ = jax.lax.scan(
            cg_step, (x0, r0, z0, jnp.sum(r0 * z0)), None,
            length=config.pose_cg_iters,
        )
        phi, dt = x[:, 0:3], x[:, 3:6]
        R_new = jnp.einsum("nab,nbc->nac", so3.exp(phi), R)
        t_new = t + dt
        # only update valid nodes
        R_new = jnp.where(g.node_valid[:, None, None], R_new, R)
        t_new = jnp.where(g.node_valid[:, None], t_new, t)
        return (R_new, t_new), _preduce(jnp.sum(r * r * row_w), axis_name)

    (R, t), costs = jax.lax.scan(
        gn_step, (R, t), None, length=config.gn_iters
    )
    return Pose(so3.project(R), t)


def _hessian_diag(J, row_w, ei, ej, N):
    """(N, 6) diagonal of the GN normal matrix for Jacobi precond."""
    di = jnp.concatenate(
        [
            jnp.einsum("erc,er->ec", J["phi_i"] ** 2, row_w),
            jnp.einsum("erc,er->ec", J["dt_i"] ** 2, row_w),
        ],
        axis=1,
    )
    dj = jnp.concatenate(
        [
            jnp.einsum("erc,er->ec", J["phi_j"] ** 2, row_w),
            jnp.einsum("erc,er->ec", J["dt_j"] ** 2, row_w),
        ],
        axis=1,
    )
    return jnp.zeros((N, 6)).at[ei].add(di).at[ej].add(dj)
