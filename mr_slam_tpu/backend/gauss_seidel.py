"""Decentralized Gauss-Seidel / Jacobi pose-graph optimization.

The reference's true *distributed* optimizer (`distributed_mapper.cpp`
+ `distributedOptimizer` in `distributed_mapper_utils.cpp:482+`) never
assembles the global system: each robot repeatedly solves only ITS
subgraph, taking its neighbors' current estimates as fixed priors over
the separator (inter-robot loop) edges —
  * `estimateRotation()` (`distributed_mapper.cpp:117-189`): linear
    chordal rotation system per robot, neighbor rotations as priors;
  * `estimatePoses()` (`:220-305`): chordal pose system per robot via
    `BetweenChordalFactor`, neighbor linearized poses as priors;
  * flagged initialization (`orderRobots`): a robot joins the sweep
    only once a neighbor is initialized; separator edges to
    uninitialized robots are ignored;
  * update modes: `incUpdate` (Gauss-Seidel, apply immediately) vs
    `postUpdate` (Jacobi, apply after the full sweep), with
    over-relaxation gamma (`distributed_mapper.h:110-123`).

Array formulation: robot subproblems are masked solves over the SAME
fixed-capacity arrays — the block solve for robot r runs matrix-free CG
where only rows with `node_robot == r` are free and every other node's
contribution is folded into the right-hand side. Sweeps are unrolled
(robot count is small and static); each robot's solve is itself batched
over all its nodes/edges. The edge-sharded CG optimizer in
`distributed.py` is the faster production path; this module exists for
algorithmic parity with the reference's decentralized scheme and as a
cross-check (with matching `robust_delta`, both optimizers share the
same fixed point on consistent graphs).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import so3
from ..geometry.se3 import Pose
from . import chordal
from .factor_graph import FactorGraph
from ..precision import accurate


class GSConfig(NamedTuple):
    rot_sweeps: int = 25        # rotation-stage sweeps over all robots
    pose_sweeps: int = 25       # pose-stage sweeps
    cg_iters: int = 15          # CG iterations per block solve
    gamma: float = 1.0          # over-relaxation (1 = plain GS)
    jacobi: bool = False        # postUpdate (Jacobi) vs incUpdate (GS)
    flagged_init: bool = True   # gate separators until both ends joined
    anchor_weight: float = 1e6
    damping: float = 1e-6
    robust_delta: float = 1.0   # Cauchy scale for loop edges (matches
                                # chordal.PGOConfig default); <=0 off


def _masked_cg(A, b, mask, iters):
    """CG for A x = b restricted to `mask` rows (others forced to 0).
    A must be linear; mask has shape b.shape[:1] and broadcasts."""
    m = mask.reshape(mask.shape[0], *([1] * (b.ndim - 1))).astype(b.dtype)

    def Am(x):
        return m * A(m * x)

    x0 = jnp.zeros_like(b)
    r0 = m * b

    def step(c, _):
        x, r, p, rs = c
        Ap = Am(p)
        alpha = rs / jnp.maximum(jnp.sum(p * Ap), 1e-12)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = jnp.sum(r * r)
        beta = rs_new / jnp.maximum(rs, 1e-12)
        p = r + beta * p
        return (x, r, p, rs_new), None

    (x, *_), _ = jax.lax.scan(step, (x0, r0, r0, jnp.sum(r0 * r0)), None,
                              length=iters)
    return x


def _robot_edge_gate(g: FactorGraph, initialized: jax.Array) -> jax.Array:
    """Flagged-init gate: a *separator* (inter-robot) edge participates
    only when the robots of both endpoints are initialized; intra-robot
    (odometry) edges always participate — the reference gates only
    separator edges (`distributed_mapper.cpp:157-163`)."""
    ri = g.node_robot[g.edge_i]
    rj = g.node_robot[g.edge_j]
    return (ri == rj) | (initialized[ri] & initialized[rj])


def _rotation_system(g: FactorGraph, gate: jax.Array, anchors: jax.Array,
                     aw: float):
    """Linear chordal rotation operator/rhs on X in R^{N x 3 x 3}:
    A(X) = grad of sum_e w_e |X_j - X_i Rij|_F^2 + anchor terms."""
    w = jnp.where(g.edge_valid & gate, g.edge_w_rot, 0.0)
    ei, ej, Rij = g.edge_i, g.edge_j, g.edge_meas.R
    a = anchors.astype(jnp.float32) * aw

    def A(X):
        d = X[ej] - jnp.einsum("eab,ebc->eac", X[ei], Rij)
        gi = -jnp.einsum("eab,ecb->eac", d, Rij)
        out = jnp.zeros_like(X)
        out = out.at[ei].add(w[:, None, None] * gi)
        out = out.at[ej].add(w[:, None, None] * d)
        return out + a[:, None, None] * X

    b_anchor = a[:, None, None] * g.poses.R
    return A, b_anchor


@accurate
@partial(jax.jit, static_argnames=("n_robots", "config"))
def optimize(
    g: FactorGraph,
    anchors: jax.Array,
    n_robots: int,
    config: GSConfig = GSConfig(),
) -> Pose:
    """Run the two-stage decentralized scheme; returns optimized poses.

    Sweep order is robot id (the reference orders by separator count;
    on the hub-and-spoke graphs it produces the same gating behavior).
    """
    N = g.node_capacity
    robots = jnp.arange(n_robots)

    # ---- flagged initialization schedule --------------------------------
    # robot 0 starts initialized; robot r joins at sweep index r (one new
    # robot per sweep), so by sweep n_robots-1 everyone participates.
    def initialized_at(sweep: jax.Array) -> jax.Array:
        if not config.flagged_init:
            return jnp.ones((n_robots,), bool)
        return robots <= sweep

    # ---- stage 1: rotation sweeps ---------------------------------------
    def rot_sweep(X, sweep):
        init = initialized_at(sweep)
        gate = _robot_edge_gate(g, init)
        A, b_anchor = _rotation_system(g, gate, anchors, config.anchor_weight)

        def block(X, r):
            m = (g.node_robot == r) & g.node_valid
            # fold fixed rows into rhs: solve A x = b - A(X_fixed) on m
            mN = m[:, None, None].astype(X.dtype)
            X_fixed = (1.0 - mN) * X
            b = b_anchor - A(X_fixed)
            x = _masked_cg(A, b, m, config.cg_iters)
            X_new = X_fixed + x
            # uninitialized robots keep their current estimate (the
            # reference skips their update entirely)
            upd = config.gamma * init[r].astype(X.dtype)
            return X + upd * (X_new - X) * mN

        if config.jacobi:
            X0 = X
            delta = jnp.zeros_like(X)
            for r in range(n_robots):
                delta = delta + block(X0, r) - X0
            X = X0 + delta
        else:
            for r in range(n_robots):
                X = block(X, r)
        return X, None

    X0 = g.poses.R
    X, _ = jax.lax.scan(rot_sweep, X0, jnp.arange(config.rot_sweeps))
    R = so3.project(X)
    R = jnp.where(g.node_valid[:, None, None], R, g.poses.R)

    # ---- stage 2: chordal pose sweeps -----------------------------------
    # One GN linearization per sweep (reference re-linearizes per
    # iteration); robot blocks solve the normal equations with neighbor
    # (phi, dt) fixed at 0 — i.e. neighbors' current poses as priors.
    aw = anchors.astype(jnp.float32) * config.anchor_weight
    anchor_R0, anchor_t0 = g.poses.R, g.poses.t

    def pose_sweep(carry, sweep):
        R, t = carry
        # the pose stage starts fully initialized: every robot joined
        # during the rotation stage (global sweep counter, not stage-local)
        init = initialized_at(sweep + config.rot_sweeps)
        gate = _robot_edge_gate(g, init)
        r_res, J = chordal._residuals_and_jac(R, t, g)
        # same Cauchy IRLS loop weighting as chordal.optimize, so both
        # optimizers share a fixed point for matching robust_delta
        row_w = chordal._edge_block_weight(g, r_res, config.robust_delta)
        row_w = row_w * gate.astype(jnp.float32)[:, None]
        ei, ej = g.edge_i, g.edge_j

        def Hx(x):
            xi, xj = x[ei], x[ej]
            Jx = (
                jnp.einsum("erc,ec->er", J["phi_i"], xi[:, 0:3])
                + jnp.einsum("erc,ec->er", J["dt_i"], xi[:, 3:6])
                + jnp.einsum("erc,ec->er", J["phi_j"], xj[:, 0:3])
                + jnp.einsum("erc,ec->er", J["dt_j"], xj[:, 3:6])
            )
            WJx = row_w * Jx
            gi = jnp.concatenate(
                [jnp.einsum("erc,er->ec", J["phi_i"], WJx),
                 jnp.einsum("erc,er->ec", J["dt_i"], WJx)], axis=1)
            gj = jnp.concatenate(
                [jnp.einsum("erc,er->ec", J["phi_j"], WJx),
                 jnp.einsum("erc,er->ec", J["dt_j"], WJx)], axis=1)
            out = jnp.zeros_like(x).at[ei].add(gi).at[ej].add(gj)
            return out + (aw[:, None] + config.damping) * x

        Wr = row_w * r_res
        bi = jnp.concatenate(
            [jnp.einsum("erc,er->ec", J["phi_i"], Wr),
             jnp.einsum("erc,er->ec", J["dt_i"], Wr)], axis=1)
        bj = jnp.concatenate(
            [jnp.einsum("erc,er->ec", J["phi_j"], Wr),
             jnp.einsum("erc,er->ec", J["dt_j"], Wr)], axis=1)
        b = -(jnp.zeros((N, 6)).at[ei].add(bi).at[ej].add(bj))
        phi_anchor = so3.log(jnp.einsum("nab,ncb->nac", R, anchor_R0))
        b = b - aw[:, None] * jnp.concatenate([phi_anchor, t - anchor_t0],
                                              axis=1)

        def block(x, r):
            m = (g.node_robot == r) & g.node_valid
            mN = m[:, None].astype(x.dtype)
            x_fixed = (1.0 - mN) * x
            rhs = b - Hx(x_fixed)
            sol = _masked_cg(Hx, rhs, m, config.cg_iters)
            x_new = x_fixed + sol
            upd = config.gamma * init[r].astype(x.dtype)
            return x + upd * (x_new - x) * mN

        x = jnp.zeros((N, 6))
        if config.jacobi:
            delta = jnp.zeros_like(x)
            for r in range(n_robots):
                delta = delta + block(x, r) - x
            x = x + delta
        else:
            for r in range(n_robots):
                x = block(x, r)

        phi, dt = x[:, 0:3], x[:, 3:6]
        R_new = jnp.einsum("nab,nbc->nac", so3.exp(phi), R)
        t_new = t + dt
        R_new = jnp.where(g.node_valid[:, None, None], R_new, R)
        t_new = jnp.where(g.node_valid[:, None], t_new, t)
        return (R_new, t_new), jnp.sum(r_res * r_res * row_w)

    (R, t), costs = jax.lax.scan(
        pose_sweep, (R, g.poses.t), jnp.arange(config.pose_sweeps))
    return Pose(so3.project(R), t)
