"""Pairwise Consistency Maximization (PCM) inter-robot loop gating.

Re-design of the vendored lajoiepy stack (`pairwise_consistency_
maximization/`): two inter-robot loops (a_i -> b_j, Z1) and
(a_k -> b_l, Z2) are *consistent* when the cycle

    Z1^-1 . (x_{a_i}^-1 x_{a_k}) . Z2 . (x_{b_l}^-1 x_{b_j})

is near identity under a Mahalanobis norm
(`pairwise_consistency.cpp:99-137`, identity covariance). The largest
mutually-consistent subset is the maximum clique of the consistency
graph (`fast_max-clique_finder`, heuristic mode in production —
`global_manager.cpp:1305`).

Device/host split: the O(L^2) consistency matrix is one batched pose-algebra op;
the max clique is inherently combinatorial and runs on host over the
tiny boolean matrix (L = active loop count, tens), exactly where the
reference runs it. A greedy+local-search heuristic matches
`findCliqueHeu.cpp`; loop counts here never justify the exact
branch-and-bound twin.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry import se3
from ..geometry.se3 import Pose

# chi2 inverse CDF at 6 dof for the reference's pcm_thresh table
# (`pairwise_consistency.cpp:7-38`: threshold prob -> chi2 value)
CHI2_6DOF = {
    0.01: 0.872,
    0.05: 1.635,
    0.10: 2.204,
    0.25: 3.455,
    0.50: 5.348,
    0.75: 7.840,
}


@jax.jit
def consistency_matrix(
    poses_a: Pose,      # (L,) robot-a keyframe odometry poses at loop ends
    poses_b: Pose,      # (L,) robot-b keyframe odometry poses at loop ends
    meas: Pose,         # (L,) loop measurements: b-frame <- a-frame
    valid: jax.Array,   # (L,)
    rot_sigma: float = 0.1,
    trans_sigma: float = 0.5,
    idx_a: jax.Array | None = None,   # (L,) keyframe indices, robot a
    idx_b: jax.Array | None = None,   # (L,) keyframe indices, robot b
    odo_drift_t: float = 0.0,         # per-step odometry drift std (m)
    odo_drift_r: float = 0.0,         # per-step odometry drift std (rad)
    step_len: float = 0.0,            # mean travel per keyframe step (m)
) -> jax.Array:
    """(L, L) squared consistency distances (chi2-comparable, 6 dof).

    For loops k, l: err_kl = log( Z_k^-1 A_kl Z_l B_lk ) with
    A_kl = x_{a_k}^-1 x_{a_l} (robot-a odometry between the two loop
    anchor frames) and B_lk = x_{b_l}^-1 x_{b_k}. Invalid pairs +inf.

    Covariance model: the cycle error mixes loop-measurement noise
    (rot_sigma/trans_sigma) with odometry drift accumulated over the
    chain segments inside the cycle. With `idx_a/idx_b` (keyframe
    indices of the anchors) and per-step drift PSDs, the per-pair
    variance grows linearly with the cycle's step count — the diagonal
    first-order analogue of composing covariances along the cycle
    (`graph_utils_functions.cpp` composeOnTrajectory). Without them the
    fixed-sigma behavior (the reference's identity covariance,
    `pairwise_consistency.cpp:131-137`) is unchanged. Omitting this
    length term falsely rejects long-cycle loop pairs on drifty
    trajectories — measured on the bench stress grid as a 1/3 false
    rejection rate.
    """
    L = valid.shape[0]
    if idx_a is None:
        steps = jnp.zeros((L, L), jnp.float32)
    else:
        steps = (
            jnp.abs(idx_a[:, None] - idx_a[None, :])
            + jnp.abs(idx_b[:, None] - idx_b[None, :])
        ).astype(jnp.float32)

    def pair(k, l):
        A = se3.between(se3.index(poses_a, k), se3.index(poses_a, l))
        B = se3.between(se3.index(poses_b, l), se3.index(poses_b, k))
        Zk = se3.index(meas, k)
        Zl = se3.index(meas, l)
        cycle = se3.compose(
            se3.compose(se3.inverse(Zk), A), se3.compose(Zl, B)
        )
        xi = se3.log(cycle)
        lever2 = jnp.maximum(
            jnp.sum(A.t**2), jnp.sum(B.t**2)
        )  # chain-segment span: the arm rotation drift acts on
        return jnp.sum(xi[0:3] ** 2), jnp.sum(xi[3:6] ** 2), lever2

    ks = jnp.arange(L)
    T2, R2, LEV2 = jax.vmap(lambda k: jax.vmap(lambda l: pair(k, l))(ks))(ks)
    # translation variance: measurement + per-step translation walk +
    # rotation drift acting on the segment lever (the dominant term on
    # long cycles: an early heading error of drift_r displaces the far
    # anchor by drift_r * lever per step)
    # random-walk heading drift integrates over the remaining path:
    # a step-k rotation error of drift_r displaces the far anchor by
    # drift_r * (path left) -> variance ~ drift_r^2 step_len^2 steps^3/3
    # (dominates on closed long cycles, where the anchor-to-anchor
    # lever is near zero but the traversed path is not)
    var_t = (
        trans_sigma**2
        + steps * odo_drift_t**2
        + steps * odo_drift_r**2 * LEV2
        + odo_drift_r**2 * step_len**2 * steps**3 / 3.0
    )
    var_r = rot_sigma**2 + steps * odo_drift_r**2
    M = T2 / var_t + R2 / var_r
    ok = valid[:, None] & valid[None, :]
    return jnp.where(ok, M, jnp.inf)


def max_clique(adj: np.ndarray) -> np.ndarray:
    """Maximum clique: native exact branch-and-bound when the C++
    library is built (`native/maxclique.cpp`, the twin of the
    reference's fast_max-clique_finder), else the greedy heuristic."""
    from .. import native

    result = native.max_clique(np.asarray(adj, bool))
    if result is not None:
        return result
    return max_clique_greedy(np.asarray(adj, bool))


def max_clique_greedy(adj: np.ndarray, restarts: int = 32, seed: int = 0) -> np.ndarray:
    """Heuristic maximum clique on a boolean adjacency matrix (host).

    Greedy-by-degree with randomized restarts + 1-swap local search —
    the same flavour as `findCliqueHeu.cpp` (Pattabiraman et al.
    heuristic). Returns indices of the best clique found.
    """
    n = adj.shape[0]
    if n == 0:
        return np.zeros((0,), np.int64)
    adj = np.asarray(adj, bool).copy()
    np.fill_diagonal(adj, False)
    rng = np.random.default_rng(seed)
    best: np.ndarray = np.zeros((0,), np.int64)
    degrees = adj.sum(1)
    for it in range(restarts):
        if it == 0:
            order = np.argsort(-degrees)
        else:
            order = rng.permutation(n)
        clique: list[int] = []
        cand = np.ones(n, bool)
        for v in order:
            if cand[v]:
                clique.append(v)
                cand &= adj[v]
        c = np.array(sorted(clique), np.int64)
        if len(c) > len(best):
            best = c
    return best


def filter_loops(
    poses_a: Pose,
    poses_b: Pose,
    meas: Pose,
    valid: np.ndarray | jax.Array,
    threshold: float = 0.872,  # pcm_thresh 0.01 (`global_manager.launch:45`)
    rot_sigma: float = 0.1,
    trans_sigma: float = 0.5,
    idx_a=None,
    idx_b=None,
    odo_drift_t: float = 0.0,
    odo_drift_r: float = 0.0,
    step_len: float = 0.0,
) -> np.ndarray:
    """Full PCM pass for one robot pair: consistency matrix (device) ->
    max clique (host) -> (L,) bool accept mask — what `solveCentralized`
    does before erasing rejected factors (`distributed_pcm.cpp:37-66`)."""
    M = consistency_matrix(
        poses_a, poses_b, meas, jnp.asarray(valid), rot_sigma, trans_sigma,
        idx_a=None if idx_a is None else jnp.asarray(idx_a),
        idx_b=None if idx_b is None else jnp.asarray(idx_b),
        odo_drift_t=odo_drift_t, odo_drift_r=odo_drift_r,
        step_len=step_len,
    )
    M = np.asarray(M)
    v = np.asarray(valid, bool)
    adj = (M < threshold) & (M.T < threshold)
    adj &= v[:, None] & v[None, :]
    clique = max_clique(adj)
    keep = np.zeros(v.shape[0], bool)
    keep[clique] = True
    # singleton graphs: a single valid loop has no pair support; the
    # reference keeps it (PCM only prunes when contradictions exist)
    if v.sum() == 1:
        keep = v.copy()
    return keep


@jax.jit
def intra_cycle_distances(
    poses: Pose,        # (L,) odometry poses at kf_a (same robot)
    poses_b: Pose,      # (L,) odometry poses at kf_b
    meas: Pose,         # (L,) loop measurements: b-frame <- a-frame
    idx_a: jax.Array,   # (L,) keyframe indices
    idx_b: jax.Array,
    trans_sigma: float = 0.5,
    rot_sigma: float = 0.1,
    odo_drift_t: float = 0.02,
    odo_drift_r: float = 0.002,
    step_len: float = 0.0,
) -> jax.Array:
    """Single-loop odometry-cycle consistency for SAME-robot loops:
    d2 = || log( Z^-1 . (x_a^-1 x_b) ) ||^2 under the drift-aware
    cycle covariance of `consistency_matrix`. Intra-robot loops never
    enter PCM (no robot pair), so a grossly wrong intra loop reaches
    the optimizer unchecked; this is the reference's odometry-space
    sanity gating (`detectLoopClosure`'s radius checks,
    `global_manager.cpp:1029-1094`) in chi2 form."""
    odo = se3.between(poses, poses_b)
    cycle = se3.compose(se3.inverse(meas), odo)
    xi = se3.log(cycle)
    steps = jnp.abs(idx_a - idx_b).astype(jnp.float32)
    lever2 = jnp.sum(odo.t**2, axis=-1)
    var_t = (
        trans_sigma**2 + steps * odo_drift_t**2
        + steps * odo_drift_r**2 * lever2
        + odo_drift_r**2 * step_len**2 * steps**3 / 3.0
    )
    var_r = rot_sigma**2 + steps * odo_drift_r**2
    return (
        jnp.sum(xi[..., 0:3] ** 2, -1) / var_t
        + jnp.sum(xi[..., 3:6] ** 2, -1) / var_r
    )
