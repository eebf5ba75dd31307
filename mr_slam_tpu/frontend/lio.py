"""FAST-LIO2-style lidar-inertial odometry as one jitted filter step.

Re-design of `Localization/src/FAST_LIO` (SURVEY.md §2.5): the reference
runs a 23-state manifold iterated error-state EKF (IKFoM) whose
measurement model is an OpenMP loop of per-point ikd-tree 5-NN plane
residuals (`laserMapping.cpp:634-766`), IMU forward-propagation +
backward undistortion (`IMU_Processing.hpp:65`), and ikd-tree insertion.

The formulation here is a 24-dof error-state filter
dx = [dphi, dp, dv, dbg, dba, dphi_e, dp_e, dgrav] (left/world-frame
rotation perturbation R_true = exp(dphi) R_hat; (dphi_e, dp_e) perturb
the lidar-IMU extrinsic R_li <- exp(dphi_e) R_li, t_li <- t_li + dp_e;
dgrav refines the gravity vector, retracted to |g| = 9.81 after each
update — together the reference's online-calibrated extrinsic + S2
gravity states of `use-ikfom.hpp`'s 23-state. Gravity is initialized at
rest by `imu_init` — the reference's `IMU_init`,
`IMU_Processing.hpp:64`; both refinements are opt-in flags with tight
priors — they are calibrations, not dynamic states):

  * `propagate` integrates the IMU packet with a per-sample first-order
    covariance propagation P <- F P F^T + Q (a `lax.scan` of 24x24
    matmuls — free next to the point kernels); the extrinsic block is
    constant (no process noise — it is a calibration, not a dynamic
    state);
  * `update` runs the iterated measurement update as MAP Gauss-Newton
    with the propagated prior:  ||dx||^2_{P^-1} + sum_i ||h_i||^2_R.
    Point-to-plane residuals touch (R, p) and — when
    `estimate_extrinsics` — (R_li, t_li); velocity and the biases
    correct through the prior cross-covariances built during
    propagation (the same mechanism as the IKFoM update), and the
    posterior covariance contracts to (J^T W J + P^-1)^-1 — the
    information-form (I - KH) P.

Frames: lidar scans stay in the LIDAR frame throughout; the filter pose
(R, p) is world <- IMU/body; `lidar_pose()` composes the extrinsic in.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import se3, so3
from ..geometry.se3 import Pose
from ..ops import linalg3, pointcloud as pcl, voxel_grid
from ..precision import accurate

GRAVITY = jnp.array([0.0, 0.0, -9.81])

_DOF = 24  # [dphi, dp, dv, dbg, dba, dphi_e, dp_e, dgrav]


class ImuSample(NamedTuple):
    gyro: jax.Array   # (..., 3) rad/s
    acc: jax.Array    # (..., 3) m/s^2 (specific force, body frame)
    dt: jax.Array     # (...,) s


class LioState(NamedTuple):
    R: jax.Array      # (3, 3) world <- IMU body
    p: jax.Array      # (3,)
    v: jax.Array      # (3,)
    bg: jax.Array     # (3,) gyro bias
    ba: jax.Array     # (3,) accel bias
    R_li: jax.Array   # (3, 3) IMU <- lidar extrinsic rotation
    t_li: jax.Array   # (3,) IMU <- lidar extrinsic translation
    grav: jax.Array   # (3,) gravity vector, world frame
    P: jax.Array      # (24, 24) error covariance
    grid: voxel_grid.VoxelGrid
    frame: jax.Array

    def pose(self) -> Pose:
        """world <- IMU body."""
        return Pose(self.R, self.p)

    def lidar_pose(self) -> Pose:
        """world <- lidar: T_wb o T_bl."""
        return Pose(self.R @ self.R_li, self.R @ self.t_li + self.p)


class LioConfig(NamedTuple):
    map_leaf: float = 1.0
    insert_leaf: float = 0.15
    scan_leaf: float = 0.4
    scan_capacity: int = 4096
    insert_capacity: int = 16384
    table_size: int = 1 << 17
    map_radius: float = 120.0
    iters: int = 4                 # IEKF / GN iterations
    max_corr_dist: float = 1.0
    gyro_noise: float = 1e-3       # PSD (rad^2/s)
    acc_noise: float = 1e-2        # PSD (m^2/s^3)
    bias_rw: float = 1e-5          # bias random-walk PSD
    lidar_noise: float = 0.05      # per-residual std (m)
    estimate_extrinsics: bool = False  # online R_li/t_li refinement
    extrinsic_prior: float = 1e-4  # initial extrinsic variance when
                                   # estimating (rad^2 / m^2)
    extrinsic_rw: float = 1e-7     # tiny extrinsic random walk: keeps the
                                   # calibration plastic instead of frozen
                                   # by the first (weakly-observable)
                                   # posterior contraction
    estimate_gravity: bool = False  # refine the gravity vector online
                                    # (IKFoM's S2 manifold state; ours is
                                    # a 3-dof tangent renormalized to
                                    # 9.81 after each update)
    gravity_prior: float = 1e-3     # initial gravity variance (m^2/s^4)
    gravity_rw: float = 0.0         # gravity random walk (0: constant)
    extrinsic_step: float = 2e-3   # trust region: max extrinsic correction
                                   # per GN iteration (rad / m). The scan-
                                   # to-map measurement cannot separate
                                   # dphi from R dphi_e within one heading;
                                   # unclamped, registration error of the
                                   # (self-built, initially-distorted) map
                                   # dumps into the extrinsic and feeds
                                   # back through inserts. Clamped, the
                                   # extrinsic converges as a slow servo
                                   # on the persistent, heading-dependent
                                   # part of the residual — the part only
                                   # a true mount error produces.


def init(
    config: LioConfig,
    origin: Pose | None = None,
    extrinsic: Pose | None = None,
) -> LioState:
    """`extrinsic`: initial IMU <- lidar transform (the per-robot YAML
    `extrinsic_R`/`extrinsic_T`, `FAST_LIO/config/*.yaml`); identity if
    None. With `config.estimate_extrinsics` it is refined online from
    `extrinsic_prior` uncertainty; otherwise held fixed."""
    if origin is None:
        origin = se3.identity()
    if extrinsic is None:
        extrinsic = se3.identity()
    P0 = jnp.zeros((_DOF, _DOF)).at[:15, :15].set(jnp.eye(15) * 1e-2)
    # biases start uncertain so the update can pull them in
    P0 = P0.at[9:15, 9:15].set(jnp.eye(6) * 1e-3)
    if config.estimate_extrinsics:
        P0 = P0.at[15:21, 15:21].set(jnp.eye(6) * config.extrinsic_prior)
    if config.estimate_gravity:
        P0 = P0.at[21:24, 21:24].set(jnp.eye(3) * config.gravity_prior)
    return LioState(
        R=origin.R, p=origin.t, v=jnp.zeros(3), bg=jnp.zeros(3),
        ba=jnp.zeros(3), R_li=extrinsic.R, t_li=extrinsic.t,
        grav=GRAVITY,
        P=P0,
        grid=voxel_grid.empty(config.map_leaf, config.table_size),
        frame=jnp.int32(0),
    )


@accurate
@jax.jit
def imu_init(state: LioState, imu: ImuSample) -> LioState:
    """Static initialization from a rest prefix (`IMU_init`,
    `IMU_Processing.hpp:64`): the gyro mean is the gyro bias; the accel
    mean direction aligns gravity (magnitude pinned to 9.81 — the
    reference scales `G_m_s2 / mean_acc.norm()`); accel bias along
    gravity is unobservable at rest and stays zero."""
    w = imu.dt / jnp.maximum(jnp.sum(imu.dt), 1e-9)
    gyro_mean = jnp.sum(imu.gyro * w[:, None], axis=0)
    acc_mean = jnp.sum(imu.acc * w[:, None], axis=0)
    # at rest: f_body = -R^T g  =>  g = -R f_mean, rescaled to 9.81
    g_dir = -(state.R @ acc_mean)
    g = g_dir * (9.81 / jnp.maximum(jnp.linalg.norm(g_dir), 1e-9))
    return state._replace(bg=gyro_mean, grav=g)


@accurate
def propagate(state: LioState, imu: ImuSample, config: LioConfig):
    """Forward-propagate mean and covariance through an IMU packet
    (`ImuProcess::Process` forward pass). imu leaves have leading time
    axis. Returns (state', per-sample poses for undistortion).

    Covariance: per-sample first-order error-state transition
      dphi' = dphi - R' dbg dt
      dp'   = dp + dv dt
      dv'   = dv - [R (a - ba)]x dphi dt - R dba dt
    (left perturbation; biases random-walk; the extrinsic block is
    constant), P <- F P F^T + Q."""
    I3 = jnp.eye(3)

    def step(carry, s):
        R, p, v, P = carry
        w = s.gyro - state.bg
        a = s.acc - state.ba
        dR = so3.exp(w * s.dt)
        R_new = R @ dR
        acc_w = R @ a + state.grav
        p_new = p + v * s.dt + 0.5 * acc_w * s.dt**2
        v_new = v + acc_w * s.dt
        dt = s.dt
        F = jnp.eye(_DOF)
        F = F.at[0:3, 9:12].set(-R_new * dt)
        F = F.at[3:6, 6:9].set(I3 * dt)
        F = F.at[6:9, 0:3].set(-so3.hat(R @ a) * dt)
        F = F.at[6:9, 12:15].set(-R * dt)
        F = F.at[6:9, 21:24].set(I3 * dt)  # dv' += dgrav dt
        qd = jnp.concatenate([
            jnp.full(3, config.gyro_noise * dt),
            jnp.full(3, 1e-8 * dt),
            jnp.full(3, config.acc_noise * dt),
            jnp.full(6, config.bias_rw * dt),
            jnp.full(6, config.extrinsic_rw * dt),
            jnp.full(3, config.gravity_rw * dt),
        ])
        P_new = F @ P @ F.T + jnp.diag(qd)
        return (R_new, p_new, v_new, P_new), (R_new, p_new)

    (R, p, v, P), (Rs, ps) = jax.lax.scan(
        step, (state.R, state.p, state.v, state.P), imu
    )
    new_state = state._replace(R=R, p=p, v=v, P=0.5 * (P + P.T))
    return new_state, (Rs, ps)


@partial(jax.jit, static_argnames=())
def undistort(
    scan: pcl.PointCloud,
    point_time: jax.Array,
    Rs: jax.Array,
    ps: jax.Array,
    R_end: jax.Array,
    p_end: jax.Array,
    imu_t: jax.Array,
    R_li: jax.Array | None = None,
    t_li: jax.Array | None = None,
):
    """Motion-compensate LIDAR-frame points to the scan-end LIDAR frame
    (`UndistortPcl`): for each point at sweep time t, find the bracketing
    propagated IMU pose, map lidar -> IMU -> world, and re-express in
    the end pose (then back to the lidar frame)."""
    k = jnp.clip(
        jnp.searchsorted(imu_t, point_time, side="right") - 1, 0, Rs.shape[0] - 1
    )
    xyz = scan.xyz
    if R_li is not None:
        xyz = jnp.einsum("ab,nb->na", R_li, xyz) + t_li
    R_t = Rs[k]
    p_t = ps[k]
    world = jnp.einsum("nab,nb->na", R_t, xyz) + p_t
    body_end = jnp.einsum("ba,nb->na", R_end, world - p_end[None])
    if R_li is not None:
        body_end = jnp.einsum("ba,nb->na", R_li, body_end - t_li[None])
    return pcl.park(pcl.PointCloud(body_end, scan.mask))


@accurate
@partial(jax.jit, static_argnames=("config",))
def update(state: LioState, scan_ds: pcl.PointCloud, config: LioConfig):
    """Iterated measurement update — MAP Gauss-Newton with the
    propagated prior over the FULL 24-dof error state.

    Residuals: point-to-plane against the map with pooled-moment planes
    on tp = R (R_li q + t_li) + p. They constrain (dphi, dp) directly
    and, with `estimate_extrinsics`, (dphi_e, dp_e) via
      de/dphi_e = (R_li q) x (R^T n),   de/dp_e = R^T n;
    (dv, dbg, dba) move through the prior cross-covariances (how the
    IKFoM update corrects biases). Posterior covariance contracts to
    (J^T W J + P^-1)^-1."""
    P = state.P + 1e-9 * jnp.eye(_DOF)
    Pinv = linalg3.inv_psd_scaled(P)
    w_meas = 1.0 / (config.lidar_noise**2)
    est_ext = config.estimate_extrinsics

    # ---- associate ONCE at the IMU-predicted state --------------------
    # (the K-row gather + moment pooling + eigh3 plane fits are the
    # measured bulk of the front-end; the IMU prior is cm-accurate so
    # the correspondence set is stable across the GN iterates — the
    # same association-caching split as registration.point_to_plane_icp.
    # The reference re-searches its ikd-tree every IEKF iteration;
    # with a good prior the fixed-set MAP GN solves the same problem.)
    s_b0 = jnp.einsum("ab,nb->na", state.R_li, scan_ds.xyz) + state.t_li
    tp0 = jnp.einsum("ab,nb->na", state.R, s_b0) + state.p
    found, cnt, mu, Cv = voxel_grid.lookup(state.grid, tp0, "direct7")
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
    usable = scan_ds.mask & (wsum >= 5) & planar

    est_grav = config.estimate_gravity

    def body(carry, _):
        R, p, v, bg, ba, R_li, t_li, grav, _H = carry
        s_b = jnp.einsum("ab,nb->na", R_li, scan_ds.xyz) + t_li  # IMU frame
        tp = jnp.einsum("ab,nb->na", R, s_b) + p
        d2 = jnp.sum((mu_p - tp) ** 2, axis=-1)
        ok = usable & (d2 < config.max_corr_dist**2)
        w = ok.astype(jnp.float32) * w_meas
        r = jnp.sum(n * (tp - mu_p), axis=-1)
        # Perturbation R <- exp(dphi) R, p <- p + dp (rotation does NOT
        # act on p): de/dphi = n . (dphi x R s) = (R s x n) . dphi
        rot_pt = tp - p  # R s_b
        cols = [jnp.cross(rot_pt, n), n]
        if est_ext:
            n_body = jnp.einsum("ba,nb->na", R, n)  # R^T n
            # de/dphi_e = n . (R (dphi_e x R_li q)) = (R_li q x R^T n) . dphi_e
            cols.append(jnp.cross(s_b - t_li, n_body))
            cols.append(n_body)
        J = jnp.concatenate(cols, axis=-1)  # (N, M)
        JtWJ = jnp.einsum("ni,nj,n->ij", J, J, w)
        H = Pinv
        H = H.at[0:6, 0:6].add(JtWJ[0:6, 0:6])
        if est_ext:
            H = H.at[0:6, 15:21].add(JtWJ[0:6, 6:12])
            H = H.at[15:21, 0:6].add(JtWJ[6:12, 0:6])
            H = H.at[15:21, 15:21].add(JtWJ[6:12, 6:12])
        # prior residual: accumulated deviation from the propagated state
        x_prior = jnp.concatenate([
            so3.log(R @ state.R.T), p - state.p, v - state.v,
            bg - state.bg, ba - state.ba,
            so3.log(R_li @ state.R_li.T), t_li - state.t_li,
            grav - state.grav,
        ])
        Jtr = jnp.einsum("ni,n,n->i", J, r, w)
        b_meas = jnp.zeros(_DOF).at[0:6].set(Jtr[0:6])
        if est_ext:
            b_meas = b_meas.at[15:21].set(Jtr[6:12])
        b = -b_meas - Pinv @ x_prior
        dx = linalg3.solve_psd_scaled(H + 1e-8 * jnp.eye(_DOF), b)
        R_new = so3.exp(dx[0:3]) @ R
        if est_ext:
            cap = config.extrinsic_step

            def clamp(u):
                nrm = jnp.linalg.norm(u)
                return u * jnp.minimum(1.0, cap / jnp.maximum(nrm, 1e-12))

            R_li_new = so3.exp(clamp(dx[15:18])) @ R_li
            t_li_new = t_li + clamp(dx[18:21])
        else:
            R_li_new, t_li_new = R_li, t_li
        if est_grav:
            # tangent update then S2 retraction: |g| stays 9.81 (the
            # IKFoM gravity-manifold constraint)
            g_new = grav + dx[21:24]
            g_new = g_new * (9.81 / jnp.maximum(
                jnp.linalg.norm(g_new), 1e-9
            ))
        else:
            g_new = grav
        return (
            (R_new, p + dx[3:6], v + dx[6:9], bg + dx[9:12], ba + dx[12:15],
             R_li_new, t_li_new, g_new, H),
            jnp.sum(ok),
        )

    carry0 = (
        state.R, state.p, state.v, state.bg, state.ba,
        state.R_li, state.t_li, state.grav, Pinv,
    )
    (R, p, v, bg, ba, R_li, t_li, grav, H_last), inliers = jax.lax.scan(
        body, carry0, None, length=config.iters,
    )
    # information-form covariance contraction at the converged estimate
    # (H carried, not stacked — only the final-iterate H is live)
    P_post = linalg3.inv_psd_scaled(H_last + 1e-8 * jnp.eye(_DOF))
    P_post = 0.5 * (P_post + P_post.T)
    state2 = state._replace(
        R=R, p=p, v=v, bg=bg, ba=ba, R_li=R_li, t_li=t_li, grav=grav,
        P=P_post,
    )
    return state2, inliers[-1]


@accurate
@partial(jax.jit, static_argnames=("config",))
def step(
    state: LioState,
    scan: pcl.PointCloud,
    point_time: jax.Array,
    imu: ImuSample,
    config: LioConfig,
):
    """One lidar-inertial frame: propagate -> undistort -> iterated
    update -> map insert/decay. `scan` is in the LIDAR frame; the map
    and pose are world/IMU — the extrinsic is composed in here."""
    state, (Rs, ps) = propagate(state, imu, config)
    imu_t = jnp.cumsum(imu.dt) - imu.dt
    und = undistort(
        scan, point_time, Rs, ps, state.R, state.p, imu_t,
        R_li=state.R_li, t_li=state.t_li,
    )
    ds = pcl.voxel_downsample(
        und, config.scan_leaf, config.scan_capacity,
        bounds=((-150.0, -150.0, -150.0), (150.0, 150.0, 150.0)),
    )

    def do_update(s):
        s2, inl = update(s, ds, config)
        return s2, inl

    def skip(s):
        return s, jnp.int32(0)

    state, inliers = jax.lax.cond(state.frame > 0, do_update, skip, state)
    fine = pcl.voxel_downsample(
        und, config.insert_leaf, config.insert_capacity,
        bounds=((-150.0, -150.0, -150.0), (150.0, 150.0, 150.0)),
    )
    world = pcl.transform(fine, state.lidar_pose())
    grid = voxel_grid.insert(state.grid, world)
    grid = voxel_grid.decay(grid, state.p, config.map_radius)
    state = state._replace(grid=grid, frame=state.frame + 1)
    return state, inliers
