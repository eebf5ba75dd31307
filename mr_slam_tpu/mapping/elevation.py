"""2.5D GPU-GEM elevation mapping as batched grid kernels.

Re-design of `elevation_mapping_periodical` (C++/CUDA, SURVEY.md §2.7):
the persistent device-global ring-buffer grid + per-cell Kalman fusion
(`gpu_process.cu`: `G_pointsprocess` :384-456, `G_fuse` :477-537,
`G_Mapfeature` :547-665, `G_Clear_map` ring shift) becomes a functional
`ElevationMap` pytree updated by scatter ops:

  * `process_points` — sensor-noise variance model + per-cell lowest-z
    reduction (the atomicMin pass) in one segment-min;
  * `fuse` — per-cell 1D Kalman update with Mahalanobis-gated reset to
    the newer (higher) surface;
  * `shift` — pure roll-and-clear replacing the wrap-around ring-buffer
    indexing (`gpu_process.cu:192-194`), keeping everything
    vectorizable;
  * `features` — 5x5 neighbourhood plane fit, one window per cell
    -> slope / roughness / traversability layers.

A leading robot axis vmaps the whole module; grid blocks shard over the
mesh for the merged global map.
"""
from __future__ import annotations

import functools
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops.pointcloud import PointCloud


class ElevationMap(NamedTuple):
    """Rolling local grid. height/variance (H, W); origin = world xy of
    cell (0, 0); resolution in metres/cell (0.2 in the reference
    detection_robot_1.yaml)."""

    height: jax.Array
    variance: jax.Array
    valid: jax.Array
    origin: jax.Array      # (2,) float32 world coords of cell (0,0) corner
    resolution: jax.Array  # () float32

    @property
    def shape(self):
        return self.height.shape


def init(size: int = 60, resolution: float = 0.2, center=(0.0, 0.0)) -> ElevationMap:
    """size=60 @ 0.2 m -> the reference's 12 m x 12 m local map."""
    half = size * resolution / 2.0
    return ElevationMap(
        height=jnp.zeros((size, size), jnp.float32),
        variance=jnp.full((size, size), 1e6, jnp.float32),
        valid=jnp.zeros((size, size), bool),
        origin=jnp.array([center[0] - half, center[1] - half], jnp.float32),
        resolution=jnp.float32(resolution),
    )


@jax.jit
def sensor_variance(
    xyz_sensor: jax.Array,
    normal_factor: float = 0.002,
    lateral_factor: float = 0.004,
) -> jax.Array:
    """Beam noise model: variance grows with squared range — the
    Jacobian-propagated laser model of `LaserSensorProcessor.cpp`
    collapsed to its dominant terms. xyz in the SENSOR frame."""
    d2 = jnp.sum(xyz_sensor * xyz_sensor, axis=-1)
    return normal_factor + lateral_factor * d2


@jax.jit
def structured_light_variance(
    xyz_sensor: jax.Array,
    normal_coeff: float = 0.002,
    lateral_coeff: float = 0.004,
) -> jax.Array:
    """StructuredLightSensorProcessor model: depth noise grows with the
    square of the z-depth (Kinect-style), lateral with depth."""
    z = jnp.abs(xyz_sensor[..., 2])
    return normal_coeff * z * z + lateral_coeff * z + 1e-4


@jax.jit
def stereo_variance(
    xyz_sensor: jax.Array,
    focal: float = 500.0,
    baseline: float = 0.1,
    disparity_sigma: float = 0.5,
) -> jax.Array:
    """StereoSensorProcessor model: sigma_z = z^2 * sigma_d / (f * b) —
    depth error from disparity quantisation."""
    z = jnp.abs(xyz_sensor[..., 2])
    s = z * z * disparity_sigma / (focal * baseline)
    return s * s + 1e-6


def perfect_variance(xyz_sensor: jax.Array) -> jax.Array:
    """PerfectSensorProcessor: ground-truth input, near-zero variance."""
    return jnp.full(xyz_sensor.shape[:-1], 1e-6, jnp.float32)


# name -> model, mirroring the sensor_processors/ plugin registry
# (`SensorProcessorBase.cpp`; one .cpp per model, SURVEY.md §2.7)
SENSOR_MODELS = {
    "laser": sensor_variance,
    "structured_light": structured_light_variance,
    "stereo": stereo_variance,
    "perfect": perfect_variance,
}


@jax.jit
def process_points(
    m: ElevationMap, pc: PointCloud, variances: jax.Array
):
    """Reduce a world-frame cloud to per-cell (lowest z, its variance)
    — `G_pointsprocess`'s transform + atomicMin pass. Returns
    (cell_z (H, W), cell_var (H, W), cell_hit (H, W))."""
    H, W = m.shape
    ij = jnp.floor((pc.xyz[:, :2] - m.origin) / m.resolution).astype(jnp.int32)
    inb = (
        pc.mask
        & (ij[:, 0] >= 0) & (ij[:, 0] < H)
        & (ij[:, 1] >= 0) & (ij[:, 1] < W)
    )
    flat = jnp.where(inb, ij[:, 0] * W + ij[:, 1], H * W)
    z = jnp.where(inb, pc.xyz[:, 2], jnp.inf)
    cell_z = jnp.full((H * W + 1,), jnp.inf).at[flat].min(z)
    # variance of (approximately) the winning point: take min variance
    cell_var = jnp.full((H * W + 1,), jnp.inf).at[flat].min(
        jnp.where(inb, variances, jnp.inf)
    )
    hit = jnp.isfinite(cell_z[: H * W])
    return (
        jnp.where(hit, cell_z[: H * W], 0.0).reshape(H, W),
        jnp.where(hit, cell_var[: H * W], 1e6).reshape(H, W),
        hit.reshape(H, W),
    )


@partial(jax.jit, static_argnames=("mahalanobis_thresh",))
def fuse(
    m: ElevationMap,
    pc: PointCloud,
    variances: jax.Array,
    mahalanobis_thresh: float = 5.0,
) -> ElevationMap:
    """One measurement update — `G_fuse` (`gpu_process.cu:477-537`):
    per cell, Kalman-blend the new height with the stored one; if the
    innovation's Mahalanobis distance exceeds the threshold, RESET to
    the new surface (dynamic obstacles / overhangs)."""
    cell_z, cell_var, hit = process_points(m, pc, variances)
    h0, v0, ok0 = m.height, m.variance, m.valid
    maha = jnp.abs(cell_z - h0) / jnp.sqrt(jnp.maximum(v0 + cell_var, 1e-9))
    consistent = maha <= mahalanobis_thresh
    # Kalman update
    v_sum = jnp.maximum(v0 + cell_var, 1e-9)
    h_new = (v0 * cell_z + cell_var * h0) / v_sum
    v_new = (v0 * cell_var) / v_sum
    # reset branch
    h_out = jnp.where(consistent & ok0, h_new, cell_z)
    v_out = jnp.where(consistent & ok0, v_new, cell_var)
    return m._replace(
        height=jnp.where(hit, h_out, h0),
        variance=jnp.where(hit, v_out, v0),
        valid=ok0 | hit,
    )


@jax.jit
def predict(m: ElevationMap, process_noise: float = 1e-4) -> ElevationMap:
    """Time update: inflate variance (`G_Mapvar_update` /
    RobotMotionMapUpdater)."""
    return m._replace(variance=m.variance + process_noise)


@jax.jit
def motion_update(
    m: ElevationMap,
    robot_xy: jax.Array,
    sigma_z: jax.Array | float = 0.0,
    sigma_tilt: jax.Array | float = 0.0,
) -> ElevationMap:
    """Robot-motion variance update — `RobotMotionMapUpdater.cpp`
    re-derived: the pose-covariance *increment* since the last update
    maps onto each cell's height variance as

        dvar(cell) = sigma_z^2 + (r(cell) * sigma_tilt)^2

    where r is the horizontal lever arm from the robot to the cell:
    vertical drift moves every height equally, roll/pitch drift tilts
    the map plane so far cells pick up more height uncertainty. Only
    valid cells are inflated (invalid ones already carry the init
    variance)."""
    H, W = m.shape
    ci = (jnp.arange(H, dtype=jnp.float32) + 0.5) * m.resolution + m.origin[0]
    cj = (jnp.arange(W, dtype=jnp.float32) + 0.5) * m.resolution + m.origin[1]
    dx = ci[:, None] - robot_xy[0]
    dy = cj[None, :] - robot_xy[1]
    r2 = dx * dx + dy * dy
    dvar = jnp.square(sigma_z) + r2 * jnp.square(sigma_tilt)
    return m._replace(variance=jnp.where(m.valid, m.variance + dvar, m.variance))


@jax.jit
def shift(m: ElevationMap, new_center: jax.Array) -> ElevationMap:
    """Recenter the rolling grid on the robot — the ring-buffer shift
    (`G_Clear_map`) as a roll + clear of vacated rows/cols."""
    H, W = m.shape
    half = jnp.array([H, W], jnp.float32) * m.resolution / 2.0
    new_origin_f = new_center - half
    shift_cells = jnp.round((new_origin_f - m.origin) / m.resolution).astype(jnp.int32)
    new_origin = m.origin + shift_cells.astype(jnp.float32) * m.resolution
    di, dj = shift_cells[0], shift_cells[1]
    rows = jnp.arange(H)[:, None] + di
    cols = jnp.arange(W)[None, :] + dj
    inb = (rows >= 0) & (rows < H) & (cols >= 0) & (cols < W)
    ri = jnp.clip(rows, 0, H - 1)
    ci = jnp.clip(cols, 0, W - 1)
    take = lambda a, fill: jnp.where(inb, a[ri, ci], fill)
    return ElevationMap(
        height=take(m.height, 0.0),
        variance=take(m.variance, 1e6),
        valid=take(m.valid, False),
        origin=new_origin,
        resolution=m.resolution,
    )


@partial(jax.jit, static_argnames=("n_samples",))
def raytrace_clear(
    m: ElevationMap,
    sensor_origin: jax.Array,
    pc: PointCloud,
    n_samples: int = 32,
    margin: float = 0.2,
    variance_inflation: float = 10.0,
) -> ElevationMap:
    """Visibility clearing — `G_Raytracing` (`gpu_process.cu:706`):
    cells crossed by a beam BELOW the beam's height must not contain a
    surface above it; stale surfaces there (dynamic obstacles that
    moved away) get their variance inflated so the next fuse overwrites
    them, and cells far above the beam are invalidated outright.

    The CUDA kernel walks each ray with a DDA; here each of the N beams
    is sampled at `n_samples` fixed fractions (excluding the endpoint
    neighbourhood) and the violations are reduced per cell with one
    scatter-max over beam height.
    """
    H, W = m.shape
    fracs = jnp.linspace(0.05, 0.92, n_samples)
    # (N, S, 3) sample points along each ray
    pts = sensor_origin[None, None, :] + fracs[None, :, None] * (
        pc.xyz[:, None, :] - sensor_origin[None, None, :]
    )
    ij = jnp.floor((pts[..., :2] - m.origin) / m.resolution).astype(jnp.int32)
    inb = (
        pc.mask[:, None]
        & (ij[..., 0] >= 0) & (ij[..., 0] < H)
        & (ij[..., 1] >= 0) & (ij[..., 1] < W)
    )
    flat = jnp.where(inb, ij[..., 0] * W + ij[..., 1], H * W).reshape(-1)
    beam_z = jnp.where(inb, pts[..., 2], -jnp.inf).reshape(-1)
    # highest beam passing through each cell
    pass_z = jnp.full((H * W + 1,), -jnp.inf).at[flat].max(beam_z)
    pass_z = pass_z[: H * W].reshape(H, W)
    seen = jnp.isfinite(pass_z)
    stale = seen & m.valid & (m.height > pass_z + margin)
    return m._replace(
        variance=jnp.where(stale, m.variance * variance_inflation, m.variance),
        valid=m.valid & ~(stale & (m.height > pass_z + 3.0 * margin)),
    )


@partial(jax.jit, static_argnames=("iterations",))
def interpolate_dense(m: ElevationMap, iterations: int = 2) -> ElevationMap:
    """Optional dense interpolation before the keyframe flush
    (`updateLocalMap`, `ElevationMapping.cpp:653-821`): fill holes from
    the 3x3 neighbourhood average of valid cells, iterated. Filled cells
    carry the neighbourhood's mean variance (inflated)."""
    h, v, ok = m.height, m.variance, m.valid

    def body(_, carry):
        h, v, ok = carry
        okf = ok.astype(jnp.float32)
        cnt = _window_sums(okf, 3)
        hs = _window_sums(jnp.where(ok, h, 0.0), 3)
        vs = _window_sums(jnp.where(ok, v, 0.0), 3)
        can = (~ok) & (cnt >= 3.0)
        h2 = jnp.where(can, hs / jnp.maximum(cnt, 1.0), h)
        v2 = jnp.where(can, 2.0 * vs / jnp.maximum(cnt, 1.0) + 1e-3, v)
        return h2, v2, ok | can

    h, v, ok = jax.lax.fori_loop(0, iterations, body, (h, v, ok))
    return m._replace(height=h, variance=v, valid=ok)


class TerrainFeatures(NamedTuple):
    slope: jax.Array          # rad
    roughness: jax.Array      # m (plane-fit residual std)
    step: jax.Array           # m (max height jump in window)
    traversability: jax.Array  # [0, 1], 1 = flat and smooth
    support: jax.Array        # valid cells in the window (fit needs >= 3)


def _window_sums(x: jax.Array, k: int) -> jax.Array:
    """Sum over k x k window via two 1D convolutions (separable box)."""
    kernel = jnp.ones((k,), x.dtype)
    pad = k // 2
    a = jnp.apply_along_axis  # noqa — keep simple: conv per axis
    x1 = jax.vmap(lambda row: jnp.convolve(row, kernel, mode="same"))(x)
    x2 = jax.vmap(lambda col: jnp.convolve(col, kernel, mode="same"))(x1.T).T
    return x2


@partial(jax.jit, static_argnames=("window",))
def features(
    m: ElevationMap,
    window: int = 5,
    slope_crit: float = 0.6,
    rough_crit: float = 0.15,
    step_crit: float = 0.3,
) -> TerrainFeatures:
    """`G_Mapfeature` (`gpu_process.cu:547-665`): per cell fit a plane
    z = ax + by + c to the valid cells of its k x k neighbourhood by
    least squares, derive slope / roughness (residual std) / step
    (height range) and blend them into a [0,1] traversability score
    (weights as the reference: slope, roughness and step each
    normalized by a critical value).

    As in the reference's one thread per cell, every cell reads its own
    window: the sums run over the k*k taps as shifted views of the
    padded grid, which XLA fuses into elementwise passes. Coordinates
    are taken relative to the window centre and heights relative to the
    window mean, so float32 moments stay free of cancellation at any map
    extent; roughness sums the squared residuals directly. Cells outside
    the map count as invalid. A window whose valid cells are collinear
    has no unique plane and gets slope 0. `step` takes the window's
    maximum over heights with invalid cells read as 0 and its minimum
    over valid cells only."""
    H, W = m.shape
    r = window // 2
    res = m.resolution
    offs = [(di, dj) for di in range(-r, r + 1) for dj in range(-r, r + 1)]
    z = jnp.where(m.valid, m.height, 0.0)
    v_p = jnp.pad(m.valid.astype(jnp.float32), r)
    z_p = jnp.pad(z, r)

    def tap(a, di, dj):
        return jax.lax.slice(a, (r + di, r + dj), (r + di + H, r + dj + W))

    # pass 1: support and window means (dx, dy are exact grid offsets)
    S1 = sum(tap(v_p, di, dj) for di, dj in offs)
    n = jnp.maximum(S1, 1.0)
    mx = sum(tap(v_p, di, dj) * (di * res) for di, dj in offs) / n
    my = sum(tap(v_p, di, dj) * (dj * res) for di, dj in offs) / n
    mz = sum(tap(v_p, di, dj) * tap(z_p, di, dj) for di, dj in offs) / n

    # pass 2: centred second moments
    def centred(di, dj):
        return (tap(v_p, di, dj), di * res - mx, dj * res - my,
                tap(z_p, di, dj) - mz)

    cxx = cyy = cxy = cxz = cyz = 0.0
    for di, dj in offs:
        w, ex, ey, ez = centred(di, dj)
        cxx = cxx + w * ex * ex
        cyy = cyy + w * ey * ey
        cxy = cxy + w * ex * ey
        cxz = cxz + w * ex * ez
        cyz = cyz + w * ey * ez
    cxx, cyy, cxy, cxz, cyz = (c / n for c in (cxx, cyy, cxy, cxz, cyz))
    det = cxx * cyy - cxy * cxy
    plane = jnp.abs(det) >= 1e-9
    det_safe = jnp.where(plane, det, 1.0)
    a = jnp.where(plane, (cyy * cxz - cxy * cyz) / det_safe, 0.0)
    b = jnp.where(plane, (cxx * cyz - cxy * cxz) / det_safe, 0.0)
    slope = jnp.arctan(jnp.sqrt(a * a + b * b))

    # pass 3: residual of the fitted plane
    resid = 0.0
    for di, dj in offs:
        w, ex, ey, ez = centred(di, dj)
        e = ez - a * ex - b * ey
        resid = resid + w * e * e
    roughness = jnp.sqrt(resid / n)

    zmax_p = jnp.pad(z, r, constant_values=-jnp.inf)
    zmin_p = jnp.pad(jnp.where(m.valid, m.height, jnp.inf), r,
                     constant_values=jnp.inf)
    zmax = functools.reduce(jnp.maximum, (tap(zmax_p, *o) for o in offs))
    zmin = functools.reduce(jnp.minimum, (tap(zmin_p, *o) for o in offs))
    step = jnp.where(jnp.isfinite(zmin), zmax - zmin, 0.0)
    enough = S1 >= 3.0
    trav = 1.0 - jnp.maximum(
        jnp.maximum(slope / slope_crit, roughness / rough_crit), step / step_crit
    )
    trav = jnp.clip(trav, 0.0, 1.0)
    trav = jnp.where(enough & m.valid, trav, 0.5)  # unknown = mid score
    return TerrainFeatures(
        slope=jnp.where(enough, slope, 0.0),
        roughness=jnp.where(enough, roughness, 0.0),
        step=step,
        traversability=trav,
        support=S1,
    )


def _dilate3(x: jax.Array) -> jax.Array:
    """3x3 max filter."""
    p = jnp.pad(x, 1, constant_values=-jnp.inf)
    stack = jnp.stack(
        [p[di : di + x.shape[0], dj : dj + x.shape[1]]
         for di in range(3) for dj in range(3)]
    )
    return jnp.max(stack, axis=0)


@jax.jit
def to_cloud(m: ElevationMap) -> PointCloud:
    """Flatten the grid into a masked world-frame cloud (cell centers)
    — what `updateLocalMap` publishes as the grid part of a SubMap."""
    H, W = m.shape
    ii = (jnp.arange(H, dtype=jnp.float32)[:, None] + 0.5) * m.resolution
    jj = (jnp.arange(W, dtype=jnp.float32)[None, :] + 0.5) * m.resolution
    xs = jnp.broadcast_to(ii + m.origin[0], (H, W))
    ys = jnp.broadcast_to(jj + m.origin[1], (H, W))
    xyz = jnp.stack([xs, ys, m.height], axis=-1).reshape(-1, 3)
    return PointCloud(xyz, m.valid.reshape(-1))


# ---------------------------------------------------------------------------
# Color / ortho-image layer (GEM's synchronized camera path)
# ---------------------------------------------------------------------------
# The reference's ElevationMapping subscribes to a synchronized
# (PointCloud2, Image) pair (`ElevationMapping.cpp:298`), projects points
# into the camera to color grid cells, and ships an `orthoImage` inside
# every `dislam_msgs/SubMap`. Robots without cameras run Tools/Fake_img
# (black 640x480 @ 10 Hz) to satisfy the synchronizer. Here the color
# layer is a separate additive grid so the height pipeline is untouched.


class ColorGrid(NamedTuple):
    """Per-cell RGB accumulated as a weighted running mean."""

    rgb: jax.Array     # (H, W, 3) float32 in [0, 1]
    weight: jax.Array  # (H, W) float32


def init_color(size: int = 60) -> ColorGrid:
    return ColorGrid(
        rgb=jnp.zeros((size, size, 3), jnp.float32),
        weight=jnp.zeros((size, size), jnp.float32),
    )


@jax.jit
def colorize_from_camera(
    xyz_world: jax.Array,   # (N, 3)
    cam_R: jax.Array,       # (3, 3) world <- camera rotation
    cam_t: jax.Array,       # (3,) camera position in world
    intrinsics: jax.Array,  # (4,) fx, fy, cx, cy
    image: jax.Array,       # (Hi, Wi, 3) float32 [0, 1]
):
    """Project world points into a pinhole camera and bilinearly sample
    per-point colors. Returns (colors (N, 3), visible (N,)). Points
    behind the camera or outside the frame are invisible — the same
    visibility rule GEM's image fusion applies."""
    Hi, Wi = image.shape[0], image.shape[1]
    fx, fy, cx, cy = intrinsics[0], intrinsics[1], intrinsics[2], intrinsics[3]
    p_cam = (xyz_world - cam_t) @ cam_R  # world->cam: R^T (x - t)
    z = p_cam[:, 2]
    safe_z = jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
    u = fx * p_cam[:, 0] / safe_z + cx
    v = fy * p_cam[:, 1] / safe_z + cy
    visible = (z > 1e-3) & (u >= 0) & (u <= Wi - 1.0) & (v >= 0) & (v <= Hi - 1.0)
    u = jnp.clip(u, 0.0, Wi - 1.001)
    v = jnp.clip(v, 0.0, Hi - 1.001)
    u0 = jnp.floor(u).astype(jnp.int32)
    v0 = jnp.floor(v).astype(jnp.int32)
    du = (u - u0)[:, None]
    dv = (v - v0)[:, None]
    c00 = image[v0, u0]
    c01 = image[v0, u0 + 1]
    c10 = image[v0 + 1, u0]
    c11 = image[v0 + 1, u0 + 1]
    colors = (
        c00 * (1 - du) * (1 - dv) + c01 * du * (1 - dv)
        + c10 * (1 - du) * dv + c11 * du * dv
    )
    return colors, visible


@jax.jit
def fuse_color(
    m: ElevationMap, cg: ColorGrid, pc: PointCloud, colors: jax.Array,
    visible: jax.Array,
) -> ColorGrid:
    """Scatter per-point colors into the grid as a weighted running mean
    (GEM keeps a color layer alongside height in the fused map)."""
    H, W = m.shape
    ij = jnp.floor((pc.xyz[:, :2] - m.origin) / m.resolution).astype(jnp.int32)
    ok = (
        pc.mask & visible
        & (ij[:, 0] >= 0) & (ij[:, 0] < H)
        & (ij[:, 1] >= 0) & (ij[:, 1] < W)
    )
    flat = jnp.where(ok, ij[:, 0] * W + ij[:, 1], H * W)
    w = ok.astype(jnp.float32)
    sum_rgb = jnp.zeros((H * W + 1, 3)).at[flat].add(colors * w[:, None])
    sum_w = jnp.zeros((H * W + 1,)).at[flat].add(w)
    new_w = cg.weight + sum_w[: H * W].reshape(H, W)
    num = cg.rgb * cg.weight[..., None] + sum_rgb[: H * W].reshape(H, W, 3)
    rgb = num / jnp.maximum(new_w[..., None], 1e-9)
    return ColorGrid(rgb=rgb, weight=new_w)


@jax.jit
def ortho_image(m: ElevationMap, cg: ColorGrid | None = None) -> jax.Array:
    """(H, W, 3) float32 top-down render — the `orthoImage` field of the
    reference's SubMap. Colored cells use the camera layer; the rest a
    height shading; invalid cells black."""
    H, W = m.shape
    h = jnp.where(m.valid, m.height, 0.0)
    lo = jnp.min(jnp.where(m.valid, h, jnp.inf))
    hi = jnp.max(jnp.where(m.valid, h, -jnp.inf))
    span = jnp.maximum(hi - lo, 1e-6)
    shade = jnp.clip((h - lo) / span, 0.0, 1.0)
    gray = jnp.repeat(shade[..., None], 3, axis=-1)
    if cg is not None:
        has_color = (cg.weight > 0)[..., None]
        gray = jnp.where(has_color, cg.rgb, gray)
    return jnp.where(m.valid[..., None], gray, 0.0)


def fake_image(height: int = 480, width: int = 640) -> jax.Array:
    """Tools/Fake_img parity (`Tools/Fake_img/robot_N.py`): a black
    camera frame for robots without cameras, keeping the synchronized
    cloud+image interface satisfied."""
    return jnp.zeros((height, width, 3), jnp.float32)
