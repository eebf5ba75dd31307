"""RING / RING++ place recognition: Radon sinograms + FFT correlation.

Re-design of `LoopDetection/src/RING_ros/util.py` and torch-radon:
  * `radon()` replaces the vendored CUDA `ParallelBeam.forward`
    (texture-sampled line integrals) with a rotate-and-sum formulation:
    bilinear resampling of the BEV onto rotated grids, summed along one
    axis. Correlation behaviour (not bit-exactness) is what matters
    (SURVEY.md §7.4).
  * `describe()` builds the rotation-equivariant sinogram (RING) and its
    row-FFT magnitude (TIRING, translation-invariant) —
    `util.py:174-200`.
  * `correlate()` is `fast_corr` (`util.py:362-374`) batched over the
    whole database: circular cross-correlation over the angle axis via
    FFT, distance = 1 - peak/(0.15 * H * W).
  * `solve_translation()` re-derives the per-row phase-correlation +
    least-squares translation solve (`util.py:388-423`).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..precision import fast


class RingParams(NamedTuple):
    n_angles: int = 120   # sinogram rows (theta)
    bev_size: int = 120   # BEV resolution (H = W)


def _rotated_coords(n_angles: int, size: int):
    """Sampling grids for all rotations: (n_angles, size, size, 2) image
    coordinates of a grid rotated by theta about the image center."""
    thetas = jnp.linspace(0.0, jnp.pi, n_angles, endpoint=False)
    c = (size - 1) / 2.0
    u = jnp.arange(size, dtype=jnp.float32) - c
    X, Y = jnp.meshgrid(u, u, indexing="xy")  # (size, size)
    cos, sin = jnp.cos(thetas), jnp.sin(thetas)
    xr = cos[:, None, None] * X[None] - sin[:, None, None] * Y[None] + c
    yr = sin[:, None, None] * X[None] + cos[:, None, None] * Y[None] + c
    return xr, yr


def _bilinear(img: jax.Array, x: jax.Array, y: jax.Array) -> jax.Array:
    """Bilinear sample img (H, W) at float coords (x, y); zero outside."""
    H, W = img.shape
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    dx = x - x0
    dy = y - y0

    def tap(xi, yi, w):
        inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        v = img[jnp.clip(yi, 0, H - 1), jnp.clip(xi, 0, W - 1)]
        return jnp.where(inb, v * w, 0.0)

    return (
        tap(x0, y0, (1 - dx) * (1 - dy))
        + tap(x0 + 1, y0, dx * (1 - dy))
        + tap(x0, y0 + 1, (1 - dx) * dy)
        + tap(x0 + 1, y0 + 1, dx * dy)
    )


@fast
@partial(jax.jit, static_argnames=("n_angles",))
def radon(bev: jax.Array, n_angles: int = 120) -> jax.Array:
    """Parallel-beam Radon transform of (H, W) -> sinogram (n_angles, W):
    row theta = line integrals of the image rotated by theta, summed
    down the column axis."""
    size = bev.shape[-1]
    xr, yr = _rotated_coords(n_angles, size)
    rotated = _bilinear(bev, xr, yr)  # (n_angles, size, size)
    return jnp.sum(rotated, axis=-2)


@partial(jax.jit, static_argnames=("size",))
def radon_backproject(sino: jax.Array, size: int) -> jax.Array:
    """EXACT adjoint of `radon`, derived by linear transposition: the
    forward transform is linear in the image, so its transpose (XLA
    turns the rotate-gather into the corresponding scatter) IS the
    backprojection — <radon(x), y> == <x, backproject(y)> to float
    precision, with no separately-maintained smearing kernel.

    Completes the vendored torch-radon API surface
    (`LoopDetection/torch-radon/src/backprojection.cu`) — RING itself
    only needs the forward transform, but the reference ships the full
    operator pair and FBP reconstruction on top of it."""
    A = sino.shape[0]
    f = lambda img: radon(img, n_angles=A)
    (bp,) = jax.linear_transpose(f, jnp.zeros((size, size), sino.dtype))(sino)
    return bp


@partial(jax.jit, static_argnames=("size",))
def fbp(sino: jax.Array, size: int) -> jax.Array:
    """Filtered backprojection: Ram-Lak ramp filter along rho (applied
    in the frequency domain on a 2W zero-padded row to avoid circular
    wrap), then `radon_backproject`, scaled by pi / n_angles.

    Re-derives `torch-radon`'s FBP pipeline (`torch_radon/__init__.py`
    ramp filter + backprojection) as batched FFT + interpolation ops."""
    A, W = sino.shape
    n = 2 * W
    freqs = jnp.fft.rfftfreq(n)
    ramp = 2.0 * jnp.abs(freqs)
    F = jnp.fft.rfft(sino, n=n, axis=-1)
    filtered = jnp.fft.irfft(F * ramp, n=n, axis=-1)[:, :W]
    return radon_backproject(filtered, size) * (jnp.pi / (2.0 * A))


class RingDescriptor(NamedTuple):
    sinogram: jax.Array  # (n_angles, W) RING
    tiring: jax.Array    # (n_angles, W) |FFT_row| — translation invariant


@fast
@partial(jax.jit, static_argnames=("n_angles",))
def describe(bev: jax.Array, n_angles: int = 120) -> RingDescriptor:
    """BEV (H, W) (or (C, H, W) multi-channel for RING++, channels
    averaged after per-channel Radon) -> RING + TIRING."""
    if bev.ndim == 3:
        sino = jax.vmap(lambda b: radon(b, n_angles))(bev)
        sino = jnp.mean(sino, axis=0)
    else:
        sino = radon(bev, n_angles)
    sino = sino / jnp.maximum(jnp.linalg.norm(sino), 1e-9)
    tiring = jnp.abs(jnp.fft.fft(sino, axis=-1))
    return RingDescriptor(sinogram=sino, tiring=tiring)


class RingPPDescriptor(NamedTuple):
    sinograms: jax.Array  # (C, A, W) per-channel RING
    tirings: jax.Array    # (C, A, W) per-channel |FFT_row|


@fast
@partial(jax.jit, static_argnames=("n_angles",))
def describe_ringpp(feature_bev: jax.Array, n_angles: int = 120) -> RingPPDescriptor:
    """RING++ (`util.py:204-250`): per-channel Radon of the eigen-feature
    BEV (see `bev.eigen_feature_bev`), per-channel row-FFT magnitudes.
    Channels are kept separate; matching sums correlation over channels
    (`fast_corr_RINGplusplus`, `util.py:337-358`)."""
    def one(ch):
        s = radon(ch, n_angles)
        s = s / jnp.maximum(jnp.linalg.norm(s), 1e-9)
        return s, jnp.abs(jnp.fft.fft(s, axis=-1))

    sino, tiring = jax.vmap(one)(feature_bev)
    return RingPPDescriptor(sinograms=sino, tirings=tiring)


@fast
@jax.jit
def correlate_multichannel(query: jax.Array, database: jax.Array):
    """Multi-channel circular correlation: query (C, A, W) vs database
    (D, C, A, W). Correlation scores sum over channels before the peak
    pick (`fast_corr_RINGplusplus`). Returns (dist (D,), shift (D,))."""
    fq = jnp.fft.fft(query, axis=-2)          # (C, A, W)
    fd = jnp.fft.fft(database, axis=-2)       # (D, C, A, W)
    corr = jnp.fft.ifft(jnp.conj(fq)[None] * fd, axis=-2).real
    score = jnp.sum(corr, axis=(-3, -1))      # (D, A): sum channels+tau
    peak = jnp.max(score, axis=-1)
    shift = jnp.argmax(score, axis=-1)
    qn = jnp.linalg.norm(query)
    dn = jnp.sqrt(jnp.sum(database * database, axis=(-3, -2, -1)))
    dist = 1.0 - peak / jnp.maximum(qn * dn, 1e-9)
    return dist, shift


@fast
@jax.jit
def correlate(query: jax.Array, database: jax.Array):
    """Circular cross-correlation over the angle axis between a query
    TIRING (A, W) and a database (D, A, W).

    A relative yaw of phi shifts the sinogram rows by phi (mod pi), so
    the correlation peak index gives the yaw estimate up to the pi
    ambiguity (`main_RING.py:146-173` tries both hypotheses).

    Returns (dist (D,), shift (D,)): dist = 1 - peak / (|q| |d|)
    (cosine-normalized so identical descriptors give 0; the reference's
    `1 - max/(0.15 H W)` normalization in `util.py:371` depends on its
    particular sinogram scaling — the 0.48 gate maps to ~0.2 here),
    shift = argmax row offset.
    """
    A, W = query.shape[-2:]
    fq = jnp.fft.fft(query, axis=-2)
    fd = jnp.fft.fft(database, axis=-2)
    corr = jnp.fft.ifft(jnp.conj(fq)[None] * fd, axis=-2).real  # (D, A, W)
    score = jnp.sum(corr, axis=-1)  # (D, A)
    peak = jnp.max(score, axis=-1)
    shift = jnp.argmax(score, axis=-1)
    qn = jnp.linalg.norm(query)
    dn = jnp.sqrt(jnp.sum(database * database, axis=(-2, -1)))
    dist = 1.0 - peak / jnp.maximum(qn * dn, 1e-9)
    return dist, shift


def shift_to_yaw(shift: jax.Array, n_angles: int) -> jax.Array:
    """Row shift -> yaw radians (pi-periodic)."""
    return shift.astype(jnp.float32) * (jnp.pi / n_angles)


@jax.jit
def rotate_rows(sino: jax.Array, shift: jax.Array) -> jax.Array:
    """Circularly shift sinogram rows by `shift` (dynamic) — aligning
    query to candidate before the translation solve."""
    A = sino.shape[-2]
    idx = (jnp.arange(A) + shift) % A
    return sino[idx, :]


@jax.jit
def align_sinogram(sino: jax.Array, shift: jax.Array) -> jax.Array:
    """Sinogram of the underlying image rotated by yaw = shift * pi / A.

    For point rotation p' = R(yaw) p the sinogram rows shift as
    sino'[theta] = sino[theta - shift]; rows that wrap past the [0, pi)
    range pick up the Radon antisymmetry R(theta + pi, rho) =
    R(theta, -rho), so wrapped rows get their column (rho) axis flipped.
    A plain circular row shift (`rotate_rows`) ignores that flip and is
    only correct for the correlation peak, not for the per-row
    translation solve."""
    A = sino.shape[-2]
    raw = jnp.arange(A) - shift
    idx = raw % A
    wrapped = (jnp.floor_divide(raw, A) % 2) != 0  # odd wrap -> flip rho
    rows = sino[idx, :]
    return jnp.where(wrapped[:, None], jnp.flip(rows, axis=-1), rows)


@partial(jax.jit, static_argnames=("bev_extent",))
def se2_hypotheses(
    query_sino: jax.Array,
    cand_sino: jax.Array,
    shift: jax.Array,
    bev_extent: float = 140.0,
):
    """Both yaw hypotheses with their translation solves
    (`main_RING.py:146-205` seeds GICP with (theta, t) AND
    (theta - pi, t')).

    Hypothesis k maps query-frame points into candidate-frame points:
    p_cand = R(yaw_k) p_query + [xy_k, 0].

    Returns (yaws (2,), xys (2, 2), residuals (2,)); lower residual =
    better-supported hypothesis."""
    A = query_sino.shape[-2]
    aligned = align_sinogram(query_sino, shift)
    # yaw - pi rotates the image by an extra pi: all columns flip
    flipped = jnp.flip(aligned, axis=-1)
    xy1, r1 = solve_translation(aligned, cand_sino, bev_extent)
    xy2, r2 = solve_translation(flipped, cand_sino, bev_extent)
    yaw = shift.astype(jnp.float32) * (jnp.pi / A)
    return (
        jnp.stack([yaw, yaw - jnp.pi]),
        jnp.stack([xy1, xy2]),
        jnp.stack([r1, r2]),
    )


@partial(jax.jit, static_argnames=("bev_extent",))
def solve_translation(
    query_sino: jax.Array,
    cand_sino: jax.Array,
    bev_extent: float = 140.0,
):
    """Estimate planar translation from two row-aligned sinograms.

    Per angle row theta, 1D phase correlation gives the projection shift
    d(theta) ~ (x cos theta + y sin theta) * (W / extent). Solving the
    overdetermined [cos, sin] [x, y]^T = d system by least squares
    (`util.py:388-423` uses per-row FFT peaks + SVD) recovers (x, y) in
    metres. Returns (xy (2,), residual)."""
    A, W = query_sino.shape
    fq = jnp.fft.fft(query_sino, axis=-1)
    fc = jnp.fft.fft(cand_sino, axis=-1)
    corr = jnp.fft.ifft(jnp.conj(fq) * fc, axis=-1).real  # (A, W)
    shift = jnp.argmax(corr, axis=-1)  # (A,)
    # signed shift in [-W/2, W/2)
    d = jnp.where(shift >= W // 2, shift - W, shift).astype(jnp.float32)
    conf = jnp.max(corr, axis=-1) - jnp.mean(corr, axis=-1)
    thetas = jnp.linspace(0.0, jnp.pi, A, endpoint=False)
    Amat = jnp.stack([jnp.cos(thetas), jnp.sin(thetas)], axis=-1)  # (A, 2)
    w = conf / jnp.maximum(jnp.sum(conf), 1e-9)
    AtA = jnp.einsum("ai,a,aj->ij", Amat, w, Amat)
    Atb = jnp.einsum("ai,a,a->i", Amat, w, d)
    xy_pix = jnp.linalg.solve(AtA + 1e-6 * jnp.eye(2), Atb)
    xy = xy_pix * (bev_extent / W)
    pred = Amat @ xy_pix
    residual = jnp.sqrt(jnp.sum(w * (pred - d) ** 2))
    return xy, residual
