"""Float64 NumPy reference for the terrain-feature layers.

The cross-check for `mapping.elevation.features` (the reference's
`G_Mapfeature`, `gpu_process.cu:547-665`): the same semantics written
plainly on the host, sharing no code with the device path. Each cell's
k x k window is gathered into an explicit stack, the plane is fitted in
float64 over the window's valid cells, and the residual is summed over
those cells directly. Slow-but-trusted: use for evaluation only.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class ReferenceFeatures(NamedTuple):
    slope: np.ndarray
    roughness: np.ndarray
    step: np.ndarray
    traversability: np.ndarray
    enough: np.ndarray   # >= 3 valid cells in the window
    valid: np.ndarray    # the cell itself holds a height


def terrain_features(
    height,
    valid,
    resolution: float,
    window: int = 5,
    slope_crit: float = 0.6,
    rough_crit: float = 0.15,
    step_crit: float = 0.3,
) -> ReferenceFeatures:
    """Per-cell plane fit z = a x + b y + c over the valid cells of the
    window (cells outside the map are invalid). Windows with fewer than
    3 valid cells, or whose valid cells are collinear, have no plane:
    slope 0, roughness the height std. `step` is the window's maximum
    height (invalid cells read as 0) minus its minimum valid height."""
    h = np.asarray(height, np.float64)
    ok = np.asarray(valid, bool)
    H, W = h.shape
    r = window // 2
    res = float(resolution)

    # explicit window stacks: (H, W, k*k)
    pad_ok = np.pad(ok, r)
    pad_z = np.pad(np.where(ok, h, 0.0), r)
    pad_max = np.pad(np.where(ok, h, 0.0), r, constant_values=-np.inf)
    wv, wz, wmax, dx, dy = [], [], [], [], []
    for di in range(-r, r + 1):
        for dj in range(-r, r + 1):
            sl = np.s_[r + di:r + di + H, r + dj:r + dj + W]
            wv.append(pad_ok[sl])
            wz.append(pad_z[sl])
            wmax.append(pad_max[sl])
            dx.append(di * res)
            dy.append(dj * res)
    wv = np.stack(wv, -1).astype(np.float64)
    wz = np.stack(wz, -1)
    wmax = np.stack(wmax, -1)
    dx = np.asarray(dx)
    dy = np.asarray(dy)

    n = wv.sum(-1)
    enough = n >= 3
    nn = np.maximum(n, 1.0)
    mx = (wv * dx).sum(-1) / nn
    my = (wv * dy).sum(-1) / nn
    mz = (wv * wz).sum(-1) / nn
    ex = dx - mx[..., None]
    ey = dy - my[..., None]
    ez = wz - mz[..., None]
    cov = lambda p, q: (wv * p * q).sum(-1) / nn
    cxx, cyy, cxy = cov(ex, ex), cov(ey, ey), cov(ex, ey)
    cxz, cyz = cov(ex, ez), cov(ey, ez)
    det = cxx * cyy - cxy * cxy
    plane = np.abs(det) >= 1e-9
    a = np.zeros_like(det)
    b = np.zeros_like(det)
    if plane.any():
        A = np.stack([np.stack([cxx, cxy], -1), np.stack([cxy, cyy], -1)], -2)
        rhs = np.stack([cxz, cyz], -1)
        sol = np.linalg.solve(A[plane], rhs[plane][..., None])[..., 0]
        a[plane] = sol[:, 0]
        b[plane] = sol[:, 1]
    slope = np.arctan(np.hypot(a, b))
    e = ez - a[..., None] * ex - b[..., None] * ey
    rough = np.sqrt((wv * e * e).sum(-1) / nn)

    zmax = wmax.max(-1)
    zmin = np.where(wv > 0, wz, np.inf).min(-1)
    step = np.where(np.isfinite(zmin), zmax - zmin, 0.0)

    trav = 1.0 - np.maximum(
        np.maximum(slope / slope_crit, rough / rough_crit), step / step_crit
    )
    trav = np.where(enough & ok, np.clip(trav, 0.0, 1.0), 0.5)
    return ReferenceFeatures(
        slope=np.where(enough, slope, 0.0),
        roughness=np.where(enough, rough, 0.0),
        step=step,
        traversability=trav,
        enough=enough,
        valid=ok,
    )
