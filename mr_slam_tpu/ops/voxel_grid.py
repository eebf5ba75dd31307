"""Voxel-hash Gaussian grid — the array-native correspondence structure.

The reference's hot registration paths search kd-trees per point
(ikd-Tree in FAST-LIO `laserMapping.cpp:666`, KdTreeFLANN in A-LOAM,
fast_gicp's GaussianVoxelMap for VGICP). Pointer trees don't map to
fixed-shape array programs; this module replaces them with an open-addressed voxel hash table built
entirely from scatters and gathers:

  * build: every point hashes its voxel coord into a slot; the lowest
    point index claims the slot (scatter-min), claims are verified by
    coordinate equality, and per-voxel Gaussian stats (count, mean,
    covariance) accumulate by scatter-add — fast_gicp's VGICP voxel map
    (mean + covariance per voxel) reconstructed without the C++ class.
  * query: a point looks up its own voxel and any neighbour offsets
    (DIRECT1 / DIRECT7 / DIRECT27 like fast_gicp's NeighborSearchMethod)
    with pure gathers.

Memory layout is performance-critical: the whole cell is PACKED into one
(H, 16) float32 row [coords(3) count mean(3) cov_sym(6) valid pad(2)] so
a lookup is a single contiguous 64-byte row gather instead of several
small strided gathers from separate (H,), (H,3), (H,3,3) arrays. Voxel
coords are
exact in float32 for any |coord| < 2^24 (bounds crops guarantee this);
the UNCLAIMED sentinel 2^30 is also exact.

All shapes static; collisions lose points (bounded by table load
factor), which only thins the map slightly — same failure mode as
voxel downsampling.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .pointcloud import PointCloud

# Odd multipliers (golden-ratio style) for the spatial hash; uint32
# wraparound is part of the hash.
_P1, _P2, _P3 = 0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D

_UNCLAIMED = jnp.int32(2**30)

# packed row layout
_C0, _CNT, _MU, _COV, _VALID = 0, 3, 4, 7, 13
_ROW = 16
# symmetric cov order: xx yy zz xy xz yz
_SYM_I = jnp.array([0, 1, 2, 0, 0, 1])
_SYM_J = jnp.array([0, 1, 2, 1, 2, 2])


def _sym6_from_cov(cov: jax.Array) -> jax.Array:
    """(..., 3, 3) -> (..., 6)."""
    return cov[..., _SYM_I, _SYM_J]


def _cov_from_sym6(s: jax.Array) -> jax.Array:
    """(..., 6) -> (..., 3, 3)."""
    xx, yy, zz, xy, xz, yz = (s[..., k] for k in range(6))
    return jnp.stack(
        [
            jnp.stack([xx, xy, xz], axis=-1),
            jnp.stack([xy, yy, yz], axis=-1),
            jnp.stack([xz, yz, zz], axis=-1),
        ],
        axis=-2,
    )


class VoxelGrid(NamedTuple):
    """Open-addressed voxel table of Gaussian cells (packed rows)."""

    packed: jax.Array  # (H, 16) float32
    leaf: jax.Array    # () float32

    @property
    def table_size(self) -> int:
        return self.packed.shape[-2]

    # --- derived views (cheap slices; use sparingly on hot paths) -----
    @property
    def coords(self) -> jax.Array:
        return self.packed[..., _C0:_C0 + 3].astype(jnp.int32)

    @property
    def count(self) -> jax.Array:
        return self.packed[..., _CNT]

    @property
    def mean(self) -> jax.Array:
        return self.packed[..., _MU:_MU + 3]

    @property
    def cov(self) -> jax.Array:
        return _cov_from_sym6(self.packed[..., _COV:_COV + 6])

    @property
    def valid(self) -> jax.Array:
        return self.packed[..., _VALID] > 0.5


def _pack(coords_i, count, mean, cov, valid) -> jax.Array:
    H = count.shape[-1]
    row = jnp.zeros((*count.shape, _ROW), jnp.float32)
    row = row.at[..., _C0:_C0 + 3].set(coords_i.astype(jnp.float32))
    row = row.at[..., _CNT].set(count)
    row = row.at[..., _MU:_MU + 3].set(mean)
    row = row.at[..., _COV:_COV + 6].set(_sym6_from_cov(cov))
    row = row.at[..., _VALID].set(valid.astype(jnp.float32))
    return row


def _hash(ijk: jax.Array, table_size: int) -> jax.Array:
    u = ijk.astype(jnp.uint32)
    h = (
        u[..., 0] * jnp.uint32(_P1)
        + u[..., 1] * jnp.uint32(_P2)
        + u[..., 2] * jnp.uint32(_P3)
    )
    # full avalanche finalizer (lowbias32) — structured lidar scenes put
    # coords on axis-aligned lattices, which defeats weaker mixes
    h = h ^ (h >> 16)
    h = h * jnp.uint32(0x7FEB352D)
    h = h ^ (h >> 15)
    h = h * jnp.uint32(0x846CA68B)
    h = h ^ (h >> 16)
    return (h % jnp.uint32(table_size)).astype(jnp.int32)


@partial(jax.jit, static_argnames=("table_size", "min_points", "regularize"))
def build(
    pc: PointCloud,
    leaf: float,
    table_size: int,
    point_covs: jax.Array | None = None,
    min_points: int = 1,
    regularize: str = "none",
) -> VoxelGrid:
    """Build a Gaussian voxel map from a masked cloud.

    point_covs: optional per-point (N, 3, 3) covariances to average into
    cells (fast_gicp VGICP averages neighbourhood covariances); without
    them cell covariance is the scatter of member points.

    regularize: 'none' | 'plane' — 'plane' clamps eigenvalues to
    (1, 1, 1e-3) scale like fast_gicp's RegularizationMethod::PLANE.
    """
    leaf = jnp.float32(leaf)
    ijk = jnp.floor(pc.xyz / leaf).astype(jnp.int32)
    n = pc.xyz.shape[0]
    slot = _hash(ijk, table_size)
    # Claim: lowest point index wins the slot.
    claim = jnp.full((table_size,), n, jnp.int32).at[slot].min(
        jnp.where(pc.mask, jnp.arange(n, dtype=jnp.int32), n)
    )
    have_owner = claim < n
    owner_idx = jnp.minimum(claim, n - 1)
    cell_coord = ijk[owner_idx]
    # A point contributes iff its voxel coord matches the slot owner's.
    contrib = pc.mask & jnp.all(ijk == cell_coord[slot], axis=-1)
    w = contrib.astype(jnp.float32)
    count = jnp.zeros((table_size,), jnp.float32).at[slot].add(w)
    xsum = jnp.zeros((table_size, 3), jnp.float32).at[slot].add(
        pc.xyz * w[:, None]
    )
    mean = xsum / jnp.maximum(count[:, None], 1.0)
    # E[xx^T] - mu mu^T (second moment scatter).
    xx = jnp.einsum("ni,nj->nij", pc.xyz, pc.xyz)
    xxsum = jnp.zeros((table_size, 3, 3), jnp.float32).at[slot].add(
        xx * w[:, None, None]
    )
    cov = xxsum / jnp.maximum(count[:, None, None], 1.0) - jnp.einsum(
        "hi,hj->hij", mean, mean
    )
    if point_covs is not None:
        csum = jnp.zeros((table_size, 3, 3), jnp.float32).at[slot].add(
            point_covs * w[:, None, None]
        )
        cov = cov + csum / jnp.maximum(count[:, None, None], 1.0)
    valid = have_owner & (count >= min_points)
    if regularize == "plane":
        from . import linalg3

        evals, V = linalg3.eigh3(cov + 1e-9 * jnp.eye(3))
        scale = jnp.maximum(evals[..., 2:3], 1e-6)
        clamped = jnp.maximum(evals / scale, 1e-3) * scale
        # component-form reconstruction C = V diag(clamped) V^T: the
        # einsum "hik,hk,hjk->hij" dot_general materializes (H, 3, 3)
        # temporaries with padded minor dims; elementwise sums over the
        # 3 eigenvectors fuse with no (H, 3, 3) tensors
        cov_comp = []
        for i, j in ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2)):
            cov_comp.append(sum(
                clamped[..., k] * V[..., i, k] * V[..., j, k]
                for k in range(3)
            ))
        cxx, cyy, czz, cxy, cxz, cyz = cov_comp
        cov = jnp.stack([
            jnp.stack([cxx, cxy, cxz], axis=-1),
            jnp.stack([cxy, cyy, cyz], axis=-1),
            jnp.stack([cxz, cyz, czz], axis=-1),
        ], axis=-2)
    coords_i = jnp.where(have_owner[:, None], cell_coord, _UNCLAIMED)
    return VoxelGrid(packed=_pack(coords_i, count, mean, cov, valid), leaf=leaf)


# Neighbour offset sets, mirroring fast_gicp NeighborSearchMethod.
OFFSETS = {
    "direct1": jnp.zeros((1, 3), jnp.int32),
    "direct7": jnp.array(
        [[0, 0, 0], [1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
        jnp.int32,
    ),
    "direct27": jnp.stack(
        jnp.meshgrid(
            jnp.arange(-1, 2), jnp.arange(-1, 2), jnp.arange(-1, 2), indexing="ij"
        ),
        axis=-1,
    ).reshape(-1, 3).astype(jnp.int32),
}


@partial(jax.jit, static_argnames=("neighbors",))
def lookup(grid: VoxelGrid, xyz: jax.Array, neighbors: str = "direct1"):
    """Gather the Gaussian cells containing `xyz` (M, 3) and neighbours.

    ONE contiguous row gather per (query, offset); everything else is
    slicing the gathered rows. Returns per query and per offset K:
      found (M, K) bool, count (M, K), mean (M, K, 3), cov (M, K, 3, 3).
    """
    offs = OFFSETS[neighbors]
    ijk = jnp.floor(xyz / grid.leaf).astype(jnp.int32)
    nijk = ijk[:, None, :] + offs[None, :, :]  # (M, K, 3)
    slot = _hash(nijk, grid.table_size)
    rows = grid.packed[slot]  # (M, K, 16) — single row gather
    found = (rows[..., _VALID] > 0.5) & jnp.all(
        rows[..., _C0:_C0 + 3] == nijk.astype(jnp.float32), axis=-1
    )
    count = rows[..., _CNT]
    mean = rows[..., _MU:_MU + 3]
    cov = _cov_from_sym6(rows[..., _COV:_COV + 6])
    return found, count, mean, cov


@partial(jax.jit, static_argnames=("neighbors",))
def lookup_rows(grid: VoxelGrid, xyz: jax.Array, neighbors: str = "direct1"):
    """Raw packed lookup for fused consumers: (rows (M, K, 16),
    found (M, K)). Row layout: see module docstring."""
    offs = OFFSETS[neighbors]
    ijk = jnp.floor(xyz / grid.leaf).astype(jnp.int32)
    nijk = ijk[:, None, :] + offs[None, :, :]
    slot = _hash(nijk, grid.table_size)
    rows = grid.packed[slot]
    found = (rows[..., _VALID] > 0.5) & jnp.all(
        rows[..., _C0:_C0 + 3] == nijk.astype(jnp.float32), axis=-1
    )
    return rows, found


@jax.jit
def nearest_cell(grid: VoxelGrid, xyz: jax.Array):
    """Single-cell lookup convenience: (found (M,), mean, cov, count)."""
    found, count, mean, cov = lookup(grid, xyz, "direct1")
    return found[:, 0], mean[:, 0], cov[:, 0], count[:, 0]


@partial(jax.jit, static_argnames=("min_points",))
def insert(grid: VoxelGrid, pc: PointCloud, min_points: int = 1) -> VoxelGrid:
    """Incrementally merge a cloud into an existing (unregularized) grid.

    The functional replacement for ikd-Tree `Add_Points`
    (`FAST_LIO/src/laserMapping.cpp:466-467`): existing cells accumulate
    moments; new voxels claim empty slots (lowest point index wins);
    points hashing onto a foreign occupied slot are dropped (collision,
    bounded by load factor). Must not be used on grids built with
    `regularize='plane'` — regularization destroys the raw moments.
    """
    leaf = grid.leaf
    ijk = jnp.floor(pc.xyz / leaf).astype(jnp.int32)
    n = pc.xyz.shape[0]
    table_size = grid.table_size
    slot = _hash(ijk, table_size)
    coords0 = grid.coords
    occupied = jnp.any(coords0 != _UNCLAIMED, axis=-1) | (grid.count > 0)
    # New points may claim currently-unoccupied slots.
    claim = jnp.full((table_size,), n, jnp.int32).at[slot].min(
        jnp.where(pc.mask, jnp.arange(n, dtype=jnp.int32), n)
    )
    newly_claimed = (~occupied) & (claim < n)
    owner_coord = jnp.where(
        occupied[:, None], coords0, ijk[jnp.minimum(claim, n - 1)]
    )
    owner_coord = jnp.where(
        (occupied | newly_claimed)[:, None], owner_coord, _UNCLAIMED
    )
    contrib = pc.mask & jnp.all(ijk == owner_coord[slot], axis=-1)
    w = contrib.astype(jnp.float32)
    # Reconstruct moments, accumulate, renormalize.
    c0 = grid.count
    mean0 = grid.mean
    xsum = mean0 * c0[:, None]
    xxsum = (grid.cov + jnp.einsum("hi,hj->hij", mean0, mean0)) * c0[
        :, None, None
    ]
    count = c0.at[slot].add(w)
    xsum = xsum.at[slot].add(pc.xyz * w[:, None])
    xxsum = xxsum.at[slot].add(
        jnp.einsum("ni,nj->nij", pc.xyz, pc.xyz) * w[:, None, None]
    )
    mean = xsum / jnp.maximum(count[:, None], 1.0)
    cov = xxsum / jnp.maximum(count[:, None, None], 1.0) - jnp.einsum(
        "hi,hj->hij", mean, mean
    )
    valid = (count >= min_points) & jnp.any(owner_coord != _UNCLAIMED, axis=-1)
    return VoxelGrid(packed=_pack(owner_coord, count, mean, cov, valid), leaf=leaf)


@jax.jit
def decay(grid: VoxelGrid, center: jax.Array, radius: float) -> VoxelGrid:
    """Drop cells farther than `radius` from `center`, freeing their
    slots — the moving-FOV map trim (`lasermap_fov_segment`,
    `laserMapping.cpp:232-276`, ikd-tree box delete)."""
    keep = (
        jnp.linalg.norm(grid.mean - center[None, :], axis=-1) <= radius
    ) & (grid.count > 0)
    empty_row = jnp.zeros((_ROW,), jnp.float32).at[_C0:_C0 + 3].set(
        jnp.float32(_UNCLAIMED)
    )
    packed = jnp.where(keep[:, None], grid.packed, empty_row[None, :])
    return VoxelGrid(packed=packed, leaf=grid.leaf)


def empty(leaf: float, table_size: int) -> VoxelGrid:
    """An all-unclaimed grid (odometry map initial state)."""
    row = jnp.zeros((table_size, _ROW), jnp.float32).at[:, _C0:_C0 + 3].set(
        jnp.float32(_UNCLAIMED)
    )
    return VoxelGrid(packed=row, leaf=jnp.float32(leaf))
