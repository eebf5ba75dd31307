"""Elevation grid sharded over the device mesh with halo exchange.

SURVEY §5.7: the reference's third scaling axis is MAP EXTENT — GEM's
ring-buffer grid is bounded by one GPU. Here the global 2.5D grid is
sharded by row blocks across the mesh and the 5x5 terrain-feature
stencil (`G_Mapfeature`) runs locally after exchanging 2-row halos with
mesh neighbours (`jax.lax.ppermute`) — the same pattern as sharded
convolutions. The result matches `elevation.features` on the unsharded
grid (window-relative coordinates make each cell's fit independent of
where its block starts).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from . import elevation

HALO = 2  # 5x5 window radius == 2 rounds of 3x3 dilation


def _exchange_and_compute(height, valid, res, *, axis, n_shards,
                          slope_crit, rough_crit, step_crit):
    """shard_map body: (Hl, W) local blocks -> local feature blocks."""
    idx = jax.lax.axis_index(axis)
    down = [(i, (i + 1) % n_shards) for i in range(n_shards)]
    up = [(i, (i - 1) % n_shards) for i in range(n_shards)]

    def halo(x, fill):
        # my bottom halo = next shard's top rows; top halo = prev's bottom
        from_prev = jax.lax.ppermute(x[-HALO:], axis, down)
        from_next = jax.lax.ppermute(x[:HALO], axis, up)
        # boundary shards received wrapped data: mask it out
        from_prev = jnp.where(idx == 0, fill, from_prev)
        from_next = jnp.where(idx == n_shards - 1, fill, from_next)
        return jnp.concatenate([from_prev, x, from_next], axis=0)

    h = halo(height, jnp.zeros_like(height[:HALO]))
    v = halo(valid, jnp.zeros_like(valid[:HALO]))
    m = elevation.ElevationMap(
        height=h, variance=jnp.ones_like(h), valid=v,
        origin=jnp.zeros(2), resolution=res,
    )
    f = elevation.features(
        m, slope_crit=slope_crit, rough_crit=rough_crit, step_crit=step_crit
    )
    crop = lambda a: a[HALO:-HALO]
    return tuple(crop(a) for a in f)


@partial(
    jax.jit,
    static_argnames=("mesh", "axis", "slope_crit", "rough_crit", "step_crit"),
)
def features_sharded(
    m: elevation.ElevationMap,
    mesh: Mesh,
    axis: str = "robot",
    slope_crit: float = 0.6,
    rough_crit: float = 0.15,
    step_crit: float = 0.3,
) -> elevation.TerrainFeatures:
    """Terrain features over a row-sharded grid. `m.height`/`m.valid`
    rows must divide by the mesh axis size (pad first if not); the
    outputs come back with the same sharding."""
    n = mesh.shape[axis]
    H = m.height.shape[0]
    if H % n or H // n < HALO:
        raise ValueError(f"grid rows {H} must split into >= {HALO}-row "
                         f"blocks across {n} shards")
    body = partial(
        _exchange_and_compute, axis=axis, n_shards=n,
        slope_crit=slope_crit, rough_crit=rough_crit, step_crit=step_crit,
    )
    fn = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P()),
        out_specs=(P(axis),) * len(elevation.TerrainFeatures._fields),
        check_vma=False,
    )
    return elevation.TerrainFeatures(
        *fn(m.height, m.valid, m.resolution.astype(jnp.float32))
    )
