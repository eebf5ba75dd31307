"""`elevation.features` against the float64 NumPy reference
(`eval/reference_terrain.py`), on dense, sparse and empty maps."""
import jax.numpy as jnp
import numpy as np
import pytest

from mr_slam_tpu.eval import reference_terrain
from mr_slam_tpu.mapping import elevation


def _map(H, W, seed, frac_valid, offset=0.0):
    rng = np.random.default_rng(seed)
    height = (rng.normal(0, 1, (H, W)).cumsum(0) * 0.02 + offset)
    # a 1.5 m wall: steep windows next to flat ones
    height[:, W // 2:W // 2 + 2] += 1.5
    valid = rng.random((H, W)) < frac_valid
    return elevation.ElevationMap(
        height=jnp.asarray(height, jnp.float32),
        variance=jnp.ones((H, W), jnp.float32),
        valid=jnp.asarray(valid),
        origin=jnp.zeros(2, jnp.float32),
        resolution=jnp.float32(0.2),
    )


# float32 sums of window-relative moments against float64: the worst
# cells (near-vertical fits at the wall) stay well under 1e-4
ATOL = 1e-4


@pytest.mark.parametrize("H,W,seed,frac_valid,offset", [
    (48, 80, 0, 0.9, 0.0),      # dense
    (40, 72, 3, 0.12, -2.0),    # sparse, below the sensor origin
    (24, 40, 5, 0.0, 0.0),      # empty
])
def test_features_match_float64_reference(H, W, seed, frac_valid, offset):
    m = _map(H, W, seed, frac_valid, offset)
    got = elevation.features(m)
    ref = reference_terrain.terrain_features(m.height, m.valid, 0.2)
    np.testing.assert_array_equal(np.asarray(got.support) >= 3, ref.enough)
    for name in ("slope", "roughness", "step", "traversability"):
        g = np.asarray(getattr(got, name))
        assert g.shape == (H, W) and np.isfinite(g).all(), name
        np.testing.assert_allclose(g, getattr(ref, name), rtol=0, atol=ATOL,
                                   err_msg=name)
    unknown = ~(ref.enough & ref.valid)
    assert np.all(np.asarray(got.traversability)[unknown] == 0.5)
