"""Loop verification seeding: dual-yaw + row-shift translation solve
(`main_RING.py:146-205` equivalent). A 10 m-offset loop in a 120 m world
exceeds the VGICP basin with yaw-only seeding; the RING SE(2) seed
recovers it."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mr_slam_tpu.datasets import synthetic
from mr_slam_tpu.frontend import keyframes as kf
from mr_slam_tpu.geometry import se3, so3
from mr_slam_tpu.geometry.se3 import Pose
from mr_slam_tpu.loop import bev, ring
from mr_slam_tpu.ops import pointcloud as pcl
from mr_slam_tpu.runtime import pipeline as pl
from mr_slam_tpu.runtime.config import SlamConfig, LoopCfg, OdometryCfg


class TestSE2Hypotheses:
    def _describe(self, pts):
        pc = pcl.PointCloud(jnp.asarray(pts, jnp.float32),
                            jnp.ones(pts.shape[0], bool))
        occ = bev.cartesian_occupancy(bev.normalize_cloud(pc))[0]
        return ring.describe(occ)

    @pytest.mark.parametrize("phi,t", [
        (0.7, (6.0, -4.0)), (-1.2, (2.0, 9.0)), (3.0, (12.0, -1.0)),
    ])
    def test_recovers_se2(self, phi, t):
        rng = np.random.default_rng(0)
        pts = rng.uniform(-45, 45, (4000, 2))
        blobs = rng.uniform(-40, 40, (30, 2))
        d = np.linalg.norm(pts[:, None] - blobs[None], axis=-1).min(1)
        pts = pts[d < 6.0]
        z = rng.uniform(0.5, 4.0, (pts.shape[0], 1))
        pa = np.concatenate([pts, z], 1)
        R2 = np.array([[np.cos(phi), -np.sin(phi)],
                       [np.sin(phi), np.cos(phi)]])
        pb = pa.copy()
        pb[:, :2] = pa[:, :2] @ R2.T + np.asarray(t)
        da, db = self._describe(pa), self._describe(pb)
        _, shift = ring.correlate(da.tiring, db.tiring[None])
        yaws, xys, res = ring.se2_hypotheses(da.sinogram, db.sinogram, shift[0])
        k = int(np.argmin(np.asarray(res)))
        dyaw = (float(yaws[k]) - phi + np.pi) % (2 * np.pi) - np.pi
        terr = float(np.linalg.norm(np.asarray(xys[k]) - np.asarray(t)))
        assert abs(dyaw) < 0.1, f"yaw {float(yaws[k])} vs {phi}"
        assert terr < 3.0, f"t {np.asarray(xys[k])} vs {t}"

    def test_radon_matches_numpy_rotate_and_sum(self):
        """`radon` against a float64 NumPy loop over angles: bilinear
        resampling of the image rotated about its centre (zero outside),
        summed down the columns."""
        rng = np.random.default_rng(2)
        size, n_angles = 40, 24
        img = (rng.random((size, size)) < 0.2).astype(np.float64)
        c = (size - 1) / 2.0
        u = np.arange(size) - c
        X, Y = np.meshgrid(u, u, indexing="xy")
        expect = np.zeros((n_angles, size))
        for a, th in enumerate(np.linspace(0, np.pi, n_angles,
                                           endpoint=False)):
            xr = np.cos(th) * X - np.sin(th) * Y + c
            yr = np.sin(th) * X + np.cos(th) * Y + c
            x0, y0 = np.floor(xr).astype(int), np.floor(yr).astype(int)
            rot = np.zeros((size, size))
            for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
                xi, yi = x0 + dx, y0 + dy
                w = ((xr - x0) if dx else (1 - (xr - x0))) * (
                    (yr - y0) if dy else (1 - (yr - y0)))
                ok = (xi >= 0) & (xi < size) & (yi >= 0) & (yi < size)
                rot += np.where(
                    ok, img[np.clip(yi, 0, size - 1),
                            np.clip(xi, 0, size - 1)] * w, 0.0)
            expect[a] = rot.sum(axis=0)
        got = np.asarray(ring.radon(jnp.asarray(img, jnp.float32), n_angles))
        np.testing.assert_allclose(got, expect, rtol=0, atol=1e-4)

    def test_align_sinogram_matches_rotated_image(self):
        rng = np.random.default_rng(1)
        img = jnp.asarray(rng.random((120, 120)), jnp.float32)
        sino = ring.radon(img, 120)
        # rotating points by phi = shift*pi/A == sampling the image
        # rotated by -phi in pixel space; check row 0 of the aligned
        # sinogram equals the row at -shift with the rho flip applied
        shift = 37
        aligned = ring.align_sinogram(sino, jnp.int32(shift))
        expect_row0 = np.flip(np.asarray(sino[(0 - shift) % 120]))
        np.testing.assert_allclose(
            np.asarray(aligned[0]), expect_row0, rtol=1e-5, atol=1e-5
        )


@pytest.mark.slow
class TestOffsetLoopVerification:
    def test_ring_seed_recovers_10m_offset(self):
        world = synthetic.default_world(seed=11, extent=60.0, n_boxes=40)
        cfg = SlamConfig(
            odometry=OdometryCfg(table_size=1 << 16, scan_capacity=4096),
            loops=LoopCfg(method="ring", fitness_thresh=0.15,
                          verify_window=0, bev_z_min=0.3,
                          verify_leaf=0.8, verify_capacity=32768),
        )
        yaw_ab = 0.9
        pose_a = Pose(so3.yaw_rot(jnp.float32(0.3)),
                      jnp.array([-4.0, 2.0, 0.0]))
        pose_b = Pose(so3.yaw_rot(jnp.float32(0.3 + yaw_ab)),
                      jnp.array([6.0, 4.0, 0.0]))  # ~10.2 m offset
        scans = {}
        for name, pose in (("a", pose_a), ("b", pose_b)):
            xyz, _, hit = synthetic.scan(
                world, pose, n_rings=32, n_azimuth=1024,
                key=jax.random.PRNGKey(3),
            )
            scans[name] = synthetic.scan_to_cloud(xyz, hit)

        stores = {}
        for name, pose in (("a", pose_a), ("b", pose_b)):
            s = kf.init(4, scans[name].xyz.shape[0])
            s, added = kf.maybe_add(s, scans[name], pose, jnp.float32(0.0),
                                    dist_thresh=0.0, leaf=0.1)
            assert bool(added)
            stores[name] = s

        descs = {
            n: pl.compute_descriptors(stores[n], cfg) for n in ("a", "b")
        }
        d, yaw = pl._descriptor_distances(descs["a"], 0, descs["b"], cfg)
        yaw0 = float(np.asarray(yaw)[0])

        true_rel = se3.between(pose_b, pose_a)  # rel = T_b^-1 T_a

        # full SE(2) seeding: must verify and recover the offset
        accept, rel, fit = pl._verify_loop(
            stores["a"], 0, stores["b"], 0, yaw0, cfg,
            descs_a=descs["a"], descs_b=descs["b"],
        )
        assert accept, f"ring-seeded verify rejected (fitness {fit})"
        terr = float(jnp.linalg.norm(rel.t - true_rel.t))
        assert terr < 1.0, f"rel.t {np.asarray(rel.t)} vs {np.asarray(true_rel.t)}"

        # yaw-only seeding at zero translation: outside the VGICP basin
        acc0, rel0, fit0 = pl._verify_loop(
            stores["a"], 0, stores["b"], 0, yaw0, cfg,
        )
        terr0 = float(jnp.linalg.norm(rel0.t - true_rel.t))
        assert (not acc0) or terr0 > 2.0, (
            f"yaw-only seeding unexpectedly solved the 10 m offset "
            f"(fitness {fit0}, terr {terr0})"
        )
