"""MLS fit + field tests (mirrors test/test_mls.cpp: analytic sphere/plane
fixtures, solveQuadratic cases, recovered distances within tolerance)."""

import numpy as np
import pytest

import jax.numpy as jnp

from mlsgpu_tpu.models.common import solve_quadratic
from mlsgpu_tpu.models.sphere import sphere_distance
from mlsgpu_tpu.models.plane import plane_distance
from mlsgpu_tpu.ops import binning, mls

from tests import oracle


class TestSolveQuadratic:
    """Cases from test_mls.cpp's testSolveQuadratic suite."""

    def check(self, a, b, c, expected):
        got = float(solve_quadratic(jnp.float32(a), jnp.float32(b), jnp.float32(c)))
        if expected is None:
            assert np.isnan(got)
        else:
            assert got == pytest.approx(expected, abs=1e-5)

    def test_linear(self):
        self.check(0.0, 2.0, -4.0, 2.0)   # 2x - 4 = 0

    def test_quadratic_larger_root(self):
        self.check(1.0, 0.0, -4.0, 2.0)   # x^2 - 4: larger root since a > 0

    def test_quadratic_smaller_root(self):
        self.check(-1.0, 0.0, 4.0, -2.0)  # -x^2 + 4: smaller root since a < 0

    def test_shifted(self):
        # (x-1)(x-3) = x^2 -4x +3 ... b must be >= 0, use (x+1)(x+3): roots -1,-3
        self.check(1.0, 4.0, 3.0, -1.0)

    def test_no_roots(self):
        self.check(1.0, 0.0, 1.0, None)

    def test_degenerate_all_zero(self):
        self.check(0.0, 0.0, 0.0, None)


def _moments_from_splats(splats, corner):
    """Corner-centered float32 moments (helper mirroring sphereFitAdd)."""
    s = jnp.asarray(splats, jnp.float32)
    p = s[:, 0:3] - jnp.asarray(corner, jnp.float32)
    pp = jnp.sum(p * p, axis=1)
    d = pp * (1.0 / s[:, 3] ** 2)
    keep = d < 0.99
    w = jnp.where(keep, (1 - d) ** 4 * s[:, 7], 0.0)
    return (jnp.sum(w), w @ p, jnp.dot(w, pp), w @ s[:, 4:7],
            jnp.dot(w, jnp.sum(s[:, 4:7] * p, axis=1)),
            jnp.sum(keep.astype(jnp.int32)))


class TestSphereFit:
    def test_exact_sphere_recovery(self):
        """Splats exactly on a sphere with exact normals -> recovered signed
        distance equals euclidean distance to the sphere."""
        rng = np.random.default_rng(7)
        center, radius = np.array([5.0, 6.0, 7.0]), 3.0
        splats = oracle.sphere_cloud(center, radius, 200, 4.0, rng)
        for corner in ([5.0, 6.0, 9.5], [5.0, 6.0, 5.5], [7.5, 6.0, 7.0]):
            mom = _moments_from_splats(splats, corner)
            f = float(sphere_distance(*mom, boundary_factor=0.0))
            expected = np.linalg.norm(np.asarray(corner) - center) - radius
            assert f == pytest.approx(expected, abs=2e-3)

    def test_too_few_hits_is_nan(self):
        rng = np.random.default_rng(8)
        splats = oracle.sphere_cloud([0, 0, 0], 3.0, 3, 4.0, rng)  # only 3 splats
        mom = _moments_from_splats(splats, [0.0, 0.0, 3.2])
        assert np.isnan(float(sphere_distance(*mom, boundary_factor=0.0)))

    def test_boundary_rejection(self):
        """A corner far to the side of a disc of splats must be rejected when
        the boundary factor is tight."""
        rng = np.random.default_rng(9)
        splats = oracle.plane_cloud(0.0, 4.0, 300, 1.0, rng)
        corner = [8.0, 2.0, 0.5]  # beyond the disc edge
        mom = _moments_from_splats(splats, corner)
        tight = float(sphere_distance(*mom, boundary_factor=1.0 - 0.25))
        assert np.isnan(tight)


class TestPlaneFit:
    def test_plane_distance(self):
        rng = np.random.default_rng(10)
        splats = oracle.plane_cloud(2.0, 8.0, 500, 1.5, rng)
        for z in (1.0, 2.5, 3.0):
            mom = _moments_from_splats(splats, [4.0, 4.0, z])
            f = float(plane_distance(*mom, boundary_factor=0.0))
            assert f == pytest.approx(z - 2.0, abs=1e-3)


class TestFieldEval:
    """End-to-end binning + eval_field vs the float64 brute-force oracle."""

    LEVELS = 3
    SUB = 3  # block = 2^(3+3-1) = 32 corners

    def _eval(self, splats_np, K=256, fit="sphere", bf=0.0, origin=(0, 0, 0),
              valid=True, with_lens=False):
        n = splats_np.shape[0]
        splats = jnp.asarray(splats_np)
        valid = jnp.full(n, valid, dtype=bool)
        min_s, max_s = self.SUB, self.LEVELS + self.SUB - 1
        origin = jnp.asarray(origin, jnp.int32)
        binned = binning.bin_splats(splats, valid, origin, min_s, max_s)
        tpa = 1 << (max_s - 3)
        starts, lens = binning.tile_segments(binned.entry_keys, min_s, max_s, tpa)
        field, max_total = mls.eval_field(
            binned.entry_data, starts, lens, origin, tpa, K, fit,
            jnp.float32(bf), tile_chunk=8)
        assert int(max_total) <= K
        if with_lens:
            return np.asarray(field), np.asarray(lens), tpa
        return np.asarray(field)

    def _oracle_field(self, splats_np, b, bf=0.0, fit="sphere",
                      origin=(0, 0, 0)):
        g = np.arange(b)
        zz, yy, xx = np.meshgrid(g, g, g, indexing="ij")
        corners = np.stack([xx.ravel(), yy.ravel(), zz.ravel()], 1).astype(np.float64)
        corners += np.asarray(origin, np.float64)
        ref = oracle.mls_field_bruteforce(splats_np, corners, bf, fit)
        return ref.reshape(b, b, b)

    @pytest.mark.parametrize("fit", ["sphere", "plane"])
    def test_sphere_cloud_matches_oracle(self, fit):
        rng = np.random.default_rng(11)
        b = 32
        splats = oracle.sphere_cloud([16.0, 15.0, 17.0], 9.0, 1200, 2.0, rng)
        got = self._eval(splats, K=1024, fit=fit)
        ref = self._oracle_field(splats, b, fit=fit)

        got_def = np.isfinite(got)
        ref_def = np.isfinite(ref)
        # NaN patterns agree except possibly at decision boundaries
        agree = got_def == ref_def
        assert np.mean(agree) > 0.999
        both = got_def & ref_def
        assert both.sum() > 1000
        err = np.abs(got[both] - ref[both])
        assert np.quantile(err, 0.99) < 2e-3
        assert err.max() < 2e-2

    def test_varied_radii_levels(self):
        """Mix of small and large splats exercises multiple octree levels."""
        rng = np.random.default_rng(12)
        small = oracle.sphere_cloud([16, 16, 16], 10.0, 800, 1.5, rng)
        large = oracle.sphere_cloud([16, 16, 16], 10.0, 150, 12.0, rng)
        splats = np.concatenate([small, large])
        got = self._eval(splats, K=1024)
        ref = self._oracle_field(splats, 32)
        both = np.isfinite(got) & np.isfinite(ref)
        assert np.mean((np.isfinite(got) == np.isfinite(ref))) > 0.999
        err = np.abs(got[both] - ref[both])
        assert np.quantile(err, 0.99) < 5e-3

    def test_splats_outside_block(self):
        """Splats centered outside the block must still influence boundary
        corners (clamped entries, octree.cl prepare semantics)."""
        rng = np.random.default_rng(13)
        # plane z=0.5 made of splats centered slightly outside x range too
        splats = oracle.plane_cloud(0.5, 40.0, 2000, 2.0, rng)
        splats[:, 0] -= 4.0  # shift x to [-4, 36]
        got = self._eval(splats, K=1024)
        ref = self._oracle_field(splats, 32)
        both = np.isfinite(got) & np.isfinite(ref)
        assert both.sum() > 500
        np.testing.assert_allclose(got[both], ref[both], atol=5e-3)
        # corners near x=0 boundary specifically
        edge = both[:, :, 0:2]
        assert edge.sum() > 10

    def test_empty_tiles_nan(self):
        rng = np.random.default_rng(14)
        splats = oracle.sphere_cloud([8, 8, 8], 3.0, 500, 1.0, rng)
        got = self._eval(splats)
        # far corner: no splats anywhere near -> NaN
        assert np.isnan(got[31, 31, 31])

    def test_boundary_factor_matches_oracle(self):
        """A nonzero boundary limit rejects the corners the oracle rejects."""
        rng = np.random.default_rng(34)
        splats = oracle.plane_cloud(15.5, 20.0, 1500, 2.0, rng)
        got = self._eval(splats, K=1024, bf=0.75)
        ref = self._oracle_field(splats, 32, bf=0.75)
        assert np.mean(np.isfinite(got) == np.isfinite(ref)) > 0.999
        both = np.isfinite(got) & np.isfinite(ref)
        assert both.sum() > 500
        assert np.quantile(np.abs(got[both] - ref[both]), 0.99) < 2e-3

    def test_nonzero_origin_matches_oracle(self):
        """A block away from the grid origin evaluates its own corners."""
        rng = np.random.default_rng(35)
        origin = (32, 64, 96)
        splats = oracle.sphere_cloud([48.0, 79.0, 111.0], 9.0, 1500, 2.0, rng)
        got = self._eval(splats, K=1024, origin=origin)
        ref = self._oracle_field(splats, 32, origin=origin)
        assert np.mean(np.isfinite(got) == np.isfinite(ref)) > 0.999
        both = np.isfinite(got) & np.isfinite(ref)
        assert both.sum() > 1000
        assert np.quantile(np.abs(got[both] - ref[both]), 0.99) < 2e-3

    def test_tiles_without_candidates_all_nan(self):
        """Every corner of a tile whose segments are empty is undefined."""
        rng = np.random.default_rng(33)
        splats = oracle.sphere_cloud([8.0, 8.0, 8.0], 3.0, 600, 1.5, rng)
        got, lens, tpa = self._eval(splats, with_lens=True)
        totals = lens.sum(axis=1).reshape(tpa, tpa, tpa)
        assert (totals == 0).any() and (totals > 0).any()
        tiles = got.reshape(tpa, 8, tpa, 8, tpa, 8).transpose(0, 2, 4, 1, 3, 5)
        assert np.isnan(tiles[totals == 0]).all()

    def test_no_valid_splats_all_nan(self):
        splats = oracle.sphere_cloud([8.0, 8.0, 8.0], 3.0, 64, 1.5,
                                     np.random.default_rng(36))
        got = self._eval(splats, valid=False)
        assert got.shape == (32, 32, 32)
        assert np.isnan(got).all()

    def test_candidate_overflow_reported(self):
        rng = np.random.default_rng(15)
        splats = oracle.sphere_cloud([16, 16, 16], 8.0, 2000, 2.0, rng)
        splats_j = jnp.asarray(splats)
        valid = jnp.ones(len(splats), dtype=bool)
        origin = jnp.zeros(3, jnp.int32)
        binned = binning.bin_splats(splats_j, valid, origin, 3, 5)
        starts, lens = binning.tile_segments(binned.entry_keys, 3, 5, 4)
        _, max_total = mls.eval_field(binned.entry_data, starts, lens, origin,
                                      4, 16, "sphere", jnp.float32(0.0),
                                      tile_chunk=8)
        assert int(max_total) > 16  # host would retry with larger K
