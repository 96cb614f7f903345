"""Cross-block bitwise determinism of shared face corners.

The reference's contract is decomposition-independent geometry
(doc/mlsgpu-user-manual.xml:494-499). ops/mls.canonical_face_field makes the
six face planes of every block's field bitwise block-independent, so two
adjacent blocks must produce IDENTICAL f32 values (and NaN pattern) on their
shared corner plane — even when the block origins are not mutually 8-aligned
(the case that produced hairline seam cracks).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from mlsgpu_tpu.ops import binning, mls

from tests import oracle

LEVELS = 3
SUB = 3
B = 1 << (LEVELS + SUB - 1)   # 32 corners per axis


# perCommit-tier suite (reference TestSet::perCommit, test/testutil.cpp:43-47):
# compile-heavy; deselect with `-m "not slow"` for the fast perBuild tier.
pytestmark = pytest.mark.slow


def eval_block(splats, origin, region, max_candidates=2048, points=None):
    n = len(splats)
    pos = splats[:, 0:3]
    r = splats[:, 3]
    valid = np.ones(n, bool)
    origin_j = jnp.asarray(np.asarray(origin, np.int32))
    region_j = jnp.asarray(np.asarray(region, np.int32))
    min_shift, max_shift = SUB, LEVELS + SUB - 1
    tpa = 1 << (max_shift - 3)
    binned = binning.bin_splats(jnp.asarray(splats), jnp.asarray(valid),
                                origin_j, min_shift, max_shift)
    starts, lens = binning.tile_segments(binned.entry_keys, min_shift,
                                         max_shift, tpa)
    field, _ = mls.eval_field(binned.entry_data, starts, lens, origin_j,
                              tpa, max_candidates, "sphere",
                              jnp.float32(0.0))
    field, fmax = mls.canonical_face_field(
        field, binned.entry_data, binned.entry_vals, starts, lens,
        origin_j, region_j, tpa, max_candidates, "sphere", 0.0)
    assert int(fmax) <= max_candidates
    if points is not None and len(points):
        field = mls.skeleton_point_field(
            field, binned.entry_data, binned.entry_vals, starts, lens,
            origin_j, jnp.asarray(np.asarray(points, np.int32)), tpa,
            max_candidates, "sphere", 0.0)
    return np.asarray(field)


def test_shared_face_bitwise_equal_across_cap_growth():
    """The seam-crack risk case of cap growth vs determinism: a cap retry mid-run leaves adjacent blocks computed by
    programs with DIFFERENT max_candidates. The canonical face pass must
    make the shared plane bitwise equal anyway — its candidate lists are
    canonicalized (exact rectangle filter + dedup + full-feature sort) and
    padded with exact zeros, so the fixed-shape reductions are
    K-independent whenever K is large enough to hold the patch list."""
    rng = np.random.default_rng(42)
    boundary = 24
    splats = oracle.sphere_cloud([boundary, 14.0, 14.0], 9.0, 6000, 1.2, rng)
    splats = splats.astype(np.float32)

    fa = eval_block(splats, (0, 0, 0), (boundary, B - 1, B - 1),
                    max_candidates=1024)
    fb = eval_block(splats, (boundary, 0, 0), (B - 1, B - 1, B - 1),
                    max_candidates=2048)

    plane_a = fa[:, :, boundary]
    plane_b = fb[:, :, 0]
    nan_a, nan_b = np.isnan(plane_a), np.isnan(plane_b)
    np.testing.assert_array_equal(nan_a, nan_b)
    ok = ~nan_a
    assert ok.sum() > 100
    np.testing.assert_array_equal(
        plane_a[ok].view(np.uint32), plane_b[ok].view(np.uint32))


@pytest.mark.parametrize("region_a", [28, 24])   # 28 % 8 != 0: misaligned
def test_shared_face_plane_bitwise_equal(region_a):
    rng = np.random.default_rng(42)
    # sphere surface crossing the x = region_a plane
    splats = oracle.sphere_cloud([region_a, 14.0, 14.0], 9.0, 6000, 1.2, rng)
    # grid-frame: positions already in cell units here (spacing 1)
    splats = splats.astype(np.float32)

    fa = eval_block(splats, (0, 0, 0), (region_a, B - 1, B - 1))
    fb = eval_block(splats, (region_a, 0, 0), (B - 1, B - 1, B - 1))

    plane_a = fa[:, :, region_a]    # [z, y] at x = region_a (A's high face)
    plane_b = fb[:, :, 0]           # B's low face

    nan_a = np.isnan(plane_a)
    nan_b = np.isnan(plane_b)
    np.testing.assert_array_equal(nan_a, nan_b)
    ok = ~nan_a
    assert ok.sum() > 100  # the surface actually crosses the plane
    np.testing.assert_array_equal(
        plane_a[ok].view(np.uint32), plane_b[ok].view(np.uint32))


def test_face_pass_preserves_interior_consistency():
    """Face values must still be a valid MLS evaluation: compare against the
    float64 oracle at face corners."""
    rng = np.random.default_rng(7)
    center = np.array([2.0, 14.0, 13.0])  # surface crosses the x=0 plane
    splats = oracle.sphere_cloud(center, 9.0, 8000, 1.2, rng).astype(np.float32)
    region = (B - 1, B - 1, B - 1)
    f = eval_block(splats, (0, 0, 0), region)
    plane = f[:, :, 0]
    zz, yy = np.nonzero(~np.isnan(plane))
    assert len(zz) > 50
    corners = np.stack([np.zeros_like(zz), yy, zz], axis=1).astype(np.float64)
    expect = oracle.mls_field_bruteforce(splats.astype(np.float64), corners,
                              boundary_factor=0.0)
    got = plane[zz, yy]
    finite = np.isfinite(expect)
    assert finite.mean() > 0.9
    np.testing.assert_allclose(got[finite], expect[finite],
                               rtol=2e-4, atol=2e-4)


def _mk_bucket(lo, hi):
    from mlsgpu_tpu.core.chunk import ChunkId
    from mlsgpu_tpu.pipeline.bucket import Bucket
    return Bucket(chunk_id=ChunkId(gen=0, coords=(0, 0, 0)),
                  cell_lo=np.array(lo, np.int64),
                  cell_hi=np.array(hi, np.int64),
                  blob_ids=np.empty(0, np.int64), num_splats=1)


def test_t_junction_edge_bitwise_equal():
    """Unequal-extent adjacent blocks (a T-junction from adaptive splits):
    the junction line is an edge of blocks A and C but interior to block
    B's face, so the per-axis face pass alone can keep different axes'
    values on the two sides. The skeleton point pass must make every
    shared corner — including the junction line — bitwise equal across
    all three blocks."""
    from mlsgpu_tpu.pipeline.bucket import skeleton_points
    rng = np.random.default_rng(3)
    # shell crossing the x=16 / y=16 planes and the junction line
    splats = oracle.sphere_cloud([12.0, 12.0, 16.0], 7.0, 9000, 1.2, rng)
    splats = splats.astype(np.float32)

    A = _mk_bucket((0, 0, 0), (16, 16, 31))
    C = _mk_bucket((16, 0, 0), (31, 16, 31))
    Bk = _mk_bucket((0, 16, 0), (31, 31, 31))
    skeleton_points([A, C, Bk])
    # the foreign T edge must be in Bk's point list
    sb = Bk.skeleton
    assert ((sb[:, 0] == 16) & (sb[:, 1] == 16)).sum() == 32

    fa = eval_block(splats, A.cell_lo, A.cell_hi - A.cell_lo,
                    points=A.skeleton)
    fc = eval_block(splats, C.cell_lo, C.cell_hi - C.cell_lo,
                    points=C.skeleton)
    fb = eval_block(splats, Bk.cell_lo, Bk.cell_hi - Bk.cell_lo,
                    points=Bk.skeleton)

    def cmp(pa, pb, min_defined):
        na, nb = np.isnan(pa), np.isnan(pb)
        np.testing.assert_array_equal(na, nb)
        ok = ~na
        assert ok.sum() >= min_defined
        np.testing.assert_array_equal(
            pa[ok].view(np.uint32), pb[ok].view(np.uint32))

    # shared y=16 plane: A vs Bk over x 0..16, C vs Bk over x 16..31
    cmp(fa[:, 16, 0:17], fb[:, 0, 0:17], 20)
    cmp(fc[:, 16, 0:16], fb[:, 0, 16:32], 20)
    # shared x=16 plane: A vs C over y 0..16
    cmp(fa[:, 0:17, 16], fc[:, 0:17, 0], 20)
    # the junction line itself must carry defined values somewhere
    line = fa[:, 16, 16]
    assert np.isfinite(line).sum() >= 2
