"""Host pipeline tests: blobs, bucketing, splat sources, mesher
(mirrors test/test_splat_set.cpp, test/test_bucket.cpp, test/test_mesher.cpp)."""

import numpy as np
import pytest

from mlsgpu_tpu.core.chunk import ChunkId
from mlsgpu_tpu.core.grid import Grid
from mlsgpu_tpu.io.splat_set import FileSource, SequenceSource, merge_ranges
from mlsgpu_tpu.io import ply
from mlsgpu_tpu.pipeline import blobs as blobs_mod
from mlsgpu_tpu.pipeline import bucket as bucket_mod
from mlsgpu_tpu.pipeline.mesher import BlockInput, OOCMesher
from mlsgpu_tpu.utils.errors import DensityError
from mlsgpu_tpu.utils.manifold import check_manifold

from tests import oracle


# perCommit-tier suite (reference TestSet::perCommit, test/testutil.cpp:43-47):
# compile-heavy; deselect with `-m "not slow"` for the fast perBuild tier.
pytestmark = pytest.mark.slow


def make_cloud(n=5000, seed=0, center=(5, 5, 5), radius=3.0, sr=0.1):
    rng = np.random.default_rng(seed)
    return oracle.sphere_cloud(center, radius, n, sr, rng)


class TestSplatSources:
    """Contract tests run against every source model (the reference's
    TestSplatSet<SetType> pattern, test/test_splat_set.h:231-380)."""

    @pytest.fixture(params=["sequence", "files"])
    def source(self, request, tmp_path):
        splats = make_cloud(1000)
        if request.param == "sequence":
            yield SequenceSource(splats), splats
        else:
            # split into 3 files to exercise file boundaries
            paths = []
            for i, seg in enumerate(np.array_split(splats, 3)):
                p = str(tmp_path / f"part{i}.ply")
                ply.write_splats_ply(p, seg)
                paths.append(p)
            src = FileSource(paths, smooth=1.0)
            yield src, splats
            src.close()

    def test_len(self, source):
        src, splats = source
        assert len(src) == len(splats)

    def test_iter_chunks_covers_all(self, source):
        src, splats = source
        got = []
        next_id = 0
        for first, chunk in src.iter_chunks(chunk_size=137):
            assert first == next_id
            next_id += len(chunk)
            got.append(chunk)
        got = np.concatenate(got)
        np.testing.assert_allclose(got[:, :7], splats[:, :7], rtol=1e-6)

    def test_read_ranges(self, source):
        src, splats = source
        ranges = [(10, 50), (400, 700), (990, 1000)]
        got = src.read_ranges(ranges)
        expect = np.concatenate([splats[a:b] for a, b in ranges])
        np.testing.assert_allclose(got[:, :7], expect[:, :7], rtol=1e-6)

    def test_read_ranges_across_files(self, source):
        src, splats = source
        got = src.read_ranges([(300, 680)])  # spans file boundaries
        np.testing.assert_allclose(got[:, :7], splats[300:680, :7], rtol=1e-6)


def test_merge_ranges():
    assert merge_ranges([(5, 10), (0, 3), (9, 12), (3, 5)]) == [(0, 12)]
    assert merge_ranges([(0, 2), (4, 6)]) == [(0, 2), (4, 6)]
    assert merge_ranges([(0, 2), (4, 6)], max_gap=2) == [(0, 6)]
    assert merge_ranges([]) == []


class TestBlobs:
    def test_blob_compression_and_coverage(self):
        splats = make_cloud(3000, radius=2.0, sr=0.05)
        src = SequenceSource(splats)
        info = blobs_mod.compute_blobs(src, spacing=0.1, micro_cells=16)
        blobs = info.blobs
        # every splat covered exactly once, in order
        assert blobs.num_splats == 3000
        ends = blobs.start + blobs.count
        assert blobs.start[0] == 0
        np.testing.assert_array_equal(blobs.start[1:], ends[:-1])
        # ranges are conservative: recompute per-splat micro range
        inv = np.float32(1.0) / np.float32(0.1)
        pos, r = splats[:, :3], splats[:, 3][:, None]
        lo = np.floor_divide(np.floor((pos - r) * inv).astype(np.int64), 16)
        hi = np.floor_divide(np.floor((pos + r) * inv).astype(np.int64), 16)
        for b in range(len(blobs)):
            s, e = blobs.start[b], blobs.start[b] + blobs.count[b]
            np.testing.assert_array_equal(lo[s:e], blobs.lo[b][None].repeat(e - s, 0))
            np.testing.assert_array_equal(hi[s:e], blobs.hi[b][None].repeat(e - s, 0))
        # grid covers all influence
        gmin = np.array([e[0] for e in info.grid.extents])
        gmax = np.array([e[1] for e in info.grid.extents])
        assert (np.floor((pos - r) * inv) >= gmin).all()
        assert (np.floor((pos + r) * inv) + 1 <= gmax).all()

    def test_nonfinite_skipped(self):
        splats = make_cloud(100)
        splats[10, 0] = np.nan
        splats[50, 3] = -1.0
        info = blobs_mod.compute_blobs(SequenceSource(splats), 0.1, 16)
        assert info.num_nonfinite == 2
        covered = np.zeros(100, dtype=bool)
        for b in range(len(info.blobs)):
            s, e = info.blobs.start[b], info.blobs.start[b] + info.blobs.count[b]
            covered[s:e] = True
        assert not covered[10] and not covered[50]
        assert covered.sum() == 98

    def test_chunk_boundary_runs(self):
        """A run crossing iter_chunks boundaries must stay one blob."""
        splats = np.tile(make_cloud(1)[0], (500, 1))  # 500 identical splats
        src = SequenceSource(splats)
        # force tiny chunks
        orig = src.iter_chunks
        info = blobs_mod.compute_blobs(
            type("S", (), {"iter_chunks": lambda self, chunk_size=0: orig(37),
                           "__len__": lambda self: 500,
                           "read_ranges": None})(), 0.1, 16)
        assert len(info.blobs) == 1
        assert info.blobs.count[0] == 500


class TestBucketing:
    def test_regions_cover_and_respect_budgets(self):
        splats = make_cloud(20000, radius=4.0, sr=0.05)
        src = SequenceSource(splats)
        info = blobs_mod.compute_blobs(src, spacing=0.05, micro_cells=16)
        buckets = bucket_mod.make_buckets(info, block_cells=63, micro_cells=16,
                                          max_splats=3000)
        assert buckets
        grid_cells = np.asarray(info.grid.shape_cells)
        inv = np.float32(1.0) / np.float32(0.05)
        ext_lo = np.array([e[0] for e in info.grid.extents])
        pos, r = splats[:, :3], splats[:, 3][:, None]
        slo = np.floor((pos - r) * inv).astype(np.int64) - ext_lo
        shi = np.floor((pos + r) * inv).astype(np.int64) - ext_lo
        covered = np.zeros(len(splats), dtype=bool)
        for b in buckets:
            assert (b.cells <= 63).all()
            assert (b.cell_lo >= 0).all() and (b.cell_hi <= grid_cells).all()
            # blob ranges must include every splat whose box intersects
            ids = set()
            for i in b.blob_ids:
                s, e = info.blobs.start[i], info.blobs.start[i] + info.blobs.count[i]
                ids.update(range(int(s), int(e)))
            inter = ((shi >= b.cell_lo) & (slo < b.cell_hi)).all(axis=1)
            missing = np.nonzero(inter)[0]
            for m in missing:
                assert int(m) in ids, f"splat {m} missing from bucket"
            covered |= inter
        assert covered.all()

    def test_density_error(self):
        # all splats in one point -> cannot subdivide below budget
        splats = np.tile(make_cloud(1)[0], (500, 1))
        info = blobs_mod.compute_blobs(SequenceSource(splats), 0.1, 4)
        with pytest.raises(DensityError):
            bucket_mod.make_buckets(info, block_cells=63, micro_cells=4,
                                    max_splats=100)


class TestMesher:
    """Synthetic MesherWork-style streams (reference TestMesherBase,
    test/test_mesher.cpp:126-1210)."""

    GRID = Grid.make((0, 0, 0), 1.0, [(0, 100)] * 3)

    @staticmethod
    def quad(x0, key_base, z=0.0):
        """An open quad of 2 triangles; corners at x0..x0+1."""
        verts = np.array([[x0, 0, z], [x0 + 1, 0, z],
                          [x0, 1, z], [x0 + 1, 1, z]], np.float32)
        tris = np.array([[0, 1, 2], [1, 3, 2]])
        keys = np.arange(4) + key_base
        return verts, tris, keys

    def test_weld_across_blocks(self, tmp_path):
        mesher = OOCMesher(self.GRID, prune=0.0)
        # two blocks sharing the boundary vertices (1,0,0)=key100 and
        # (1,1,0)=key101 (externals must come last in each block)
        v1 = np.array([[0, 0, 0], [0, 1, 0], [1, 0, 0], [1, 1, 0]], np.float32)
        t1 = np.array([[0, 2, 1], [2, 3, 1]])
        mesher.add(BlockInput(ChunkId(), v1, 2, np.array([100, 101]), t1))
        v2 = np.array([[2, 0, 0], [1, 0, 0], [1, 1, 0]], np.float32)
        t2 = np.array([[1, 0, 2]])
        mesher.add(BlockInput(ChunkId(), v2, 1, np.array([100, 101]), t2))
        out = str(tmp_path / "weld.ply")
        mesher.write(out)
        verts, tris = ply.read_mesh(out)
        assert len(verts) == 5  # 4 + 3 - 2 shared
        assert len(tris) == 3
        rep = check_manifold(verts, tris)
        assert rep.is_manifold, rep.reason
        assert rep.num_components == 1
        mesher.cleanup()

    def test_pruning(self, tmp_path):
        mesher = OOCMesher(self.GRID, prune=0.4)  # threshold 0.4*12 = 4.8
        vbig, tbig, _ = self.quad(0, 0)
        # big component: 3 connected quads (8 verts)
        big_v = np.concatenate([vbig, vbig + [2, 0, 0]])
        big_t = np.concatenate([tbig, tbig + 4])
        big_t = np.concatenate([big_t, [[1, 4, 3], [4, 6, 3]]])  # connect
        mesher.add(BlockInput(ChunkId(), big_v, 8, np.zeros(0, np.int64), big_t))
        # small separate component (4 verts < 4.8)
        small_v, small_t, _ = self.quad(50, 0, z=10.0)
        mesher.add(BlockInput(ChunkId(), small_v, 4, np.zeros(0, np.int64), small_t))
        out = str(tmp_path / "pruned.ply")
        mesher.write(out)
        verts, tris = ply.read_mesh(out)
        assert len(verts) == 8  # small component pruned
        assert verts[:, 0].max() < 40
        mesher.cleanup()

    def test_pruning_merged_across_blocks_survives(self, tmp_path):
        """Components connected via external keys must be sized globally
        before pruning."""
        mesher = OOCMesher(self.GRID, prune=0.4)
        # two blocks, each a quad, connected via keys -> one 6-vert component
        v1 = np.array([[0, 0, 0], [0, 1, 0], [1, 0, 0], [1, 1, 0]], np.float32)
        t1 = np.array([[0, 2, 1], [2, 3, 1]])
        mesher.add(BlockInput(ChunkId(), v1, 2, np.array([7, 8]), t1))
        v2 = np.array([[2, 0, 0], [2, 1, 0], [1, 0, 0], [1, 1, 0]], np.float32)
        t2 = np.array([[2, 0, 3], [0, 1, 3]])
        mesher.add(BlockInput(ChunkId(), v2, 2, np.array([7, 8]), t2))
        # an isolated quad that should be pruned (4 < 0.4 * 10)
        v3, t3, _ = self.quad(50, 0, z=5.0)
        mesher.add(BlockInput(ChunkId(), v3, 4, np.zeros(0, np.int64), t3))
        out = str(tmp_path / "merge_prune.ply")
        mesher.write(out)
        verts, tris = ply.read_mesh(out)
        assert len(verts) == 6
        assert len(tris) == 4
        mesher.cleanup()

    def test_chunked_output(self, tmp_path):
        mesher = OOCMesher(self.GRID, prune=0.0)
        for i, cid in enumerate([ChunkId(0, (0, 0, 0)), ChunkId(1, (1, 0, 0))]):
            v, t, _ = self.quad(i * 10, 0)
            mesher.add(BlockInput(cid, v, 4, np.zeros(0, np.int64), t))
        out = str(tmp_path / "chunks.ply")
        files = mesher.write(out, split_size=1000)
        assert len(files) == 2
        for f in files:
            verts, tris = ply.read_mesh(f)
            assert len(verts) == 4 and len(tris) == 2
        mesher.cleanup()

    def test_checkpoint_resume(self, tmp_path):
        mesher = OOCMesher(self.GRID, prune=0.0)
        v, t, _ = self.quad(0, 0)
        mesher.add(BlockInput(ChunkId(), v, 4, np.zeros(0, np.int64), t))
        ckpt = str(tmp_path / "state.ckpt")
        mesher.checkpoint(ckpt)

        resumed = OOCMesher.resume(ckpt)
        out = str(tmp_path / "resumed.ply")
        resumed.write(out)
        verts, tris = ply.read_mesh(out)
        assert len(verts) == 4 and len(tris) == 2

    def test_world_transform(self, tmp_path):
        grid = Grid.make((10.0, 20.0, 30.0), 0.5, [(4, 10)] * 3)
        mesher = OOCMesher(grid, prune=0.0)
        v = np.array([[0, 0, 0], [2, 0, 0], [0, 2, 0]], np.float32)
        t = np.array([[0, 1, 2]])
        mesher.add(BlockInput(ChunkId(), v, 3, np.zeros(0, np.int64), t))
        out = str(tmp_path / "world.ply")
        mesher.write(out)
        verts, _ = ply.read_mesh(out)
        # grid coord 0 -> world reference + spacing * extent_lo
        np.testing.assert_allclose(verts[0], [12.0, 22.0, 32.0])
        np.testing.assert_allclose(verts[1], [13.0, 22.0, 32.0])
        mesher.cleanup()


class TestSparseBucketing:
    def test_sparse_matches_dense(self):
        """The sparse (Morton-range) bucketing must produce the same region
        decomposition as the dense count grid."""
        splats = make_cloud(8000, radius=4.0, sr=0.05)
        info = blobs_mod.compute_blobs(SequenceSource(splats), 0.05, 16)
        dense = bucket_mod.bucket_regions(
            bucket_mod.microblock_counts(info.blobs, info.micro_lo,
                                         info.micro_dims),
            16, np.asarray(info.grid.shape_cells), 63, 10**9)
        codes, counts = bucket_mod.sparse_micro_counts(info.blobs,
                                                       info.micro_lo)
        sparse = bucket_mod.bucket_regions_sparse(
            codes, counts, 16, info.micro_dims, 63, 10**9)
        dn = sorted((tuple(lo), tuple(sz)) for lo, sz in dense)
        sp = sorted((tuple(lo), tuple(sz)) for lo, sz in sparse)
        assert dn == sp

    def test_sparse_fallback_huge_extent(self, monkeypatch):
        """Extents beyond the dense guard take the sparse path end-to-end."""
        monkeypatch.setattr(bucket_mod, "MAX_MICRO_GRID", 4)
        splats = make_cloud(4000, radius=4.0, sr=0.05)
        info = blobs_mod.compute_blobs(SequenceSource(splats), 0.05, 8)
        assert (info.micro_dims > 4).any()
        buckets = bucket_mod.make_buckets(info, block_cells=63, micro_cells=8,
                                          max_splats=2000)
        assert buckets
        total = sum(b.num_splats for b in buckets)
        assert total >= 4000  # conservative cover

    def test_sparse_density_error(self):
        splats = np.tile(make_cloud(1)[0], (500, 1))
        info = blobs_mod.compute_blobs(SequenceSource(splats), 0.1, 4)
        codes, counts = bucket_mod.sparse_micro_counts(info.blobs,
                                                       info.micro_lo)
        with pytest.raises(DensityError):
            bucket_mod.bucket_regions_sparse(codes, counts, 4,
                                             info.micro_dims, 63, 100)


def test_native_blob_rle_matches_numpy():
    """The C++ one-pass blob RLE must match the numpy path bitwise
    (same f32 floor expressions, same run/bbox/nonfinite semantics)."""
    from mlsgpu_tpu import _native as nat
    if not nat.available():
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(9)
    splats = oracle.sphere_cloud([1.0, -2.0, 0.5], 2.0, 30000, 0.1, rng)
    splats[17, 1] = np.nan
    splats[1000, 3] = -0.5
    splats[2000, 3] = np.inf
    src = SequenceSource(splats)
    a = blobs_mod.compute_blobs(src, 0.05, 16)
    orig = nat.available
    nat.available = lambda: False
    try:
        b = blobs_mod.compute_blobs(src, 0.05, 16)
    finally:
        nat.available = orig
    np.testing.assert_array_equal(a.blobs.start, b.blobs.start)
    np.testing.assert_array_equal(a.blobs.count, b.blobs.count)
    np.testing.assert_array_equal(a.blobs.lo, b.blobs.lo)
    np.testing.assert_array_equal(a.blobs.hi, b.blobs.hi)
    assert a.grid.extents == b.grid.extents
    assert a.num_nonfinite == b.num_nonfinite == 3


def test_caps_cache_roundtrip(tmp_path, monkeypatch):
    from mlsgpu_tpu.config import ReconstructConfig
    from mlsgpu_tpu.pipeline import reconstruct as rec
    monkeypatch.setenv("MLSGPU_TPU_CACHE_DIR", str(tmp_path))
    cfg = ReconstructConfig(levels=4)
    caps = rec.load_cached_caps(cfg)
    base_vertex = caps.vertex_cap
    caps.vertex_cap = base_vertex * 4
    caps.cell_cap *= 2
    rec.save_cached_caps(cfg, caps)
    again = rec.load_cached_caps(cfg)
    assert again.vertex_cap == base_vertex * 4
    assert again.cell_cap == caps.cell_cap
    # different geometry key is unaffected
    other = rec.load_cached_caps(ReconstructConfig(levels=5))
    assert other.vertex_cap == ReconstructConfig(levels=5).vertex_cap


@pytest.mark.slow
def test_statistics_device_staged_run(tmp_path):
    """--statistics-device runs the block step as separately-timed stages
    (the reference's --statistics-cl event timing, src/statistics_cl.h:43-93)
    and must produce the same mesh while recording per-stage device times."""
    from mlsgpu_tpu.config import ReconstructConfig
    from mlsgpu_tpu.pipeline.reconstruct import reconstruct
    from mlsgpu_tpu.utils.statistics import get_registry

    rng = np.random.default_rng(11)
    splats = oracle.sphere_cloud(np.zeros(3), 3.0, 8000, 0.35, rng)
    cfg = dict(fit_grid=0.1, fit_smooth=1.0, levels=4, subsampling=3,
               leaf_cells=8, max_device_splats=200000, tile_candidates=512,
               progress=False)
    out1 = str(tmp_path / "plain.ply")
    out2 = str(tmp_path / "staged.ply")
    reconstruct(SequenceSource(splats), ReconstructConfig(**cfg), out1)
    get_registry().clear()
    reconstruct(SequenceSource(splats),
                ReconstructConfig(statistics_device=True, **cfg), out2)
    stats = get_registry().to_dict()
    for stage in ("binning", "mls", "marching", "weld", "pack"):
        key = f"device.{stage}.time"
        assert key in stats, f"missing {key} in {sorted(stats)}"
    v1, t1 = ply.read_mesh(out1)
    v2, t2 = ply.read_mesh(out2)
    np.testing.assert_array_equal(v1, v2)
    np.testing.assert_array_equal(t1, t2)


def test_blob_store_spills_to_disk_and_matches():
    """Past --mem-blobs the blob records live in a disk-backed store
    (src/splat_set.h:824-849 analogue); results must be identical."""
    from mlsgpu_tpu.utils.statistics import get_registry
    rng = np.random.default_rng(7)
    splats = oracle.sphere_cloud(np.zeros(3), 3.0, 20000, 0.25, rng)
    src = SequenceSource(splats)
    ram = blobs_mod.compute_blobs(src, 0.1, 8)
    get_registry().clear()
    spilled = blobs_mod.compute_blobs(src, 0.1, 8, mem_budget=1024)
    assert get_registry().to_dict()["blobs.spilled"]["total"] == 1
    np.testing.assert_array_equal(np.asarray(ram.blobs.start),
                                  np.asarray(spilled.blobs.start))
    np.testing.assert_array_equal(np.asarray(ram.blobs.count),
                                  np.asarray(spilled.blobs.count))
    np.testing.assert_array_equal(np.asarray(ram.blobs.lo),
                                  np.asarray(spilled.blobs.lo))
    np.testing.assert_array_equal(np.asarray(ram.blobs.hi),
                                  np.asarray(spilled.blobs.hi))
    assert ram.grid.extents == spilled.grid.extents
    # the store is memmap-backed
    assert isinstance(spilled.blobs.start.base, np.memmap) or \
        isinstance(spilled.blobs.start, np.memmap)


@pytest.mark.slow
def test_tight_memory_budgets_end_to_end(tmp_path):
    """Tiny --mem-load-splats / --mem-host-splats / --mem-mesh budgets
    throttle the pipeline (CircularBuffer semantics,
    src/circular_buffer.h:47-248) without changing the output."""
    from mlsgpu_tpu.config import ReconstructConfig
    from mlsgpu_tpu.pipeline.reconstruct import reconstruct
    rng = np.random.default_rng(3)
    splats = oracle.sphere_cloud(np.zeros(3), 3.0, 12000, 0.3, rng)
    base = dict(fit_grid=0.1, fit_smooth=1.0, levels=3, subsampling=3,
                leaf_cells=8, max_device_splats=200000, tile_candidates=512,
                cell_cap=1 << 15, vertex_cap=1 << 17, index_cap=3 << 17,
                progress=False)
    out1 = str(tmp_path / "roomy.ply")
    out2 = str(tmp_path / "tight.ply")
    reconstruct(SequenceSource(splats), ReconstructConfig(**base), out1)
    # budgets small enough to throttle (mem_mesh forces a 1-block window)
    # but with mem_bucket_splats still above any bucket, so the block
    # decomposition — and hence the output — is unchanged
    tight = ReconstructConfig(
        mem_bucket_splats=2 << 20, mem_load_splats=2 << 20,
        mem_host_splats=4 << 20, mem_mesh=1 << 20, mem_blobs=1 << 12, **base)
    reconstruct(SequenceSource(splats), tight, out2)
    v1, t1 = ply.read_mesh(out1)
    v2, t2 = ply.read_mesh(out2)
    assert len(v1) == len(v2) and len(t1) == len(t2)


@pytest.mark.slow
def test_device_filter_chain_end_to_end(tmp_path):
    """A device-side vertex filter (the reference's MeshFilterChain run
    before readback, src/mesh_filter.h:57-170) shifts geometry on-device;
    output must equal the unfiltered run shifted by the same amount."""
    from mlsgpu_tpu.config import ReconstructConfig
    from mlsgpu_tpu.pipeline.mesh_filter import (DeviceFilterChain,
                                                 DeviceScaleBias)
    from mlsgpu_tpu.pipeline.reconstruct import reconstruct
    rng = np.random.default_rng(9)
    splats = oracle.sphere_cloud(np.zeros(3), 3.0, 8000, 0.35, rng)
    base = dict(fit_grid=0.1, fit_smooth=1.0, levels=4, subsampling=3,
                leaf_cells=8, max_device_splats=200000, tile_candidates=512,
                cell_cap=1 << 15, vertex_cap=1 << 17, index_cap=3 << 17,
                progress=False)
    out1 = str(tmp_path / "plain.ply")
    out2 = str(tmp_path / "shifted.ply")
    reconstruct(SequenceSource(splats), ReconstructConfig(**base), out1)
    chain = DeviceFilterChain([DeviceScaleBias(bias=(5.0, 0.0, 0.0))])
    reconstruct(SequenceSource(splats), ReconstructConfig(**base), out2,
                device_filter=chain)
    v1, t1 = ply.read_mesh(out1)
    v2, t2 = ply.read_mesh(out2)
    assert len(v1) == len(v2) and len(t1) == len(t2)
    # bias is in grid cells: 5 cells * 0.1 spacing = 0.5 world units in x
    np.testing.assert_allclose(
        np.sort(v2[:, 0]), np.sort(v1[:, 0]) + 0.5, atol=1e-4)


@pytest.mark.slow
def test_device_filter_scale_is_origin_independent(tmp_path):
    """DeviceScaleBias with scale != 1 must apply a single global affine
    map: the output must be scale * plain + const for one run-wide const,
    not a per-block transform (the regression: applying scale to
    block-local coords before the unscaled origin is re-added makes
    vertex positions depend on which block computed them)."""
    from mlsgpu_tpu.config import ReconstructConfig
    from mlsgpu_tpu.pipeline.mesh_filter import (DeviceFilterChain,
                                                 DeviceScaleBias)
    from mlsgpu_tpu.pipeline.reconstruct import reconstruct
    rng = np.random.default_rng(9)
    splats = oracle.sphere_cloud(np.zeros(3), 3.0, 8000, 0.35, rng)
    base = dict(fit_grid=0.1, fit_smooth=1.0, levels=4, subsampling=3,
                leaf_cells=8, max_device_splats=200000, tile_candidates=512,
                cell_cap=1 << 15, vertex_cap=1 << 17, index_cap=3 << 17,
                progress=False)
    out1 = str(tmp_path / "plain.ply")
    out2 = str(tmp_path / "scaled.ply")
    reconstruct(SequenceSource(splats), ReconstructConfig(**base), out1)
    chain = DeviceFilterChain([DeviceScaleBias(scale=2.0)])
    reconstruct(SequenceSource(splats), ReconstructConfig(**base), out2,
                device_filter=chain)
    v1, t1 = ply.read_mesh(out1)
    v2, t2 = ply.read_mesh(out2)
    assert len(v1) == len(v2) and len(t1) == len(t2)
    for ax in range(3):
        a = np.sort(v1[:, ax])
        b = np.sort(v2[:, ax])
        const = np.median(b - 2.0 * a)
        np.testing.assert_allclose(b, 2.0 * a + const, atol=1e-4)


def test_procedural_scan_source_coherent_and_consistent():
    """The OOC benchmark's procedural source must regenerate ranges
    identically and be spatially coherent enough for blob compression
    (the property FastBlobSet exploits, src/splat_set.h:653-708)."""
    from mlsgpu_tpu.tools.bench_ooc import ProceduralScanSource
    src = ProceduralScanSource(200000)
    a = src.read_ranges([(1000, 3000)])
    chunks = {start: c for start, c in src.iter_chunks(chunk_size=2048)}
    b = np.concatenate([chunks[0], chunks[2048]])[1000:3000]
    np.testing.assert_array_equal(a, b)
    assert np.isfinite(a).all()
    r = np.linalg.norm(a[:, :3], axis=1)
    np.testing.assert_allclose(r, 3.0, rtol=1e-5)
    info = blobs_mod.compute_blobs(src, spacing=src.splat_radius / 3.0,
                                   micro_cells=63)
    assert len(info.blobs) < 200000 / 5  # >=5 splats/blob on average


class TestConsumeThreaded:
    """The threaded mesher consumer (reference MesherGroup,
    src/workers.h:74-131): order preservation and two-way error
    propagation."""

    def test_preserves_order_and_consumes_all(self):
        from mlsgpu_tpu.pipeline.streamer import consume_threaded
        got = []
        consume_threaded(((i, i * i) for i in range(100)),
                         lambda a, b: got.append((a, b)))
        assert got == [(i, i * i) for i in range(100)]

    def test_consumer_error_propagates_and_stops_producer(self):
        from mlsgpu_tpu.pipeline.streamer import consume_threaded
        produced = []

        def produce():
            for i in range(1000):
                produced.append(i)
                yield i, i

        def consume(a, b):
            if a == 5:
                raise RuntimeError("mesher failed")

        with pytest.raises(RuntimeError, match="mesher failed"):
            consume_threaded(produce(), consume)
        # bounded over-production: the queue depth, not the full stream
        assert len(produced) < 50

    def test_producer_error_propagates(self):
        from mlsgpu_tpu.pipeline.streamer import consume_threaded

        def produce():
            yield 1, 1
            raise ValueError("loader failed")

        got = []
        with pytest.raises(ValueError, match="loader failed"):
            consume_threaded(produce(), lambda a, b: got.append(a))
        assert got == [1]

    def test_producer_cleanup_runs(self):
        from mlsgpu_tpu.pipeline.streamer import consume_threaded
        cleaned = []

        def produce():
            try:
                for i in range(100):
                    yield i, i
            finally:
                cleaned.append(True)

        with pytest.raises(RuntimeError):
            consume_threaded(produce(), lambda a, b: (_ for _ in ()).throw(
                RuntimeError("boom")))
        assert cleaned == [True]


class TestOverflowCheck:
    def test_stale_inflight_result_detected(self):
        """A result built with small caps must be flagged as overflowed even
        after another block's retry grew the shared caps past its counts
        (regression: the check once compared against the live caps and
        accepted a garbage in-flight block)."""
        import numpy as np
        from mlsgpu_tpu.ops.block import BlockResult
        from mlsgpu_tpu.pipeline.reconstruct import BlockCaps
        from mlsgpu_tpu.pipeline.streamer import _check_overflow

        def res(nuw):
            z = np.int32(0)
            return BlockResult(
                vertices=None, key_hi=None, key_lo=None, triangles=None,
                num_vertices=z, first_external=z, num_indices=np.int32(3),
                max_tile_candidates=z, num_cells=np.int32(1),
                num_unwelded=np.int32(nuw))

        built = BlockCaps(512, 1024, 2048, 3 * 2048, 0)
        live = BlockCaps(512, 1024, 8192, 3 * 8192, 0)  # grown meanwhile
        r = res(3000)  # fits live caps, overflows the caps it was built with
        assert _check_overflow(r, built, live) is True
        # growth never shrinks the live caps
        assert live.vertex_cap == 8192
        # and a result that fit its own caps passes
        assert _check_overflow(res(2000), built, live) is False


def test_spare_capacity_device_scheduling(monkeypatch):
    """Multi-device dispatch picks the device with the fewest in-flight
    blocks (the reference's CopyGroup picks the device with the most free
    queue slots, src/workers.cpp:315-351): on the 8-virtual-device CPU mesh
    every device is used, per-device load is balanced, and the yielded
    results are complete and correct."""
    import jax
    from mlsgpu_tpu.config import ReconstructConfig
    from mlsgpu_tpu.pipeline import streamer as streamer_mod
    from mlsgpu_tpu.pipeline.reconstruct import load_cached_caps

    devices = jax.local_devices()
    if len(devices) < 4:
        pytest.skip("needs >= 4 virtual devices")
    devices = devices[:4]

    splats = make_cloud(n=8000, seed=7)
    cfg = ReconstructConfig(fit_grid=0.1, fit_smooth=1.0, levels=4,
                            subsampling=3, leaf_cells=8,
                            max_device_splats=3000, tile_candidates=512,
                            progress=False)
    source = SequenceSource(splats)
    info = blobs_mod.compute_blobs(source, cfg.fit_grid, cfg.micro_cells)
    buckets = bucket_mod.make_buckets(info, cfg.block_cells, cfg.micro_cells,
                                      max_splats=cfg.max_device_splats)
    assert len(buckets) >= 8, "test needs several buckets"

    used = []
    real_dispatch = streamer_mod._dispatch

    def spy(padded, valid, bucket, cfg, caps, device, *a, **kw):
        used.append(device)
        return real_dispatch(padded, valid, bucket, cfg, caps, device,
                             *a, **kw)

    monkeypatch.setattr(streamer_mod, "_dispatch", spy)
    caps = load_cached_caps(cfg)
    got = list(streamer_mod.stream_blocks(source, info, buckets, cfg, caps,
                                          devices=devices))
    assert len(got) == len(buckets)
    assert {b.chunk_id for b, _ in got} == {b.chunk_id for b in buckets}
    counts = {d: 0 for d in devices}
    for d in used:
        counts[d] += 1
    assert all(c > 0 for c in counts.values()), counts
    # fewest-in-flight with FIFO forcing keeps loads within one block
    # (dispatch count may exceed len(buckets) on cap retries; the balance
    # property still holds because retries re-use the same device)
    assert max(counts.values()) - min(counts.values()) <= 1 + (
        len(used) - len(buckets)), counts
