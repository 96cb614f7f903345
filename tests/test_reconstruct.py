"""End-to-end reconstruction tests: synthetic sphere cloud -> manifold PLY
(the reference's integration level: TestMarching::testSphere +
plymanifold verification, BASELINE.md config 1)."""

import numpy as np
import pytest

from mlsgpu_tpu.config import ReconstructConfig
from mlsgpu_tpu.io import ply
from mlsgpu_tpu.io.splat_set import FileSource, SequenceSource
from mlsgpu_tpu.pipeline.reconstruct import reconstruct, resume
from mlsgpu_tpu.utils.manifold import check_manifold

from tests import oracle

CENTER = np.array([0.7, -0.3, 0.2])
RADIUS = 3.0


# perCommit-tier suite (reference TestSet::perCommit, test/testutil.cpp:43-47):
# compile-heavy; deselect with `-m "not slow"` for the fast perBuild tier.
pytestmark = pytest.mark.slow


def small_config(**kw) -> ReconstructConfig:
    base = dict(
        fit_grid=0.1, fit_smooth=1.0, fit_prune=0.02,
        levels=3, subsampling=3,      # 32^3-corner blocks
        leaf_cells=8,
        max_device_splats=200000,
        tile_candidates=512,
        cell_cap=1 << 15, vertex_cap=1 << 17, index_cap=3 << 17,
        progress=False,
    )
    base.update(kw)
    return ReconstructConfig(**base)


def make_sphere_source(n=20000, sr=0.25, seed=21):
    rng = np.random.default_rng(seed)
    splats = oracle.sphere_cloud(CENTER, RADIUS, n, sr, rng)
    return SequenceSource(splats)


def check_sphere_output(path, expect_components=1, closed=True):
    """Manifoldness is required always; `closed` additionally demands zero
    boundary edges. This now holds for multi-block runs too: the canonical
    face pass (ops/mls.canonical_face_field) makes shared corners bitwise
    block-independent, so block seams weld crack-free."""
    verts, tris = ply.read_mesh(path)
    assert len(verts) > 500
    rep = check_manifold(verts, tris)
    assert rep.is_manifold, rep.reason
    if closed:
        assert rep.num_boundary_edges == 0
        assert rep.num_components == expect_components
        assert rep.euler_characteristics == [2] * expect_components
    else:
        assert rep.num_boundary_edges <= max(len(verts) // 500, 32)
        assert rep.num_components <= expect_components + 4
    r = np.linalg.norm(verts - CENTER, axis=1)
    # MLS reconstruction of a sphere cloud with outward normals
    assert abs(np.median(r) - RADIUS) < 0.08
    assert np.abs(r - RADIUS).max() < 0.25
    return verts, tris


@pytest.mark.slow
class TestEndToEnd:
    def test_sphere_single_bucket(self, tmp_path):
        """Whole cloud fits one block: config-1 of BASELINE.md."""
        cfg = small_config(levels=4)  # 64^3 block > 62-cell grid... one bucket
        out = str(tmp_path / "sphere1.ply")
        files = reconstruct(make_sphere_source(), cfg, out)
        assert files == [out]
        check_sphere_output(out)

    def test_sphere_multi_bucket(self, tmp_path):
        """Grid spans multiple 31-cell blocks: exercises cross-block welding
        on real geometry. The mesh must be CLOSED — the canonical face pass
        guarantees crack-free seams (plymanifold contract,
        doc/mlsgpu-user-manual.xml:494-499)."""
        cfg = small_config()
        out = str(tmp_path / "sphere2.ply")
        files = reconstruct(make_sphere_source(), cfg, out)
        check_sphere_output(out, closed=True)

    def test_rerun_identical_geometry(self, tmp_path):
        """The determinism contract (doc/mlsgpu-user-manual.xml:494-499):
        rerunning the same input yields identical geometry. Ours is stronger
        than the reference's — the pipeline is order-deterministic, so
        vertices and triangles match bitwise including order."""
        src = make_sphere_source()
        cfg = small_config()
        out1 = str(tmp_path / "r1.ply")
        out2 = str(tmp_path / "r2.ply")
        reconstruct(src, cfg, out1)
        reconstruct(src, cfg, out2)
        v1, t1 = ply.read_mesh(out1)
        v2, t2 = ply.read_mesh(out2)
        np.testing.assert_array_equal(v1, v2)
        np.testing.assert_array_equal(t1, t2)

    def test_multi_bucket_matches_single(self, tmp_path):
        """Block decomposition must not change the surface beyond float
        noise at shared corners: vertex/triangle counts agree to ~0.1% and
        the geometry matches where keys coincide."""
        src = make_sphere_source(8000, sr=0.35)
        out1 = str(tmp_path / "a.ply")
        out2 = str(tmp_path / "b.ply")
        reconstruct(src, small_config(levels=4), out1)
        reconstruct(src, small_config(levels=3), out2)
        v1, t1 = ply.read_mesh(out1)
        v2, t2 = ply.read_mesh(out2)
        assert abs(len(v1) - len(v2)) <= max(len(v1) // 500, 8)
        assert abs(len(t1) - len(t2)) <= max(len(t1) // 500, 16)
        # distributions match closely
        r1 = np.sort(np.linalg.norm(v1 - CENTER, axis=1))
        r2 = np.sort(np.linalg.norm(v2 - CENTER, axis=1))
        m = min(len(r1), len(r2))
        assert np.abs(r1[:m] - r2[:m]).max() < 0.02

    def test_determinism_same_decomposition(self, tmp_path):
        """Identical runs produce identical geometry (the reference's
        determinism contract, doc/mlsgpu-user-manual.xml:494-499)."""
        src = make_sphere_source(6000, sr=0.4)
        out1 = str(tmp_path / "r1.ply")
        out2 = str(tmp_path / "r2.ply")
        reconstruct(src, small_config(), out1)
        reconstruct(src, small_config(), out2)
        v1, t1 = ply.read_mesh(out1)
        v2, t2 = ply.read_mesh(out2)
        s1 = v1[np.lexsort(v1.T)]
        s2 = v2[np.lexsort(v2.T)]
        np.testing.assert_array_equal(s1, s2)
        assert len(t1) == len(t2)

    def test_file_source_end_to_end(self, tmp_path):
        """PLY files in -> PLY mesh out, with radius smoothing applied at
        decode (the full CLI data path)."""
        rng = np.random.default_rng(5)
        splats = oracle.sphere_cloud(CENTER, RADIUS, 15000, 0.125, rng)
        paths = []
        for i, seg in enumerate(np.array_split(splats, 2)):
            p = str(tmp_path / f"in{i}.ply")
            ply.write_splats_ply(p, seg)
            paths.append(p)
        src = FileSource(paths, smooth=2.0)  # radius 0.125 -> 0.25
        cfg = small_config(levels=4, fit_smooth=2.0)
        out = str(tmp_path / "fromfile.ply")
        reconstruct(src, cfg, out)
        src.close()
        check_sphere_output(out)

    def test_checkpoint_resume_end_to_end(self, tmp_path):
        ckpt = str(tmp_path / "ck.state")
        cfg = small_config(levels=4, checkpoint=ckpt)
        files = reconstruct(make_sphere_source(), cfg, str(tmp_path / "x.ply"))
        assert files == []
        out = str(tmp_path / "resumed.ply")
        cfg2 = small_config(levels=4)
        resume(ckpt, cfg2, out)
        check_sphere_output(out)

    def test_large_block_streams_as_subvolumes(self, tmp_path):
        """Blocks above the device sub-volume bound (component #33, the
        reference's z-swathe streaming of one block, src/marching.cpp:783-823,
        src/marching.h:117-141): a levels+subsampling block LARGER than
        device_block_shift streams through the device as aligned sub-volume
        dispatches. The decomposition is the bucketing lattice itself, so the
        output must be BITWISE IDENTICAL to a run whose block size equals the
        device bound — and the mesh closed (no sub-volume seams)."""
        src = make_sphere_source()
        # levels=5 -> 2^7-corner blocks; device bound 2^5 -> 27 sub-volumes
        big = small_config(levels=5, device_block_shift=5)
        ref = small_config(levels=3)  # block size == device bound
        out1 = str(tmp_path / "streamed.ply")
        out2 = str(tmp_path / "direct.ply")
        reconstruct(src, big, out1)
        check_sphere_output(out1, closed=True)
        reconstruct(src, ref, out2)
        v1, t1 = ply.read_mesh(out1)
        v2, t2 = ply.read_mesh(out2)
        np.testing.assert_array_equal(v1, v2)
        np.testing.assert_array_equal(t1, t2)

    def test_plane_fit_shape(self, tmp_path):
        cfg = small_config(levels=4, fit_shape="plane")
        out = str(tmp_path / "plane_fit.ply")
        reconstruct(make_sphere_source(), cfg, out)
        check_sphere_output(out)

    def test_cap_growth_mid_run_crack_free(self, tmp_path):
        """The seam-crack risk case of cap growth vs determinism: a mid-run candidate-cap retry leaves earlier blocks
        computed with the small K and later ones with the grown K, across
        shared faces. The contract: the output is still a CLOSED MANIFOLD
        (the canonical face pass makes shared-face corners bitwise
        K-independent — test_canonical.py pins that directly — so no
        cracks open), and the geometry matches a grown-caps-upfront run to
        float noise. Interior corners are owned by exactly one block, so
        their slight K-sensitivity (contraction tiling changes with the
        pad) cannot crack the mesh; it can flip a handful of near-zero
        corners, hence counts are compared with a small tolerance rather
        than bitwise.

        The sizing probe normally pre-grows caps so this never happens;
        it is disabled here to drive the risk case (in production the
        probe can still underestimate — demand is only measurable by
        running a block)."""
        from mlsgpu_tpu.pipeline.reconstruct import (
            BlockCaps, default_march_tile_cap)
        from mlsgpu_tpu.utils.statistics import get_registry

        rng = np.random.default_rng(5)
        base = oracle.sphere_cloud(CENTER, RADIUS, 9000, 0.32, rng)
        # Dense patch confined to the +x+y+z pole: its bucket streams LAST
        # (buckets follow chunk/cell order), so the overflow retry happens
        # after other blocks already ran with the small K.
        u = base[:, 0:3] - CENTER
        pole = u @ (np.ones(3) / np.sqrt(3)) > 0.93 * RADIUS
        patch = oracle.sphere_cloud(CENTER, RADIUS, 60000, 0.32, rng)
        pu = patch[:, 0:3] - CENTER
        patch = patch[pu @ (np.ones(3) / np.sqrt(3)) > 0.93 * RADIUS]
        assert pole.sum() > 50 and len(patch) > 500
        src = SequenceSource(np.concatenate([base, patch]))

        cfg = small_config(sizing_probe=False)

        def fresh_caps(k):
            return BlockCaps(k, cfg.cell_cap, cfg.vertex_cap, cfg.index_cap,
                             march_tile_cap=default_march_tile_cap(cfg))

        reg = get_registry()
        before = reg.counter("device.capRetries").get()
        caps = fresh_caps(192)   # small enough for the patch to overflow
        out1 = str(tmp_path / "grown_midrun.ply")
        reconstruct(src, cfg, out1, caps=caps)
        assert reg.counter("device.capRetries").get() > before, \
            "fixture no longer forces a mid-run cap retry"
        assert caps.max_candidates > 192

        # The real contract first: crack-free despite the mid-run growth.
        v1, t1 = ply.read_mesh(out1)
        rep = check_manifold(v1, t1)
        assert rep.is_manifold, rep.reason
        assert rep.num_boundary_edges == 0

        # Control: start straight from the final grown caps (no retry).
        out2 = str(tmp_path / "grown_upfront.ply")
        reconstruct(src, cfg, out2, caps=fresh_caps(caps.max_candidates))
        v2, t2 = ply.read_mesh(out2)
        assert abs(len(v1) - len(v2)) <= max(len(v1) // 2000, 4)
        assert abs(len(t1) - len(t2)) <= max(len(t1) // 2000, 8)
        r1 = np.sort(np.linalg.norm(v1 - CENTER, axis=1))
        r2 = np.sort(np.linalg.norm(v2 - CENTER, axis=1))
        m = min(len(r1), len(r2))
        assert np.abs(r1[:m] - r2[:m]).max() < 0.02


@pytest.fixture(autouse=True)
def _clear_caches_each_test():
    """XLA-CPU in this jaxlib segfaults sporadically when a process holds
    many large compiled executables; drop them after every e2e test."""
    yield
    import jax
    jax.clear_caches()


@pytest.mark.slow
class TestEagerChunkWrite:
    """Eager per-chunk write (the final-write/device-compute overlap): each
    chunk's PLY streams out as its last block lands; write() reuses clean
    files and rewrites pruning-touched ones (pipeline/mesher.py
    enable_eager_write; overlap rationale = the reference's TmpWriter/
    AsyncWriter design, src/mesher.h:514-620)."""

    def _split_cfg(self, **kw):
        kw.setdefault("fit_prune", 0.02)
        return small_config(output_split_size=150_000, **kw)

    def test_eager_matches_classic_bitwise(self, tmp_path):
        from mlsgpu_tpu.utils.statistics import get_registry
        src = make_sphere_source(12000, sr=0.3)
        before = get_registry().counter("write.eagerClean").get()
        files_e = reconstruct(src, self._split_cfg(),
                              str(tmp_path / "e.ply"))
        clean = get_registry().counter("write.eagerClean").get() - before
        files_c = reconstruct(src, self._split_cfg(eager_write=False),
                              str(tmp_path / "c.ply"))
        assert len(files_e) == len(files_c) > 1
        assert clean > 0, "eager write never produced a reusable chunk"
        for fe, fc in zip(files_e, files_c):
            ve, te = ply.read_mesh(fe)
            vc, tc = ply.read_mesh(fc)
            np.testing.assert_array_equal(ve, vc)
            np.testing.assert_array_equal(te, tc)

    def _debris_source(self):
        rng = np.random.default_rng(11)
        sphere = oracle.sphere_cloud(CENTER, RADIUS, 12000, 0.3, rng)
        # a tiny separate blob: its own component, < fit_prune of vertices
        debris = oracle.sphere_cloud(CENTER + np.array([0, 0, RADIUS + 1.5]),
                                     0.4, 300, 0.25, rng)
        return SequenceSource(np.concatenate([sphere, debris]))

    def _assert_bitwise_and_debris_pruned(self, files_e, files_c):
        all_v = []
        for fe, fc in zip(files_e, files_c):
            ve, te = ply.read_mesh(fe)
            vc, tc = ply.read_mesh(fc)
            np.testing.assert_array_equal(ve, vc)
            np.testing.assert_array_equal(te, tc)
            if len(ve):
                all_v.append(ve)
        # the debris blob was pruned from the final surface
        v = np.concatenate(all_v)
        r = np.linalg.norm(v - CENTER, axis=1)
        assert r.max() < RADIUS + 1.0

    def test_predicted_prune_keeps_chunks_clean(self, tmp_path):
        """Pruned debris no longer dirties its chunk: the eager write
        predicts the per-clump prune decision (tiny component vs scaled
        threshold), write() verifies the prediction and reuses the file.
        Output must still equal the non-eager run's bitwise (measured
        rationale: the nothing-pruned speculation left 5/8 chunks dirty on
        a 10M run — pipeline/mesher.py _predict_pruned)."""
        from mlsgpu_tpu.utils.statistics import get_registry
        src = self._debris_source()
        reg = get_registry()
        before_d = reg.counter("write.eagerDirty").get()
        before_c = reg.counter("write.eagerClean").get()
        files_e = reconstruct(src, self._split_cfg(fit_prune=0.05),
                              str(tmp_path / "e.ply"))
        dirty = reg.counter("write.eagerDirty").get() - before_d
        clean = reg.counter("write.eagerClean").get() - before_c
        assert dirty == 0, "prediction missed: pruning dirtied a chunk"
        assert clean > 0
        files_c = reconstruct(src, self._split_cfg(fit_prune=0.05,
                                                   eager_write=False),
                              str(tmp_path / "c.ply"))
        self._assert_bitwise_and_debris_pruned(files_e, files_c)

    def test_mispredicted_chunk_rewritten(self, tmp_path, monkeypatch):
        """A wrong prune prediction makes the chunk's eager file stale;
        write() must detect the mismatch (per-clump decision comparison)
        and rewrite classically. Forced deterministically by predicting
        'nothing pruned' while pruning is active. Output must equal the
        non-eager run's bitwise."""
        from mlsgpu_tpu.pipeline.mesher import OOCMesher
        from mlsgpu_tpu.utils.statistics import get_registry
        monkeypatch.setattr(OOCMesher, "_predict_pruned",
                            lambda self, rec: None)
        src = self._debris_source()
        before = get_registry().counter("write.eagerDirty").get()
        files_e = reconstruct(src, self._split_cfg(fit_prune=0.05),
                              str(tmp_path / "e.ply"))
        dirty = get_registry().counter("write.eagerDirty").get() - before
        assert dirty > 0, "fixture no longer drives the misprediction path"
        files_c = reconstruct(src, self._split_cfg(fit_prune=0.05,
                                                   eager_write=False),
                              str(tmp_path / "c.ply"))
        self._assert_bitwise_and_debris_pruned(files_e, files_c)


@pytest.mark.slow
def test_tiny_reorder_budget_spills_and_matches(tmp_path):
    """A tiny --mem-reorder forces the async spill path during add and
    disk reads during write; output must match the in-memory run."""
    src = make_sphere_source(6000, sr=0.4)
    out_mem = str(tmp_path / "mem.ply")
    out_spill = str(tmp_path / "spill.ply")
    reconstruct(src, small_config(), out_mem)
    reconstruct(src, small_config(mem_reorder=1 << 14), out_spill)
    v1, t1 = ply.read_mesh(out_mem)
    v2, t2 = ply.read_mesh(out_spill)
    assert len(v1) == len(v2) and len(t1) == len(t2)
    np.testing.assert_array_equal(np.sort(v1.view("u4").ravel()),
                                  np.sort(v2.view("u4").ravel()))


@pytest.mark.slow
class TestCodesReadbackE2E:
    """--readback codes vs packed: same surface, deterministic reruns
    (the codes path rebuilds + welds host-side, _native.mls_rebuild_block)."""

    def test_codes_matches_packed_surface(self, tmp_path):
        import mlsgpu_tpu._native as nat
        if not nat.available():
            pytest.skip("native library unavailable")
        out_c = str(tmp_path / "codes.ply")
        out_p = str(tmp_path / "packed.ply")
        reconstruct(make_sphere_source(), small_config(readback="codes"),
                    out_c)
        reconstruct(make_sphere_source(), small_config(readback="packed"),
                    out_p)
        vc, tc = check_sphere_output(out_c, closed=True)
        vp, tp = check_sphere_output(out_p, closed=True)
        # same topology size; positions agree to the t16 quantum (vertex
        # order differs — first-occurrence vs key order — so sample
        # nearest-neighbor distances rather than pairing by sort order,
        # which swaps nearby vertices between the two meshes)
        assert len(vc) == len(vp) and len(tc) == len(tp)
        idx = np.random.default_rng(0).choice(len(vc), 500, replace=False)
        d = (np.abs(vc[idx][:, None, :] - vp[None, :, :]).max(axis=2)
             .min(axis=1))
        assert d.max() < 1e-4  # couple of t16 quanta in world units

    def test_codes_rerun_bitwise_identical(self, tmp_path):
        import mlsgpu_tpu._native as nat
        if not nat.available():
            pytest.skip("native library unavailable")
        outs = []
        for i in (0, 1):
            out = str(tmp_path / f"codes{i}.ply")
            reconstruct(make_sphere_source(),
                        small_config(readback="codes"), out)
            outs.append(open(out, "rb").read())
        assert outs[0] == outs[1]


class TestVerifyChunks:
    """tools/verify_chunks: the chunked-output welding contract checker
    (reference src/mesher.cpp:763-852 — shared cut-plane vertices must be
    present, bitwise identical, in both adjacent chunk files)."""

    def _chunked_run(self, tmp_path):
        src = make_sphere_source()
        cfg = small_config(output_split_size=150_000)
        out = str(tmp_path / "out.ply")
        files = reconstruct(src, cfg, out, show_progress=False)
        assert len(files) >= 2, "test needs a multi-chunk output"
        return out, files

    def test_geom_comment_present(self, tmp_path):
        from mlsgpu_tpu.tools.verify_chunks import parse_geom_comment
        out, files = self._chunked_run(tmp_path)
        geom = parse_geom_comment(files[0])
        assert geom is not None
        assert geom["chunk_cells"] > 0
        assert geom["spacing"] == pytest.approx(0.1)

    def test_continuity_green_on_real_output(self, tmp_path):
        from mlsgpu_tpu.tools.verify_chunks import verify
        out, files = self._chunked_run(tmp_path)
        result = verify(out, sample=3, log=lambda s: None)
        assert result["chunks"] == len(files)
        assert result["manifold"]["failures"] == 0
        cont = result["continuity"]
        assert cont["checked"] > 0, "no cut plane carried surface (weak test)"
        assert cont["mismatched_pairs"] == 0, cont["examples"]
        assert result["ok"]

    def test_continuity_catches_tampering(self, tmp_path):
        """Perturb one on-plane vertex in one chunk file: the pass must
        flag the pair (negative control for the checker itself)."""
        from mlsgpu_tpu.tools.verify_chunks import (check_continuity,
                                                    discover_chunks,
                                                    parse_geom_comment,
                                                    read_vertices)
        out, files = self._chunked_run(tmp_path)
        chunks = discover_chunks(out)
        geom = parse_geom_comment(files[0])
        clean = check_continuity(chunks, geom)
        assert clean["checked"] > 0 and clean["mismatched_pairs"] == 0

        # find a file with on-plane vertices and nudge one of them: the
        # shared plane value is the most repeated x bit pattern common to
        # both adjacent files (same derivation as the checker's)
        tampered = False
        for coords, path in sorted(chunks.items()):
            nb = (coords[0] + 1, coords[1], coords[2])
            if nb not in chunks:
                continue
            v = read_vertices(path)
            vb = read_vertices(chunks[nb])
            ua, ca = np.unique(v[:, 0].view(np.uint32), return_counts=True)
            ub = np.unique(vb[:, 0].view(np.uint32))
            common = np.intersect1d(ua[ca >= 4], ub)
            if len(common) == 0:
                continue
            plane_u = common[int(np.argmax(
                [ca[np.searchsorted(ua, c)] for c in common]))]
            # pick a vertex SHARED by both files (an A-only on-plane
            # vertex is legitimate open boundary and would not flag)
            av = np.ascontiguousarray(v[v[:, 0].view(np.uint32) == plane_u])
            bv = np.ascontiguousarray(
                vb[vb[:, 0].view(np.uint32) == plane_u])
            rec = [("x", np.uint32), ("y", np.uint32), ("z", np.uint32)]
            shared = np.intersect1d(av.view(np.uint32).reshape(-1, 3).view(rec),
                                    bv.view(np.uint32).reshape(-1, 3).view(rec))
            if len(shared) == 0:
                continue
            # prefer a vertex whose y is far from zero: the ulp nudge
            # below steps the mantissa, and ulp(0.0) is a denormal that
            # does not displace the vertex meaningfully
            ys = np.stack([shared["y"]]).view(np.float32).ravel()
            s0 = shared[int(np.argmax(np.abs(ys)))]
            if abs(float(np.array([s0["y"]], np.uint32)
                         .view(np.float32)[0])) < 1e-3:
                continue
            target = np.array([s0["x"], s0["y"], s0["z"]], np.uint32)
            sel = np.where(
                (np.asarray(v).view(np.uint32) == target[None, :])
                .all(axis=1))[0]
            if len(sel) == 0:
                continue
            from mlsgpu_tpu.io.ply import parse_header
            with open(path, "rb") as f:
                head = f.read(65536)
            h = parse_header(head, need_splat_fields=False)
            off = h.header_size + int(sel[0]) * 12 + 4  # y coordinate
            with open(path, "r+b") as f:
                f.seek(off)
                raw_u = np.frombuffer(f.read(4), "<u4")[0]
                # a 2-ULP nudge (mantissa +2): the checker flags one-sided
                # verts only when an ulp-near non-bitwise twin exists
                # (farther away reads as legitimate open boundary)
                f.seek(off)
                f.write(np.uint32(raw_u + 2).tobytes())
            tampered = True
            break
        assert tampered, "no on-plane vertex found to tamper with"
        dirty = check_continuity(chunks, geom)
        assert dirty["mismatched_pairs"] >= 1
