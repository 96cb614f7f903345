"""Tests for auxiliary subsystems: decache, diskstats, async writer,
provenance, resource estimation, CLI tools (mirrors the reference's
test_async.cpp and small-utility coverage)."""

import os

import numpy as np
import pytest

from mlsgpu_tpu.config import ReconstructConfig
from mlsgpu_tpu.io import binary, ply
from mlsgpu_tpu.io.async_io import AsyncWriter
from mlsgpu_tpu.io.decache import decache, decache_all
from mlsgpu_tpu.pipeline.resources import estimate_block_usage, validate_device
from mlsgpu_tpu.utils import provenance
from mlsgpu_tpu.utils.diskstats import DiskUsage, snapshot
from mlsgpu_tpu.utils.errors import InvalidOption
from mlsgpu_tpu.utils.statistics import Registry

from tests import oracle


def test_decache(tmp_path):
    p = tmp_path / "f.bin"
    p.write_bytes(b"x" * 4096)
    assert decache(str(p)) in (True, False)  # platform-dependent but no raise
    assert decache_all([str(p), str(p)]) in (0, 2)


def test_diskstats():
    snap = snapshot()
    assert set(snap) == {"reads", "read_sectors", "writes", "write_sectors"}
    reg = Registry()
    with DiskUsage(registry=reg):
        pass
    assert reg.counter("disk.readBytes").get() >= 0


def test_async_writer(tmp_path):
    store = {}
    w = binary.MemoryWriter(store)
    w.open("out.bin")
    aw = AsyncWriter(n_buffers=2, buffer_size=64)
    aw.start()
    for i in range(5):
        buf = aw.get(8)
        buf[0:8] = bytes([i]) * 8
        aw.push(w, i * 8, buf, 8)
    aw.stop()
    data = bytes(store["out.bin"])
    assert len(data) == 40
    assert data[8:16] == b"\x01" * 8

    with pytest.raises(ValueError):
        aw.get(1000)


def test_provenance():
    v = provenance.version()
    assert v.startswith("mlsgpu_tpu")
    c = provenance.comments(["prog", "-o", "x.ply"])
    assert any("command: prog -o x.ply" in line for line in c)


def test_resource_estimation():
    cfg = ReconstructConfig()
    usage = estimate_block_usage(cfg)
    assert usage["total"] > 0
    assert usage["field"] == 256 ** 3 * 4
    # absurd configuration must be rejected against a finite device
    big = ReconstructConfig(levels=10, subsampling=3)
    import mlsgpu_tpu.pipeline.resources as res
    orig = res.device_memory_bytes
    res.device_memory_bytes = lambda device=None: 16 * 1024 ** 3
    try:
        with pytest.raises(InvalidOption):
            validate_device(big)
    finally:
        res.device_memory_bytes = orig


def test_plypntcat(tmp_path):
    from mlsgpu_tpu.tools.plypntcat import main as cat_main
    rng = np.random.default_rng(0)
    a = oracle.sphere_cloud([0, 0, 0], 1.0, 10, 0.1, rng)
    b = oracle.sphere_cloud([5, 0, 0], 1.0, 15, 0.1, rng)
    pa, pb = str(tmp_path / "a.ply"), str(tmp_path / "b.ply")
    ply.write_splats_ply(pa, a)
    ply.write_splats_ply(pb, b)
    out = str(tmp_path / "cat.ply")
    assert cat_main([pa, pb, "-o", out]) == 0
    r = ply.PlyReader(out, smooth=1.0)
    assert len(r) == 25
    r.close()


def test_analyze_timeplot(tmp_path, capsys):
    from mlsgpu_tpu.tools.analyze_timeplot import main as at_main
    trace = tmp_path / "tp.txt"
    trace.write_text(
        "EVENT loader load 0.0 1.0\n"
        "EVENT loader load 2.0 2.5\n"
        "EVENT device compute 0.5 3.0\n")
    assert at_main([str(trace)]) == 0
    out = capsys.readouterr().out
    assert "loader" in out and "device" in out
    assert "1.500s" in out  # loader busy


def test_draw_timeplot(tmp_path, capsys):
    from mlsgpu_tpu.tools.draw_timeplot import main as dt_main
    trace = tmp_path / "tp.txt"
    trace.write_text(
        "EVENT loader load 0.0 1.0\n"
        "EVENT loader load 2.0 2.5\n"
        "EVENT device compute 0.5 3.0\n"
        "junk line\n")
    out = tmp_path / "tp.svg"
    assert dt_main([str(trace), "-o", str(out)]) == 0
    svg = out.read_text()
    assert svg.startswith("<svg") and svg.rstrip().endswith("</svg>")
    assert "loader" in svg and "compute" in svg
    assert svg.count("<rect") >= 4  # surface + 3 spans
    # empty trace -> error exit
    empty = tmp_path / "empty.txt"
    empty.write_text("no events here\n")
    assert dt_main([str(empty), "-o", str(tmp_path / "e.svg")]) == 1


def test_procedural_scan_source():
    """bench_ooc's disk-free source honors the SplatSource contract:
    read_ranges regenerates exactly what iter_chunks streams, splats are
    finite, on the sphere, and consecutive ids are spatial neighbors
    (the coherence FastBlobSet-style blob RLE depends on)."""
    import numpy as np
    from mlsgpu_tpu.tools.bench_ooc import ProceduralScanSource

    src = ProceduralScanSource(10_000, radius=3.0)
    assert len(src) == 10_000
    chunks = list(src.iter_chunks(chunk_size=4096))
    assert [c[0] for c in chunks] == [0, 4096, 8192]
    streamed = np.concatenate([c[1] for c in chunks])
    assert streamed.shape == (10_000, 8)
    # regeneration matches streaming bitwise
    again = src.read_ranges([(0, 5000), (5000, 10_000)])
    np.testing.assert_array_equal(streamed, again)
    ranged = src.read_ranges([(123, 456)])
    np.testing.assert_array_equal(streamed[123:456], ranged)
    # geometry: on the sphere, unit normals, constant radius, finite
    assert np.isfinite(streamed).all()
    r = np.linalg.norm(streamed[:, 0:3], axis=1)
    np.testing.assert_allclose(r, 3.0, atol=1e-3)
    np.testing.assert_allclose(
        np.linalg.norm(streamed[:, 4:7], axis=1), 1.0, atol=1e-5)
    # scanline coherence: median hop between consecutive samples is a
    # small fraction of the sphere diameter
    hops = np.linalg.norm(np.diff(streamed[:, 0:3], axis=0), axis=1)
    assert np.median(hops) < 0.2
    assert src.read_ranges([]).shape == (0, 8)


def test_cli_backend_unavailable(tmp_path, monkeypatch, capsys):
    """Backend init failure (no driver, or the card is held by another
    process) exits with a clear message, not a traceback (reference mlsgpu.cpp:219-228)."""
    import jax
    from mlsgpu_tpu.cli import main

    def boom():
        raise RuntimeError("Unable to initialize backend 'cuda': UNAVAILABLE")

    monkeypatch.setattr(jax, "default_backend", boom)
    rc = main(["-o", str(tmp_path / "o.ply"), str(tmp_path / "in.ply")])
    assert rc == 1
    err = capsys.readouterr().err
    assert "device backend unavailable" in err
    assert "MLSGPU_TPU_FORCE_CPU" in err


def test_cli_response_file(tmp_path):
    from mlsgpu_tpu.cli import build_parser
    rf = tmp_path / "args.txt"
    rf.write_text("--fit-grid\n0.5\n")
    args = build_parser().parse_args(
        ["-o", "out.ply", f"@{rf}", "in.ply"])
    assert args.fit_grid == 0.5


# ---------------------------------------------------------------- spill store

class TestSpillStore:
    def test_memory_only(self):
        from mlsgpu_tpu.io.spill import SpillStore
        s = SpillStore("test.spill.", mem_budget=1 << 20)
        try:
            a = np.arange(100, dtype=np.uint32)
            b = np.arange(100, 300, dtype=np.uint32)
            off_a = s.append(a)
            off_b = s.append(b)
            s.freeze()
            assert off_a == 0 and off_b == 400
            got = np.frombuffer(s.read(0, 400), np.uint32)
            np.testing.assert_array_equal(got, a)
            # read spanning both appends
            got = np.frombuffer(s.read(396, 8), np.uint32)
            np.testing.assert_array_equal(got, [99, 100])
        finally:
            s.cleanup()

    def test_spill_to_disk_and_boundary_read(self):
        from mlsgpu_tpu.io.spill import SpillStore
        s = SpillStore("test.spill.", mem_budget=1024)  # tiny budget
        try:
            chunks = [np.full(200, i, np.uint8) for i in range(40)]
            offs = [s.append(c) for c in chunks]
            s.freeze()
            assert s._disk_end > 0, "flusher never ran"
            for i in (0, 10, 20, 39):
                got = np.frombuffer(s.read(offs[i], 200), np.uint8)
                np.testing.assert_array_equal(got, chunks[i])
            # one read crossing many chunk boundaries (and likely the
            # disk/memory boundary)
            got = np.frombuffer(s.read(100, 8000 - 200), np.uint8)
            expect = np.concatenate(chunks)[100:7900]
            np.testing.assert_array_equal(got, expect)
        finally:
            s.cleanup()

    def test_flush_all_and_from_file(self, tmp_path):
        from mlsgpu_tpu.io.spill import SpillStore
        s = SpillStore("test.spill.", mem_budget=1 << 20)
        data = np.random.default_rng(0).integers(0, 255, 5000).astype(np.uint8)
        s.append(data)
        path = s.flush_all()
        s2 = SpillStore.from_file(path)
        got = np.frombuffer(s2.read(0, 5000), np.uint8)
        np.testing.assert_array_equal(got, data)
        s.cleanup()

    def test_read_past_end(self):
        from mlsgpu_tpu.io.spill import SpillStore
        s = SpillStore("test.spill.", mem_budget=1024)
        try:
            s.append(b"abc")
            s.freeze()
            with pytest.raises(EOFError):
                s.read(0, 10)
        finally:
            s.cleanup()


# -------------------------------------------------------------------- tools

def test_analyze_stats(tmp_path, capsys):
    from mlsgpu_tpu.tools.analyze_stats import main as as_main
    stats = tmp_path / "stats.txt"
    stats.write_text(
        "run.time: 10.0 : 10.0 +/- 0.0 [1]\n"
        "pass0.time: 1.0 : 1.0 +/- 0.0 [1]\n"
        "device.time: 4.0 : 0.4 +/- 0.1 [10]\n"
        "mesher.time: 3.0 : 0.3 +/- 0.1 [10]\n"
        "mesher.blocks: 10\n"
        "mesher.vertices: 1000\n"
        "mesher.triangles: 2000\n"
        "device.mls.time: 3.0 : 0.3 +/- 0.0 [10]\n"
        "device.marching.time: 1.0 : 0.1 +/- 0.0 [10]\n"
        "mem.peak: 5 (peak 1048576)\n")
    assert as_main([str(stats)]) == 0
    out = capsys.readouterr().out
    assert "total run time: 10.00s" in out
    assert "device compute" in out and "40.0%" in out
    assert "blocks: 10" in out
    assert "1.0 MiB" in out
    # --statistics-device stage breakdown (statistics_cl parity)
    assert "device stages" in out
    assert "mls" in out and "75.0%" in out


def test_simulate_tool(tmp_path, capsys):
    from mlsgpu_tpu.tools.simulate import main as sim_main, simulate
    trace = tmp_path / "tp.txt"
    lines = []
    t = 0.0
    for i in range(8):
        lines.append(f"EVENT loader load {t} {t + 0.5}")
        lines.append(f"EVENT device compute {t + 0.5} {t + 1.5}")
        lines.append(f"EVENT mesher mesher {t + 1.5} {t + 1.7}")
        t += 1.7
    trace.write_text("\n".join(lines) + "\n")
    assert sim_main([str(trace), "--devices", "2"]) == 0
    out = capsys.readouterr().out
    assert "8 blocks" in out
    # two devices should beat one on compute-bound stages
    one = simulate([0.1] * 8, [1.0] * 8, [0.1] * 8, devices=1)
    two = simulate([0.1] * 8, [1.0] * 8, [0.1] * 8, devices=2)
    assert two < one


def test_bucket_regions_pow2_aligned():
    """Region origins must stay on power-of-two microblock boundaries
    (cross-block accumulation-order determinism; see bucket_regions)."""
    from mlsgpu_tpu.pipeline.bucket import bucket_regions
    rng = np.random.default_rng(3)
    counts = rng.integers(0, 50, size=(9, 9, 9)).astype(np.int64)
    regions = bucket_regions(counts, micro_cells=8, grid_cells=None,
                             max_cells=63, max_splats=2000)
    assert regions
    total = 0
    covered = np.zeros_like(counts)
    for lo, size in regions:
        assert (size > 0).all()
        assert (size * 8 <= 64).all()  # cell budget (rounded to microblocks)
        # whole tiles (not splat-budget splits) sit on the pow2 tile grid
        if (size == 4).all():
            assert (lo % 4 == 0).all()
        covered[lo[0]:lo[0]+size[0], lo[1]:lo[1]+size[1],
                lo[2]:lo[2]+size[2]] += 1
        total += counts[lo[0]:lo[0]+size[0], lo[1]:lo[1]+size[1],
                        lo[2]:lo[2]+size[2]].sum()
    assert covered.max() <= 1, "regions overlap"
    assert total == counts.sum(), "regions miss splats"


def test_mesh_filter_chain():
    from mlsgpu_tpu.pipeline.mesh_filter import MeshFilterChain, ScaleBiasFilter
    verts = np.array([[1.0, 2.0, 3.0], [0.0, 0.0, 0.0]], np.float32)
    tris = np.array([[0, 1, 0]], np.int64)
    chain = MeshFilterChain([ScaleBiasFilter(scale=2.0, bias=(1.0, 0.0, 0.0))])
    chain.add_filter(lambda v, t: (v + 1.0, t))
    v2, t2 = chain(verts, tris)
    np.testing.assert_allclose(v2[0], [4.0, 5.0, 7.0])
    np.testing.assert_array_equal(t2, tris)

    class FakeGrid:
        extents = ((2, 10), (0, 10), (0, 10))
        spacing = 0.5
        reference = (1.0, 1.0, 1.0)
    sb = ScaleBiasFilter.from_grid(FakeGrid())
    v3, _ = sb(np.zeros((1, 3), np.float32), tris)
    np.testing.assert_allclose(v3[0], [2.0, 1.0, 1.0])


def test_bench_outage_still_reports():
    """bench.py on a machine without a GPU reports the missing device and
    exits non-zero with no result line: a CPU number is never reported as
    a device number."""
    import subprocess
    import sys

    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "bench.py"], cwd=os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))),
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "not 'gpu'" in proc.stderr


def test_chip_smoke_refuses_cpu():
    """chip_smoke.py exits non-zero without a result line on the CPU."""
    import subprocess
    import sys

    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))),
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "not 'gpu'" in proc.stderr


def test_compile_cache_dir(monkeypatch, tmp_path):
    from mlsgpu_tpu import cli
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    default = cli.compile_cache_dir()
    assert default == os.path.join(cli.REPO_ROOT, ".jax_cache")
    assert os.path.isfile(os.path.join(cli.REPO_ROOT, "chip_smoke.py"))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cc"))
    assert cli.compile_cache_dir() == str(tmp_path / "cc")


def test_enable_compile_cache_uses_dir(monkeypatch, tmp_path):
    """On an accelerator the cache goes to compile_cache_dir() and nowhere
    else."""
    import jax
    from mlsgpu_tpu import cli
    set_to = {}
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: set_to.__setitem__(k, v))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cc"))
    cli.enable_compile_cache()
    assert set_to["jax_compilation_cache_dir"] == str(tmp_path / "cc")
    assert os.path.isdir(tmp_path / "cc")


class _FakeDevice:
    device_kind = "fake"

    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


def test_device_memory_bytes_without_memory_stats():
    from mlsgpu_tpu.pipeline.resources import device_memory_bytes
    assert device_memory_bytes(_FakeDevice(None)) is None
    assert device_memory_bytes(_FakeDevice({"bytes_in_use": 5})) is None
    assert device_memory_bytes(
        _FakeDevice({"bytes_limit": 80 * 2 ** 30})) == 80 * 2 ** 30


def test_resource_estimate_counts_mls_weights():
    """The MLS weight tensor is part of every estimate and grows with the
    candidate cap K."""
    cfg = ReconstructConfig()
    small = estimate_block_usage(cfg)["mls_weights"]
    cfg.tile_candidates *= 2
    assert estimate_block_usage(cfg)["mls_weights"] == 2 * small
