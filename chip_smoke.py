#!/usr/bin/env python3
"""Smoke test of the splats -> mesh path on an NVIDIA GPU.

Run from the root of a checkout:

    python chip_smoke.py            # one card, all default phases
    python chip_smoke.py --cards 4  # the four-card path only

Default phases, in order; any failure exits non-zero with no result line:

1. device: JAX's default backend is the GPU; the card's name and power
   limit; the native host library and the readback mode it enables;
2. mls: the MLS field compiled for the card against the float64 oracle
   on a 32^3 block (catches reduced-precision matmuls on the card);
3. main path: 2M splats (bench.make_cloud) written as a PLY and meshed by
   `mlsgpu_tpu.cli.main` in this process with the bench's settings and a
   chunked output;
4. output: every chunk manifold, the cross-chunk continuity pass run and
   clean, every vertex within 2 grid cells of the sphere.

`--cards 4` runs only the main path on four cards and on one, checks that
every card ran blocks and that both meshes are equal after canonical
vertex ordering.

The last line of standard output is the result:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import bench  # noqa: E402  (make_cloud: the bench's scan)


def _load_oracle():
    """tests/oracle.py by path: `tests` is not a package, and another
    installed `tests` package may shadow it."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "mls_oracle", os.path.join(REPO, "tests", "oracle.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


oracle = _load_oracle()

N_SPLATS = 2_000_000
LEVELS, SUBSAMPLING = 6, 3
TILE_CANDIDATES = 384
SPLIT_SIZE = "100M"


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# --------------------------------------------------------------- phase 1 --

def phase_device() -> None:
    import jax
    backend = jax.default_backend()
    if backend != "gpu":
        fail(f"JAX's default backend is {backend!r}, not 'gpu'")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    for line in smi.stdout.strip().splitlines():
        log(f"card: {line.strip()}")
    from mlsgpu_tpu import _native
    from mlsgpu_tpu.cli import enable_compile_cache
    from mlsgpu_tpu.ops.block import resolve_readback
    enable_compile_cache()
    native = _native.available()
    mode = resolve_readback("auto", LEVELS, SUBSAMPLING)
    log(f"device: {jax.devices()[0].device_kind} x{jax.device_count()}; "
        f"native library {'loaded' if native else 'NOT loaded'}; "
        f"readback {mode}")
    if not native:
        fail("the native host library did not load (the default codes "
             "readback needs it)")


# --------------------------------------------------------------- phase 2 --

def make_scan():
    """The main phase's cloud and its grid spacing (splat radius / 3)."""
    splats, sr = bench.make_cloud(N_SPLATS)
    return splats, float(sr / 3.0)


def phase_mls() -> None:
    """tests/test_mls.py's 32^3 fixture on the card, with its bounds."""
    import jax.numpy as jnp

    from mlsgpu_tpu.ops import binning, mls
    rng = np.random.default_rng(11)
    small = oracle.sphere_cloud([16.0, 15.0, 17.0], 9.0, 1200, 2.0, rng)
    origin = jnp.zeros(3, jnp.int32)
    binned = binning.bin_splats(jnp.asarray(small),
                                jnp.ones(len(small), bool), origin, 3, 5)
    starts, lens = binning.tile_segments(binned.entry_keys, 3, 5, 4)
    got, _ = mls.eval_field(binned.entry_data, starts, lens, origin, 4,
                            1024, "sphere", jnp.float32(0.0))
    got = np.asarray(got)
    g = np.arange(32)
    zz, yy, xx = np.meshgrid(g, g, g, indexing="ij")
    corners = np.stack([xx.ravel(), yy.ravel(), zz.ravel()], 1)
    ref = oracle.mls_field_bruteforce(small, corners).reshape(32, 32, 32)
    agree = float(np.mean(np.isfinite(got) == np.isfinite(ref)))
    both = np.isfinite(got) & np.isfinite(ref)
    p99 = float(np.quantile(np.abs(got[both] - ref[both]), 0.99))
    log(f"mls: 32^3 block vs float64 oracle: pattern {agree:.6f}, "
        f"p99 |err| {p99:.3e}, {int(both.sum())} defined")
    if not (agree > 0.999 and p99 < 2e-3 and both.sum() > 1000):
        fail("the MLS field on the card disagrees with the float64 oracle")


# --------------------------------------------------------------- phase 3 --

def write_scan(splats, work: str) -> str:
    from mlsgpu_tpu.io.ply import write_splats_ply
    path = os.path.join(work, "scan.ply")
    write_splats_ply(path, splats)
    return path


def run_main(ply: str, spacing: float, out: str,
             num_devices: int = 1) -> dict:
    """One reconstruction through the CLI; returns its figures."""
    import jax

    from mlsgpu_tpu.cli import main as cli_main
    from mlsgpu_tpu.io.ply import parse_header
    from mlsgpu_tpu.utils.statistics import get_registry
    get_registry().clear()
    argv = ["-o", out, "--fit-grid", repr(spacing), "--fit-smooth", "1.0",
            "--fit-prune", "0.02", "--levels", str(LEVELS),
            "--subsampling", str(SUBSAMPLING), "--max-device-splats", "4M",
            "--tile-candidates", str(TILE_CANDIDATES),
            "--split-size", SPLIT_SIZE, "--num-devices", str(num_devices),
            "--no-progress", "--quiet", ply]
    t0 = time.monotonic()
    rc = cli_main(argv)
    wall = time.monotonic() - t0
    if rc != 0:
        fail(f"mlsgpu_tpu.cli.main exited {rc}")
    stem, ext = os.path.splitext(out)
    files = sorted(glob.glob(f"{stem}_*_*_*{ext}"))
    nv = nt = 0
    for f in files:
        with open(f, "rb") as fh:
            h = parse_header(fh.read(65536), need_splat_fields=False)
        nv += h.vertex_count
        nt += h.triangle_count
    peak = max((d.memory_stats() or {}).get("peak_bytes_in_use", 0)
               for d in jax.local_devices())
    return {"wall_s": wall, "files": files,
            "blocks": int(get_registry().counter("bucket.count").get()),
            "vertices": nv, "triangles": nt, "peak_device_bytes": peak}


def phase_main(ply, spacing, work) -> dict:
    out = os.path.join(work, "main", "mesh.ply")
    os.makedirs(os.path.dirname(out))
    res = run_main(ply, spacing, out)
    log(f"main: {res['wall_s']:.3f} s wall including "
        f"compilation, {res['blocks']} blocks, {len(res['files'])} chunks, "
        f"{res['vertices']} vertices, {res['triangles']} triangles, peak "
        f"device memory {res['peak_device_bytes'] / 2 ** 30:.3f} GiB")
    res["out"] = out
    return res


# --------------------------------------------------------------- phase 4 --

def phase_output(res, spacing) -> None:
    from mlsgpu_tpu.tools.verify_chunks import read_vertices, verify
    files = res["files"]
    if len(files) < 2:
        fail(f"expected a chunked output, got {len(files)} file(s)")
    result = verify(res["out"], sample=len(files), continuity=True,
                    log=lambda s: None)
    cont = result.get("continuity", {})
    log(f"output: {result['manifold']['sampled']} chunks manifold-checked, "
        f"{result['manifold']['failures']} failures; continuity "
        f"{cont.get('checked', 0)}/{cont.get('pairs', 0)} cut planes "
        f"checked, {cont.get('mismatched_pairs', 'n/a')} mismatched")
    if not result["ok"]:
        fail(f"output verification: {json.dumps(result)[:2000]}")
    if result["manifold"]["sampled"] != len(files):
        fail("not every chunk was manifold-checked")
    if cont.get("checked", 0) == 0:
        fail("no cut plane carried surface: continuity not exercised")
    worst = 0.0
    for f in files:
        v = np.asarray(read_vertices(f), np.float64)
        if len(v):
            worst = max(worst, float(np.abs(np.linalg.norm(v, axis=1)
                                            - 3.0).max()))
    log(f"output: max |r - 3| = {worst:.6f} ({worst / spacing:.3f} cells)")
    if not worst <= 2.0 * spacing:
        fail("vertices stray more than 2 grid cells from the sphere")


# ----------------------------------------------------------- four cards --

def canonical_mesh(files):
    """All chunks' (vertices, triangles) with vertices sorted bitwise and
    triangles rotated to start at their least index, then sorted."""
    from mlsgpu_tpu.io.ply import read_mesh
    out = {}
    for f in files:
        verts, tris = read_mesh(f)
        u = verts.view(np.uint32)
        order = np.lexsort((u[:, 2], u[:, 1], u[:, 0]))
        rank = np.empty(len(order), np.int64)
        rank[order] = np.arange(len(order))
        t = rank[tris]
        r = np.argmin(t, axis=1)
        t = np.stack([t[np.arange(len(t)), (r + k) % 3] for k in range(3)], 1)
        t = t[np.lexsort((t[:, 2], t[:, 1], t[:, 0]))]
        out[os.path.basename(f)] = (verts[order], t)
    return out


def phase_four_cards(ply, spacing, work) -> None:
    import jax

    from mlsgpu_tpu.pipeline import streamer
    devs = jax.local_devices()
    if len(devs) < 4:
        fail(f"--cards 4 needs 4 local GPUs, found {len(devs)}")
    used = []
    real_dispatch = streamer._dispatch

    def spy(padded, valid, bucket, cfg, caps, device, *a, **kw):
        used.append(device.id)
        return real_dispatch(padded, valid, bucket, cfg, caps, device,
                             *a, **kw)

    runs = {}
    for n in (4, 1):
        used.clear()
        out = os.path.join(work, f"cards{n}", "mesh.ply")
        os.makedirs(os.path.dirname(out))
        streamer._dispatch = spy
        try:
            res = run_main(ply, spacing, out, num_devices=n)
        finally:
            streamer._dispatch = real_dispatch
        per_card = {d: used.count(d) for d in sorted(set(used))}
        log(f"cards: {n} card(s): {res['wall_s']:.3f} s wall, "
            f"{res['blocks']} blocks, dispatches per card {per_card}, "
            f"{res['vertices']} vertices, {res['triangles']} triangles")
        if n == 4 and (len(per_card) != 4 or min(per_card.values()) == 0):
            fail(f"not every card ran blocks: {per_card}")
        runs[n] = res
    a = canonical_mesh(runs[4]["files"])
    b = canonical_mesh(runs[1]["files"])
    if sorted(a) != sorted(b):
        fail(f"chunk files differ: {sorted(set(a) ^ set(b))[:8]}")
    for name in sorted(a):
        (va, ta), (vb, tb) = a[name], b[name]
        if va.shape != vb.shape:
            fail(f"{name}: vertex count {len(va)} (4 cards) vs {len(vb)}")
        if not np.array_equal(va.view(np.uint32), vb.view(np.uint32)):
            fail(f"{name}: vertex positions differ, max |d| "
                 f"{float(np.abs(va - vb).max()):.3e}")
        if not np.array_equal(ta, tb):
            fail(f"{name}: triangles differ ({len(ta)} vs {len(tb)})")
    log(f"cards: 4-card and 1-card meshes equal over {len(a)} chunks")


# ------------------------------------------------------------------ main --

def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cards", type=int, choices=(1, 4), default=1,
                   help="4 = run only the four-card path and its one-card "
                        "comparison")
    args = p.parse_args(argv)

    phase_device()
    import jax
    splats, spacing = make_scan()
    with tempfile.TemporaryDirectory(prefix="chip_smoke.") as work:
        ply = write_scan(splats, work)
        if args.cards == 4:
            phase_four_cards(ply, spacing, work)
        else:
            phase_mls()
            res = phase_main(ply, spacing, work)
            phase_output(res, spacing)
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": args.cards}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
