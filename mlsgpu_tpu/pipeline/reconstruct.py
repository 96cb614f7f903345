"""End-to-end reconstruction driver: splat source -> manifold mesh PLY.

The single-host orchestration (the reference's run(), mlsgpu.cpp:83-184):
blob pass -> bucketing -> per-bucket device block step -> mesher -> write.
Device work is fed through the streaming executor (pipeline/streamer.py) so
host loading, device compute, and mesher consumption overlap; with multiple
local devices buckets go to whichever has the most spare capacity (the reference's P2-P4
pipelining and P3 multi-GPU load balancing, src/workers.*).

Static-shape policy (XLA): splat batches are padded to power-of-two sizes,
and the per-tile candidate cap / marching caps come from the config. When a
block overflows a cap it is retried with that cap doubled — the compile cache
makes the retry cost one extra compilation (the reference's analogue is
DeviceWorkerGroup's ship-out-when-full loop).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import time

import jax
import numpy as np

from mlsgpu_tpu.config import ReconstructConfig
from mlsgpu_tpu.core.splat import SplatArray
from mlsgpu_tpu.io.splat_set import SplatSource, merge_ranges
from mlsgpu_tpu.ops.block import BlockResult, block_step
from mlsgpu_tpu.pipeline import blobs as blobs_mod
from mlsgpu_tpu.pipeline import bucket as bucket_mod
from mlsgpu_tpu.pipeline.mesher import BlockInput, OOCMesher
from mlsgpu_tpu.utils import logging as log
from mlsgpu_tpu.utils.misc import next_pow2
from mlsgpu_tpu.utils.progress import NullProgress, ProgressDisplay
from mlsgpu_tpu.utils.statistics import get_registry


@dataclass
class BlockCaps:
    """Mutable per-run device caps (grow-on-overflow)."""
    max_candidates: int
    cell_cap: int
    vertex_cap: int
    index_cap: int
    # candidate-tile cap for the tile-compacted marching classification
    # (ops/marching.py); 0 = dense. Grown on overflow like the rest.
    march_tile_cap: int = 0


def default_march_tile_cap(cfg) -> int:
    """Initial marching candidate-tile cap; 0 selects the dense
    classification path. Candidacy is any-finite-corner (a superset of
    MLS-occupied: the face/skeleton passes widen the finite set slightly).

    Dense classification uses shifted views of the whole volume; the tiled
    path gathers (tile_cap, 9^3) candidate corners instead, which pays only
    once dense sign passes over the volume dominate, so tiling engages
    above 2^8 corners/axis."""
    if cfg.device_block_cells + 1 <= (1 << 8):
        return 0
    g = -(-cfg.device_block_cells // 8)
    num_tiles = g ** 3
    return max(min(num_tiles, 512), num_tiles // 8)


def _caps_cache_path() -> str:
    import os
    return os.path.join(
        os.path.expanduser(os.environ.get(
            "MLSGPU_TPU_CACHE_DIR", "~/.cache/mlsgpu_tpu")), "caps.json")


def _caps_cache_key(cfg) -> str:
    # max_device_splats proxies bucket size: caps grown by a dense run
    # should not inflate the programs of an unrelated small run. v2:
    # eighth-pow2 near-fit growth (old pow2-grown entries must not pin the
    # fat caps). v3: fit_grid joins the key — per-block vertex/cell demand
    # scales with splat density per cell, so a fine-grid out-of-core run
    # must not grow the caps of a coarser run.
    return (f"v3.L{cfg.device_levels}.S{cfg.subsampling}.{cfg.fit_shape}"
            f".M{cfg.max_device_splats}.G{cfg.fit_grid:.4g}")


def load_cached_caps(cfg) -> "BlockCaps":
    """Start from the largest caps any previous run with this geometry
    grew to: every cap growth costs a retry plus a fresh block_step
    compile, so persisting them makes repeat runs single-program (the
    compile-cache companion; see cli.enable_compile_cache)."""
    import json
    import os
    caps = BlockCaps(cfg.tile_candidates, cfg.cell_cap, cfg.vertex_cap,
                     cfg.index_cap, march_tile_cap=default_march_tile_cap(cfg))
    try:
        with open(_caps_cache_path()) as f:
            saved = json.load(f).get(_caps_cache_key(cfg))
        if saved:
            caps.max_candidates = max(caps.max_candidates,
                                      int(saved.get("max_candidates", 0)))
            caps.cell_cap = max(caps.cell_cap, int(saved.get("cell_cap", 0)))
            caps.vertex_cap = max(caps.vertex_cap,
                                  int(saved.get("vertex_cap", 0)))
            caps.index_cap = max(caps.index_cap,
                                 int(saved.get("index_cap", 0)))
            # march_tile_cap == 0 means the dense path was CHOSEN for this
            # geometry (faster below 512^3); a cached tiled cap must not
            # re-enable tiling.
            if caps.march_tile_cap:
                caps.march_tile_cap = max(caps.march_tile_cap,
                                          int(saved.get("march_tile_cap", 0)))
    except (OSError, ValueError, KeyError):
        pass
    return caps


def save_cached_caps(cfg, caps: "BlockCaps") -> None:
    import json
    import os
    path = _caps_cache_path()
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            data = {}
        data[_caps_cache_key(cfg)] = {
            "max_candidates": caps.max_candidates,
            "cell_cap": caps.cell_cap,
            "vertex_cap": caps.vertex_cap,
            "index_cap": caps.index_cap,
            "march_tile_cap": caps.march_tile_cap,
        }
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(data, f)
        os.replace(tmp, path)
    except OSError:
        pass


def prepare_block_inputs(splats: np.ndarray, bucket: bucket_mod.Bucket,
                         grid, pad_to: Optional[int] = None):
    """Convert world-frame splats to padded device inputs in the global grid
    frame (blocks never re-center splats on the host: block-dependent f32
    rounding would break cross-block determinism; see ops/mls.py)."""
    arr = SplatArray(splats)
    grid_form = arr.to_grid_frame(grid)
    # to_grid_frame put 1/r^2 in col 3; the device step wants the radius
    # (binning computes 1/r^2 itself), so recompute in grid units.
    grid_form[:, 3] = splats[:, 3] / np.float32(grid.spacing)

    n = len(grid_form)
    npad = pad_to if pad_to is not None else next_pow2(n)
    padded = np.zeros((npad, 8), dtype=np.float32)
    padded[:, 3] = 1.0  # benign radius for padding rows
    padded[:n] = grid_form
    valid = np.zeros(npad, dtype=bool)
    valid[:n] = arr.is_finite()
    return padded, valid


def run_block(splats_padded: np.ndarray, valid: np.ndarray,
              bucket: bucket_mod.Bucket, cfg: ReconstructConfig,
              caps: BlockCaps, device=None) -> BlockResult:
    """Run one bucket through the jitted block step, growing caps on
    overflow."""
    stats = get_registry()
    region = (bucket.cell_hi - bucket.cell_lo).astype(np.int32)
    skel = getattr(bucket, "skeleton", None)
    args = dict(
        splats=splats_padded, valid=valid,
        region_cells=jax.numpy.asarray(region),
        cell_origin=jax.numpy.asarray(bucket.cell_lo.astype(np.int32)),
        points=(None if skel is None or not len(skel)
                else jax.numpy.asarray(skel.astype(np.int32))),
    )
    if device is not None:
        args = {k: jax.device_put(v, device) for k, v in args.items()}

    from mlsgpu_tpu.pipeline.streamer import _check_overflow
    attempt = 0
    while True:
        result = block_step(
            **args,
            boundary_factor=float(cfg.boundary_factor),
            levels=cfg.device_levels, subsampling=cfg.subsampling,
            max_candidates=caps.max_candidates,
            cell_cap=caps.cell_cap, vertex_cap=caps.vertex_cap,
            index_cap=caps.index_cap, fit_shape=cfg.fit_shape,
            march_tile_cap=caps.march_tile_cap)
        if not _check_overflow(result, caps, caps, attempt=attempt):
            return result
        attempt += 1
        stats.counter("device.capRetries").add(1)
        log.info("block cap overflow; retrying with larger caps")


def _fetch_prefix(arr, n: int) -> np.ndarray:
    """Transfer only the live prefix of a capped device buffer, padded to a
    power of two so the device slice program is reused (the analogue of the
    reference's sized enqueueReadMesh, src/mesh.h:141-179)."""
    if n <= 0:
        return np.empty((0,) + arr.shape[1:], dtype=arr.dtype)
    m = min(next_pow2(n), arr.shape[0])
    return np.asarray(arr[:m])[:n]


def block_result_to_input(result: BlockResult, bucket: bucket_mod.Bucket
                          ) -> BlockInput:
    """Device -> host adaptation (the reference's mesh readback +
    MesherGroup hand-off)."""
    stats = get_registry()
    with stats.timer("readback.counts"):
        nv = int(result.num_vertices)
        ni = int(result.num_indices)
        fe = int(result.first_external)
    from mlsgpu_tpu.ops.block import CodesFormat
    from mlsgpu_tpu.pipeline.streamer import PrefetchedResult
    with stats.timer("readback.mesh"):
        if (getattr(result, "packed", None) is not None
                and isinstance(getattr(result, "pack_fmt", None),
                               CodesFormat)):
            # Codes-mode readback: native rebuild + weld on the host
            # (_native.mls_rebuild_block) from per-cell case codes and
            # per-vertex interpolants — no device mesh ever existed.
            from mlsgpu_tpu import _native as nat
            with stats.timer("readback.wait"):
                flat = np.asarray(result.packed)
            stats.counter("readback.bytes").add(flat.nbytes)
            t_cpu = time.thread_time()
            with stats.timer("readback.decode"):
                verts, tris, keys, fe = nat.rebuild_block(
                    flat, result.num_cells, result.num_unwelded, ni,
                    result.pack_fmt.nc_axis,
                    bucket.cell_lo.astype(np.int64),
                    (bucket.cell_hi - bucket.cell_lo).astype(np.int64))
            stats.variable("readback.decodeCpu").add(
                time.thread_time() - t_cpu)
            return BlockInput(chunk_id=bucket.chunk_id, vertices=verts,
                              first_external=fe, ext_keys=keys,
                              triangles=tris)
        if (getattr(result, "packed", None) is not None
                and getattr(result, "pack_fmt", None) is not None):
            # Single quantized transfer (ops/block._pack_readback layout);
            # weld keys are reconstructed from the vertex encoding, so no
            # key region travels at all.
            from mlsgpu_tpu.ops.block import unpack_readback_global
            with stats.timer("readback.wait"):
                flat = np.asarray(result.packed)
            stats.counter("readback.bytes").add(flat.nbytes)
            t_cpu = time.thread_time()
            with stats.timer("readback.decode"):
                verts, tris, keys = unpack_readback_global(
                    flat, ni, nv, fe, result.pack_fmt,
                    bucket.cell_lo.astype(np.int64))
            stats.variable("readback.decodeCpu").add(
                time.thread_time() - t_cpu)
            return BlockInput(chunk_id=bucket.chunk_id, vertices=verts,
                              first_external=fe, ext_keys=keys,
                              triangles=tris)
        elif isinstance(result, PrefetchedResult):
            # Arrays are already pow2-prefix slices with host copies in
            # flight (copy_to_host_async at force time) — re-slicing here
            # would dispatch fresh device programs and a second transfer.
            verts = np.asarray(result.vertices)[:nv]
            tris = np.asarray(result.triangles)[:ni // 3]
            hi = np.asarray(result.key_hi)[fe:nv].astype(np.int64)
            lo = np.asarray(result.key_lo)[fe:nv].astype(np.int64)
        else:
            verts = _fetch_prefix(result.vertices, nv)
            tris = _fetch_prefix(result.triangles, ni // 3)
            hi = _fetch_prefix(result.key_hi, nv)[fe:].astype(np.int64)
            lo = _fetch_prefix(result.key_lo, nv)[fe:].astype(np.int64)
    verts = verts + bucket.cell_lo.astype(np.float32)  # block -> grid frame
    keys = ((hi & 0x7FFFFFFF) << 32) | lo
    return BlockInput(chunk_id=bucket.chunk_id, vertices=verts,
                      first_external=fe, ext_keys=keys, triangles=tris)


def reconstruct(source: SplatSource, cfg: ReconstructConfig, output: str,
                writer_factory=None, show_progress: Optional[bool] = None,
                mesher: Optional[OOCMesher] = None,
                caps: Optional[BlockCaps] = None,
                filters=None, device_filter=None) -> List[str]:
    """Full single-host reconstruction. Returns the list of output files."""
    cfg.validate()
    from mlsgpu_tpu.utils.misc import bound_mmap_threshold
    bound_mmap_threshold()  # keep cycling per-block buffers off the brk heap
    stats = get_registry()
    show_progress = cfg.progress if show_progress is None else show_progress

    with stats.timer("pass0.time"):
        info = blobs_mod.compute_blobs(source, cfg.fit_grid, cfg.micro_cells,
                                       mem_budget=cfg.mem_blobs)

    chunk_cells = None
    if cfg.output_split_size:
        # Output-chunk-size heuristic (src/mlsgpu_core.cpp:632-653): a cut
        # plane yields ~20 x^2 vertices at 38 bytes each -> x = sqrt(S/760),
        # rounded up to whole blocks so chunks align with bucket boundaries.
        from mlsgpu_tpu.utils.misc import round_up
        chunk_cells = round_up(
            int(np.ceil(np.sqrt(cfg.output_split_size / 760.0))),
            cfg.device_block_cells)
    # --mem-bucket-splats bounds splat bytes per bucket alongside the device
    # cap (reference maxBucketSplats, src/mlsgpu_core.cpp:130-137).
    max_splats = min(cfg.max_device_splats, cfg.mem_bucket_splats // 32)
    buckets = bucket_mod.make_buckets(
        info, cfg.device_block_cells, cfg.micro_cells,
        max_splats=max_splats, chunk_cells=chunk_cells,
        max_split=cfg.max_split)
    from mlsgpu_tpu.utils.misc import malloc_trim
    malloc_trim()  # bucketing's blob-expansion temporaries are GBs at 100M+

    mesher = mesher or OOCMesher(info.grid, prune=cfg.fit_prune,
                                 reorder_budget=cfg.mem_reorder)
    if chunk_cells is not None:
        mesher.chunk_cells = chunk_cells
    if caps is None:
        caps = load_cached_caps(cfg)

    # Eager per-chunk write: chunked outputs stream to disk as their last
    # block lands, overlapping the final write with device compute (write()
    # falls back per chunk when pruning touches it). Not applicable to
    # single-file outputs (global header counts) or checkpoint runs (no
    # write happens in this invocation).
    if (cfg.output_split_size and not cfg.checkpoint
            and getattr(cfg, "eager_write", True)):
        expected: dict = {}
        for b in buckets:
            c = b.chunk_id.coords
            expected[c] = expected.get(c, 0) + 1
        mesher.enable_eager_write(output, expected,
                                  writer_factory=writer_factory)

    total = sum(b.num_splats for b in buckets)
    progress = (ProgressDisplay(total, label="reconstructing")
                if show_progress else NullProgress())

    with stats.timer("pass1.time"):
        from mlsgpu_tpu.pipeline.streamer import (consume_threaded,
                                                  stream_blocks)
        from mlsgpu_tpu.utils import timeplot
        mesher_worker = timeplot.Worker("mesher")

        def consume(bucket, result):
            block = block_result_to_input(result, bucket)
            with timeplot.Action("mesher", mesher_worker,
                                 stats.variable("mesher.time")):
                if filters is not None:
                    # MeshFilterChain hook (pipeline/mesh_filter.py; the
                    # reference applies its chain device-side before the
                    # output functor, src/mesh_filter.h:132-170).
                    v, t = filters(block.vertices, block.triangles)
                    block = BlockInput(chunk_id=block.chunk_id, vertices=v,
                                       first_external=block.first_external,
                                       ext_keys=block.ext_keys, triangles=t)
                mesher.add(block)
            progress.add(bucket.num_splats)

        # Mesher consumption on its own thread (the reference's MesherGroup,
        # src/workers.h:74-131): readback decode + union-find overlap the
        # producer's device scalar/transfer waits.
        consume_threaded(
            stream_blocks(source, info, buckets, cfg, caps,
                          device_filter=device_filter), consume)
    save_cached_caps(cfg, caps)

    if cfg.checkpoint:
        mesher.checkpoint(cfg.checkpoint)
        log.info(f"checkpointed mesher state to {cfg.checkpoint}")
        return []

    with stats.timer("write.time"):
        outputs = mesher.write(output, writer_factory=writer_factory,
                               split_size=cfg.output_split_size)
    mesher.cleanup()
    return outputs


def resume(checkpoint_path: str, cfg: ReconstructConfig, output: str,
           writer_factory=None) -> List[str]:
    """Write-only run from a checkpoint (--resume)."""
    from mlsgpu_tpu.utils.misc import bound_mmap_threshold
    bound_mmap_threshold()  # the streamed write cycles multi-MB slices too
    mesher = OOCMesher.resume(checkpoint_path)
    outputs = mesher.write(output, writer_factory=writer_factory,
                           split_size=cfg.output_split_size)
    return outputs
