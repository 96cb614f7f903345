"""Command-line interface: `python -m mlsgpu_tpu -o out.ply in1.ply in2.ply`.

Mirrors the reference's option surface (mlsgpu.cpp:186-263 +
src/mlsgpu_core.cpp:78-137) including --fit-* knobs, memory/capacity sizes
with B/K/M/G suffixes, checkpoint/resume, statistics and timeplot output.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import List, Optional

from mlsgpu_tpu import __version__
from mlsgpu_tpu.config import ReconstructConfig, parse_capacity
from mlsgpu_tpu.utils import logging as log
from mlsgpu_tpu.utils import misc, timeplot
from mlsgpu_tpu.utils.errors import MlsError
from mlsgpu_tpu.utils.statistics import get_registry


def build_parser() -> argparse.ArgumentParser:
    d = ReconstructConfig()
    p = argparse.ArgumentParser(
        prog="mlsgpu_tpu",
        description="MLS surface reconstruction from point clouds on an "
                    "accelerator",
        fromfile_prefix_chars="@")  # @file = the reference's --response-file
    p.add_argument("inputs", nargs="*", help="input PLY files")
    p.add_argument("-o", "--output-file", required=True, help="output PLY file")
    p.add_argument("--version", action="version", version=f"mlsgpu_tpu {__version__}")

    g = p.add_argument_group("fit options")
    g.add_argument("--fit-smooth", type=float, default=d.fit_smooth,
                   help="smoothing factor [%(default)s]")
    g.add_argument("--max-radius", type=float, default=None,
                   help="limit influence radii before smoothing")
    g.add_argument("--fit-grid", type=float, default=d.fit_grid,
                   help="spacing of output grid [%(default)s]")
    g.add_argument("--fit-prune", type=float, default=d.fit_prune,
                   help="prune components smaller than this fraction [%(default)s]")
    g.add_argument("--fit-boundary-limit", type=float, default=d.fit_boundary_limit,
                   help="larger values preserve more of the boundary [%(default)s]")
    g.add_argument("--fit-shape", choices=["sphere", "plane"], default=d.fit_shape)

    a = p.add_argument_group("advanced")
    a.add_argument("--levels", type=int, default=d.levels,
                   help="octree levels [%(default)s]")
    a.add_argument("--subsampling", type=int, default=d.subsampling,
                   help="octree subsampling shift [%(default)s]")
    a.add_argument("--leaf-cells", type=int, default=d.leaf_cells,
                   help="microblock size in cells [%(default)s]")
    a.add_argument("--device-block-shift", type=int,
                   default=d.device_block_shift,
                   help="largest device dispatch: 2^shift corners per axis; "
                        "bigger blocks stream as aligned sub-volumes "
                        "[%(default)s]")
    a.add_argument("--max-device-splats", type=parse_capacity,
                   default=d.max_device_splats,
                   help="splat budget per device block [%(default)s]")
    a.add_argument("--tile-candidates", type=parse_capacity, default=d.tile_candidates,
                   help="per-tile candidate cap (auto-grows) [%(default)s]")
    a.add_argument("--device-threads", type=int, default=d.device_threads)
    a.add_argument("--num-devices", type=int, default=0,
                   help="local devices to use (0 = all)")
    a.add_argument("--split-size", type=parse_capacity, default=0,
                   help="approximate size of output chunks (0 = single file)")
    a.add_argument("--checkpoint", help="checkpoint state to PATH instead of writing")
    a.add_argument("--resume", help="resume from checkpoint PATH (write only)")
    a.add_argument("--tmp-dir", help="directory for temporary spill files")
    a.add_argument("--reader", choices=["syscall", "mmap", "stream"],
                   default="syscall",
                   help="input IO backend (reference --reader)")
    a.add_argument("--writer", choices=["syscall", "stream"],
                   default="syscall",
                   help="output IO backend (reference --writer)")
    a.add_argument("--readback", choices=["auto", "codes", "packed", "raw"],
                   default="auto",
                   help="device->host mesh readback format: codes = per-"
                        "cell case codes + interpolants, host rebuilds the "
                        "welded mesh natively (fastest); packed = quantized "
                        "welded mesh; raw = full arrays [auto]")
    a.add_argument("--mem-reorder", type=parse_capacity, default=d.mem_reorder,
                   help="mesher reorder-window byte budget before spilling "
                        "to disk [%(default)s]")
    a.add_argument("--mem-load-splats", type=parse_capacity,
                   default=d.mem_load_splats,
                   help="loader queue byte budget [%(default)s]")
    a.add_argument("--mem-host-splats", type=parse_capacity,
                   default=d.mem_host_splats,
                   help="bytes of splats resident on the host (queue + "
                        "in-flight) [%(default)s]")
    a.add_argument("--mem-bucket-splats", type=parse_capacity,
                   default=d.mem_bucket_splats,
                   help="splat byte budget per bucket [%(default)s]")
    a.add_argument("--mem-mesh", type=parse_capacity, default=d.mem_mesh,
                   help="in-flight mesh readback byte budget [%(default)s]")
    a.add_argument("--mem-blobs", type=parse_capacity, default=d.mem_blobs,
                   help="blob records kept in RAM before spilling to the "
                        "disk-resident blob store [%(default)s]")
    a.add_argument("--max-split", type=parse_capacity, default=d.max_split,
                   help="max subdivisions per bucketing pass [%(default)s]")
    a.add_argument("--decache", action="store_true",
                   help="evict inputs from the page cache first (cold-cache runs)")

    m = p.add_argument_group(
        "distributed (the reference's mlsgpu-mpi interface, mlsgpu-mpi.cpp)")
    m.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="jax.distributed coordinator address (process 0)")
    m.add_argument("--num-processes", type=int, default=1,
                   help="total processes in the multi-host run: one per "
                        "host, each driving all of its host's GPUs "
                        "[%(default)s]")
    m.add_argument("--process-id", type=int, default=0,
                   help="this process's rank [%(default)s]")
    m.add_argument("--scatter", choices=("dynamic", "static"),
                   default=d.scatter,
                   help="work distribution: dynamic = chunks claimed from a "
                        "shared queue (pull-model, self-balancing), static = "
                        "one-shot greedy assignment [%(default)s]")

    o = p.add_argument_group("observability")
    o.add_argument("--statistics", action="store_true",
                   help="print statistics at exit")
    o.add_argument("--profile", metavar="DIR", default=None,
                   help="capture a jax device profile of the compute pass "
                        "into DIR (TensorBoard trace; the reference's "
                        "--statistics-cl event timing analogue)")
    o.add_argument("--statistics-file", help="write statistics to file")
    o.add_argument("--statistics-device", action="store_true",
                   help="time each device stage (binning/MLS/marching/weld) "
                        "into the statistics registry; fences the pipeline, "
                        "so profiling only (the reference's --statistics-cl, "
                        "src/statistics_cl.h:43-93)")
    o.add_argument("--timeplot", help="write timing trace to file")
    o.add_argument("--quiet", action="store_true")
    o.add_argument("--debug", action="store_true")
    o.add_argument("--no-progress", action="store_true")
    return p


def config_from_args(args) -> ReconstructConfig:
    return ReconstructConfig(
        fit_smooth=args.fit_smooth,
        fit_grid=args.fit_grid,
        fit_prune=args.fit_prune,
        fit_boundary_limit=args.fit_boundary_limit,
        fit_shape=args.fit_shape,
        max_radius=args.max_radius if args.max_radius is not None else float("inf"),
        levels=args.levels,
        subsampling=args.subsampling,
        leaf_cells=args.leaf_cells,
        device_block_shift=args.device_block_shift,
        max_device_splats=args.max_device_splats,
        tile_candidates=args.tile_candidates,
        device_threads=args.device_threads,
        num_devices=args.num_devices,
        scatter=args.scatter,
        output_split_size=args.split_size,
        readback=args.readback,
        mem_reorder=args.mem_reorder,
        mem_load_splats=args.mem_load_splats,
        mem_host_splats=args.mem_host_splats,
        mem_bucket_splats=args.mem_bucket_splats,
        mem_mesh=args.mem_mesh,
        mem_blobs=args.mem_blobs,
        max_split=args.max_split,
        decache=args.decache,
        checkpoint=args.checkpoint,
        resume=args.resume,
        tmp_dir=args.tmp_dir,
        timeplot=args.timeplot,
        statistics=args.statistics,
        statistics_file=args.statistics_file,
        statistics_device=args.statistics_device,
        progress=not args.no_progress,
    )


#: The checkout's root: the package's parent directory.
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def compile_cache_dir() -> str:
    """`JAX_COMPILATION_CACHE_DIR` when set, else one fixed directory
    inside the checkout (the path is part of the cache key, so it must not
    move between runs)."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(REPO_ROOT, ".jax_cache"))


def enable_compile_cache() -> None:
    """Persistent XLA compilation cache: the block step compiles once per
    padded-shape/cap combination; caching makes reruns and cap-growth
    retries near-free. Call before the first compile; it initializes the
    backend."""
    import jax
    if jax.default_backend() == "cpu":
        # Serializing CPU executables segfaults in this jaxlib; CPU compiles
        # are comparatively cheap anyway.
        return
    path = compile_cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)


def main(argv: Optional[List[str]] = None) -> int:
    if os.environ.get("MLSGPU_TPU_FORCE_CPU"):
        # Run on the CPU backend (how the multi-process tests run several
        # ranks on one box).
        import jax
        jax.config.update("jax_platforms", "cpu")
    args = build_parser().parse_args(argv)
    transport = None
    if args.num_processes > 1:
        # Must happen before anything initializes a jax backend
        # (MPI_Init analogue, mlsgpu-mpi.cpp:513).
        from mlsgpu_tpu.parallel.multihost import init_distributed
        transport = init_distributed(
            coordinator=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id)
    try:
        enable_compile_cache()  # first backend touch
    except RuntimeError as e:
        # Device backend init failed (no driver, or the card is held by
        # another process). The reference exits with a clear message when
        # no usable CL device exists (mlsgpu.cpp:219-228); do the same
        # instead of a traceback, and point at the CPU backend.
        print(f"error: device backend unavailable: {e}\n"
              f"       (set MLSGPU_TPU_FORCE_CPU=1 to run on the CPU "
              f"backend)", file=sys.stderr)
        return 1
    if args.quiet:
        log.set_log_level("quiet")
    elif args.debug:
        log.set_log_level("debug")
    cfg = config_from_args(args)
    try:
        cfg.validate()
    except MlsError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    if cfg.tmp_dir:
        misc.set_tmp_dir(cfg.tmp_dir)
    if cfg.timeplot:
        timeplot.init(cfg.timeplot)

    from mlsgpu_tpu.io.splat_set import FileSource
    from mlsgpu_tpu.pipeline.reconstruct import reconstruct, resume
    from mlsgpu_tpu.pipeline.resources import validate_device
    from mlsgpu_tpu.utils import provenance
    from mlsgpu_tpu.utils.diskstats import DiskUsage

    start = time.monotonic()
    stats = get_registry()
    comments = provenance.comments()
    try:
        if args.resume:
            if transport is not None:
                from mlsgpu_tpu.parallel.multihost import resume_distributed
                outputs = resume_distributed(args.resume, cfg,
                                             args.output_file, transport)
            else:
                outputs = resume(args.resume, cfg, args.output_file)
        else:
            if not args.inputs:
                print("error: no input files", file=sys.stderr)
                return 2
            validate_device(cfg)
            if cfg.decache:
                from mlsgpu_tpu.io.decache import decache_all
                decache_all(args.inputs)
            source = FileSource(args.inputs, smooth=cfg.fit_smooth,
                                max_radius=cfg.max_radius,
                                reader_type=args.reader)
            try:
                from mlsgpu_tpu.io.binary import make_writer
                from mlsgpu_tpu.io.ply import PlyWriter
                import contextlib

                def _writer_factory():
                    return PlyWriter(writer=make_writer(args.writer),
                                     comments=comments)

                @contextlib.contextmanager
                def _maybe_profile():
                    # Device op-level profiling (--statistics-cl analogue,
                    # src/statistics_cl.h:43-93): a TensorBoard trace of
                    # the compute pass.
                    if not args.profile:
                        yield
                        return
                    import jax
                    try:
                        trace = jax.profiler.trace(args.profile)
                        trace.__enter__()
                    except Exception as e:
                        log.warn(f"profiling unavailable: {e}")
                        yield
                        return
                    try:
                        yield
                    finally:
                        try:
                            trace.__exit__(None, None, None)
                            log.info(
                                f"device profile written to {args.profile}")
                        except Exception as e:
                            log.warn(f"profiling failed: {e}")

                with DiskUsage(), _maybe_profile():
                    if transport is not None:
                        from mlsgpu_tpu.parallel.multihost import (
                            reconstruct_distributed)
                        outputs = reconstruct_distributed(
                            source, cfg, args.output_file, transport,
                            writer_factory=_writer_factory)
                    else:
                        outputs = reconstruct(
                            source, cfg, args.output_file,
                            writer_factory=_writer_factory)
            finally:
                source.close()
    except (MlsError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    elapsed = time.monotonic() - start
    stats.variable("run.time").add(elapsed)
    if cfg.checkpoint:
        log.info(f"checkpoint written in {elapsed:.1f}s")
    else:
        log.info(f"reconstructed {len(outputs)} file(s) in {elapsed:.1f}s")
    if cfg.statistics or cfg.statistics_file:
        out = (open(cfg.statistics_file, "w")
               if cfg.statistics_file else sys.stdout)
        stats.dump(out)
        if cfg.statistics_file:
            out.close()
    timeplot.init(None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
