"""Configuration schema with the reference's option surface and defaults.

Mirrors the option names/defaults of src/mlsgpu_core.cpp:86-137 plus
device-specific knobs (static-shape caps). Capacity values accept B/K/M/G suffixes like
the reference's Capacity wrapper (src/options.h:44-120).
"""

from __future__ import annotations

from dataclasses import dataclass, field, asdict
from typing import Optional

from mlsgpu_tpu.utils.errors import InvalidOption

_SUFFIXES = {"B": 1, "K": 1024, "M": 1024 ** 2, "G": 1024 ** 3, "T": 1024 ** 4}


def parse_capacity(text) -> int:
    """Parse '512M'-style sizes (reference Capacity, src/options.h:44-120)."""
    if isinstance(text, int):
        return text
    text = str(text).strip()
    mult = 1
    if text and text[-1].upper() in _SUFFIXES:
        mult = _SUFFIXES[text[-1].upper()]
        text = text[:-1]
    try:
        return int(text) * mult
    except ValueError as e:
        raise InvalidOption(f"invalid capacity {text!r}") from e


@dataclass
class ReconstructConfig:
    # --- fit options (defaults: src/mlsgpu_core.cpp:86-113) ---
    fit_smooth: float = 4.0          # radius scale factor
    fit_grid: float = 0.01           # grid spacing (world units)
    fit_prune: float = 0.02          # min component size as fraction of total vertices
    fit_boundary_limit: float = 1.0  # gamma: boundary rejection tuning
    fit_shape: str = "sphere"        # 'sphere' | 'plane'
    max_radius: float = float("inf")  # --max-radius clamp before smoothing

    # --- grid/block geometry ---
    levels: int = 6                  # octree levels
    subsampling: int = 3             # log2 of leaf size in cells
    leaf_cells: int = 63             # microblock cap for bucketing
    # Largest device dispatch: 2^shift corners per axis (the dense MLS
    # corner field of one dispatch lives in HBM; 2^10 = 4.3 GiB f32).
    # Bucket volumes larger than this stream through the device as aligned
    # sub-volume dispatches — the analogue of the reference's z-swathe
    # streaming of one block (src/marching.cpp:783-823, src/marching.h:67-80),
    # which is how it reaches its 2^13 block bound on bounded device memory.
    device_block_shift: int = 10
    max_split: int = 2 ** 30         # max subdivisions in one bucketing level

    # --- memory budgets (host, bytes; reference defaults
    # src/mlsgpu_core.cpp:130-137) ---
    mem_load_splats: int = 256 * 1024 ** 2   # loader queue byte budget
    mem_host_splats: int = 512 * 1024 ** 2   # queue + in-flight splat bytes
    mem_bucket_splats: int = 64 * 1024 ** 2  # splat bytes per bucket
    mem_mesh: int = 512 * 1024 ** 2          # in-flight mesh readback bytes
    mem_reorder: int = 2 * 1024 ** 3         # mesher reorder buffer
    mem_blobs: int = 512 * 1024 ** 2         # blob records in RAM before the
    # disk-resident store takes over (the reference always uses temp files,
    # src/splat_set.h:824-849)

    # --- device caps (static shapes; overflow => retry grown to a
    # near-fit eighth-pow2 step — cap slop is wall time in the cap-sized
    # marching/weld stages, and the grown values persist across runs via
    # the caps cache) ---
    max_device_splats: int = 1 << 20   # splats resident per block step
    tile_candidates: int = 512         # K: padded per-tile candidate splats
    cell_cap: int = 1 << 16            # occupied-cell cap per block
    vertex_cap: int = 1 << 18          # unwelded vertex cap per block
    index_cap: int = 3 << 18           # index cap per block

    # --- pipeline ---
    readback: str = "auto"           # 'auto' | 'codes' | 'packed' | 'raw'
    device_threads: int = 1
    sizing_probe: bool = True        # pre-run the densest bucket to grow
    # caps before streaming (kills mid-run recompiles); tests
    # that drive the mid-run growth path disable it
    eager_write: bool = True         # chunked outputs: write each chunk as
    # its last block lands (overlaps the final write with device compute);
    # chunks touched by pruning are rewritten at finalization
    output_split_size: int = 0       # bytes; 0 = single output file
    checkpoint: Optional[str] = None
    resume: Optional[str] = None
    tmp_dir: Optional[str] = None
    timeplot: Optional[str] = None
    statistics: bool = False
    statistics_file: Optional[str] = None
    statistics_device: bool = False  # per-stage device timing (the
    # reference's --statistics-cl event timing, src/statistics_cl.h:43-93);
    # fences between stages, so use for profiling only
    progress: bool = True
    decache: bool = False

    # --- parallel ---
    num_devices: int = 0             # 0 = all local devices
    scatter: str = "dynamic"         # distributed work distribution:
    # 'dynamic' = chunks claimed from a shared queue (the reference's
    # pull-model scatter, mlsgpu-mpi.cpp:202-246; self-balances skew),
    # 'static' = one-shot greedy assignment (no side channel needed)

    def validate(self) -> None:
        """Two-stage validation, stage 1 (reference validateOptions,
        src/mlsgpu_core.cpp:398-457)."""
        if self.fit_smooth <= 0:
            raise InvalidOption("fit_smooth must be positive")
        if self.fit_grid <= 0:
            raise InvalidOption("fit_grid must be positive")
        if not (0.0 <= self.fit_prune < 1.0):
            raise InvalidOption("fit_prune must be in [0, 1)")
        if not (0.0 < self.fit_boundary_limit):
            raise InvalidOption("fit_boundary_limit must be positive")
        if self.fit_shape not in ("sphere", "plane"):
            raise InvalidOption("fit_shape must be sphere or plane")
        if self.levels < 1 or self.levels > 12:
            # Reference maxLevels = min(MAX_DIMENSION_LOG2 + 1,
            # SplatTreeCL::MAX_LEVELS) (src/mlsgpu_core.cpp:411-419); with
            # subsampling >= 3 the levels+subsampling bound below governs.
            raise InvalidOption("levels must be in 1..12")
        if self.subsampling < 3:
            # The MLS tile is 8^3 corners = one leaf node; leaves must be at
            # least that big (reference subsamplingMin, src/mls.cpp:53-60).
            raise InvalidOption("subsampling must be >= 3")
        if self.levels + self.subsampling > 14:
            # The reference's own block bound: 2^(levels+subsampling-1)
            # corners per axis <= 2^13 (Marching::MAX_DIMENSION_LOG2,
            # src/marching.h:117-141).
            raise InvalidOption(
                "levels + subsampling must be <= 14: blocks are "
                f"2^(levels+subsampling-1) (= 2^{self.levels + self.subsampling - 1}) "
                "corners per axis and vertex keys carry 13-bit block-local "
                "coordinates (the reference's Marching::MAX_DIMENSION_LOG2)")
        if not (4 <= self.device_block_shift <= 10):
            # The dense MLS corner field of one device dispatch must fit
            # HBM ((2^10)^3 f32 = 4.3 GiB). Volumes larger than this are
            # streamed through the device as aligned sub-volumes (the
            # analogue of the reference's z-swathe streaming,
            # src/marching.cpp:783-823); see device_block_cells.
            raise InvalidOption("device_block_shift must be in 4..10")
        if self.subsampling > self.device_block_shift:
            raise InvalidOption(
                "subsampling must not exceed device_block_shift "
                f"({self.device_block_shift}): one device sub-volume must "
                "hold at least one leaf")
        if self.leaf_cells < 1:
            raise InvalidOption("leaf_cells must be >= 1")
        # budget ordering (reference validateOptions,
        # src/mlsgpu_core.cpp:398-457)
        if self.mem_bucket_splats > self.mem_load_splats:
            raise InvalidOption(
                "mem_bucket_splats must not exceed mem_load_splats")
        if self.mem_load_splats > self.mem_host_splats:
            raise InvalidOption(
                "mem_load_splats must not exceed mem_host_splats")
        if self.max_split < 8:
            raise InvalidOption("max_split must be at least 8")
        if self.scatter not in ("dynamic", "static"):
            raise InvalidOption("scatter must be dynamic or static")

    @property
    def block_corners(self) -> int:
        """Corners per axis of a device block: 2^(levels + subsampling - 1)
        (reference src/mlsgpu_core.cpp:600-603)."""
        return 1 << (self.levels + self.subsampling - 1)

    @property
    def block_cells(self) -> int:
        return self.block_corners - 1

    @property
    def device_shift(self) -> int:
        """log2 corners per axis of one device dispatch: the block shift,
        clamped to the device sub-volume bound (device_block_shift)."""
        return min(self.levels + self.subsampling - 1,
                   self.device_block_shift)

    @property
    def device_levels(self) -> int:
        """The `levels` the device step runs at (>= 1 by validate)."""
        return self.device_shift - self.subsampling + 1

    @property
    def device_block_cells(self) -> int:
        """Cells per axis of one device dispatch region. Bucketing bounds
        regions to this, so blocks requested above the device bound (up to
        the reference's 2^13) stream as multiple aligned sub-volume
        dispatches welded by the ordinary external-key machinery."""
        return (1 << self.device_shift) - 1

    @property
    def micro_cells(self) -> int:
        """Microblock size for bucketing = min(leaf_cells, device block)."""
        return min(self.leaf_cells, self.device_block_cells)

    @property
    def boundary_factor(self) -> float:
        """1 - gamma^2 (reference MlsFunctor::setBoundaryLimit, src/mls.h:164-169)."""
        g = self.fit_boundary_limit
        return 1.0 - g * g

    def to_dict(self) -> dict:
        return asdict(self)
