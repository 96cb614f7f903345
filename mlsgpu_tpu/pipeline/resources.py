"""Device resource estimation and validation.

Re-creation of the reference's up-front memory budgeting
(resourceUsage/validateDevice, src/mlsgpu_core.cpp:469-518): estimate the
HBM working set of one block step from the configuration, print it, and
fail early when it cannot fit — instead of dying mid-run.
"""

from __future__ import annotations

from typing import Dict, Optional

from mlsgpu_tpu.config import ReconstructConfig
from mlsgpu_tpu.utils import logging as log
from mlsgpu_tpu.utils.errors import InvalidOption
from mlsgpu_tpu.utils.misc import next_pow2

F32 = 4
I32 = 4


def estimate_block_usage(cfg: ReconstructConfig) -> Dict[str, int]:
    """Approximate peak device bytes for one jitted block step."""
    b = 1 << cfg.device_shift  # corners of one device dispatch
    cells = (b - 1) ** 3
    npad = next_pow2(cfg.max_device_splats)
    entries = 8 * npad

    usage = {
        # splats + binning entries (keys, values, gathered entry data)
        "splats": npad * 8 * F32,
        "binning": entries * (I32 * 2 + 8 * F32) * 2,  # sort double-buffers
        # distance field + marching dense classification (~6 cell-sized arrays)
        "field": b ** 3 * F32,
        "marching_dense": cells * I32 * 6,
        # per-occupied-cell emission stage
        "marching_cells": cfg.cell_cap * (36 + 13 * 8) * I32,
        # unwelded vertices/keys/triangles + weld sort double-buffers
        "weld": (cfg.vertex_cap * (3 * F32 + 2 * I32) * 2
                 + cfg.index_cap * I32 * 2),
        # the MLS field materializes per-chunk weight tensors
        "mls_weights": 32 * 512 * cfg.tile_candidates * F32 * 3,
    }
    usage["total"] = sum(usage.values())
    return usage


def device_memory_bytes(device=None) -> Optional[int]:
    """The device's memory limit from `memory_stats()`, or None (logged)
    when the device reports none: the limit is never guessed."""
    import jax
    device = device or jax.devices()[0]
    stats = device.memory_stats()
    if stats and "bytes_limit" in stats:
        return int(stats["bytes_limit"])
    log.info(f"device {device.device_kind!r} reports no memory limit; "
             "skipping the block-step memory check")
    return None


def validate_device(cfg: ReconstructConfig, device=None) -> Dict[str, int]:
    """Estimate + check against the device (validateDevice analogue).
    Raises InvalidOption when the block step cannot fit."""
    usage = estimate_block_usage(cfg)
    limit = device_memory_bytes(device)
    log.info("device block-step memory estimate: "
             + ", ".join(f"{k}={v / 1e6:.0f}M" for k, v in usage.items()))
    if limit is not None and usage["total"] > limit * 0.9:
        raise InvalidOption(
            f"estimated block usage {usage['total'] / 1e9:.2f} GB exceeds "
            f"device memory {limit / 1e9:.2f} GB; reduce --levels, "
            "--max-device-splats, or the device caps")
    return usage
