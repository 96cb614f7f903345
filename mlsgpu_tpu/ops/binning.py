"""Splat binning: the sort-based re-expression of the reference's GPU octree.

The reference builds a pointer-chained command list per leaf
(src/splat_tree_cl.{h,cpp} + kernels/octree.cl + clogs radix sort/scan).
The data it encodes is simply, per octree node, the contiguous run of splats
assigned to that node in Morton order. We keep exactly that data — a sorted
(node-key, splat) entry array — and drop the pointer chasing: a corner tile's
candidate splats are the union of at most `levels` *contiguous segments* of
the sorted array (one per ancestor node), located by binary search.

Level assignment matches kernels/octree.cl:39-97: each splat picks the
shift (level) at which its bounding box spans at most 2 nodes per axis, emits
up to 8 (node, splat) entries gated by a conservative sphere/box test, and the
stored radius is replaced by 1/r^2 for the MLS weight (octree.cl:192-194).

Everything here is jit-safe with static shapes: N splats -> exactly 8N
entries, invalid entries get key INVALID_KEY and sort to the end.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from mlsgpu_tpu.ops import morton

INVALID_KEY = jnp.uint32(0xFFFFFFFF)


def level_offsets(min_shift: int, max_shift: int) -> np.ndarray:
    """Key-space offset per shift so each level's Morton codes are disjoint.
    offsets[s - min_shift] for s in [min_shift, max_shift]."""
    offs = []
    pos = 0
    for s in range(min_shift, max_shift + 1):
        offs.append(pos)
        pos += 8 ** (max_shift - s)
    return np.asarray(offs, dtype=np.uint32)


def _level_shift(lo: jnp.ndarray, hi: jnp.ndarray) -> jnp.ndarray:
    """Smallest shift at which [lo, hi] spans <= 2 nodes/axis; depends only on
    hi - lo so it is invariant to octree alignment (kernels/octree.cl:39-55)."""
    diff = hi - lo
    big = jnp.max(diff, axis=-1)
    bits = 32 - jax.lax.clz(jnp.maximum(big - 1, 1).astype(jnp.int32))
    return jnp.where(big > 1, bits, 0)


def _level_shift1(big: jnp.ndarray) -> jnp.ndarray:
    """_level_shift from the per-splat max axis span (1-D form)."""
    bits = 32 - jax.lax.clz(jnp.maximum(big - 1, 1).astype(jnp.int32))
    return jnp.where(big > 1, bits, 0)


def _point_box_dist2(pos: jnp.ndarray, blo: jnp.ndarray, bhi: jnp.ndarray) -> jnp.ndarray:
    nearest = jnp.clip(pos, blo, bhi)
    d = nearest - pos
    return jnp.sum(d * d, axis=-1)


class BinnedSplats(NamedTuple):
    """Sorted entry arrays for one block."""
    entry_data: jnp.ndarray   # (8N, 8) f32: splat fields in entry order, col 3 = 1/r^2
    entry_keys: jnp.ndarray   # (8N,) uint32 sorted node keys (INVALID_KEY = unused)
    entry_vals: jnp.ndarray   # (8N,) int32 splat row index per entry (rows are
    # in ascending global-id order, so equal rows <=> same physical splat —
    # the identity key for the canonical face pass's dedupe)


@functools.partial(jax.jit, static_argnames=("min_shift", "max_shift"))
def bin_splats(splats: jnp.ndarray, valid: jnp.ndarray,
               cell_origin: jnp.ndarray,
               min_shift: int, max_shift: int) -> BinnedSplats:
    """Bin splats into sorted (node, splat) entries for one block.

    Positions stay in the *global* grid frame throughout — like the
    reference's kernels (octree.cl `bias` subtraction happens on integer
    node coordinates only) — so every block sees bitwise-identical splat
    values; block-dependent f32 rounding would otherwise cause cracks at
    block seams.

    Args:
      splats: (N, 8) f32, positions in global grid cell coords, col 3 = radius.
      valid: (N,) bool — padding / out-of-bucket splats are False.
      cell_origin: (3,) int32 — the block's first cell in global coords.
      min_shift: leaf node size = 2^min_shift cells (the subsampling shift).
      max_shift: root node size = 2^max_shift cells (levels+subsampling-1).
    """
    n = splats.shape[0]
    r = splats[:, 3]

    # Everything below runs on per-axis (N,) vectors, NOT (N, 3) arrays: a
    # trailing dim of 3 pads poorly in vector layouts; the per-axis form is
    # bitwise identical (same elementwise ops).
    px = [splats[:, a] for a in range(3)]
    org = [cell_origin[a].astype(jnp.int32) for a in range(3)]
    lo_g = [jnp.floor(px[a] - r).astype(jnp.int32) for a in range(3)]
    hi_g = [jnp.floor(px[a] + r).astype(jnp.int32) for a in range(3)]
    big = jnp.maximum(jnp.maximum(hi_g[0] - lo_g[0], hi_g[1] - lo_g[1]),
                      hi_g[2] - lo_g[2])
    shift = jnp.clip(_level_shift1(big), min_shift, max_shift)
    ilo = [jnp.maximum(lo_g[a] - org[a], 0) >> shift for a in range(3)]

    offs = jnp.asarray(level_offsets(min_shift, max_shift))
    level_offset = offs[shift - min_shift]
    bound = (1 << (max_shift - shift)).astype(jnp.int32)

    r2 = r * r
    r2_conservative = r2 * 1.00001  # octree.cl:194

    def axis_d2(a, d):
        """Squared axis distance from the splat to node slab [addr, addr+1)
        at `shift` (the axis term of the point-box distance)."""
        addr = ilo[a] + d
        blo = ((addr << shift) + org[a]).astype(jnp.float32)
        bhi = (((addr + 1) << shift) + org[a]).astype(jnp.float32)
        nearest = jnp.clip(px[a], blo, bhi)
        dd = nearest - px[a]
        return addr, dd * dd

    # Per-axis tables for d in {0, 1}: 6 slab tests total instead of 24
    # (the 8 corner tests share axis terms).
    addr_t = [[None, None], [None, None], [None, None]]
    d2_t = [[None, None], [None, None], [None, None]]
    for a in range(3):
        for d in (0, 1):
            addr_t[a][d], d2_t[a][d] = axis_d2(a, d)

    keys = []
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                ax, ay, az = addr_t[0][dx], addr_t[1][dy], addr_t[2][dz]
                d2 = d2_t[0][dx] + d2_t[1][dy] + d2_t[2][dz]
                isect = d2 < r2_conservative
                inb = (ax < bound) & (ay < bound) & (az < bound)
                key = level_offset + morton.encode_jnp(
                    ax.astype(jnp.uint32), ay.astype(jnp.uint32),
                    az.astype(jnp.uint32))
                keys.append(jnp.where(isect & inb & valid, key, INVALID_KEY))
    all_keys = jnp.concatenate(keys)                       # (8N,)
    all_vals = jnp.tile(jnp.arange(n, dtype=jnp.int32), 8)  # (8N,)

    sorted_keys, sorted_vals = jax.lax.sort((all_keys, all_vals), num_keys=1)

    # Pre-gather splat data into entry order so the MLS kernel's per-segment
    # reads are contiguous. Radius column becomes 1/r^2.
    mls_form = splats.at[:, 3].set(1.0 / r2)
    entry_data = mls_form[sorted_vals]
    return BinnedSplats(entry_data=entry_data, entry_keys=sorted_keys,
                        entry_vals=sorted_vals)


def tile_segments(entry_keys: jnp.ndarray, min_shift: int, max_shift: int,
                  tiles_per_axis: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """For every 8^3-corner tile, locate the sorted-entry segment of each
    ancestor octree node.

    Tiles are enumerated in (tz, ty, tx) C order and are 8 cells wide; when
    min_shift > 3 several tiles share one leaf node (the reference's
    startShift subsampling, kernels/mls.cl:318). Returns (starts, lengths),
    each (T, L) int32 with T = tiles_per_axis^3 and L = number of levels.
    This replaces the reference's per-leaf `start` array + jump-chained
    command list (src/splat_tree.h:40-75).
    """
    nlev = max_shift - min_shift + 1
    tile_shift = min_shift - 3  # tile coords -> leaf node coords
    t = jnp.arange(tiles_per_axis, dtype=jnp.uint32)
    tz, ty, tx = jnp.meshgrid(t, t, t, indexing="ij")
    code = morton.encode_jnp(tx.ravel(), ty.ravel(), tz.ravel())  # (T,)
    ntiles = code.shape[0]

    offs = jnp.asarray(level_offsets(min_shift, max_shift))
    keys = []
    for li in range(nlev):
        # morton(t) >> 3k == morton(t >> k): ancestor node code by shifting.
        node = code >> jnp.uint32(3 * (tile_shift + li))
        keys.append(offs[li] + node)
        keys.append(offs[li] + node + jnp.uint32(1))
    # ONE batched rank computation: method='sort' pays a sort of the whole
    # entry array per call, so 2*nlev separate calls cost 2*nlev entry
    # sorts; per-level key ranges are disjoint, so a single call over the
    # concatenated queries is equivalent and ~nlev*2 cheaper.
    ranks = jnp.searchsorted(entry_keys, jnp.concatenate(keys), side="left",
                             method="sort").astype(jnp.int32)
    per = ranks.reshape(nlev, 2, ntiles)
    starts = per[:, 0, :].T                        # (T, L)
    lens = (per[:, 1, :] - per[:, 0, :]).T
    return starts, lens
