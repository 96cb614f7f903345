"""Spatial decomposition of the grid into device-sized buckets.

Re-creation of the reference's out-of-core bucketing (src/bucket.{h,cpp},
src/bucket_impl.h:111-580): the grid is partitioned into microblocks; an
implicit octree of per-region splat counts drives a recursive descent that
emits the largest aligned regions satisfying both the cell budget (device
block size) and the splat budget. Counts come from the blob ranges, so no
second pass over the input is needed.

Differences from the reference, chosen for the device pipeline:
- counts live in a dense microblock grid (numpy) instead of a hashed sparse
  octree — trivially vectorized, and even a 2^20-cell extent is only a
  ~256^3 microblock grid at the default 63-cell microblock;
- regions are rectangular boxes of microblocks on a power-of-two-aligned
  tiling, binary-split only where the splat budget is exceeded — padding to
  the static device block shape is cheap (see bucket_regions for why
  alignment is load-bearing);
- a splat spanning multiple microblocks is counted in each (the reference
  counts it once per intersecting region as well: both are the conservative
  'splats intersecting the region' measure, src/bucket.h:144-178).

Output-chunk assignment (ChunkId) follows the reference's generation counter
(src/bucket_collector.h:48-84).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from mlsgpu_tpu.core.chunk import ChunkId
from mlsgpu_tpu.pipeline.blobs import BlobArray, BlobInfo
from mlsgpu_tpu.utils import logging as log
from mlsgpu_tpu.utils.errors import DensityError
from mlsgpu_tpu.utils.misc import div_up
from mlsgpu_tpu.utils.statistics import get_registry

MAX_MICRO_GRID = 512  # dense microblock-count grid guard, per axis


@dataclass
class Bucket:
    """A unit of device work: a cell region plus the blob ranges overlapping
    it (the reference's BucketCollector::Bin)."""
    chunk_id: ChunkId
    cell_lo: np.ndarray        # (3,) int64 grid-local cell coords (x, y, z)
    cell_hi: np.ndarray        # (3,) int64 exclusive
    blob_ids: np.ndarray       # (K,) int64 indices into BlobArray
    num_splats: int            # conservative count (intersecting splats)
    # Decomposition edge-skeleton corner points on this bucket's boundary
    # (global grid coords, (P, 3) int64); see skeleton_points. These are
    # recomputed per-point on the device so every block containing such a
    # point produces a bitwise-identical field value there.
    skeleton: Optional[np.ndarray] = None

    @property
    def cells(self) -> np.ndarray:
        return self.cell_hi - self.cell_lo


def microblock_counts(blobs: BlobArray, micro_lo: np.ndarray,
                      micro_dims: np.ndarray) -> np.ndarray:
    """Dense (mx, my, mz) grid of conservative per-microblock splat counts."""
    dims = tuple(int(d) for d in micro_dims)
    if max(dims) > MAX_MICRO_GRID:
        raise NotImplementedError(
            f"microblock grid {dims} exceeds {MAX_MICRO_GRID}^3; "
            "increase leaf_cells or grid spacing")
    counts = np.zeros(dims, dtype=np.int64)
    lo = blobs.lo - micro_lo
    hi = blobs.hi - micro_lo
    span = hi - lo
    single = (span == 0).all(axis=1)

    # Fast path: blobs covering one microblock (the overwhelming majority).
    # bincount is ~5x faster than np.add.at for this scatter-add.
    if single.any():
        l = lo[single]
        flat = (l[:, 0] * dims[1] + l[:, 1]) * dims[2] + l[:, 2]
        acc = np.bincount(flat, weights=blobs.count[single],
                          minlength=counts.size)
        counts += acc.astype(np.int64).reshape(dims)
    # Spanning blobs, vectorized per span offset: splat radii are a few
    # cells, so spans are 0..1 microblocks per axis almost always — a
    # handful of masked bincounts covers them all (a per-blob Python loop
    # here cost minutes at 100M+ splats).
    multi = np.nonzero(~single)[0]
    small = multi[(span[multi] < _SPAN_VEC).all(axis=1)]
    if len(small):
        mlo, msp = lo[small], span[small]
        mw = blobs.count[small]
        for off in _span_offsets(msp.max(axis=0)):
            sel = (msp >= off).all(axis=1)
            l = mlo[sel] + off
            flat = (l[:, 0] * dims[1] + l[:, 1]) * dims[2] + l[:, 2]
            counts += np.bincount(flat, weights=mw[sel],
                                  minlength=counts.size
                                  ).astype(np.int64).reshape(dims)
    # Rare huge spans: per-blob slice add.
    for i in multi[(span[multi] >= _SPAN_VEC).any(axis=1)]:
        l, h = lo[i], hi[i]
        counts[l[0]:h[0] + 1, l[1]:h[1] + 1, l[2]:h[2] + 1] += blobs.count[i]
    return counts


_SPAN_VEC = 4  # per-axis span bound for the vectorized offset sweep


def _span_offsets(max_span: np.ndarray):
    """All (dx, dy, dz) offsets up to an inclusive per-axis span bound."""
    for dx in range(int(max_span[0]) + 1):
        for dy in range(int(max_span[1]) + 1):
            for dz in range(int(max_span[2]) + 1):
                yield np.array([dx, dy, dz], dtype=np.int64)


def sparse_micro_counts(blobs: BlobArray, micro_lo: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Sorted (morton_codes, counts) of occupied microblocks — the sparse
    replacement for the dense count grid when the extent exceeds
    MAX_MICRO_GRID^3 (the reference's octree of counters is sparse too,
    src/bucket_internal.h). Codes are uint64 Morton (21 bits/axis)."""
    from mlsgpu_tpu.ops import morton
    lo = (blobs.lo - micro_lo).astype(np.uint64)
    hi = (blobs.hi - micro_lo).astype(np.uint64)
    span = (blobs.hi - blobs.lo)
    single = (span == 0).all(axis=1)

    codes = [morton.encode_np(lo[single, 0], lo[single, 1], lo[single, 2])]
    weights = [blobs.count[single]]
    # Spanning blobs, vectorized per span offset (see microblock_counts).
    multi = np.nonzero(~single)[0]
    small = multi[(span[multi] < _SPAN_VEC).all(axis=1)]
    if len(small):
        mlo = lo[small]
        msp = span[small].astype(np.int64)
        mw = blobs.count[small]
        for off in _span_offsets(msp.max(axis=0)):
            sel = (msp >= off).all(axis=1)
            l = mlo[sel] + off.astype(np.uint64)
            codes.append(morton.encode_np(l[:, 0], l[:, 1], l[:, 2]))
            weights.append(mw[sel])
    for i in multi[(span[multi] >= _SPAN_VEC).any(axis=1)]:
        l, h = lo[i], hi[i]
        xs = np.arange(l[0], h[0] + 1, dtype=np.uint64)
        ys = np.arange(l[1], h[1] + 1, dtype=np.uint64)
        zs = np.arange(l[2], h[2] + 1, dtype=np.uint64)
        gx, gy, gz = np.meshgrid(xs, ys, zs, indexing="ij")
        codes.append(morton.encode_np(gx.ravel(), gy.ravel(), gz.ravel()))
        weights.append(np.full(gx.size, blobs.count[i], dtype=np.int64))
    all_codes = np.concatenate(codes)
    all_weights = np.concatenate(weights)
    ucodes, inv = np.unique(all_codes, return_inverse=True)
    counts = np.bincount(inv, weights=all_weights.astype(np.float64),
                         minlength=len(ucodes)).astype(np.int64)
    return ucodes, counts


def bucket_regions_sparse(codes: np.ndarray, counts: np.ndarray,
                          micro_cells: int, dims: np.ndarray,
                          max_cells: int, max_splats: int
                          ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Sparse analogue of bucket_regions: the same pow2-aligned tiling, but
    box sums come from Morton-range queries over the sorted occupied-
    microblock codes (an aligned pow2 cube is one contiguous Morton range).
    Splat-budget splits recurse to octree children (also Morton-contiguous)
    instead of longest-axis halves."""
    from mlsgpu_tpu.ops import morton
    step = max(max_cells // micro_cells, 1)
    step = 1 << int(np.floor(np.log2(step)))
    prefix = np.concatenate([[0], np.cumsum(counts)])

    def cube_sum(code_lo: int, size: int) -> int:
        a = np.searchsorted(codes, code_lo, side="left")
        b = np.searchsorted(codes, code_lo + size ** 3, side="left")
        return int(prefix[b] - prefix[a])

    out: List[Tuple[np.ndarray, np.ndarray]] = []

    def emit(code_lo: int, size: int) -> None:
        n = cube_sum(code_lo, size)
        if n == 0:
            return
        if n <= max_splats:
            x, y, z = morton.decode_np(np.array([code_lo], dtype=np.uint64))
            lo = np.array([int(x[0]), int(y[0]), int(z[0])], dtype=np.int64)
            sz = np.minimum(lo + size, dims) - lo
            if (sz > 0).all():
                out.append((lo, sz))
            return
        if size == 1:
            raise DensityError(
                f"microblock (code {code_lo}) has {n} splats > budget "
                f"{max_splats}", n)
        child = (size // 2) ** 3
        for c in range(8):
            emit(code_lo + c * child, size // 2)

    # Occupied tiles straight from the codes (no dense sweep).
    tile_vol = step ** 3
    tiles = np.unique(codes // tile_vol)
    for t in tiles:
        emit(int(t) * tile_vol, step)
    return out


def _node_count(summed: np.ndarray, lo: np.ndarray, hi: np.ndarray) -> int:
    """Box-sum via 3D summed-area table (inclusive prefix sums)."""
    dims = summed.shape
    hi = np.minimum(hi, dims)  # exclusive, clipped
    l = np.maximum(lo, 0)

    def s(x, y, z):
        if x < 1 or y < 1 or z < 1:
            return 0
        return int(summed[x - 1, y - 1, z - 1])

    x0, y0, z0 = int(l[0]), int(l[1]), int(l[2])
    x1, y1, z1 = int(hi[0]), int(hi[1]), int(hi[2])
    return (s(x1, y1, z1) - s(x0, y1, z1) - s(x1, y0, z1) - s(x1, y1, z0)
            + s(x0, y0, z1) + s(x0, y1, z0) + s(x1, y0, z0) - s(x0, y0, z0))


def bucket_regions(counts: np.ndarray, micro_cells: int, grid_cells: np.ndarray,
                   max_cells: int, max_splats: int
                   ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Tile the microblock grid with aligned boxes, then binary-split any box
    exceeding the splat budget along its longest axis. Returns a list of
    (micro_lo (3,), micro_size (3,)) boxes.

    The tile step is the largest *power-of-two* microblock count within the
    cell budget — NOT the largest count outright. Power-of-two alignment
    keeps the per-block octree node grids (ops/binning.py, anchored at the
    block origin) mutually aligned across blocks, which keeps each shared
    corner's splat accumulation order identical in both blocks; unaligned
    origins reorder the f32 sums and open hairline seam cracks (observed:
    ~1 boundary edge per 4k triangles with non-pow2 56-cell tiles). The
    reference merges sibling runs into non-pow2 regions (src/bucket_impl.h)
    but its per-corner octree walk is alignment-independent; ours is the
    price of the sort/matmul formulation.

    Raises DensityError when a single microblock exceeds max_splats
    (reference src/bucket.h:53-64)."""
    dims = np.asarray(counts.shape, dtype=np.int64)
    summed = counts.cumsum(0).cumsum(1).cumsum(2)
    max_micro = max(max_cells // micro_cells, 1)
    max_micro = 1 << int(np.floor(np.log2(max_micro)))

    out: List[Tuple[np.ndarray, np.ndarray]] = []

    def emit(lo: np.ndarray, hi: np.ndarray) -> None:
        n = _node_count(summed, lo, hi)
        if n == 0:
            return
        if n <= max_splats:
            out.append((lo.copy(), hi - lo))
            return
        size = hi - lo
        ax = int(np.argmax(size))
        if size[ax] == 1:
            raise DensityError(
                f"microblock at {lo} has {n} splats > budget {max_splats}", n)
        mid = int(lo[ax]) + int(size[ax]) // 2
        hi_a = hi.copy()
        hi_a[ax] = mid
        lo_b = lo.copy()
        lo_b[ax] = mid
        emit(lo, hi_a)
        emit(lo_b, hi)

    # Tile sums for the whole tiling at once (padded prefix table + np.ix_),
    # so empty tiles are skipped without entering Python per tile.
    step = int(max_micro)
    pad = np.zeros(tuple(int(d) + 1 for d in dims), dtype=np.int64)
    pad[1:, 1:, 1:] = summed
    starts = [np.arange(0, int(d), step) for d in dims]
    ends = [np.minimum(s + step, int(d)) for s, d in zip(starts, dims)]
    tile_sums = (pad[np.ix_(ends[0], ends[1], ends[2])]
                 - pad[np.ix_(starts[0], ends[1], ends[2])]
                 - pad[np.ix_(ends[0], starts[1], ends[2])]
                 - pad[np.ix_(ends[0], ends[1], starts[2])]
                 + pad[np.ix_(starts[0], starts[1], ends[2])]
                 + pad[np.ix_(starts[0], ends[1], starts[2])]
                 + pad[np.ix_(ends[0], starts[1], starts[2])]
                 - pad[np.ix_(starts[0], starts[1], starts[2])])
    for ti, tj, tk in zip(*np.nonzero(tile_sums)):
        lo = np.array([starts[0][ti], starts[1][tj], starts[2][tk]],
                      dtype=np.int64)
        hi = np.minimum(lo + step, dims)
        emit(lo, hi)
    return out


def assign_blobs(blobs: BlobArray, micro_lo: np.ndarray,
                 regions: List[Tuple[np.ndarray, np.ndarray]],
                 step: Optional[int] = None) -> List[np.ndarray]:
    """Blob ids overlapping each region.

    When `step` (the bucket_regions tiling step) is given, single-tile blobs
    are pre-grouped by tile with one argsort, so each region only tests its
    own tile's blobs plus the (rare) tile-spanning ones — O(B log B + R·k)
    instead of the O(R·B) per-region sweep (the reference's per-recursion
    blob-stream walk plays the same role, src/bucket_impl.h)."""
    lo = blobs.lo - micro_lo  # (B, 3)
    hi = blobs.hi - micro_lo

    def precise(ids, rlo, rhi):
        sel = ((hi[ids] >= rlo) & (lo[ids] < rhi)).all(axis=1)
        return ids[sel]

    if step is None or not regions:
        out = []
        for rlo, size in regions:
            rhi = rlo + size
            sel = ((hi >= rlo) & (lo < rhi)).all(axis=1)
            out.append(np.nonzero(sel)[0].astype(np.int64))
        return out

    tl = lo // step
    th = hi // step
    tspan = th - tl
    single = (tspan == 0).all(axis=1)
    ids = np.arange(len(lo), dtype=np.int64)
    tdim = np.maximum(th.max(axis=0) + 1, 1)

    # Expand every blob into (tile, id) pairs so each region only inspects
    # its own tile's blobs. Tile-spanning blobs (rare: tiles are many
    # microblocks wide) are expanded vectorized per span offset; a per-blob
    # scan of them for every region cost O(R * B_multi) = minutes at 100M+
    # splats.
    pair_keys = [(tl[single, 0] * tdim[1] + tl[single, 1]) * tdim[2]
                 + tl[single, 2]]
    pair_ids = [ids[single]]
    multi = ids[~single]
    small = multi[(tspan[multi] < _SPAN_VEC).all(axis=1)]
    if len(small):
        mtl, msp = tl[small], tspan[small]
        for off in _span_offsets(msp.max(axis=0)):
            sel = (msp >= off).all(axis=1)
            t = mtl[sel] + off
            pair_keys.append((t[:, 0] * tdim[1] + t[:, 1]) * tdim[2]
                             + t[:, 2])
            pair_ids.append(small[sel])
    for i in multi[(tspan[multi] >= _SPAN_VEC).any(axis=1)]:
        xs = np.arange(tl[i, 0], th[i, 0] + 1, dtype=np.int64)
        ys = np.arange(tl[i, 1], th[i, 1] + 1, dtype=np.int64)
        zs = np.arange(tl[i, 2], th[i, 2] + 1, dtype=np.int64)
        gx, gy, gz = np.meshgrid(xs, ys, zs, indexing="ij")
        pair_keys.append((gx.ravel() * tdim[1] + gy.ravel()) * tdim[2]
                         + gz.ravel())
        pair_ids.append(np.full(gx.size, i, dtype=np.int64))

    key = np.concatenate(pair_keys)
    pid = np.concatenate(pair_ids)
    order = np.argsort(key, kind="stable")
    skey = key[order]
    sids = pid[order]

    out = []
    for rlo, size in regions:
        rhi = rlo + size
        t = rlo // step
        if (t < 0).any() or (t >= tdim).any():
            base = np.empty(0, np.int64)
        else:
            k = (t[0] * tdim[1] + t[1]) * tdim[2] + t[2]
            a = np.searchsorted(skey, k, side="left")
            b = np.searchsorted(skey, k, side="right")
            base = precise(sids[a:b], rlo, rhi)
        out.append(np.sort(base))
    return out


def skeleton_points(buckets: List[Bucket]) -> None:
    """Attach to every bucket the decomposition edge-skeleton points on its
    boundary (global corner coords).

    The canonical face pass (ops/mls.canonical_face_field) makes face values
    block-independent *per face axis*, but a grid point on the EDGE of some
    region is written by more than one face pass — and at a T-junction
    (adaptive splits with unequal extents) a neighbor sees that point in the
    interior of a single face, so the two blocks can keep values from
    different axes, whose f32 rounding differs. The fix is a third, per-point
    device pass (ops/mls.skeleton_point_field) over exactly these points.

    The skeleton is the union of all regions' box edges (12 segments each).
    Any skeleton point p lying on a bucket's closed boundary is attached to
    that bucket: every block containing p overwrites its field there with
    the same position-keyed value. A foreign edge can only touch a bucket's
    boundary, never its interior (regions have disjoint interiors), so
    clipping each segment to the bucket's closed box is sufficient.

    The reference needs no analogue: its per-corner octree walk accumulates
    in a block-independent order by construction (kernels/mls.cl:299-433).
    """
    if not buckets:
        return
    # Segment soup: for each bucket, 12 edges. axis d varies; the other two
    # axes (in (d+1)%3, (d+2)%3 order) are fixed at lo/hi corner planes.
    seg_axis, seg_lo, seg_hi, seg_fb, seg_fc = [], [], [], [], []
    for b in buckets:
        lo, hi = b.cell_lo, b.cell_hi
        for d in range(3):
            e1, e2 = (d + 1) % 3, (d + 2) % 3
            for vb in (lo[e1], hi[e1]):
                for vc in (lo[e2], hi[e2]):
                    seg_axis.append(d)
                    seg_lo.append(lo[d])
                    seg_hi.append(hi[d])
                    seg_fb.append(vb)
                    seg_fc.append(vc)
    seg_axis = np.asarray(seg_axis, np.int64)
    seg_lo = np.asarray(seg_lo, np.int64)
    seg_hi = np.asarray(seg_hi, np.int64)
    seg_fb = np.asarray(seg_fb, np.int64)
    seg_fc = np.asarray(seg_fc, np.int64)
    e1 = (seg_axis + 1) % 3
    e2 = (seg_axis + 2) % 3

    for b in buckets:
        blo, bhi = b.cell_lo, b.cell_hi
        in_fb = (seg_fb >= blo[e1]) & (seg_fb <= bhi[e1])
        in_fc = (seg_fc >= blo[e2]) & (seg_fc <= bhi[e2])
        clo = np.maximum(seg_lo, blo[seg_axis])
        chi = np.minimum(seg_hi, bhi[seg_axis])
        sel = np.nonzero(in_fb & in_fc & (clo <= chi))[0]
        if not len(sel):
            b.skeleton = np.empty((0, 3), np.int64)
            continue
        counts = (chi[sel] - clo[sel] + 1)
        total = int(counts.sum())
        rep = np.repeat(sel, counts)
        # running coordinate along each segment's axis
        base = np.repeat(clo[sel], counts)
        off = np.arange(total) - np.repeat(
            np.concatenate([[0], np.cumsum(counts)[:-1]]), counts)
        pts = np.empty((total, 3), np.int64)
        idx = np.arange(total)
        pts[idx, seg_axis[rep]] = base + off
        pts[idx, e1[rep]] = seg_fb[rep]
        pts[idx, e2[rep]] = seg_fc[rep]
        key = (pts[:, 0] << 42) | (pts[:, 1] << 21) | pts[:, 2]
        _, uniq = np.unique(key, return_index=True)
        b.skeleton = pts[np.sort(uniq)]


def make_buckets(info: BlobInfo, block_cells: int, micro_cells: int,
                 max_splats: int,
                 chunk_cells: Optional[int] = None,
                 max_split: Optional[int] = None) -> List[Bucket]:
    """Full bucketing driver: counts -> regions -> blob assignment -> Buckets
    (the doBucket + BucketCollector path, src/mlsgpu_core.cpp:656-678).

    chunk_cells groups buckets into output chunks (--split-size heuristic,
    src/mlsgpu_core.cpp:632-653); None = single output chunk. External-vertex
    deduplication happens per chunk, so all buckets of one chunk must share
    one ChunkId (the reference's BucketCollector generation assignment)."""
    stats = get_registry()
    with stats.timer("bucket.time"):
        grid_cells = np.asarray(info.grid.shape_cells, dtype=np.int64)
        if (info.micro_dims > MAX_MICRO_GRID).any():
            codes, counts = sparse_micro_counts(info.blobs, info.micro_lo)
            regions = bucket_regions_sparse(
                codes, counts, micro_cells, info.micro_dims,
                block_cells, max_splats)
        else:
            counts = microblock_counts(info.blobs, info.micro_lo,
                                       info.micro_dims)
            regions = bucket_regions(counts, micro_cells, grid_cells,
                                     block_cells, max_splats)
        if max_split is not None and len(regions) > max_split:
            # --max-split bounds the region list of one bucketing pass
            # (the reference's maxSplit recursion budget,
            # src/bucket.h:180-189, default 2^30).
            raise DensityError(
                f"bucketing produced {len(regions)} regions > max_split "
                f"{max_split}; raise --max-split or --leaf-cells",
                len(regions))
        step = max(block_cells // micro_cells, 1)
        step = 1 << int(np.floor(np.log2(step)))  # must match bucket_regions
        blob_lists = assign_blobs(info.blobs, info.micro_lo, regions,
                                  step=step)

    # Grid-local cell coordinates: microblock (0,0,0) sits at absolute cell
    # micro_lo * micro_cells; the grid's cell 0 is extent lo.
    ext_lo = np.array([e[0] for e in info.grid.extents], dtype=np.int64)
    micro_origin = info.micro_lo * micro_cells - ext_lo  # grid-local cells

    buckets: List[Bucket] = []
    chunk_ids: dict = {}
    for (rlo, size), bids in zip(regions, blob_lists):
        if not len(bids):
            continue
        cell_lo = micro_origin + rlo * micro_cells
        cell_hi = np.minimum(cell_lo + size * micro_cells, grid_cells)
        cell_lo_cl = np.maximum(cell_lo, 0)
        if (cell_hi <= cell_lo_cl).any():
            continue
        n = int(info.blobs.count[bids].sum())
        if chunk_cells is None:
            coords = (0, 0, 0)
        else:
            coords = tuple(int(c) for c in cell_lo_cl // chunk_cells)
        cid = chunk_ids.get(coords)
        if cid is None:
            cid = ChunkId(gen=len(chunk_ids), coords=coords)
            chunk_ids[coords] = cid
        buckets.append(Bucket(
            chunk_id=cid,
            cell_lo=cell_lo_cl, cell_hi=cell_hi,
            blob_ids=bids, num_splats=n))

    with stats.timer("bucket.skeletonTime"):
        skeleton_points(buckets)
    stats.counter("bucket.count").add(len(buckets))
    log.info(f"bucketing: {len(buckets)} buckets "
             f"(max splats/bucket: {max((b.num_splats for b in buckets), default=0)})")
    return buckets
