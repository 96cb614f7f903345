"""The fused per-block device step: binning -> MLS field -> marching -> weld.

This is the JAX analogue of the reference's per-bucket device hot loop
(src/workers.cpp:232-286: SplatTreeCL::enqueueBuild, MlsFunctor,
Marching::generate, mesh readback) collapsed into one `jax.jit`ted function
with fully static shapes. One call consumes a padded splat batch for one
bucket region and produces a welded block mesh plus overflow diagnostics.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from mlsgpu_tpu.ops import binning, marching, mls, weld


class BlockResult(NamedTuple):
    vertices: jnp.ndarray        # (vertex_cap, 3) f32 block-local grid coords
    key_hi: jnp.ndarray          # (vertex_cap,) uint32
    key_lo: jnp.ndarray          # (vertex_cap,) uint32
    triangles: jnp.ndarray       # (index_cap//3, 3) int32
    num_vertices: jnp.ndarray    # () welded vertices
    first_external: jnp.ndarray  # () first external welded vertex
    num_indices: jnp.ndarray     # () valid indices (3 * triangles)
    # Overflow diagnostics (host checks against the static caps):
    max_tile_candidates: jnp.ndarray  # () int32
    num_cells: jnp.ndarray            # () int32 occupied cells
    num_unwelded: jnp.ndarray         # () int32 pre-weld vertices
    # () int32 candidate marching tiles (tile-compacted classification,
    # ops/marching.py); None/0 when the dense path ran.
    num_march_tiles: jnp.ndarray = None
    # Optional single-transfer quantized readback image (pack_output=True):
    # flat u32 [index region | vertex region] per PackFormat — one d2h
    # transfer replaces four, indices ride 16/21 bits, vertices ride
    # edge-key + t16 encoding, and no separate key region is needed at all
    # (the host recomputes weld keys from the vertex encoding).
    packed: jnp.ndarray = None
    # All diagnostic/count scalars stacked into ONE int32[7] device array
    # (order = COUNTS_FIELDS): every separate int() read is a device round
    # trip, so the host fetches this once per block instead of ~8 times
    # (the reference reads its three counts in one readback too,
    # src/marching.cpp:553-566).
    counts: jnp.ndarray = None


#: Order of the scalars inside BlockResult.counts.
COUNTS_FIELDS = ("num_vertices", "first_external", "num_indices",
                 "max_tile_candidates", "num_cells", "num_unwelded",
                 "num_march_tiles")


def fetch_counts(result) -> "np.ndarray":
    """Fetch all of a result's count scalars with a single d2h transfer
    (falls back to per-field reads for results without a counts vector)."""
    import numpy as np
    c = getattr(result, "counts", None)
    if c is not None:
        return np.asarray(c).astype(np.int64)
    out = []
    for f in COUNTS_FIELDS:
        v = getattr(result, f, None)
        out.append(0 if v is None else int(v))
    return np.asarray(out, np.int64)


def _stack_counts(welded, mesh, max_total) -> jnp.ndarray:
    vals = (welded.num_vertices, welded.first_external, welded.num_indices,
            max_total, mesh.num_cells, mesh.num_vertices,
            mesh.num_tiles if mesh.num_tiles is not None else 0)
    return jnp.stack([jnp.asarray(v, jnp.int32).reshape(()) for v in vals])


class PackFormat(NamedTuple):
    """Static layout of the quantized single-transfer readback image.

    The packed buffer is `[index region | vertex region]`, both u32-word
    aligned, live-prefix sized (the quantized analogue of the reference's
    3-event enqueueReadMesh, src/mesh.h:141-179):

    * index region — welded triangle indices:
        - 'u16':   one u16 per index (vertex_cap <= 2^16), 2 per word;
        - 'u21x3': 3 x 21-bit indices per triangle in 2 words
                   (vertex_cap <= 2^21);
        - 'u32':   raw i32 bits (fallback).
    * vertex region — `vertex_words` u16 fields per welded vertex. Every
      marching vertex lies on a cell edge, so it is fully described by its
      edge key plus the interpolation parameter t: per axis, the doubled
      edge-midpoint coordinate kl (from the vertex key) gives an integer
      base = kl>>1 (coord_bits wide), a parity bit (kl odd <=> the vertex
      moves along this axis), and a direction bit (the fraction is 1-t
      rather than t); one shared t is sent as 16-bit fixed point. The host
      reconstructs both the f32 position (base + {0, t, 1-t}) and the
      64-bit global weld key (2*base + parity + 2*cell_origin), so the
      external-keys region of the naive format disappears entirely.
        - vertex_words == 3 (coord_bits <= 8, i.e. blocks up to 256^3
          corners): w[a] = base_a | parity_a<<8 | dir_a<<9 | t16_part<<10,
          where t16 is split 6+6+4 across the three words' high bits;
        - vertex_words == 4 (coord_bits <= 13, the reference's 2^13 block
          limit, src/marching.h:117-141): w[a] = base_a | parity_a<<13 |
          dir_a<<14, and w[3] = t16.
    Positions are quantized to ~2^-16 of a cell; weld keys and topology
    stay exact.
    """
    index_mode: str
    vertex_words: int
    coord_bits: int

    def index_cap_words(self, index_cap: int) -> int:
        if self.index_mode == "u16":
            return (index_cap + 1) // 2
        if self.index_mode == "u21x3":
            return 2 * (index_cap // 3)
        return index_cap

    def index_words(self, num_indices: int) -> int:
        if self.index_mode == "u16":
            return (num_indices + 1) // 2
        if self.index_mode == "u21x3":
            return 2 * (num_indices // 3)
        return num_indices

    def vertex_region_words(self, num_vertices: int) -> int:
        return (num_vertices * self.vertex_words + 1) // 2

    def total_words(self, num_indices: int, num_vertices: int) -> int:
        return (self.index_words(num_indices)
                + self.vertex_region_words(num_vertices))

    def live_words(self, counts) -> int:
        # counts layout = COUNTS_FIELDS: [0]=num_vertices, [2]=num_indices
        return self.total_words(int(counts[2]), int(counts[0]))


class CodesFormat(NamedTuple):
    """Static layout of the codes-mode readback image: one flat u32 buffer
    `[cells u32 | case codes u8 (4/word) | t16 u16 (2/word)]`, live-prefix
    sized. The host rebuilds the welded mesh natively from it
    (_native.mls_rebuild_block); the device never materializes vertices,
    keys, triangle indices, or the weld. nc_axis (cells per axis of the
    block's dense volume) is carried so the host can decode flat cell ids."""
    nc_axis: int

    def total_words(self, num_cells: int, num_unwelded: int) -> int:
        return (num_cells + (num_cells + 3) // 4
                + (num_unwelded + 1) // 2)

    def live_words(self, counts) -> int:
        # counts layout = COUNTS_FIELDS: [4]=num_cells, [5]=num_unwelded
        return self.total_words(int(counts[4]), int(counts[5]))


def codes_format(levels: int, subsampling: int) -> Optional[CodesFormat]:
    """Codes layout for a block size, or None when flat cell ids would not
    fit u32 (needs > 2^10 cells/axis — beyond the supported block bound
    anyway, see config.validate). The block field has 2^max_shift CORNERS
    (ops/mls eval over tiles_per_axis*8 corners), so the cell-id stride is
    2^max_shift - 1 cells per axis."""
    nc_axis = (1 << (levels + subsampling - 1)) - 1
    if nc_axis + 1 > 1 << 10:
        return None
    return CodesFormat(nc_axis=nc_axis)


def pack_format(levels: int, subsampling: int,
                vertex_cap: int) -> Optional[PackFormat]:
    """Choose the static packed layout; None when the block is too large to
    quantize (beyond the reference's own 2^13-corner block limit)."""
    coord_bits = levels + subsampling - 1
    if coord_bits > 13:
        return None
    vertex_words = 3 if coord_bits <= 8 else 4
    if vertex_cap <= 1 << 16:
        index_mode = "u16"
    elif vertex_cap <= 1 << 21:
        index_mode = "u21x3"
    else:
        index_mode = "u32"
    return PackFormat(index_mode, vertex_words, coord_bits)


def _key_to_doubled_local(key_hi, key_lo, cell_origin):
    """Invert ops/marching.py's key packing to the per-axis doubled
    *block-local* edge-midpoint coordinates (kc_local)."""
    m21 = jnp.uint32(0x1FFFFF)
    kx = key_lo & m21
    ky = ((key_lo >> 21) | ((key_hi & jnp.uint32(0x3FF)) << 11)) & m21
    kz = (key_hi >> 10) & m21
    kg = jnp.stack([kx, ky, kz], axis=1).astype(jnp.int32)   # (vc, 3)
    return kg - 2 * cell_origin[None, :].astype(jnp.int32)


def _u16_pairs_to_u32(u16_flat: jnp.ndarray) -> jnp.ndarray:
    """Little-endian pairing of a flat u16 array into u32 words (host side
    reads back with ndarray.view(np.uint16))."""
    return jax.lax.bitcast_convert_type(
        u16_flat.reshape(-1, 2), jnp.uint32)


def _pack_readback(welded, cell_origin, fmt: PackFormat,
                   vertex_cap: int, index_cap: int) -> jnp.ndarray:
    """Quantize and compact the welded mesh into one flat u32 buffer.

    Two dynamic_update_slice copies in slop-safe order: the vertex region is
    written at the END of the index region's live prefix, so its static-size
    slop only overwrites dead tail (no per-element gather)."""
    vc = vertex_cap
    nv = welded.num_vertices.astype(jnp.int32)

    # --- index region ------------------------------------------------------
    if fmt.index_mode == "u16":
        tri_u16 = welded.triangles.astype(jnp.uint16).reshape(-1)
        idx_words = _u16_pairs_to_u32(tri_u16)           # (index_cap/2,)
    elif fmt.index_mode == "u21x3":
        t = welded.triangles.astype(jnp.uint32)
        a, bcol, c = t[:, 0], t[:, 1], t[:, 2]
        w0 = a | ((bcol & jnp.uint32(0x7FF)) << 21)
        w1 = (bcol >> 11) | (c << 10)
        idx_words = jnp.stack([w0, w1], axis=1).reshape(-1)
    else:
        idx_words = jax.lax.bitcast_convert_type(
            welded.triangles, jnp.uint32).reshape(-1)
    ni = welded.num_indices
    if fmt.index_mode == "u16":
        live_idx_words = (ni + 1) // 2
    elif fmt.index_mode == "u21x3":
        live_idx_words = 2 * (ni // 3)
    else:
        live_idx_words = ni

    # --- vertex region -----------------------------------------------------
    kl = _key_to_doubled_local(welded.key_hi, welded.key_lo, cell_origin)
    parity = kl & 1                                       # (vc, 3)
    base = kl >> 1
    f = welded.vertices - base.astype(jnp.float32)        # {0, t, 1-t}
    ref = jnp.argmax(parity, axis=1)                      # first odd axis
    t_par = jnp.take_along_axis(f, ref[:, None], axis=1)  # (vc, 1)
    # fraction equals 1-t (rather than t) on this axis
    dirb = (parity == 1) & (jnp.abs(f - (1.0 - t_par))
                            < jnp.abs(f - t_par))
    t16 = jnp.clip(jnp.round(t_par[:, 0] * 65535.0), 0, 65535
                   ).astype(jnp.uint32)

    base_u = base.astype(jnp.uint32)
    par_u = parity.astype(jnp.uint32)
    dir_u = dirb.astype(jnp.uint32)
    if fmt.vertex_words == 3:
        tparts = jnp.stack([t16 & 0x3F, (t16 >> 6) & 0x3F,
                            (t16 >> 12) & 0xF], axis=1)   # (vc, 3)
        words = (base_u | (par_u << 8) | (dir_u << 9)
                 | (tparts << 10)).astype(jnp.uint16)     # (vc, 3)
    else:
        w012 = (base_u | (par_u << 13) | (dir_u << 14)).astype(jnp.uint16)
        words = jnp.concatenate(
            [w012, t16[:, None].astype(jnp.uint16)], axis=1)  # (vc, 4)
    vert_words = _u16_pairs_to_u32(words.reshape(-1))

    buf = jnp.zeros(fmt.index_cap_words(index_cap)
                    + fmt.vertex_region_words(vc), jnp.uint32)
    buf = jax.lax.dynamic_update_slice(buf, idx_words, (0,))
    buf = jax.lax.dynamic_update_slice(buf, vert_words, (live_idx_words,))
    return buf


def unpack_readback(flat: np.ndarray, num_indices: int, num_vertices: int,
                    first_external: int, fmt: PackFormat,
                    cell_origin: np.ndarray):
    """Host-side decode of _pack_readback's buffer.

    Returns (vertices (nv,3) f32 block-local, triangles (nt,3) i32,
    ext_keys (nv-fe,) i64 global 63-bit weld keys)."""
    ni, nv, fe = int(num_indices), int(num_vertices), int(first_external)
    iw = fmt.index_words(ni)
    if fmt.index_mode == "u16":
        tris = (flat[:iw].view(np.uint16)[:ni]
                .astype(np.int32).reshape(-1, 3))
    elif fmt.index_mode == "u21x3":
        w = flat[:iw].reshape(-1, 2)
        m21 = np.uint32(0x1FFFFF)
        a = w[:, 0] & m21
        b = ((w[:, 0] >> 21) | ((w[:, 1] & np.uint32(0x3FF)) << 11)) & m21
        c = (w[:, 1] >> 10) & m21
        tris = np.stack([a, b, c], axis=1).astype(np.int32)
    else:
        tris = flat[:iw].view(np.int32).reshape(-1, 3)

    vw = fmt.vertex_words
    words = (flat[iw:iw + fmt.vertex_region_words(nv)]
             .view(np.uint16)[:nv * vw].reshape(nv, vw))
    if vw == 3:
        cmask = np.uint16(0xFF)
        base = (words & cmask).astype(np.int32)
        parity = ((words >> 8) & 1).astype(np.int32)
        dirb = ((words >> 9) & 1).astype(bool)
        tp = (words >> 10).astype(np.uint32)
        t16 = (tp[:, 0] & 0x3F) | ((tp[:, 1] & 0x3F) << 6) \
            | ((tp[:, 2] & 0xF) << 12)
    else:
        cmask = np.uint16(0x1FFF)
        base = (words[:, :3] & cmask).astype(np.int32)
        parity = ((words[:, :3] >> 13) & 1).astype(np.int32)
        dirb = ((words[:, :3] >> 14) & 1).astype(bool)
        t16 = words[:, 3].astype(np.uint32)

    t = (t16.astype(np.float32) / np.float32(65535.0))[:, None]
    frac = np.where(parity == 1, np.where(dirb, 1.0 - t, t),
                    np.float32(0.0)).astype(np.float32)
    verts = base.astype(np.float32) + frac

    kg = (2 * base + parity)[fe:] + 2 * np.asarray(cell_origin,
                                                   np.int64)[None, :]
    ext_keys = kg[:, 0] | (kg[:, 1] << 21) | (kg[:, 2] << 42)
    return verts, tris, ext_keys


def _pack_codes(codes_mesh, cell_cap: int, vertex_cap: int) -> jnp.ndarray:
    """Compact the codes-mode marching output into one flat u32 buffer
    (CodesFormat layout). Same slop-safe dynamic_update_slice ordering as
    _pack_readback: each region is written at the end of the previous
    region's live prefix, so static-size slop only overwrites dead tail."""
    nc_l = jnp.minimum(codes_mesh.num_cells, cell_cap).astype(jnp.int32)
    pad4 = (-cell_cap) % 4
    c8 = codes_mesh.cell_codes.astype(jnp.uint8)
    if pad4:
        c8 = jnp.concatenate([c8, jnp.zeros(pad4, jnp.uint8)])
    code_words = jax.lax.bitcast_convert_type(c8.reshape(-1, 4), jnp.uint32)
    pad2 = vertex_cap % 2
    t16 = codes_mesh.t16.astype(jnp.uint16)
    if pad2:
        t16 = jnp.concatenate([t16, jnp.zeros(pad2, jnp.uint16)])
    t_words = _u16_pairs_to_u32(t16)

    fmt = CodesFormat(nc_axis=0)  # total_words only
    buf = jnp.zeros(fmt.total_words(cell_cap, vertex_cap + pad2) + pad4 // 4,
                    jnp.uint32)
    buf = jax.lax.dynamic_update_slice(buf, codes_mesh.cell_ids, (0,))
    off1 = nc_l
    buf = jax.lax.dynamic_update_slice(buf, code_words, (off1,))
    off2 = off1 + (nc_l + 3) // 4
    buf = jax.lax.dynamic_update_slice(buf, t_words, (off2,))
    return buf


def unpack_readback_global(flat: np.ndarray, num_indices: int,
                           num_vertices: int, first_external: int,
                           fmt: PackFormat, cell_origin: np.ndarray):
    """unpack_readback with the block->global cell-origin add folded in,
    through the native C++ decoder when available (bitwise-identical)."""
    from mlsgpu_tpu import _native as nat
    out = nat.unpack_readback(flat, int(num_indices), int(num_vertices),
                              int(first_external), fmt.index_mode,
                              fmt.vertex_words,
                              np.asarray(cell_origin, np.int64))
    if out is not None:
        return out
    verts, tris, keys = unpack_readback(flat, num_indices, num_vertices,
                                        first_external, fmt, cell_origin)
    return verts + np.asarray(cell_origin, np.float32), tris, keys


def block_step_body(splats: jnp.ndarray,
                    valid: jnp.ndarray,
                    region_cells: jnp.ndarray,
                    cell_origin: jnp.ndarray,
                    boundary_factor: float,
                    points: jnp.ndarray = None,
                    *,
                    levels: int,
                    subsampling: int,
                    max_candidates: int,
                    cell_cap: int,
                    vertex_cap: int,
                    index_cap: int,
                    fit_shape: str = "sphere",
                    tile_chunk: int = 32,
                    pack_output: bool = False,
                    march_tile_cap: int = 0,
                    device_filter=None,
                    canonical_faces: bool = True,
                    readback: str = None) -> BlockResult:
    """Reconstruct one block (un-jitted body; see block_step).

    Args:
      splats: (Npad, 8) f32 — *global* grid cell coords, col 3 = radius
        (cells). Global coords keep shared splats bitwise identical across
        blocks (crack avoidance; see ops/mls.py).
      valid: (Npad,) bool.
      region_cells: (3,) int32 (x,y,z) actual cells in the bucket region.
      cell_origin: (3,) int32 global cell coords of the block origin.
      boundary_factor: python float, 1 - gamma^2 (static: config-constant).
    """
    min_shift = subsampling
    max_shift = levels + subsampling - 1
    tiles_per_axis = 1 << (max_shift - 3)  # block corners / 8

    binned = binning.bin_splats(splats, valid, cell_origin,
                                min_shift, max_shift)
    starts, lens = binning.tile_segments(binned.entry_keys, min_shift,
                                         max_shift, tiles_per_axis)
    field, max_total = mls.eval_field(
        binned.entry_data, starts, lens, cell_origin, tiles_per_axis,
        max_candidates, fit_shape, jnp.float32(boundary_factor),
        tile_chunk=tile_chunk)

    if canonical_faces:
        # Face corner planes recomputed block-independently so adjacent
        # blocks agree bitwise at shared corners (no seam cracks; see
        # ops/mls.canonical_face_field).
        field, face_max = mls.canonical_face_field(
            field, binned.entry_data, binned.entry_vals, starts, lens,
            cell_origin, region_cells, tiles_per_axis, max_candidates,
            fit_shape, boundary_factor, tile_chunk=tile_chunk)
        max_total = jnp.maximum(max_total, face_max)
        if points is not None and points.shape[0] > 0:
            # Decomposition edge-skeleton points recomputed per-point so
            # blocks agree bitwise ACROSS face axes too (T-junction seams;
            # see ops/mls.skeleton_point_field).
            field = mls.skeleton_point_field(
                field, binned.entry_data, binned.entry_vals, starts, lens,
                cell_origin, points, tiles_per_axis, max_candidates,
                fit_shape, boundary_factor)

    if readback is None:
        readback = "packed" if pack_output else "raw"
    if readback == "codes" and device_filter is None:
        # Codes mode: no device weld, no index emission, no key packing —
        # the host rebuilds natively (_native.mls_rebuild_block).
        cmesh = marching.generate(field, region_cells, cell_origin,
                                  cell_cap, vertex_cap, index_cap,
                                  tile_cap=march_tile_cap, emit="codes")
        packed = _pack_codes(cmesh, cell_cap, vertex_cap)
        counts = jnp.stack([
            jnp.asarray(v, jnp.int32).reshape(()) for v in (
                cmesh.num_vertices,            # unwelded (welded unknown)
                0,                             # first_external: host-side
                cmesh.num_indices,
                max_total, cmesh.num_cells, cmesh.num_vertices,
                cmesh.num_tiles)])
        return BlockResult(
            vertices=None, key_hi=None, key_lo=None, triangles=None,
            num_vertices=cmesh.num_vertices,
            first_external=jnp.int32(0),
            num_indices=cmesh.num_indices,
            max_tile_candidates=max_total,
            num_cells=cmesh.num_cells,
            num_unwelded=cmesh.num_vertices,
            num_march_tiles=cmesh.num_tiles,
            packed=packed,
            counts=counts)

    mesh = marching.generate(field, region_cells, cell_origin,
                             cell_cap, vertex_cap, index_cap,
                             tile_cap=march_tile_cap)
    welded = weld.weld(mesh.vertices, mesh.key_hi, mesh.key_lo,
                       mesh.triangles, mesh.num_vertices, mesh.num_indices)

    packed = None
    if device_filter is not None:
        # Device-side mesh filter chain (the reference's MeshFilterChain,
        # src/mesh_filter.h:57-170, run before readback): a static jittable
        # vertex transform in *block-local grid coords*. Filtered vertices
        # no longer lie on cell edges, so the quantized pack is skipped and
        # the readback uses the raw arrays (the default grid->world
        # ScaleBias stays folded into the final write instead — cheaper
        # than any device-side form once the pack quantization exists).
        welded = welded._replace(
            vertices=device_filter(welded.vertices, cell_origin))
    elif pack_output:
        fmt = pack_format(levels, subsampling, vertex_cap)
        if fmt is not None:
            packed = _pack_readback(welded, cell_origin, fmt,
                                    vertex_cap, index_cap)

    return BlockResult(
        vertices=welded.vertices,
        key_hi=welded.key_hi,
        key_lo=welded.key_lo,
        triangles=welded.triangles,
        num_vertices=welded.num_vertices,
        first_external=welded.first_external,
        num_indices=welded.num_indices,
        max_tile_candidates=max_total,
        num_cells=mesh.num_cells,
        num_unwelded=mesh.num_vertices,
        num_march_tiles=mesh.num_tiles,
        packed=packed,
        counts=_stack_counts(welded, mesh, max_total),
    )


block_step = functools.partial(
    jax.jit,
    static_argnames=("boundary_factor", "levels", "subsampling",
                     "max_candidates", "cell_cap", "vertex_cap", "index_cap",
                     "fit_shape", "tile_chunk", "pack_output",
                     "march_tile_cap", "device_filter",
                     "canonical_faces", "readback"),
)(block_step_body)
block_step.__doc__ = "Jitted block_step_body (one compile per static config)."


def block_step_staged(splats, valid, region_cells, cell_origin,
                      boundary_factor, points=None, *, levels, subsampling,
                      max_candidates, cell_cap, vertex_cap, index_cap,
                      fit_shape="sphere", tile_chunk=32,
                      pack_output=False, march_tile_cap=0,
                      device_filter=None,
                      canonical_faces=True, registry=None,
                      readback=None) -> BlockResult:
    """`block_step` split into separately-jitted, individually-timed stages.

    The analogue of the reference's per-kernel event timing
    (--statistics-cl, src/statistics_cl.h:43-93): wall-times each device
    sub-program with a block_until_ready fence and records
    `device.binning/mls/marching/weld/pack.time` Variables into the
    statistics registry so analyze_stats can show a device breakdown.
    Fencing between stages defeats XLA's cross-stage fusion and the
    pipeline's async dispatch, so this mode is for profiling, not
    production throughput (the reference's event timing likewise perturbs
    its queues).
    """
    import time as _time

    from mlsgpu_tpu.utils.statistics import get_registry
    registry = registry or get_registry()

    def timed(name, fn, *a, **kw):
        t0 = _time.monotonic()
        out = jax.block_until_ready(fn(*a, **kw))
        registry.variable(f"device.{name}.time").add(_time.monotonic() - t0)
        return out

    min_shift = subsampling
    max_shift = levels + subsampling - 1
    tiles_per_axis = 1 << (max_shift - 3)

    binned = timed("binning", binning.bin_splats, splats, valid, cell_origin,
                   min_shift=min_shift, max_shift=max_shift)
    starts, lens = timed("segments", _jit_tile_segments, binned.entry_keys,
                         min_shift, max_shift, tiles_per_axis)
    field, max_total = timed(
        "mls", _jit_eval_field,
        binned.entry_data, starts, lens, cell_origin, tiles_per_axis,
        max_candidates, fit_shape, jnp.float32(boundary_factor),
        tile_chunk)
    if canonical_faces:
        field, face_max = timed(
            "faces", _jit_face_field, field, binned.entry_data,
            binned.entry_vals, starts, lens, cell_origin, region_cells,
            tiles_per_axis, max_candidates, fit_shape,
            jnp.float32(boundary_factor), tile_chunk)
        max_total = jnp.maximum(max_total, face_max)
        if points is not None and points.shape[0] > 0:
            field = timed(
                "skeleton", _jit_skeleton_field, field, binned.entry_data,
                binned.entry_vals, starts, lens, cell_origin, points,
                tiles_per_axis, max_candidates, fit_shape,
                jnp.float32(boundary_factor))
    if readback is None:
        readback = "packed" if pack_output else "raw"
    if readback == "codes" and device_filter is None:
        cmesh = timed("marching", _jit_marching_codes, field, region_cells,
                      cell_origin, cell_cap, vertex_cap, index_cap,
                      march_tile_cap)
        packed = timed("pack", _jit_pack_codes, cmesh, cell_cap, vertex_cap)
        counts = jax.jit(lambda cm, mt: jnp.stack(
            [jnp.asarray(v, jnp.int32).reshape(()) for v in (
                cm.num_vertices, 0, cm.num_indices, mt, cm.num_cells,
                cm.num_vertices, cm.num_tiles)]))(cmesh, max_total)
        return BlockResult(
            vertices=None, key_hi=None, key_lo=None, triangles=None,
            num_vertices=cmesh.num_vertices, first_external=jnp.int32(0),
            num_indices=cmesh.num_indices, max_tile_candidates=max_total,
            num_cells=cmesh.num_cells, num_unwelded=cmesh.num_vertices,
            num_march_tiles=cmesh.num_tiles,
            packed=packed, counts=counts)
    mesh = timed("marching", _jit_marching, field, region_cells, cell_origin,
                 cell_cap, vertex_cap, index_cap, march_tile_cap)
    welded = timed("weld", _jit_weld, mesh.vertices, mesh.key_hi, mesh.key_lo,
                   mesh.triangles, mesh.num_vertices, mesh.num_indices)
    packed = None
    if device_filter is not None:
        welded = welded._replace(
            vertices=jax.jit(device_filter)(welded.vertices, cell_origin))
    elif pack_output:
        fmt = pack_format(levels, subsampling, vertex_cap)
        if fmt is not None:
            packed = timed("pack", _jit_pack, welded, cell_origin, fmt,
                           vertex_cap, index_cap)
    return BlockResult(
        vertices=welded.vertices, key_hi=welded.key_hi, key_lo=welded.key_lo,
        triangles=welded.triangles, num_vertices=welded.num_vertices,
        first_external=welded.first_external, num_indices=welded.num_indices,
        max_tile_candidates=max_total, num_cells=mesh.num_cells,
        num_unwelded=mesh.num_vertices,
        num_march_tiles=mesh.num_tiles, packed=packed,
        counts=jax.jit(_stack_counts)(welded, mesh, max_total))


_jit_tile_segments = functools.partial(
    jax.jit, static_argnums=(1, 2, 3))(binning.tile_segments)
_jit_eval_field = functools.partial(
    jax.jit, static_argnums=(4, 5, 6, 8))(
        lambda e, s, l, o, tpa, K, shape, bf, chunk: mls.eval_field(
            e, s, l, o, tpa, K, shape, bf, tile_chunk=chunk))
_jit_face_field = functools.partial(
    jax.jit, static_argnums=(7, 8, 9, 11))(
        lambda f, e, v, s, l, o, r, tpa, K, shape, bf, chunk:
        mls.canonical_face_field(f, e, v, s, l, o, r, tpa, K, shape, bf,
                                 tile_chunk=chunk))
_jit_skeleton_field = functools.partial(
    jax.jit, static_argnums=(7, 8, 9))(
        lambda f, e, v, s, l, o, p, tpa, K, shape, bf:
        mls.skeleton_point_field(f, e, v, s, l, o, p, tpa, K, shape, bf))
_jit_marching = functools.partial(
    jax.jit, static_argnums=(3, 4, 5, 6))(marching.generate)
_jit_marching_codes = functools.partial(
    jax.jit, static_argnums=(3, 4, 5, 6))(
        lambda f, r, o, cc, vc, ic, tc: marching.generate(
            f, r, o, cc, vc, ic, tile_cap=tc, emit="codes"))
_jit_weld = jax.jit(weld.weld)
_jit_pack = functools.partial(
    jax.jit, static_argnums=(2, 3, 4))(_pack_readback)
_jit_pack_codes = functools.partial(
    jax.jit, static_argnums=(1, 2))(_pack_codes)


def resolve_readback(requested: str, levels: int, subsampling: int) -> str:
    """'auto' -> 'codes' when the native host rebuild is available and the
    block size fits flat u32 cell ids (fastest: no device weld/index
    emission, smallest transfer); else the quantized 'packed' layout."""
    if requested and requested != "auto":
        return requested
    from mlsgpu_tpu import _native as nat
    if nat.available() and codes_format(levels, subsampling) is not None:
        return "codes"
    return "packed"
