"""Marching tetrahedra over a dense distance-field block.

The reference streams swathes of slices through genOccupied / scan /
generateElements with atomics and blocking readbacks
(kernels/marching.cl, src/marching.cpp:500-823). Here the whole block is
classified densely and the emission is *output-driven*: per output slot
(occupied cell / vertex / index) a branchless binary search over the
inclusive count prefix-sums locates the producing cell, and everything else
is gathers rather than cap-sized scatters. Dynamic totals are returned so the host can
detect cap overflow and retry larger — the static-shape analogue of the
reference's ship-out-when-full (src/marching.h:77-80).

With `tile_cap > 0` the classification itself is tile-compacted (the
analogue of the reference's genOccupied compaction, kernels/marching.cl:84,
src/marching.cpp:500-553): one cheap dense reduction finds 8^3-cell tiles
containing any finite corner (an MLS field is finite only near the
surface), the candidate tiles are compacted to `tile_cap` slots, and the
per-cell classification, count tables and occupied-cell sort all run over
`tile_cap * 512` cells instead of the full volume. The compaction order
(ascending tile id, raster within tile) matches the dense path's, so
outputs are BITWISE IDENTICAL whenever the candidate tiles fit; when they
do not, `num_tiles` exceeds the cap and the host retries larger (counts may
undercount in that case, which is safe because the tile overflow itself
already forces the retry).

Vertex keys use the reference's scheme (kernels/marching.cl:144-163):
21-bit-per-axis fixed point of the doubled global edge-midpoint coordinates,
packed here into two uint32 lanes (hi: ext|z|y_hi, lo: y_lo|x), which sort
and compare as fast 32-bit keys; the external flag makes externals sort last. Unlike the
reference (which leaves z=0 implicit in its swathe order), externals are
marked on all six block faces — welding is symmetric across blocks.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from mlsgpu_tpu.ops import tables

PAD_KEY = jnp.uint32(0xFFFFFFFF)

TILE = 8  # cells per axis of a classification tile

# (8, 3) corner offsets; corner id bit a = offset along axis a.
_CORNER_OFFS = np.array([[(v >> a) & 1 for a in range(3)] for v in range(8)],
                        dtype=np.int32)


class BlockMesh(NamedTuple):
    """Unwelded marching output for one block (static-cap padded)."""
    vertices: jnp.ndarray   # (vertex_cap, 3) f32, block-local grid coords
    key_hi: jnp.ndarray     # (vertex_cap,) uint32
    key_lo: jnp.ndarray     # (vertex_cap,) uint32
    triangles: jnp.ndarray  # (index_cap // 3, 3) int32 into vertices
    num_cells: jnp.ndarray  # () int32 — occupied cells (may exceed cell_cap!)
    num_vertices: jnp.ndarray  # () int32
    num_indices: jnp.ndarray   # () int32
    # () int32 — candidate classification tiles (tile-compacted path; may
    # exceed the tile_cap the program was built with -> host retries). 0 on
    # the dense path.
    num_tiles: jnp.ndarray = None


class BlockCodes(NamedTuple):
    """Codes-mode marching output: the minimal description the host needs
    to rebuild the welded block mesh natively (pipeline/reconstruct +
    _native.mls_rebuild_block). The device never materializes vertices,
    keys, indices, or the weld — the analogue of shipping the reference's
    compacted cell array + per-edge interpolants instead of its welded
    DeviceKeyMesh (src/marching.cpp:553-743 collapsed to the host side)."""
    cell_ids: jnp.ndarray   # (cell_cap,) uint32 flat occupied cell id
    cell_codes: jnp.ndarray  # (cell_cap,) uint32 (8-bit case code values)
    t16: jnp.ndarray        # (vertex_cap,) uint32 (16-bit interpolants,
    #                         emission order = v_start[cell] + j)
    num_cells: jnp.ndarray
    num_vertices: jnp.ndarray  # unwelded emission count
    num_indices: jnp.ndarray
    num_tiles: jnp.ndarray = None


def _slot_to_producer(starts: jnp.ndarray, valid: jnp.ndarray,
                      num_slots: int) -> jnp.ndarray:
    """Map each output slot to the producer index whose [start, next-start)
    range covers it. starts is non-decreasing (an exclusive prefix sum), so
    Scatter each valid producer's id to its start slot (max-combined: among
    start ties the later producer owns the slot — the one with a non-empty
    range) and forward-fill with cummax: one producer-sized scatter instead
    of a cap-sized one, and no sort."""
    n_prod = starts.shape[0]
    pos = jnp.where(valid, starts, jnp.int32(num_slots))  # dropped below
    ids = jnp.arange(n_prod, dtype=jnp.int32)
    seeded = jnp.zeros(num_slots, jnp.int32).at[pos].max(ids, mode="drop")
    return jax.lax.cummax(seeded)


def _cell_tables(sgn):
    """Per-cell true vertex/triangle-count fields from the 8 corner sign
    fields (arithmetic, not a dense 256-row table gather; this fuses into
    the classification): vertices =
    bipolar edges of the 19-edge set; triangles per tet with p outside
    corners = min(p, 4-p) (see tables._build)."""
    nv3 = jnp.zeros_like(sgn[0])
    for (ea, eb) in tables.EDGES:
        nv3 = nv3 + (sgn[ea] ^ sgn[eb])
    nt3 = jnp.zeros_like(sgn[0])
    for t in tables.TETS:
        p = sgn[t[0]] + sgn[t[1]] + sgn[t[2]] + sgn[t[3]]
        nt3 = nt3 + jnp.minimum(p, 4 - p)
    return nv3, nt3


def _classify_dense(field, region_cells, cell_cap):
    """Dense classification: every cell of the (B-1)^3 volume."""
    b = field.shape[0]
    nc = b - 1
    ncells = nc ** 3
    flat_field = field.reshape(-1)

    sgn = []
    code = jnp.zeros((nc, nc, nc), dtype=jnp.int32)
    finite = jnp.ones((nc, nc, nc), dtype=bool)
    for v, (dx, dy, dz) in enumerate(_CORNER_OFFS):
        cv = field[dz:dz + nc, dy:dy + nc, dx:dx + nc]
        s = jnp.where(cv >= 0.0, 1, 0)
        sgn.append(s)
        code = code | (s << v)
        finite = finite & jnp.isfinite(cv)

    zz, yy, xx = jnp.meshgrid(jnp.arange(nc), jnp.arange(nc), jnp.arange(nc),
                              indexing="ij")
    in_region = ((xx < region_cells[0]) & (yy < region_cells[1])
                 & (zz < region_cells[2]))
    occ_mask = finite & in_region
    occupied3 = occ_mask & (code != 0) & (code != 255)

    num_cells = jnp.sum(occupied3.astype(jnp.int32))

    # True output totals over ALL occupied cells (not just the first
    # cell_cap compacted ones): the host's overflow check must see the real
    # requirement even when cell_cap itself overflows, or cap growth would
    # converge by repeated clamped retries — and an undetected vertex/index
    # overflow would ship a corrupt block.
    nv3, nt3 = _cell_tables(sgn)
    true_nv = jnp.sum(jnp.where(occ_mask, nv3, 0))
    true_ni = 3 * jnp.sum(jnp.where(occ_mask, nt3, 0))

    # --- compact occupied cells: two-level tile compaction -------------------
    # Instead of a global occupancy sort over the dense volume, sort 8^3-cell
    # tiles independently (one small batched sort), map each output slot to
    # its tile via the tile-count prefix sum, and take the slot's rank
    # within the tile. Compaction order becomes
    # tile-major rather than raster — downstream only needs *some* fixed
    # order (weld canonicalizes by key).
    tile = TILE
    g = -(-nc // tile)
    occp = jnp.pad(occupied3, ((0, g * tile - nc),) * 3)
    otiles = (occp.reshape(g, tile, g, tile, g, tile)
              .transpose(0, 2, 4, 1, 3, 5).reshape(g ** 3, tile ** 3))
    tcnt = otiles.sum(axis=1, dtype=jnp.int32)
    tstart = jnp.cumsum(tcnt) - tcnt
    loc = jnp.where(otiles, jnp.arange(tile ** 3, dtype=jnp.int32)[None, :],
                    tile ** 3)
    loc_s = jax.lax.sort(loc, dimension=1)                # (g^3, tile^3)

    slots = jnp.arange(cell_cap, dtype=jnp.int32)
    tprod_tile = _slot_to_producer(tstart, tcnt > 0, cell_cap)
    rank = jnp.clip(slots - tstart[tprod_tile], 0, tile ** 3 - 1)
    l_id = jnp.minimum(loc_s[tprod_tile, rank], tile ** 3 - 1)

    occ_valid = slots < jnp.minimum(num_cells, cell_cap)
    t_x = tprod_tile % g
    t_y = (tprod_tile // g) % g
    t_z = tprod_tile // (g * g)
    l_x = l_id % tile
    l_y = (l_id // tile) % tile
    l_z = l_id // (tile * tile)
    cxd = t_x * tile + l_x
    cyd = t_y * tile + l_y
    czd = t_z * tile + l_z
    occ_cell_c = jnp.minimum(czd * (nc * nc) + cyd * nc + cxd, ncells - 1)

    occ_code = code.reshape(-1)[occ_cell_c]

    offs = jnp.asarray(_CORNER_OFFS)
    base = czd * (b * b) + cyd * b + cxd
    corner_flat = (jnp.minimum(base, b ** 3 - 1)[:, None]
                   + offs[None, :, 2] * (b * b) + offs[None, :, 1] * b
                   + offs[None, :, 0])                    # (cell_cap, 8)
    occ_iso = flat_field[jnp.minimum(corner_flat, b ** 3 - 1)]

    return (occ_iso, occ_code, cxd, cyd, czd, occ_valid, num_cells,
            true_nv, true_ni, jnp.int32(0))


def _classify_tiled(field, region_cells, cell_cap, tile_cap):
    """Tile-compacted classification: one dense finite-reduction finds
    candidate 8^3-cell tiles; everything else runs over tile_cap slots.

    A cell can be occupied only if all 8 corners are finite — in particular
    its base corner, which lies in its own tile's 8^3 corner region — so
    "tile has any finite corner in its own region" is a superset of tiles
    with occupied cells. Candidate slots hold ascending tile ids; cells
    within a tile stay raster-ordered, so the occupied-cell compaction
    order (and every downstream output) is bitwise identical to the dense
    path's whenever the candidates fit."""
    b = field.shape[0]
    nc = b - 1
    tile = TILE
    g = -(-nc // tile)
    gb = g * tile + 1
    tcap = min(int(tile_cap), g ** 3)
    # NaN pad: pad cells classify as undefined (and sit outside the region
    # mask anyway).
    fpad = jnp.pad(field, ((0, gb - b),) * 3, constant_values=jnp.nan)

    fin8 = jnp.isfinite(fpad[:g * tile, :g * tile, :g * tile])
    cand = (fin8.reshape(g, tile, g, tile, g, tile)
            .transpose(0, 2, 4, 1, 3, 5).reshape(g ** 3, tile ** 3)
            .any(axis=1))
    num_tiles = jnp.sum(cand.astype(jnp.int32))
    order = jnp.argsort(~cand, stable=True).astype(jnp.int32)
    tids = order[:tcap]                                  # (tcap,)
    slot_ok = jnp.arange(tcap, dtype=jnp.int32) < num_tiles

    t_x = tids % g
    t_y = (tids // g) % g
    t_z = tids // (g * g)

    # Gather each slot's 9^3 corner subvolume (the +1 halo row belongs to
    # the next tile; gb-1 == g*tile so indices stay in range).
    r9 = jnp.arange(tile + 1, dtype=jnp.int32)
    zi = t_z[:, None] * tile + r9[None, :]
    yi = t_y[:, None] * tile + r9[None, :]
    xi = t_x[:, None] * tile + r9[None, :]
    tf = fpad[zi[:, :, None, None], yi[:, None, :, None],
              xi[:, None, None, :]]                      # (tcap, 9, 9, 9)

    sgn = []
    code = jnp.zeros((tcap, tile, tile, tile), dtype=jnp.int32)
    finite = jnp.ones((tcap, tile, tile, tile), dtype=bool)
    for v, (dx, dy, dz) in enumerate(_CORNER_OFFS):
        cv = tf[:, dz:dz + tile, dy:dy + tile, dx:dx + tile]
        s = jnp.where(cv >= 0.0, 1, 0)
        sgn.append(s)
        code = code | (s << v)
        finite = finite & jnp.isfinite(cv)

    lr = jnp.arange(tile, dtype=jnp.int32)
    cx = t_x[:, None, None, None] * tile + lr[None, None, None, :]
    cy = t_y[:, None, None, None] * tile + lr[None, None, :, None]
    cz = t_z[:, None, None, None] * tile + lr[None, :, None, None]
    in_region = ((cx < region_cells[0]) & (cy < region_cells[1])
                 & (cz < region_cells[2]))
    occ_mask = finite & in_region & slot_ok[:, None, None, None]
    occupied = occ_mask & (code != 0) & (code != 255)

    num_cells = jnp.sum(occupied.astype(jnp.int32))
    nv3, nt3 = _cell_tables(sgn)
    true_nv = jnp.sum(jnp.where(occ_mask, nv3, 0))
    true_ni = 3 * jnp.sum(jnp.where(occ_mask, nt3, 0))

    otiles = occupied.reshape(tcap, tile ** 3)
    tcnt = otiles.sum(axis=1, dtype=jnp.int32)
    tstart = jnp.cumsum(tcnt) - tcnt
    loc = jnp.where(otiles, jnp.arange(tile ** 3, dtype=jnp.int32)[None, :],
                    tile ** 3)
    loc_s = jax.lax.sort(loc, dimension=1)               # (tcap, tile^3)

    slots = jnp.arange(cell_cap, dtype=jnp.int32)
    tprod = _slot_to_producer(tstart, tcnt > 0, cell_cap)
    rank = jnp.clip(slots - tstart[tprod], 0, tile ** 3 - 1)
    l_id = jnp.minimum(loc_s[tprod, rank], tile ** 3 - 1)

    occ_valid = slots < jnp.minimum(num_cells, cell_cap)
    l_x = l_id % tile
    l_y = (l_id // tile) % tile
    l_z = l_id // (tile * tile)
    cxd = t_x[tprod] * tile + l_x
    cyd = t_y[tprod] * tile + l_y
    czd = t_z[tprod] * tile + l_z

    occ_code = code.reshape(-1)[tprod * tile ** 3 + l_id]

    offs = jnp.asarray(_CORNER_OFFS)
    s9 = tile + 1
    base = tprod * s9 ** 3 + l_z * s9 ** 2 + l_y * s9 + l_x
    corner_flat = (base[:, None] + offs[None, :, 2] * s9 ** 2
                   + offs[None, :, 1] * s9 + offs[None, :, 0])
    occ_iso = tf.reshape(-1)[corner_flat]                # (cell_cap, 8)

    return (occ_iso, occ_code, cxd, cyd, czd, occ_valid, num_cells,
            true_nv, true_ni, num_tiles)


def generate(field: jnp.ndarray,
             region_cells: jnp.ndarray,
             cell_origin: jnp.ndarray,
             cell_cap: int,
             vertex_cap: int,
             index_cap: int,
             tile_cap: int = 0,
             emit: str = "mesh"):
    """Run marching tetrahedra on a (B, B, B) corner field (indexed [z,y,x]).

    Args:
      field: signed distances, NaN = undefined.
      region_cells: (3,) int32 (x, y, z) — cells actually inside the bucket
        region (<= B-1 per axis); cells beyond are masked off.
      cell_origin: (3,) int32 (x, y, z) global cell coords of local cell 0.
      *_cap: static capacities.
      tile_cap: > 0 compacts classification to that many candidate 8^3
        tiles (bitwise-identical to the dense path when they fit; overflow
        reported via num_tiles). 0 = dense classification.
      emit: "mesh" = full device mesh + keys (welded downstream by
        ops/weld); "codes" = BlockCodes only (per-cell case codes + per-
        vertex t16; the host rebuilds and welds natively) — no device
        vertex positions, keys, indices, or weld, and index_cap is unused.
    """
    assert index_cap % 3 == 0
    # Producer bases ride f32 lanes of occ_row (exact only to 2^24); caps
    # are static, so guard here rather than corrupt triangles silently.
    if vertex_cap >= 1 << 24 or index_cap // 3 >= 1 << 24:
        raise ValueError(
            f"vertex_cap {vertex_cap} / index_cap//3 {index_cap // 3} exceed "
            "2^24-1 (f32-exact packing bound); split the region instead "
            "(lower --levels or the cell budget)")

    if tile_cap:
        (occ_iso, occ_code, ocx, ocy, ocz, occ_valid, num_cells,
         true_nv, true_ni, num_tiles) = _classify_tiled(
            field, region_cells, cell_cap, tile_cap)
    else:
        (occ_iso, occ_code, ocx, ocy, ocz, occ_valid, num_cells,
         true_nv, true_ni, num_tiles) = _classify_dense(
            field, region_cells, cell_cap)

    count_tab = jnp.asarray(tables.COUNT_TABLE)           # (256, 2)
    nv_c = jnp.where(occ_valid, count_tab[occ_code, 0], 0)
    ni_c = jnp.where(occ_valid, count_tab[occ_code, 1], 0)
    v_end = jnp.cumsum(nv_c)
    i_end = jnp.cumsum(ni_c)
    v_start = v_end - nv_c
    i_start = i_end - ni_c
    # Equal to v_end[-1]/i_end[-1] whenever cells fit (the accepted case);
    # strictly larger when cell_cap overflowed, so the host always retries.
    num_vertices = true_nv
    num_indices = true_ni

    offs = jnp.asarray(_CORNER_OFFS)

    if emit == "codes":
        nc = field.shape[0] - 1
        flat_cell = (ocz * (nc * nc) + ocy * nc + ocx).astype(jnp.uint32)
        cell_ids = jnp.where(occ_valid, flat_cell, jnp.uint32(0))
        cell_codes = jnp.where(occ_valid, occ_code, 0).astype(jnp.uint32)

        # One contiguous 16-wide row gather per vertex slot (same trick as
        # the mesh path: independent random gathers are the dominant cost).
        slim_row = jnp.concatenate([
            occ_iso,                                      # 0:8 corner isos
            occ_code[:, None].astype(jnp.float32),        # 8   case code
            v_start[:, None].astype(jnp.float32),         # 9   vertex base
            jnp.zeros((occ_iso.shape[0], 6), jnp.float32),
        ], axis=1)                                        # (cell_cap, 16)

        vert_tab_c = jnp.asarray(tables.VERT_TABLE)
        edges_c = jnp.asarray(tables.EDGES)
        vslots_c = jnp.arange(vertex_cap, dtype=jnp.int32)
        vprod_c = _slot_to_producer(v_start, occ_valid, vertex_cap)
        vvalid_c = vslots_c < num_vertices
        vrow_c = slim_row[vprod_c]                        # (vertex_cap, 16)
        vcode_c = vrow_c[:, 8].astype(jnp.int32)
        jj = jnp.clip(vslots_c - vrow_c[:, 9].astype(jnp.int32), 0,
                      tables.MAX_CELL_VERTICES - 1)
        vedge_cc = jnp.maximum(vert_tab_c[vcode_c, jj], 0)
        viso_c = vrow_c[:, 0:8]
        iso0_c = jnp.take_along_axis(
            viso_c, edges_c[vedge_cc, 0][:, None], axis=1)[:, 0]
        iso1_c = jnp.take_along_axis(
            viso_c, edges_c[vedge_cc, 1][:, None], axis=1)[:, 0]
        t_c = iso0_c / (iso0_c - iso1_c)
        t16 = jnp.clip(jnp.round(t_c * 65535.0), 0, 65535).astype(jnp.uint32)
        t16 = jnp.where(vvalid_c, t16, jnp.uint32(0))
        return BlockCodes(
            cell_ids=cell_ids,
            cell_codes=cell_codes,
            t16=t16,
            num_cells=num_cells.astype(jnp.int32),
            num_vertices=num_vertices.astype(jnp.int32),
            num_indices=num_indices.astype(jnp.int32),
            num_tiles=num_tiles.astype(jnp.int32),
        )

    # Pack everything a downstream slot needs into one 16-wide f32 row: the
    # per-slot stages then do a single contiguous row-gather instead of ~7
    # independent random gathers. All packed ints (code<=255, coords<=2^13, starts<=2^24) are
    # exact in f32.
    occ_row = jnp.concatenate([
        occ_iso,                                          # 0:8  corner isos
        occ_code[:, None].astype(jnp.float32),            # 8    case code
        ocx[:, None].astype(jnp.float32),                 # 9    cell x
        ocy[:, None].astype(jnp.float32),                 # 10   cell y
        ocz[:, None].astype(jnp.float32),                 # 11   cell z
        v_start[:, None].astype(jnp.float32),             # 12   vertex base
        (i_start // 3)[:, None].astype(jnp.float32),      # 13   triangle base
        jnp.zeros((occ_iso.shape[0], 2), jnp.float32),    # 14:16 pad
    ], axis=1)                                            # (cell_cap, 16)

    # --- vertices (producer mapped per output slot; gathers only) -------------
    vert_tab = jnp.asarray(tables.VERT_TABLE)            # (256, MV)
    edges = jnp.asarray(tables.EDGES)                    # (19, 2)
    edge_key = jnp.asarray(tables.EDGE_KEY)              # (19, 3)

    vslots = jnp.arange(vertex_cap, dtype=jnp.int32)
    vprod = _slot_to_producer(v_start, occ_valid, vertex_cap)
    vvalid = vslots < num_vertices
    vrow = occ_row[vprod]                                # (vertex_cap, 16)
    v_base = vrow[:, 12].astype(jnp.int32)
    vcode = vrow[:, 8].astype(jnp.int32)
    cell_xyz = vrow[:, 9:12].astype(jnp.int32)
    j = jnp.clip(vslots - v_base, 0, tables.MAX_CELL_VERTICES - 1)

    vedge = vert_tab[vcode, j]                           # (vertex_cap,)
    vedge_c = jnp.maximum(vedge, 0)
    e0 = edges[vedge_c, 0]
    e1 = edges[vedge_c, 1]
    viso = vrow[:, 0:8]
    iso0 = jnp.take_along_axis(viso, e0[:, None], axis=1)[:, 0]
    iso1 = jnp.take_along_axis(viso, e1[:, None], axis=1)[:, 0]
    off0 = offs[e0]                                      # (vertex_cap, 3)
    off1 = offs[e1]
    t = (iso0 / (iso0 - iso1))[:, None]
    pos = (cell_xyz + off0).astype(jnp.float32) + t * (off1 - off0).astype(jnp.float32)
    vertices = jnp.where(vvalid[:, None], pos, 0.0)

    # Keys: doubled global coordinates of the edge midpoint.
    kc_local = 2 * cell_xyz + edge_key[vedge_c]          # (vertex_cap, 3)
    kc = (kc_local + 2 * cell_origin[None, :]).astype(jnp.uint32)
    top = (2 * region_cells).astype(jnp.int32)
    ext = (jnp.any(kc_local == 0, axis=-1)
           | jnp.any(kc_local == top[None, :], axis=-1))
    key_lo = kc[:, 0] | ((kc[:, 1] & jnp.uint32(0x7FF)) << 21)
    key_hi = ((kc[:, 1] >> 11) | (kc[:, 2] << 10)
              | (ext.astype(jnp.uint32) << 31))
    key_lo = jnp.where(vvalid, key_lo, PAD_KEY)
    key_hi = jnp.where(vvalid, key_hi, PAD_KEY)

    # --- indices --------------------------------------------------------------
    # Per-cell index counts are multiples of 3, so the producer search runs
    # per *triangle* slot (index_cap/3 queries instead of index_cap — the
    # rank sort is the cost, see _slot_to_producer).
    index_tab = jnp.asarray(tables.INDEX_TABLE)          # (256, MI)
    tslots = jnp.arange(index_cap // 3, dtype=jnp.int32)
    tprod = _slot_to_producer(i_start // 3, occ_valid, index_cap // 3)
    tvalid = tslots < num_indices // 3
    trow = occ_row[tprod]                                # (icap//3, 16)
    tcode = trow[:, 8].astype(jnp.int32)
    t_base = trow[:, 13].astype(jnp.int32)
    tv_base = trow[:, 12].astype(jnp.int32)
    k3 = jnp.clip(3 * (tslots - t_base), 0,
                  tables.MAX_CELL_INDICES - 3)
    kk = k3[:, None] + jnp.arange(3, dtype=jnp.int32)[None, :]
    ilocal = index_tab[tcode[:, None], kk]               # (icap//3, 3)
    indices = jnp.where(tvalid[:, None],
                        tv_base[:, None] + jnp.maximum(ilocal, 0),
                        0).reshape(-1)

    return BlockMesh(
        vertices=vertices,
        key_hi=key_hi,
        key_lo=key_lo,
        triangles=indices.reshape(-1, 3),
        num_cells=num_cells.astype(jnp.int32),
        num_vertices=num_vertices.astype(jnp.int32),
        num_indices=num_indices.astype(jnp.int32),
        num_tiles=num_tiles.astype(jnp.int32),
    )
