"""Signed-distance field evaluation: the XLA form of kernels/mls.cl.

The reference's `processCorners` (kernels/mls.cl:299-433) walks an octree
command list per 8x8x8-corner workgroup, staging splats into local memory and
accumulating weighted moments per corner. Here the walk is already resolved
into per-tile contiguous segments (ops/binning.py); the accumulation is
restructured as dense linear algebra:

  pairwise |x - c|^2 = |x|^2 - 2 c.x + |c|^2     -> one (512,3)x(3,K) matmul
  weights  w = relu(1-d)^4 * quality * mask       -> elementwise
  moments  M = W @ [1, x, |x|^2, n, n.x]          -> one (512,K)x(K,9) matmul

Positions are re-centered on each tile's origin before the matmuls so the
|x|^2 expansion stays well-conditioned in float32 (corner-relative values are
O(tile + radius), never O(block)); the final per-corner re-centering of the
moments is exact in the same small frame.

A corner with < 4 hits or failing the boundary test gets NaN, exactly like
the reference (mls.cl:394-426).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from mlsgpu_tpu.models import FIT_MODELS
from mlsgpu_tpu.models.common import RADIUS_CUTOFF

TILE = 8            # corners per tile axis (the reference's WGS, src/mls.cpp:53)
TILE_CORNERS = TILE ** 3


def _corner_offsets() -> np.ndarray:
    """(512, 3) tile-local corner coordinates in (cz, cy, cx) C order,
    columns ordered (x, y, z)."""
    g = np.arange(TILE)
    cz, cy, cx = np.meshgrid(g, g, g, indexing="ij")
    return np.stack([cx.ravel(), cy.ravel(), cz.ravel()], axis=1).astype(np.float32)


def eval_field(entry_data: jnp.ndarray,
               seg_starts: jnp.ndarray,
               seg_lens: jnp.ndarray,
               cell_origin: jnp.ndarray,
               tiles_per_axis: int,
               max_candidates: int,
               fit_shape: str,
               boundary_factor,
               tile_chunk: int = 32) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Evaluate the MLS signed distance on every corner of a block.

    Args:
      entry_data: (E, 8) f32 sorted entry splat data in *global* grid coords
        (col3 = 1/r^2). Splats are re-centered on each tile's global origin
        in a single f32 subtraction, so two blocks sharing a corner see
        bitwise-identical distances — block-local frames would introduce
        block-dependent rounding and cracks at seams.
      seg_starts/seg_lens: (T, L) per-tile per-level segments into entry_data.
      cell_origin: (3,) int32 global cell coords of the block origin.
      tiles_per_axis: block corners = 8 * tiles_per_axis.
      max_candidates: K, static per-tile candidate cap.
      fit_shape: 'sphere' | 'plane'.
      boundary_factor: 1 - gamma^2.
    Returns:
      field: (B, B, B) f32, indexed [z, y, x]; NaN = undefined.
      max_total: () int32 — max candidates any tile wanted; if > K the caller
        must retry with a larger K (the static-shape analogue of the
        reference's unbounded command list).
    """
    fit = FIT_MODELS[fit_shape]
    tpa = int(tiles_per_axis)
    num_tiles = tpa ** 3
    K = int(max_candidates)
    L = seg_starts.shape[1]
    E = entry_data.shape[0]

    cum = jnp.cumsum(seg_lens, axis=1)          # (T, L)
    cum0 = jnp.concatenate([jnp.zeros((num_tiles, 1), jnp.int32), cum[:, :-1]], axis=1)
    totals = cum[:, -1]
    max_total = jnp.max(totals)

    corners = jnp.asarray(_corner_offsets())     # (512, 3)
    cc = jnp.sum(corners * corners, axis=-1)     # (512,)

    ks = jnp.arange(K, dtype=jnp.int32)          # (K,)
    tile_ids = jnp.arange(num_tiles, dtype=jnp.int32)

    # Tile origins in *global* cell coords, (tz, ty, tx) C order. Integer
    # coords <= 2^21 are exact in f32.
    tz = tile_ids // (tpa * tpa)
    ty = (tile_ids // tpa) % tpa
    tx = tile_ids % tpa
    origins = (jnp.stack([tx, ty, tz], axis=1) * TILE
               + cell_origin[None, :].astype(jnp.int32)).astype(jnp.float32)

    def chunk_fn(tids):
        c_starts = seg_starts[tids]              # (C, L)
        c_cum = cum[tids]
        c_cum0 = cum0[tids]
        c_tot = totals[tids]
        c_org = origins[tids]                    # (C, 3)

        # Which level each candidate slot k falls into, then its entry index.
        lvl = jnp.sum(c_cum[:, None, :] <= ks[None, :, None], axis=-1)  # (C, K)
        lvl_c = jnp.minimum(lvl, L - 1)
        start_k = jnp.take_along_axis(c_starts, lvl_c, axis=1)
        cum0_k = jnp.take_along_axis(c_cum0, lvl_c, axis=1)
        idx = start_k + (ks[None, :] - cum0_k)
        mask = ks[None, :] < c_tot[:, None]                              # (C, K)
        idx = jnp.clip(idx, 0, E - 1)

        data = entry_data[idx]                   # (C, K, 8)
        x = data[..., 0:3] - c_org[:, None, :]   # tile-local splat positions
        invr2 = data[..., 3]
        nrm = data[..., 4:7]
        qual = data[..., 7]

        x2 = jnp.sum(x * x, axis=-1)             # (C, K)
        ndotx = jnp.sum(nrm * x, axis=-1)
        feats = jnp.concatenate([
            jnp.ones_like(x2)[..., None], x, x2[..., None], nrm, ndotx[..., None],
        ], axis=-1)                              # (C, K, 9)

        # HIGHEST keeps f32 instead of TF32: a reduced-mantissa product is
        # catastrophic for the |x-c|^2 expansion.
        dotcx = jnp.einsum("cd,tkd->tck", corners, x,
                           precision=jax.lax.Precision.HIGHEST,
                           preferred_element_type=jnp.float32)           # (C, 512, K)
        pp = x2[:, None, :] - 2.0 * dotcx + cc[None, :, None]
        d = pp * invr2[:, None, :]
        keep = (d < RADIUS_CUTOFF) & mask[:, None, :]
        w = 1.0 - d
        w = w * w
        w = w * w
        w = jnp.where(keep, w * qual[:, None, :], 0.0)
        hits = jnp.sum(keep, axis=-1)            # (C, 512)

        m = jnp.einsum("tck,tkm->tcm", w, feats,
                       precision=jax.lax.Precision.HIGHEST,
                       preferred_element_type=jnp.float32)               # (C, 512, 9)
        sum_w = m[..., 0]
        sx = m[..., 1:4]
        sxx = m[..., 4]
        sn = m[..., 5:8]
        snx = m[..., 8]

        # Re-center moments on each corner (exact in the small tile frame).
        sum_wp = sx - corners[None] * sum_w[..., None]
        sum_wpp = (sxx - 2.0 * jnp.einsum("cd,tcd->tc", corners, sx,
                                          precision=jax.lax.Precision.HIGHEST)
                   + cc[None, :] * sum_w)
        sum_wpn = snx - jnp.einsum("cd,tcd->tc", corners, sn,
                                   precision=jax.lax.Precision.HIGHEST)

        return fit(sum_w, sum_wp, sum_wpp, sn, sum_wpn, hits, boundary_factor)

    # Occupied-tile compaction: a surface typically crosses a small fraction
    # of tiles; empty tiles (no candidates) are NaN by definition. Sorting
    # occupied tiles first and looping a *dynamic* number of chunks skips
    # the empty ones entirely (the XLA-friendly form of the reference's
    # early-out on start[code] < 0, kernels/mls.cl:325).
    chunk = min(tile_chunk, num_tiles)
    occupied = totals > 0
    order = jnp.argsort(~occupied, stable=True).astype(jnp.int32)
    n_occ = jnp.sum(occupied.astype(jnp.int32))
    n_chunks = (n_occ + chunk - 1) // chunk

    init = jnp.full((num_tiles, TILE_CORNERS), jnp.nan, jnp.float32)

    def body(carry):
        j, field = carry
        tids = jax.lax.dynamic_slice(order, (j * chunk,), (chunk,))
        f = chunk_fn(tids)
        return j + 1, field.at[tids].set(f)

    _, f = jax.lax.while_loop(lambda c: c[0] < n_chunks, body, (0, init))
    f = f.reshape(tpa, tpa, tpa, TILE, TILE, TILE)
    field = f.transpose(0, 3, 1, 4, 2, 5).reshape(tpa * TILE, tpa * TILE, tpa * TILE)
    return field, max_total


def canonical_face_field(field: jnp.ndarray,
                         entry_data: jnp.ndarray,
                         entry_vals: jnp.ndarray,
                         seg_starts: jnp.ndarray,
                         seg_lens: jnp.ndarray,
                         cell_origin: jnp.ndarray,
                         region_cells: jnp.ndarray,
                         tiles_per_axis: int,
                         max_candidates: int,
                         fit_shape: str,
                         boundary_factor,
                         tile_chunk: int = 32
                         ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Recompute the six face corner planes of `field` so adjacent blocks
    agree *bitwise* on shared corners (no seam cracks; the reference's
    contract is decomposition-independent geometry,
    doc/mlsgpu-user-manual.xml:494-499).

    Two sources of cross-block divergence exist in the fast interior path:
    (1) tile re-centering frames are anchored at block origins, which are
    not mutually aligned, and (2) the per-level segment concatenation
    orders candidates block-dependently. Both vanish by recomputing face
    corners on patches of the *global* 8-corner grid:

    * every computation runs in the patch frame — a multiple-of-8 global
      anchor — so both blocks evaluate identical f32 expressions on
      identical inputs;
    * each patch's candidate list is made canonical: the union of the <=4
      covering tiles' segment lists is filtered by an exact
      splat-to-patch-rectangle distance test, deduplicated by splat
      identity, and sorted by the full feature tuple (+ stream order as the
      tiebreaker). Both blocks then hold the same physical splats at the
      same slot positions (the binning octree guarantees every
      rectangle-relevant splat appears in a covering tile's list), so the
      fixed-shape matmul reductions produce bitwise-identical moments —
      invalid slots contribute exact zeros at identical positions.

    Returns (field with face planes overwritten, max candidate count over
    the face tile layers) — the caller must retry with a larger
    `max_candidates` when that exceeds it, like the interior path.
    """
    fit = FIT_MODELS[fit_shape]
    tpa = int(tiles_per_axis)
    num_tiles = tpa ** 3
    K = int(max_candidates)
    L = seg_starts.shape[1]
    E = entry_data.shape[0]
    K4 = 4 * K

    cum = jnp.cumsum(seg_lens, axis=1)
    cum0 = jnp.concatenate(
        [jnp.zeros((num_tiles, 1), jnp.int32), cum[:, :-1]], axis=1)
    totals = cum[:, -1]
    ks = jnp.arange(K, dtype=jnp.int32)

    # --- static patch-row table: 6 faces x (tpa+1)^2 global 8-grid patches
    n_p = tpa + 1
    f2 = n_p * n_p
    nrows = 6 * f2
    rows = np.arange(nrows)
    face = rows // f2
    axis_a = face // 2                      # 0=x, 1=y, 2=z
    side = face % 2
    pb_i = (rows % f2) // n_p               # patch index on axis b=(a+1)%3
    pc_i = rows % n_p                       # patch index on axis c=(a+2)%3
    axis_b = (axis_a + 1) % 3
    axis_c = (axis_a + 2) % 3
    a_j = jnp.asarray(axis_a)
    b_j = jnp.asarray(axis_b)
    c_j = jnp.asarray(axis_c)
    side_j = jnp.asarray(side)

    org = cell_origin.astype(jnp.int32)
    rc = region_cells.astype(jnp.int32)
    plane_g = org[a_j] + jnp.where(side_j == 1, rc[a_j], 0)  # (nrows,)
    base_a = (plane_g // 8) * 8
    base_b = (org[b_j] // 8 + jnp.asarray(pb_i)) * 8
    base_c = (org[c_j] // 8 + jnp.asarray(pc_i)) * 8

    # covering tiles: one layer on axis a, a 2x2 in-plane neighborhood
    layer_a = jnp.where(side_j == 1, rc[a_j] // TILE, 0)
    lo_b = base_b - org[b_j]
    lo_c = base_c - org[c_j]
    tb0 = jnp.clip(jnp.floor_divide(lo_b, TILE), 0, tpa - 1)
    tb1 = jnp.clip(jnp.floor_divide(lo_b + 7, TILE), 0, tpa - 1)
    tc0 = jnp.clip(jnp.floor_divide(lo_c, TILE), 0, tpa - 1)
    tc1 = jnp.clip(jnp.floor_divide(lo_c + 7, TILE), 0, tpa - 1)

    def tile_id(ta, tb, tc):
        """(a, b, c) tile coords -> (tz*tpa + ty)*tpa + tx."""
        t = jnp.zeros((nrows, 3), jnp.int32)
        r_i = jnp.arange(nrows)
        t = t.at[r_i, a_j].set(ta)
        t = t.at[r_i, b_j].set(tb)
        t = t.at[r_i, c_j].set(tc)
        return (t[:, 2] * tpa + t[:, 1]) * tpa + t[:, 0]

    tid4 = jnp.stack([tile_id(layer_a, tb0, tc0),
                      tile_id(layer_a, tb0, tc1),
                      tile_id(layer_a, tb1, tc0),
                      tile_id(layer_a, tb1, tc1)], axis=1)   # (nrows, 4)

    row_tot = jnp.max(totals[tid4], axis=1)
    occ = row_tot > 0
    n_occ = jnp.sum(occ.astype(jnp.int32))
    face_max = jnp.max(row_tot)
    order = jnp.argsort(~occ, stable=True).astype(jnp.int32)

    chunk = min(tile_chunk, nrows)
    n_chunks = (n_occ + chunk - 1) // chunk

    g8 = np.arange(TILE)
    fb, fc = np.meshgrid(g8, g8, indexing="ij")
    fb = jnp.asarray(fb.ravel())            # (64,)
    fc = jnp.asarray(fc.ravel())

    cut = jnp.float32(RADIUS_CUTOFF)
    bf = jnp.float32(boundary_factor)
    out_init = jnp.full((nrows, 64), jnp.nan, jnp.float32)

    # After rect-filter + dedup, the kept candidates of one 8x8 patch are
    # the splats within reach of a single-tile-sized rectangle — the same
    # population the interior pass bounds by K per tile — so the heavy
    # per-slot stages (row gather + distance/moment einsums) run on a
    # K2 = K compaction of the 4K slot table (4x less gather/compute).
    # kept_max is returned to the caller: > K2 means contributions were
    # dropped and the block must retry with a larger max_candidates, like
    # every other cap.
    K2 = K

    def chunk_body(carry):
        j, out, kmax = carry
        ridx = jax.lax.dynamic_slice(order, (j * chunk,), (chunk,))
        tids = tid4[ridx].reshape(-1)                        # (4C,)

        # per-tile K-slot tables (same level walk as the interior path)
        c_starts = seg_starts[tids]
        c_cum = cum[tids]
        c_cum0 = cum0[tids]
        c_tot = totals[tids]
        lvl = jnp.sum(c_cum[:, None, :] <= ks[None, :, None], axis=-1)
        lvl_c = jnp.minimum(lvl, L - 1)
        start_k = jnp.take_along_axis(c_starts, lvl_c, axis=1)
        cum0_k = jnp.take_along_axis(c_cum0, lvl_c, axis=1)
        idx = jnp.clip(start_k + (ks[None, :] - cum0_k), 0, E - 1)
        slot_ok = ks[None, :] < c_tot[:, None]               # (4C, K)
        idx = idx.reshape(chunk, K4)
        slot_ok = slot_ok.reshape(chunk, K4)

        # Rect filter needs only position + 1/r^2: gather the contiguous
        # first 4 columns (half the bytes of full rows); the full 8-wide
        # rows are gathered once, post-compaction, at K2 width.
        pre = entry_data[:, 0:4][idx]                        # (C, 4K, 4)
        ids = entry_vals[idx]                                # (C, 4K)

        # canonical splat-to-patch-rectangle filter (global f32 coords)
        pg = plane_g[ridx].astype(jnp.float32)[:, None]
        bb = base_b[ridx].astype(jnp.float32)[:, None]
        bc = base_c[ridx].astype(jnp.float32)[:, None]
        aa = a_j[ridx]
        bj = b_j[ridx]
        cj = c_j[ridx]
        # Axis selection by one-hot arithmetic (integer one-hots and
        # coordinate values are exact in f32, so values are bitwise equal
        # to a gather) — C*4K per-element axis gathers were a measured
        # face-pass hot spot; three fused multiply-reduces are cheap.
        ar3 = jnp.arange(3)[None, :]
        oh_a = (ar3 == aa[:, None]).astype(jnp.float32)      # (C, 3)
        oh_b = (ar3 == bj[:, None]).astype(jnp.float32)
        oh_c = (ar3 == cj[:, None]).astype(jnp.float32)
        p_abc = pre[:, :, 0:3]                               # (C, 4K, 3)
        p_a = jnp.sum(p_abc * oh_a[:, None, :], axis=-1)
        p_b = jnp.sum(p_abc * oh_b[:, None, :], axis=-1)
        p_c = jnp.sum(p_abc * oh_c[:, None, :], axis=-1)
        da = p_a - pg
        db = jnp.maximum(jnp.maximum(bb - p_b, p_b - (bb + 7.0)), 0.0)
        dc = jnp.maximum(jnp.maximum(bc - p_c, p_c - (bc + 7.0)), 0.0)
        rect2 = da * da + db * db + dc * dc
        valid = slot_ok & (rect2 * pre[:, :, 3] < cut)       # (C, 4K)

        # sort 1: identity-major, for the duplicate drop (a splat can sit
        # in several covering tiles' lists). Payload is the entry INDEX —
        # duplicate slots reference different entries of the same physical
        # splat, whose rows are bitwise identical, so gathering through
        # either index yields the same data.
        vkey = jnp.where(valid, jnp.uint32(0), jnp.uint32(1))
        ops1 = jax.lax.sort((vkey, ids, idx), num_keys=2)
        ids1 = ops1[1]
        v1 = ops1[0] == 0
        dup = jnp.zeros_like(v1).at[:, 1:].set(
            v1[:, 1:] & v1[:, :-1] & (ids1[:, 1:] == ids1[:, :-1]))
        v2 = v1 & ~dup
        kmax = jnp.maximum(kmax, jnp.max(jnp.sum(v2.astype(jnp.int32),
                                                 axis=1)))

        # sort 2: canonical final order — a *stable* validity-only
        # compaction. Sort 1 already ordered valid entries by globally
        # unique splat id, which is block-independent, so stably moving
        # invalid/dup slots to the end leaves both blocks with identical
        # physical splats at identical slot positions.
        vkey2 = jnp.where(v2, jnp.uint32(0), jnp.uint32(1))
        ops2 = jax.lax.sort((vkey2, ops1[2], v2.astype(jnp.int32)),
                            num_keys=1, is_stable=True)
        cols = entry_data[ops2[1][:, :K2]]                   # (C, K2, 8)
        sval = ops2[2][:, :K2] == 1                          # (C, K2)

        # patch frame (multiple-of-8 global anchor): one-hot assembly,
        # exact in f32 (integer values, products by 1.0/0.0, disjoint axes)
        pf_f = (base_a[ridx].astype(jnp.float32)[:, None] * oh_a
                + base_b[ridx].astype(jnp.float32)[:, None] * oh_b
                + base_c[ridx].astype(jnp.float32)[:, None] * oh_c)

        x = cols[:, :, 0:3] - pf_f[:, None, :]               # (C, K2, 3)
        invr2 = cols[:, :, 3]
        nrm = cols[:, :, 4:7]
        qual = cols[:, :, 7]

        # patch-frame corner coords (the 8x8 in-plane grid at the plane),
        # one-hot assembled (same exactness argument)
        pa_val = (plane_g[ridx] - base_a[ridx]).astype(jnp.float32)
        corners = (pa_val[:, None, None] * oh_a[:, None, :]
                   + fb[None, :, None].astype(jnp.float32) * oh_b[:, None, :]
                   + fc[None, :, None].astype(jnp.float32) * oh_c[:, None, :])
        cc = jnp.sum(corners * corners, axis=-1)             # (C, 64)

        x2 = jnp.sum(x * x, axis=-1)
        ndotx = jnp.sum(nrm * x, axis=-1)
        feats = jnp.concatenate([
            jnp.ones_like(x2)[..., None], x, x2[..., None], nrm,
            ndotx[..., None]], axis=-1)                      # (C, 4K, 9)

        dotcx = jnp.einsum("tcd,tkd->tck", corners, x,
                           precision=jax.lax.Precision.HIGHEST,
                           preferred_element_type=jnp.float32)
        pp = x2[:, None, :] - 2.0 * dotcx + cc[..., None]
        d = pp * invr2[:, None, :]
        keep = (d < cut) & sval[:, None, :]
        w = 1.0 - d
        w = w * w
        w = w * w
        w = jnp.where(keep, w * qual[:, None, :], 0.0)
        hits = jnp.sum(keep, axis=-1)

        m = jnp.einsum("tck,tkm->tcm", w, feats,
                       precision=jax.lax.Precision.HIGHEST,
                       preferred_element_type=jnp.float32)   # (C, 64, 9)
        sum_w = m[..., 0]
        sx = m[..., 1:4]
        sxx = m[..., 4]
        sn = m[..., 5:8]
        snx = m[..., 8]
        sum_wp = sx - corners * sum_w[..., None]
        sum_wpp = (sxx - 2.0 * jnp.einsum(
            "tcd,tcd->tc", corners, sx,
            precision=jax.lax.Precision.HIGHEST) + cc * sum_w)
        sum_wpn = snx - jnp.einsum("tcd,tcd->tc", corners, sn,
                                   precision=jax.lax.Precision.HIGHEST)

        vals = fit(sum_w, sum_wp, sum_wpp, sn, sum_wpn, hits, bf)
        return j + 1, out.at[ridx].set(vals), kmax

    _, out, kept_max = jax.lax.while_loop(
        lambda c: c[0] < n_chunks, chunk_body,
        (0, out_init, jnp.int32(0)))
    # kept_max > K means the K2 compaction dropped contributions for some
    # patch: fold it into the returned cap demand so the caller's existing
    # max_candidates retry covers it.
    face_max = jnp.maximum(face_max, kept_max)

    # Assemble each face's patches into a dense plane image and write it
    # with ONE sliced update per face: the previous formulation scattered
    # nrows*64 individual corners into the dense field. The patch grid tiles the whole plane, so a reshape/
    # transpose of `out` IS the plane image; a dynamic slice drops the
    # pre-origin overhang (org mod 8). Sequential face order (x-, x+, y-,
    # y+, z-, z+) makes the edge-overlap winner the highest axis in EVERY
    # block, so blocks sharing an edge corner still agree bitwise (the
    # skeleton pass canonicalizes decomposition-edge points separately).
    bdim = field.shape[0]
    side_np = TILE * n_p
    for f in range(6):
        a = f // 2
        s = f % 2
        b_ax = (a + 1) % 3
        c_ax = (a + 2) % 3
        pface = (out[f * f2:(f + 1) * f2]
                 .reshape(n_p, n_p, TILE, TILE)
                 .transpose(0, 2, 1, 3).reshape(side_np, side_np))
        la = rc[a] if s == 1 else jnp.int32(0)
        ob = (org[b_ax] // 8) * 8 - org[b_ax]
        oc = (org[c_ax] // 8) * 8 - org[c_ax]
        psl = jax.lax.dynamic_slice(pface, (-ob, -oc), (bdim, bdim))
        if a == 0:    # plane x = la; psl[y, z] -> field[z, y, la]
            field = jax.lax.dynamic_update_slice(
                field, psl.T[:, :, None], (0, 0, la))
        elif a == 1:  # plane y = la; psl[z, x] -> field[z, la, x]
            field = jax.lax.dynamic_update_slice(
                field, psl[:, None, :], (0, la, 0))
        else:         # plane z = la; psl[x, y] -> field[la, y, x]
            field = jax.lax.dynamic_update_slice(
                field, psl.T[None, :, :], (la, 0, 0))
    return field, face_max


def skeleton_point_field(field: jnp.ndarray,
                         entry_data: jnp.ndarray,
                         entry_vals: jnp.ndarray,
                         seg_starts: jnp.ndarray,
                         seg_lens: jnp.ndarray,
                         cell_origin: jnp.ndarray,
                         points: jnp.ndarray,
                         tiles_per_axis: int,
                         max_candidates: int,
                         fit_shape: str,
                         boundary_factor,
                         point_chunk: int = 64) -> jnp.ndarray:
    """Recompute `field` at decomposition edge-skeleton points so that EVERY
    block containing such a point computes a bitwise-identical value — the
    cross-axis completion of canonical_face_field, which is canonical only
    per face axis (a region-edge point is covered by several face passes,
    and at a T-junction different blocks keep different axes' values).

    Canonicality argument, keyed purely by the point's global position:
    * candidates come from ONE tile whose closed 8-cell box contains the
      point. Binning emits each splat to every node of its <= 2-per-axis
      neighborhood that its ball intersects (ops/binning.py:105-118 with the
      conservative sphere/box gate), so the chain of any tile whose closed
      box contains p already holds every splat with positive weight at p:
      dist(splat, node box) <= dist(splat, p) < r. Which containing tile a
      block picks is irrelevant — the strict per-point filter below reduces
      any such chain to the same set;
    * the filter keeps exactly {splats with |x - p|^2 / r^2 < cutoff}, a
      global predicate (such a splat's ball penetrates every region having
      p on its boundary, so it is in every relevant bucket's splat list);
    * the kept entries are compacted in ascending stream order
      (entry_vals ranks block rows, and rows are ascending in global splat
      order), so both blocks hold the same physical splats at the same slot
      positions and the fixed-shape reductions round identically;
    * all arithmetic runs in the frame of the global 8-aligned cube
      containing p (exact integer-in-f32 anchor), identical everywhere.

    Args:
      points: (P, 3) int32 global corner coords; rows with any negative
        coordinate are padding. Points outside this block scatter-drop.
    Returns the field with skeleton points overwritten. Needs no cap of its
    own: per-point candidate counts are per-tile totals, which the interior
    pass's max_total retry already bounds by `max_candidates`.
    """
    fit = FIT_MODELS[fit_shape]
    tpa = int(tiles_per_axis)
    num_tiles = tpa ** 3
    K = int(max_candidates)
    L = seg_starts.shape[1]
    E = entry_data.shape[0]
    P = points.shape[0]
    if P == 0:
        return field

    cum = jnp.cumsum(seg_lens, axis=1)
    cum0 = jnp.concatenate(
        [jnp.zeros((num_tiles, 1), jnp.int32), cum[:, :-1]], axis=1)
    totals = cum[:, -1]
    ks = jnp.arange(K, dtype=jnp.int32)
    cut = jnp.float32(RADIUS_CUTOFF)
    bf = jnp.float32(boundary_factor)

    pts = points.astype(jnp.int32)
    valid_pt = jnp.all(pts >= 0, axis=1)
    lp = pts - cell_origin.astype(jnp.int32)[None, :]
    # one tile whose CLOSED box contains the point (clip handles the far
    # boundary plane, local coord == 8 * tpa - ... == region extent)
    t = jnp.clip(lp // TILE, 0, tpa - 1)
    tid = (t[:, 2] * tpa + t[:, 1]) * tpa + t[:, 0]
    tid = jnp.where(valid_pt, tid, 0)

    occ = valid_pt & (totals[tid] > 0)
    n_occ = jnp.sum(occ.astype(jnp.int32))
    order = jnp.argsort(~occ, stable=True).astype(jnp.int32)
    chunk = min(point_chunk, P)
    n_chunks = (n_occ + chunk - 1) // chunk

    out_init = jnp.full((P,), jnp.nan, jnp.float32)

    def chunk_body(carry):
        j, out = carry
        pidx = jax.lax.dynamic_slice(order, (j * chunk,), (chunk,))
        tids = tid[pidx]                                     # (C,)
        pg = pts[pidx].astype(jnp.float32)                   # (C, 3)

        # per-tile K-slot walk (same form as the interior path)
        c_starts = seg_starts[tids]
        c_cum = cum[tids]
        c_cum0 = cum0[tids]
        c_tot = totals[tids]
        lvl = jnp.sum(c_cum[:, None, :] <= ks[None, :, None], axis=-1)
        lvl_c = jnp.minimum(lvl, L - 1)
        start_k = jnp.take_along_axis(c_starts, lvl_c, axis=1)
        cum0_k = jnp.take_along_axis(c_cum0, lvl_c, axis=1)
        idx = jnp.clip(start_k + (ks[None, :] - cum0_k), 0, E - 1)
        slot_ok = ks[None, :] < c_tot[:, None]               # (C, K)

        data = entry_data[idx]                               # (C, K, 8)
        rows = entry_vals[idx]                               # (C, K)

        # strict point-keyed filter: exactly the positive-weight set
        dx = data[:, :, 0:3] - pg[:, None, :]
        d2 = jnp.sum(dx * dx, axis=-1)
        valid_c = slot_ok & (d2 * data[:, :, 3] < cut)

        # canonical compaction: ascending stream order (no duplicates — a
        # splat emits at most one entry into a single tile's chain)
        key = jnp.where(valid_c, rows.astype(jnp.uint32),
                        jnp.uint32(0xFFFFFFFF))
        ops = jax.lax.sort(
            (key,) + tuple(data[:, :, i] for i in range(8))
            + (valid_c.astype(jnp.int32),), num_keys=1)
        cols = jnp.stack(ops[1:9], axis=-1)                  # (C, K, 8)
        sval = ops[9] == 1

        # global 8-aligned cube frame (position-keyed, exact in f32)
        base = (pts[pidx] // TILE) * TILE
        co = (pts[pidx] - base).astype(jnp.float32)          # (C, 3)
        x = cols[:, :, 0:3] - base.astype(jnp.float32)[:, None, :]
        invr2 = cols[:, :, 3]
        nrm = cols[:, :, 4:7]
        qual = cols[:, :, 7]

        x2 = jnp.sum(x * x, axis=-1)                         # (C, K)
        ndotx = jnp.sum(nrm * x, axis=-1)
        feats = jnp.concatenate([
            jnp.ones_like(x2)[..., None], x, x2[..., None], nrm,
            ndotx[..., None]], axis=-1)                      # (C, K, 9)

        dotcx = jnp.einsum("td,tkd->tk", co, x,
                           precision=jax.lax.Precision.HIGHEST,
                           preferred_element_type=jnp.float32)
        ccs = jnp.sum(co * co, axis=-1)                      # (C,)
        d = (x2 - 2.0 * dotcx + ccs[:, None]) * invr2
        keep = (d < cut) & sval
        w = 1.0 - d
        w = w * w
        w = w * w
        w = jnp.where(keep, w * qual, 0.0)
        hits = jnp.sum(keep, axis=-1)                        # (C,)

        m = jnp.einsum("tk,tkm->tm", w, feats,
                       precision=jax.lax.Precision.HIGHEST,
                       preferred_element_type=jnp.float32)   # (C, 9)
        sum_w = m[:, 0]
        sx = m[:, 1:4]
        sxx = m[:, 4]
        sn = m[:, 5:8]
        snx = m[:, 8]
        sum_wp = sx - co * sum_w[:, None]
        sum_wpp = (sxx - 2.0 * jnp.einsum(
            "td,td->t", co, sx, precision=jax.lax.Precision.HIGHEST)
            + ccs * sum_w)
        sum_wpn = snx - jnp.einsum("td,td->t", co, sn,
                                   precision=jax.lax.Precision.HIGHEST)

        vals = fit(sum_w, sum_wp, sum_wpp, sn, sum_wpn, hits, bf)
        return j + 1, out.at[pidx].set(vals)

    _, out = jax.lax.while_loop(lambda c: c[0] < n_chunks, chunk_body,
                                (0, out_init))

    lp_s = jnp.where(valid_pt[:, None], lp, -1)
    return field.at[lp_s[:, 2], lp_s[:, 1], lp_s[:, 0]].set(out, mode="drop")
