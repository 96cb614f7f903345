"""Unit tests for the quantized single-transfer readback packing
(ops/block._pack_readback / unpack_readback) — the analogue of the
reference's sized 3-event enqueueReadMesh (src/mesh.h:141-179).

A synthetic welded mesh is built the way ops/marching.py builds real ones
(vertices on cell edges, keys = doubled global edge midpoints), packed on
device, and decoded on the host; topology and keys must round-trip exactly,
positions to the t16 quantization step.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from mlsgpu_tpu.ops import tables
from mlsgpu_tpu.ops.block import (PackFormat, _pack_readback, pack_format,
                                  unpack_readback)
from mlsgpu_tpu.ops.weld import WeldedMesh


def make_welded(nv, ntri, vertex_cap, index_cap, block_cells, origin, rng,
                n_external=5):
    edges = np.asarray(tables.EDGES)
    edge_key = np.asarray(tables.EDGE_KEY)
    offs = np.array([[(v >> a) & 1 for a in range(3)] for v in range(8)],
                    dtype=np.int32)

    cell = rng.integers(0, block_cells, size=(nv, 3)).astype(np.int32)
    eid = rng.integers(0, len(edges), size=nv)
    t = rng.random(nv).astype(np.float32)
    t[0] = 0.0  # exercise the t=0 edge case
    off0 = offs[edges[eid, 0]]
    off1 = offs[edges[eid, 1]]
    pos = ((cell + off0).astype(np.float32)
           + t[:, None] * (off1 - off0).astype(np.float32))

    kl = 2 * cell + edge_key[eid]                    # doubled local coords
    kg = (kl + 2 * origin[None, :]).astype(np.uint32)
    ext = np.zeros(nv, bool)
    ext[nv - n_external:] = True                     # externals sort last
    key_lo = kg[:, 0] | ((kg[:, 1] & np.uint32(0x7FF)) << 21)
    key_hi = ((kg[:, 1] >> 11) | (kg[:, 2] << 10)
              | (ext.astype(np.uint32) << 31))

    vc, icap = vertex_cap, index_cap
    verts_p = np.zeros((vc, 3), np.float32)
    verts_p[:nv] = pos
    hi_p = np.full(vc, 0xFFFFFFFF, np.uint32)
    lo_p = np.full(vc, 0xFFFFFFFF, np.uint32)
    hi_p[:nv], lo_p[:nv] = key_hi, key_lo
    tris = rng.integers(0, nv, size=(icap // 3, 3)).astype(np.int32)
    tris[ntri:] = 0

    welded = WeldedMesh(
        vertices=jnp.asarray(verts_p), key_hi=jnp.asarray(hi_p),
        key_lo=jnp.asarray(lo_p), triangles=jnp.asarray(tris),
        num_vertices=jnp.int32(nv), first_external=jnp.int32(nv - n_external),
        num_indices=jnp.int32(3 * ntri))
    expect_keys = (kg[:, 0].astype(np.int64)
                   | (kg[:, 1].astype(np.int64) << 21)
                   | (kg[:, 2].astype(np.int64) << 42))
    return welded, pos, tris[:ntri], expect_keys


@pytest.mark.parametrize("fmt,block_cells", [
    (PackFormat("u16", 3, 8), 255),
    (PackFormat("u21x3", 3, 8), 255),
    (PackFormat("u32", 3, 8), 255),
    (PackFormat("u16", 4, 13), 8191),
    (PackFormat("u21x3", 4, 13), 8191),
])
def test_roundtrip(fmt, block_cells):
    rng = np.random.default_rng(hash((fmt.index_mode, fmt.vertex_words))
                                & 0xFFFF)
    nv, ntri = 333, 170
    vc, icap = 512, 3 * 256
    origin = np.array([block_cells, 2 * block_cells, 0], np.int32)
    welded, pos, tris, keys = make_welded(nv, ntri, vc, icap, block_cells,
                                          origin, rng)
    buf = np.asarray(_pack_readback(welded, jnp.asarray(origin), fmt,
                                    vc, icap))
    assert buf.shape[0] == fmt.index_cap_words(icap) + fmt.vertex_region_words(vc)
    live = fmt.total_words(3 * ntri, nv)
    v, tr, ek = unpack_readback(buf[:live], 3 * ntri, nv, nv - 5, fmt,
                                origin.astype(np.int64))
    np.testing.assert_array_equal(tr, tris)
    np.testing.assert_array_equal(ek, keys[nv - 5:])
    # positions quantize to one shared t16 per vertex, plus the f32 ulp at
    # the block's coordinate scale (inherent to any f32 representation)
    tol = 1.0 / 65535 + float(np.spacing(np.float32(block_cells)))
    assert np.abs(v - pos).max() <= tol


def test_pack_format_selection():
    assert pack_format(6, 3, 1 << 16) == PackFormat("u16", 3, 8)
    assert pack_format(6, 3, 1 << 18) == PackFormat("u21x3", 3, 8)
    assert pack_format(6, 3, 1 << 22) == PackFormat("u32", 3, 8)
    assert pack_format(7, 3, 1 << 16) == PackFormat("u16", 4, 9)
    assert pack_format(11, 3, 1 << 16) == PackFormat("u16", 4, 13)
    assert pack_format(12, 3, 1 << 16) is None  # beyond 2^13 block limit


def test_format_word_counts():
    fmt = PackFormat("u16", 3, 8)
    assert fmt.index_words(9) == 5           # odd u16 count rounds up
    assert fmt.vertex_region_words(3) == 5   # 9 u16 -> 5 words
    fmt2 = PackFormat("u21x3", 4, 13)
    assert fmt2.index_words(9) == 6
    assert fmt2.vertex_region_words(3) == 6
