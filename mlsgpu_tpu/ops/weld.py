"""Device-side vertex welding: sort by key, unique, reindex.

Replaces the reference's shipOut phase (clogs radix sort +
countUniqueVertices/compactVertices/reindex, kernels/marching.cl:271-345,
src/marching.cpp:553-743). Keys are (hi, lo) uint32 pairs sorted
lexicographically with `jax.lax.sort(num_keys=2)`; because the external flag
is the top bit of `hi`, internal vertices come first, then externals in key
order, then padding (all-ones keys) — the same partition the reference's
DeviceKeyMesh maintains (src/mesh.h:101-140).

Vertices sharing a key have bitwise-identical interpolated positions (the
endpoints and parameter of the shared edge are computed identically in every
incident cell), so keeping any one instance is exact.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class WeldedMesh(NamedTuple):
    vertices: jnp.ndarray        # (vertex_cap, 3) f32 — welded, internal first
    key_hi: jnp.ndarray          # (vertex_cap,) uint32 (ext flag kept)
    key_lo: jnp.ndarray          # (vertex_cap,) uint32
    triangles: jnp.ndarray       # (num_tri_cap, 3) int32 into welded vertices
    num_vertices: jnp.ndarray    # () int32 welded vertex count
    first_external: jnp.ndarray  # () int32 index of first external vertex
    num_indices: jnp.ndarray     # () int32 (copied through)


def weld(vertices: jnp.ndarray,
         key_hi: jnp.ndarray,
         key_lo: jnp.ndarray,
         triangles: jnp.ndarray,
         num_unwelded: jnp.ndarray,
         num_indices: jnp.ndarray) -> WeldedMesh:
    """Sort/gather-only formulation: the representative compaction and the old->new remap are expressed as two
    extra sorts plus contiguous gathers instead of five cap-sized
    scatters."""
    cap = vertices.shape[0]
    idx = jnp.arange(cap, dtype=jnp.int32)
    s_hi, s_lo, s_idx = jax.lax.sort((key_hi, key_lo, idx), num_keys=2)

    first = jnp.ones(cap, dtype=bool).at[1:].set(
        (s_hi[1:] != s_hi[:-1]) | (s_lo[1:] != s_lo[:-1]))
    real = jnp.arange(cap) < num_unwelded  # pads (all-ones keys) sort last
    new_id = jnp.cumsum(first.astype(jnp.int32)) - 1

    num_welded = jnp.sum(jnp.where(first & real, 1, 0)).astype(jnp.int32)
    is_ext = (s_hi >> 31) == 1
    first_external = jnp.sum(jnp.where(first & real & ~is_ext, 1, 0)).astype(jnp.int32)

    # Representative per key: compact the first sorted instance of each
    # group with one sort (positions of `first` rows in new_id order), then
    # gather its data.
    firstpos = jax.lax.sort(jnp.where(first & real, idx, cap))  # ascending
    firstpos_c = jnp.minimum(firstpos, cap - 1)
    out_verts = vertices[s_idx[firstpos_c]]
    pad = firstpos >= cap
    out_hi = jnp.where(pad, jnp.uint32(0xFFFFFFFF), s_hi[firstpos_c])
    out_lo = jnp.where(pad, jnp.uint32(0xFFFFFFFF), s_lo[firstpos_c])
    out_verts = jnp.where(pad[:, None], 0.0, out_verts)

    # old index -> welded index: invert the sort permutation with a second
    # sort keyed by s_idx (a permutation, so this is exact).
    _, remap = jax.lax.sort((s_idx, new_id), num_keys=1)
    new_tris = remap[triangles]

    return WeldedMesh(
        vertices=out_verts,
        key_hi=out_hi,
        key_lo=out_lo,
        triangles=new_tris,
        num_vertices=num_welded,
        first_external=first_external,
        num_indices=num_indices,
    )
