"""3D Morton (Z-order) codes, vectorized for numpy (uint64, 21 bits/axis) and
JAX (uint32, 10 bits/axis).

The reference interleaves bits with a scalar loop per item
(kernels/octree.cl:121-135 makeCode / mls.cl:183 decode); here the interleave
is branch-free magic-number bit spreading so it vectorizes on the device and
in numpy. Codes are z-major (z bits above y above x), matching the reference.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def _part1by2_u64(x: np.ndarray) -> np.ndarray:
    """Spread the low 21 bits of x so there are two zero bits between each."""
    x = x.astype(np.uint64) & np.uint64(0x1FFFFF)
    x = (x | (x << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
    x = (x | (x << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
    x = (x | (x << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
    x = (x | (x << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
    x = (x | (x << np.uint64(2))) & np.uint64(0x1249249249249249)
    return x


def _compact1by2_u64(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64) & np.uint64(0x1249249249249249)
    x = (x | (x >> np.uint64(2))) & np.uint64(0x10C30C30C30C30C3)
    x = (x | (x >> np.uint64(4))) & np.uint64(0x100F00F00F00F00F)
    x = (x | (x >> np.uint64(8))) & np.uint64(0x1F0000FF0000FF)
    x = (x | (x >> np.uint64(16))) & np.uint64(0x1F00000000FFFF)
    x = (x | (x >> np.uint64(32))) & np.uint64(0x1FFFFF)
    return x


def encode_np(x: np.ndarray, y: np.ndarray, z: np.ndarray) -> np.ndarray:
    """Interleave up to 21 bits per axis into a uint64 Morton code (z-major)."""
    return (_part1by2_u64(np.asarray(x))
            | (_part1by2_u64(np.asarray(y)) << np.uint64(1))
            | (_part1by2_u64(np.asarray(z)) << np.uint64(2)))


def decode_np(code: np.ndarray):
    code = np.asarray(code, dtype=np.uint64)
    return (_compact1by2_u64(code).astype(np.int64),
            _compact1by2_u64(code >> np.uint64(1)).astype(np.int64),
            _compact1by2_u64(code >> np.uint64(2)).astype(np.int64))


def _part1by2_u32(x: jnp.ndarray) -> jnp.ndarray:
    """Spread the low 10 bits of x (JAX/uint32)."""
    x = x.astype(jnp.uint32) & jnp.uint32(0x3FF)
    x = (x | (x << 16)) & jnp.uint32(0x30000FF)
    x = (x | (x << 8)) & jnp.uint32(0x300F00F)
    x = (x | (x << 4)) & jnp.uint32(0x30C30C3)
    x = (x | (x << 2)) & jnp.uint32(0x9249249)
    return x


def _compact1by2_u32(x: jnp.ndarray) -> jnp.ndarray:
    x = x.astype(jnp.uint32) & jnp.uint32(0x9249249)
    x = (x | (x >> 2)) & jnp.uint32(0x30C30C3)
    x = (x | (x >> 4)) & jnp.uint32(0x300F00F)
    x = (x | (x >> 8)) & jnp.uint32(0x30000FF)
    x = (x | (x >> 16)) & jnp.uint32(0x3FF)
    return x


def encode_jnp(x: jnp.ndarray, y: jnp.ndarray, z: jnp.ndarray) -> jnp.ndarray:
    """Interleave up to 10 bits per axis into a uint32 Morton code (z-major)."""
    return (_part1by2_u32(x)
            | (_part1by2_u32(y) << 1)
            | (_part1by2_u32(z) << 2))


def decode_jnp(code: jnp.ndarray):
    code = code.astype(jnp.uint32)
    return (_compact1by2_u32(code).astype(jnp.int32),
            _compact1by2_u32(code >> 1).astype(jnp.int32),
            _compact1by2_u32(code >> 2).astype(jnp.int32))
