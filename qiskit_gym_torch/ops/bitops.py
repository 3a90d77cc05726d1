"""Packed GF(2) bit-matrix primitives.

Port of the JAX package's `ops/bitops.py`. A bit-matrix of logical size
(dim x dim) is stored as [R, W] words with W = ceil(dim / 32) words per row
and R = 32 * W rows; bit c of row r lives at word c // 32, bit position
c % 32. Rows dim..R-1 carry identity padding so the padded matrix stays
invertible and bit-transposes stay exact (block-diag(M, I) transposes and
inverts blockwise). On the host the words are numpy uint32; on a device they
are int32 tensors holding the same bit patterns, as in the rest of the
package.
"""

from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor


def words_for(dim: int) -> int:
    return max((dim + 31) // 32, 1)


def padded_rows(dim: int) -> int:
    return 32 * words_for(dim)


def pack_bits(mat: np.ndarray) -> np.ndarray:
    """numpy bool/int [dim, dim] -> uint32 [R, W] with identity padding."""
    mat = np.asarray(mat)
    dim = mat.shape[0]
    W = words_for(dim)
    R = padded_rows(dim)
    full = np.eye(R, dtype=np.uint8)
    full[:dim, :dim] = (mat != 0).astype(np.uint8)
    full[:dim, dim:] = 0
    full[dim:, :dim] = 0
    # little-endian within each word
    words = full.reshape(R, W, 32)
    weights = (1 << np.arange(32, dtype=np.uint64)).astype(np.uint64)
    packed = (words.astype(np.uint64) * weights).sum(axis=2)
    return packed.astype(np.uint32)


def pack_lanes(bits: np.ndarray, W: int) -> np.ndarray:
    """numpy 0/1 [..., n] (n <= 32 W) -> uint32 [..., W]: bit i of word g
    is entry 32 g + i of the last axis."""
    n = bits.shape[-1]
    padded = np.zeros(bits.shape[:-1] + (32 * W,), np.uint8)
    padded[..., :n] = bits != 0
    return np.packbits(padded, axis=-1, bitorder="little").view("<u4")


def to_words(packed: np.ndarray, device=None) -> Tensor:
    """numpy uint32 words -> the int32 tensor with the same bits."""
    return torch.from_numpy(
        np.ascontiguousarray(packed, dtype=np.uint32).view(np.int32).copy()
    ).to(device=device)


def u32(x: Tensor) -> Tensor:
    """int32 words -> their uint32 values, held in int64."""
    return x.to(torch.int64) & 0xFFFFFFFF


def to_i32(v: Tensor) -> Tensor:
    """uint32 values held in int64 -> the int32 words with the same bits."""
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def unpack_bits(packed: Tensor, dim: int) -> Tensor:
    """int32 words [..., R, W] -> uint8 [..., dim, dim]."""
    shifts = torch.arange(32, device=packed.device)
    bits = (u32(packed[..., :dim, :])[..., None] >> shifts) & 1
    flat = bits.reshape(*packed.shape[:-2], dim, -1)
    return flat[..., :dim].to(torch.uint8)


def packed_identity(dim: int) -> np.ndarray:
    return pack_bits(np.eye(dim, dtype=np.uint8))


_MASKS = (0x0000FFFF, 0x00FF00FF, 0x0F0F0F0F, 0x33333333, 0x55555555)
_SHIFTS = (16, 8, 4, 2, 1)


def _tile_transpose32(a: Tensor) -> Tensor:
    """Transpose 32x32 bit tiles given as uint32 values (in int64) [..., 32]
    (bit j of word r = element (r, j)). Butterfly network, 5 stages (the
    classic bit-matrix transpose), vectorized over the leading axes."""
    idx = torch.arange(32, device=a.device)
    for s, m in zip(_SHIFTS, _MASKS):
        nm = ~m & 0xFFFFFFFF
        partner = a[..., idx ^ s]
        upper = (idx & s) == 0  # rows whose partner is s below
        # little-endian bits (bit c = column c): the upper row keeps its low
        # bits and takes the partner's low bits shifted up; the lower row
        # keeps its high bits and takes the partner's high bits shifted down
        up_new = (a & m) | ((partner << s) & nm)
        dn_new = (a & nm) | ((partner >> s) & m)
        a = torch.where(upper, up_new, dn_new)
    return a


def bit_transpose(packed: Tensor) -> Tensor:
    """Transpose int32 words [..., R, W] (R = 32 * W) as a bit matrix.

    Tiles: word (r, w) holds the bits of columns 32w..32w+31 of row r. The
    transpose swaps 32x32 tiles across the grid diagonal and transposes each
    tile internally."""
    *lead, R, W = packed.shape
    assert R == 32 * W, (R, W)
    tiles = u32(packed).reshape(*lead, W, 32, W)  # [.., tile_row, r, tile_col]
    tiles = tiles.movedim(-1, -2)                 # [.., tile_row, tile_col, r]
    tiles = _tile_transpose32(tiles)              # transpose each tile
    tiles = tiles.transpose(-3, -2)               # swap tile grid indices
    tiles = tiles.movedim(-1, -2)                 # [.., tile_row, r, tile_col]
    return to_i32(tiles.reshape(*lead, R, W))


def popcount(x: Tensor) -> Tensor:
    """Per-word population count (int32 words -> int32 counts)."""
    v = u32(x)
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)
