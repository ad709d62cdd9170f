"""Nibble-planar and bit-planar storage of INT8 embedding databases.

Port of `repro.core.bitplanar`. The streaming layout is two planes,

    msb_plane: (N, D/2) uint8 — two MSB nibbles packed per byte
    lsb_plane: (N, D/2) uint8 — two LSB nibbles packed per byte

Byte j of a plane holds dim 2j in its low nibble and dim 2j+1 in its high
nibble; nibbles are raw two's-complement. Stage 1 touches only msb_plane.
"""
from __future__ import annotations

import dataclasses

import torch

_SHIFTS8 = tuple(range(8))


def _as_u8(codes: torch.Tensor) -> torch.Tensor:
    return (codes.view(torch.uint8) if codes.dtype == torch.int8
            else codes.to(torch.uint8))


def _shifts(t: torch.Tensor) -> torch.Tensor:
    return torch.arange(8, dtype=torch.uint8, device=t.device)


# ---------------------------------------------------------------------------
# Nibble planes
# ---------------------------------------------------------------------------

def pack_nibble_planes(codes_int8: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Split (N, D) int8 into (msb_plane, lsb_plane), each (N, D//2) uint8."""
    n, d = codes_int8.shape
    if d % 2:
        raise ValueError("dimension must be even to pack 2 nibbles per byte")
    u = _as_u8(codes_int8)
    msb = (u >> 4) & 0xF
    lsb = u & 0xF

    def _pack(nib: torch.Tensor) -> torch.Tensor:
        nib = nib.reshape(n, d // 2, 2)
        return nib[..., 0] | (nib[..., 1] << 4)

    return _pack(msb), _pack(lsb)


def split_nibbles_signed(plane: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Packed plane -> (lo, hi) signed int8 nibbles (even dims, odd dims),
    each the shape of `plane`; sign-extended by two arithmetic shifts."""
    b = plane.view(torch.int8)
    return (b << 4) >> 4, b >> 4


def _interleave(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    return torch.stack([lo, hi], dim=-1).reshape(*lo.shape[:-1], -1)


def unpack_nibble_plane_signed(plane: torch.Tensor) -> torch.Tensor:
    """(N, D//2) uint8 msb-plane -> (N, D) int8 signed nibbles in [-8, 7]."""
    lo, hi = split_nibbles_signed(plane)
    return _interleave(lo, hi)


def unpack_nibble_plane_unsigned(plane: torch.Tensor) -> torch.Tensor:
    """(N, D//2) uint8 lsb-plane -> (N, D) int8 unsigned nibbles in [0, 15]."""
    return _interleave(plane & 0xF, (plane >> 4) & 0xF).to(torch.int8)


def reconstruct_int8(msb_plane: torch.Tensor,
                     lsb_plane: torch.Tensor) -> torch.Tensor:
    """Exact inverse of pack_nibble_planes."""
    msb = unpack_nibble_plane_signed(msb_plane).to(torch.int16)
    lsb = unpack_nibble_plane_unsigned(lsb_plane).to(torch.int16)
    return (msb * 16 + lsb).to(torch.int8)


def expand_block_rows(block_ids: torch.Tensor,
                      block_rows: int) -> torch.Tensor:
    """(B, J) block ids -> (B, J * block_rows) row ids, block-major: row r
    of block b is global row b * block_rows + r."""
    offs = torch.arange(block_rows, dtype=torch.int32,
                        device=block_ids.device)
    return (block_ids[:, :, None].to(torch.int32) * block_rows
            + offs).reshape(block_ids.shape[0], -1)


def gather_blocks(plane: torch.Tensor, block_ids: torch.Tensor,
                  block_rows: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, D2) plane x (B, J) clamped block ids -> (gathered (B, R, D2),
    rows (B, R)) with R = J * block_rows. Rows past N read as zero rows."""
    n = plane.shape[0]
    rows = expand_block_rows(block_ids, block_rows)
    gathered = plane[torch.clamp(rows, max=n - 1).long()]
    gathered = torch.where((rows < n)[:, :, None], gathered,
                           torch.zeros((), dtype=plane.dtype,
                                       device=plane.device))
    return gathered, rows


# ---------------------------------------------------------------------------
# Sign plane (the stage-0 prescreen's 1-bit layout)
# ---------------------------------------------------------------------------

def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., 8) uint8 bits -> (...) uint8, bit i of the byte from bits[i]."""
    return (bits << _shifts(bits)).sum(dim=-1, dtype=torch.uint8)


def pack_sign_plane(codes_int8: torch.Tensor) -> torch.Tensor:
    """(N, D) int8 -> (N, D//8) uint8; bit k%8 of byte k//8 is set iff
    dim k is negative."""
    n, d = codes_int8.shape
    if d % 8:
        raise ValueError("dimension must be a multiple of 8 for sign packing")
    return _pack_bits((codes_int8 < 0).to(torch.uint8).reshape(n, d // 8, 8))


def sign_plane_from_msb(msb_plane: torch.Tensor) -> torch.Tensor:
    """The sign plane as a bit-extraction of the packed MSB nibble plane
    (the INT4 nibble's sign bit is the INT8 sign bit): bit 3 of byte j is
    the sign of dim 2j, bit 7 the sign of dim 2j+1."""
    n, d2 = msb_plane.shape
    if (d2 * 2) % 8:
        raise ValueError("dimension must be a multiple of 8 for sign packing")
    lo = (msb_plane >> 3) & 1
    hi = (msb_plane >> 7) & 1
    return _pack_bits(_interleave(lo, hi).reshape(n, d2 * 2 // 8, 8))


def unpack_sign_pm1(sign_plane: torch.Tensor) -> torch.Tensor:
    """(..., D//8) uint8 sign plane -> (..., D) int8 in {+1, -1}."""
    bits = (sign_plane[..., :, None] >> _shifts(sign_plane)) & 1
    bits = bits.reshape(*sign_plane.shape[:-1], sign_plane.shape[-1] * 8)
    return 1 - 2 * bits.to(torch.int8)


def sign_pm1(codes: torch.Tensor) -> torch.Tensor:
    """int8 codes -> {+1, -1} int8 signs (0 maps to +1)."""
    one = torch.ones((), dtype=torch.int8, device=codes.device)
    return torch.where(codes < 0, -one, one)


# ---------------------------------------------------------------------------
# Full 8-plane bit-planar layout (used by the energy model)
# ---------------------------------------------------------------------------

def pack_bitplanes(codes_int8: torch.Tensor) -> torch.Tensor:
    """(N, D) int8 -> (8, N, D//8) uint8; plane b holds bit b of every dim
    (dim k -> byte k//8, bit k%8); plane 7 is the sign bit."""
    n, d = codes_int8.shape
    if d % 8:
        raise ValueError("dimension must be a multiple of 8")
    u = _as_u8(codes_int8)
    return torch.stack([_pack_bits(((u >> b) & 1).reshape(n, d // 8, 8))
                        for b in _SHIFTS8])


def unpack_bitplanes(planes: torch.Tensor, *,
                     num_planes: int = 8) -> torch.Tensor:
    """(8, N, D//8) uint8 -> (N, D) int8, reading only the top
    `num_planes` bit-planes (missing low bits read as zero)."""
    _, n, db = planes.shape
    shifts = _shifts(planes)
    acc = torch.zeros((n, db * 8), dtype=torch.uint8, device=planes.device)
    for b in range(8 - num_planes, 8):
        bits = ((planes[b][..., None] >> shifts) & 1).reshape(n, db * 8)
        acc = acc | (bits << b)
    return acc.view(torch.int8)


@dataclasses.dataclass(frozen=True)
class BitPlanarDB:
    """Nibble-planar database as streamed on the device.

    msb_plane, lsb_plane: (N, D//2) uint8.
    norms_sq: (N,) int32 integer squared norms of the full INT8 codes.
    scale: dequant scale (see quantization.QuantizedDB).
    sign_plane: optional (N, D//8) uint8 1-bit sign plane.
    """

    msb_plane: torch.Tensor
    lsb_plane: torch.Tensor
    norms_sq: torch.Tensor
    scale: torch.Tensor
    sign_plane: torch.Tensor | None = None

    @property
    def num_docs(self) -> int:
        return self.msb_plane.shape[0]

    @property
    def dim(self) -> int:
        return self.msb_plane.shape[1] * 2

    @classmethod
    def from_quantized(cls, db) -> "BitPlanarDB":
        msb, lsb = pack_nibble_planes(db.values)
        sign = (pack_sign_plane(db.values)
                if db.values.shape[1] % 8 == 0 else None)
        return cls(msb_plane=msb, lsb_plane=lsb, norms_sq=db.norms_sq,
                   scale=db.scale, sign_plane=sign)
