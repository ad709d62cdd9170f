"""Symmetric INT8 quantization for embedding databases.

Port of `repro.core.quantization`. For an INT8 code v in [-128, 127]:

    msb(v) = v >> 4        (arithmetic shift, range [-8, 7]  -> "INT4")
    lsb(v) = v & 0xF       (range [0, 15], unsigned nibble)
    v      = msb(v) * 16 + lsb(v)

`torch.round`, like `jnp.round`, rounds half to even, so codes are
bit-identical to the reference for the same float32 input.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch._device import resolve_device

INT8_MAX = 127
INT4_MAX = 7


@dataclasses.dataclass(frozen=True)
class QuantizedDB:
    """An INT8-quantized embedding database.

    values: (N, D) int8 quantized embeddings.
    scale: () or (N,) float32 dequant scale (x ~= values * scale).
    norms_sq: (N,) int32 integer squared L2 norms of the INT8 codes (fits
        int32 for D <= 2**31 / 128**2 = 131072 dims).
    """

    values: torch.Tensor
    scale: torch.Tensor
    norms_sq: torch.Tensor

    @property
    def num_docs(self) -> int:
        return self.values.shape[0]

    @property
    def dim(self) -> int:
        return self.values.shape[1]


def true_div(x: torch.Tensor, divisor: float) -> torch.Tensor:
    """x / divisor correctly rounded on every device, as `jnp` divides. On
    a CUDA tensor torch turns division by a Python number into a multiply
    by its reciprocal, which can differ in the last bit; a tensor divisor
    keeps the true division."""
    return x / torch.full_like(x, divisor)


def quantize_int8(x: torch.Tensor, *, per_vector: bool = False
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric INT8 quantization. Returns (codes int8, scale f32)."""
    x = x.to(torch.float32)
    if per_vector:
        amax = x.abs().amax(dim=-1, keepdim=True)
    else:
        amax = x.abs().amax()
    scale = true_div(torch.clamp(amax, min=1e-12), INT8_MAX)
    # Elementwise division by a broadcast tensor: a scalar divisor may be
    # turned into a multiply by its reciprocal, which rounds differently.
    codes = torch.clamp(torch.round(x / scale.expand_as(x)),
                        -INT8_MAX - 1, INT8_MAX).to(torch.int8)
    return codes, scale.squeeze(-1) if per_vector else scale


def quantize_int4(x: torch.Tensor, *, per_vector: bool = False
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric INT4 quantization. Returns (codes widened to int8 in
    [-8, 7], scale f32)."""
    x = x.to(torch.float32)
    if per_vector:
        amax = x.abs().amax(dim=-1, keepdim=True)
    else:
        amax = x.abs().amax()
    scale = true_div(torch.clamp(amax, min=1e-12), INT4_MAX)
    codes = torch.clamp(torch.round(x / scale.expand_as(x)),
                        -INT4_MAX - 1, INT4_MAX).to(torch.int8)
    return codes, scale.squeeze(-1) if per_vector else scale


def unit_norm_scale(dim: int) -> float:
    """Default fixed scale for L2-normalized embeddings of dimension `dim`.

    The max-abs coordinate of a random unit vector concentrates near
    sqrt(2 ln D / D); 4/sqrt(D) covers it with slack, so codes use most of
    the INT8 range and only extreme outlier coordinates saturate.
    """
    return 4.0 / (INT8_MAX * math.sqrt(dim))


def quantize_int8_fixed(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Symmetric INT8 quantization with a fixed, caller-supplied scale."""
    x = x.to(torch.float32)
    return torch.clamp(torch.round(true_div(x, np.float32(scale))),
                       -INT8_MAX - 1, INT8_MAX).to(torch.int8)


def dequantize(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """INT8 codes back to float32: codes * scale (per-vector scales
    broadcast over rows)."""
    scale = torch.as_tensor(scale, device=codes.device)
    if scale.ndim == 1:
        scale = scale[:, None]
    return codes.to(torch.float32) * scale


def msb_nibble(codes_int8: torch.Tensor) -> torch.Tensor:
    """Most-significant nibble of INT8 codes: arithmetic >> 4, in [-8, 7]."""
    return codes_int8.to(torch.int8) >> 4


def lsb_nibble(codes_int8: torch.Tensor) -> torch.Tensor:
    """Least-significant nibble in [0, 15], returned as int8."""
    return codes_int8.to(torch.int8) & 0xF


def reconstruct_from_nibbles(msb: torch.Tensor,
                             lsb: torch.Tensor) -> torch.Tensor:
    """Exact inverse of the (msb, lsb) split."""
    return (msb.to(torch.int16) * 16 + lsb.to(torch.int16)).to(torch.int8)


def build_database(embeddings, *, per_vector: bool = False,
                   device: str | torch.device | None = None) -> QuantizedDB:
    """Offline phase: quantize a float embedding matrix (a tensor or a
    numpy array) into a QuantizedDB on `device`."""
    x = torch.as_tensor(embeddings).to(resolve_device(device))
    codes, scale = quantize_int8(x, per_vector=per_vector)
    norms_sq = (codes.to(torch.int32) ** 2).sum(dim=-1, dtype=torch.int32)
    return QuantizedDB(values=codes, scale=scale, norms_sq=norms_sq)
