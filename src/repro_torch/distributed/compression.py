"""INT8 gradient compression with error feedback: the numerics core of
`repro.distributed.compression`.

Each round quantizes a gradient to INT8 with one max-abs scale per
tensor, and the quantization residual is added to the NEXT round's
gradient before compression, which keeps the accumulated bias bounded
(Karimireddy et al., 2019). The scale divides by a tensor (`true_div`),
so codes and scales equal the reference's bit for bit on every device.

The reference's two-level all-reduce (`make_two_level_all_reduce`:
intra-pod f32 reduce-scatter, INT8 across pods, all-gather) needs
collectives across processes; it waits for ROADMAP A2's training half.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import _tree
from repro_torch.core.quantization import true_div


def quantize_int8_tensor(x: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """x -> (int8 codes, 0-d scale = max|x| / 127)."""
    scale = true_div(torch.clamp(torch.max(torch.abs(x)), min=1e-12), 127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8_tensor(q: torch.Tensor, scale: torch.Tensor
                           ) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_decompress(g: torch.Tensor, err: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """One error-feedback round: returns (decompressed g, new residual)."""
    g32 = g.to(torch.float32) + err
    q, scale = quantize_int8_tensor(g32)
    deq = dequantize_int8_tensor(q, scale)
    return deq.to(g.dtype), g32 - deq


def init_error_state(params: Any) -> Any:
    return _tree.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params)


def apply_error_feedback(grads: Any, err_state: Any) -> tuple[Any, Any]:
    out = _tree.tree_map(compress_decompress, grads, err_state)
    return (_tree.tree_map(lambda _, o: o[0], grads, out),
            _tree.tree_map(lambda _, o: o[1], grads, out))
