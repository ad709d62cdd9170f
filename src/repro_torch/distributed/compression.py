"""INT8 gradient compression with error feedback, and the two-level
compressed all-reduce (port of `repro.distributed.compression`).

Each round quantizes a gradient to INT8 with one max-abs scale per
tensor, and the quantization residual is added to the NEXT round's
gradient before compression, which keeps the accumulated bias bounded
(Karimireddy et al., 2019). The scale divides by a tensor (`true_div`),
so codes and scales equal the reference's bit for bit on every device.
On a sharded state (`shardings=`) each rank holds a block of every
gradient and residual; the per-tensor scale is still over the whole
tensor: the max-abs of the blocks, all-reduced (MAX) over the axes the
leaf is split over.

`make_two_level_all_reduce` is the reference's schedule over a
`collectives.RankMesh` with pod and data axes: an intra-pod f32
reduce-scatter, an INT8 sum across pods on an agreed scale, and an
intra-pod all-gather. As in the reference, the launcher does not call it.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import _tree
from repro_torch.core.quantization import true_div
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding as sh


def _scale(amax: torch.Tensor) -> torch.Tensor:
    return true_div(torch.clamp(amax, min=1e-12), 127.0)


def _codes(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def quantize_int8_tensor(x: torch.Tensor, sharding=None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """x -> (int8 codes, 0-d scale = max|x| / 127); with a `sharding`, x
    is this rank's block and the max is over the whole tensor."""
    amax = torch.max(torch.abs(x))
    if sharding is not None:
        amax = coll.all_reduce(amax, sharding.mesh, sh.split_axes(sharding),
                               "max")
    scale = _scale(amax)
    return _codes(x, scale), scale


def dequantize_int8_tensor(q: torch.Tensor, scale: torch.Tensor
                           ) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_decompress(g: torch.Tensor, err: torch.Tensor, sharding=None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """One error-feedback round: returns (decompressed g, new residual)."""
    g32 = g.to(torch.float32) + err
    q, scale = quantize_int8_tensor(g32, sharding)
    deq = dequantize_int8_tensor(q, scale)
    return deq.to(g.dtype), g32 - deq


def init_error_state(params: Any) -> Any:
    return _tree.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params)


def apply_error_feedback(grads: Any, err_state: Any, shardings: Any = None
                         ) -> tuple[Any, Any]:
    """One round over a tree; `shardings` (a NamedSharding per leaf) when
    the grads and residuals are this rank's blocks."""
    if shardings is None:
        out = _tree.tree_map(compress_decompress, grads, err_state)
    else:
        out = _tree.tree_map(compress_decompress, grads, err_state,
                             shardings)
    return (_tree.tree_map(lambda _, o: o[0], grads, out),
            _tree.tree_map(lambda _, o: o[1], grads, out))


def make_two_level_all_reduce(mesh, *, pod_axis: str = "pod",
                              data_axis: str = "data"):
    """Explicit two-level mean-all-reduce of a per-rank gradient tree over
    a RankMesh with `pod_axis` and `data_axis`: intra-pod f32
    reduce-scatter, INT8 across pods, all-gather back. Returns a fn
    g_tree -> g_tree (the mean over pod x data, on every rank)."""
    npod = mesh.shape[pod_axis]
    ndata = mesh.shape[data_axis]

    def reduce_leaf(g):
        orig_shape = g.shape
        flat = g.reshape(-1).to(torch.float32)
        pad = (-flat.shape[0]) % ndata
        flat = torch.nn.functional.pad(flat, (0, pad))
        # 1) intra-pod reduce-scatter (f32)
        shard = coll.reduce_scatter(flat, mesh, data_axis)
        # 2) cross-pod sum on an INT8 payload. The scale is AGREED before
        #    quantizing (max of the local max-abs): codes quantized under
        #    different scales cannot be summed.
        amax = coll.all_reduce(torch.max(torch.abs(shard)), mesh, pod_axis,
                               "max")
        scale = _scale(amax)
        summed = coll.all_reduce(_codes(shard, scale).to(torch.int32), mesh,
                                 pod_axis)
        shard = summed.to(torch.float32) * scale
        # 3) intra-pod all-gather
        full = true_div(coll.all_gather(shard, mesh, data_axis),
                        npod * ndata)
        if pad:
            full = full[:-pad]
        return full.reshape(orig_shape).to(g.dtype)

    return lambda tree: _tree.tree_map(reduce_leaf, tree)
