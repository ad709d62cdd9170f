"""State carried across from the JAX package: numpy leaves -> the port.

The reference's `QuantizedDB`, `BitPlanarDB` and `ClusterCodebook` are
pytrees of arrays, and its `Arena` and `ClusterIndex` hold arrays plus
host counters; a caller turns their leaves into numpy (``np.asarray``)
and hands them here to get the port's objects on a chosen device, so a
history begun on the reference continues on the port. Model parameters
cross the same way (`dense_params`, `embedder_params`), and a sharded
index as its padded arrays (`sharded_index`); the MoE model's through
`moe_params`, the SSM and hybrid models' through `ssm_params` and
`hybrid_params`, the enc-dec model's through `encdec_params`. A bfloat16 parameter (numpy's `ml_dtypes.bfloat16`) stays
bfloat16 bit for bit. This module imports no JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.bitplanar import BitPlanarDB
from repro_torch.core.clustering import ClusterCodebook, ClusterIndex
from repro_torch.core.index import ShardedIndex, shard_database
from repro_torch.core.quantization import QuantizedDB
from repro_torch.tenancy.arena import Arena, ArenaStats


def _tensor(a, dtype: np.dtype, name: str, dev: torch.device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype != dtype:
        raise TypeError(f"{name} must be {np.dtype(dtype).name}, "
                        f"got {arr.dtype}")
    return torch.from_numpy(np.array(arr, order="C", copy=True)).to(dev)


def quantized_db(values, scale, norms_sq, *, device=None) -> QuantizedDB:
    """values (N, D) int8, scale f32 () or (N,), norms_sq (N,) int32."""
    dev = resolve_device(device)
    return QuantizedDB(values=_tensor(values, np.int8, "values", dev),
                       scale=_tensor(scale, np.float32, "scale", dev),
                       norms_sq=_tensor(norms_sq, np.int32, "norms_sq", dev))


def bitplanar_db(msb_plane, lsb_plane, norms_sq, scale, sign_plane=None, *,
                 device=None) -> BitPlanarDB:
    """msb/lsb planes (N, D//2) uint8, norms_sq (N,) int32, scale f32,
    optional sign_plane (N, D//8) uint8."""
    dev = resolve_device(device)
    return BitPlanarDB(
        msb_plane=_tensor(msb_plane, np.uint8, "msb_plane", dev),
        lsb_plane=_tensor(lsb_plane, np.uint8, "lsb_plane", dev),
        norms_sq=_tensor(norms_sq, np.int32, "norms_sq", dev),
        scale=_tensor(scale, np.float32, "scale", dev),
        sign_plane=(None if sign_plane is None else
                    _tensor(sign_plane, np.uint8, "sign_plane", dev)))


def sharded_index(msb_plane, lsb_plane, norms_sq, scale, *, n_global: int,
                  mesh) -> ShardedIndex:
    """The reference `ShardedIndex`'s arrays, padded as it holds them
    (msb/lsb planes (N_pad, D//2) uint8, norms_sq (N_pad,) int32, scale
    f32, N_pad a multiple of the mesh size, pad rows included) and its
    `n_global`, as the port's index over `mesh` (a
    `repro_torch.distributed.Mesh`)."""
    db = bitplanar_db(msb_plane, lsb_plane, norms_sq, scale,
                      device=mesh.slots()[0])
    return ShardedIndex(db=shard_database(db, mesh), mesh=mesh,
                        n_global=int(n_global))


def cluster_codebook(codes, msb_plane, norms_sq, *,
                     device=None) -> ClusterCodebook:
    """The reference `ClusterCodebook`'s leaves: codes (K, D) int8,
    msb_plane (K, D//2) uint8, norms_sq (K,) int32. The reference's numpy
    `labels` and `block_table` need no conversion: the cluster entry
    points take them as they are."""
    dev = resolve_device(device)
    return ClusterCodebook(codes=_tensor(codes, np.int8, "codes", dev),
                           msb_plane=_tensor(msb_plane, np.uint8,
                                             "msb_plane", dev),
                           norms_sq=_tensor(norms_sq, np.int32, "norms_sq",
                                            dev))


def query_codes(codes, *, device=None) -> torch.Tensor:
    """(..., D) int8 query codes -> an int8 tensor on `device`."""
    return _tensor(codes, np.int8, "query codes", resolve_device(device))


def arena(msb_plane, lsb_plane, sign_plane, norms_sq, owner, cluster_labels,
          *, next_slot: int, tombstones: int, generation: int, stats: dict,
          scale, device=None) -> Arena:
    """The reference `Arena`'s state: planes (N, D//2) uint8, sign_plane
    (N, D//8) uint8 or None, norms_sq and owner (N,) int32,
    cluster_labels (N,) int32, its `_next`, `_tombstones` and
    `generation`, `stats` as a dict of ArenaStats' counts, and its f32
    scale. The port's arena holds the same rows and continues the same
    slot allocation."""
    planes = np.asarray(msb_plane)
    capacity, dim = planes.shape[0], planes.shape[1] * 2
    out = Arena(capacity, dim, scale=np.float32(np.asarray(scale)),
                device=device)
    dev = out.device
    given = [(out.msb_plane, msb_plane, np.uint8, "msb_plane"),
             (out.lsb_plane, lsb_plane, np.uint8, "lsb_plane"),
             (out.norms_sq, norms_sq, np.int32, "norms_sq"),
             (out.owner, owner, np.int32, "owner")]
    if (sign_plane is None) != (out.sign_plane is None):
        raise ValueError("sign_plane is given exactly when dim % 8 == 0")
    if sign_plane is not None:
        given.append((out.sign_plane, sign_plane, np.uint8, "sign_plane"))
    for dst, src, dtype, name in given:
        t = _tensor(src, dtype, name, dev)
        if t.shape != dst.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{tuple(dst.shape)}")
        dst.copy_(t)
    labels = np.asarray(cluster_labels)
    if labels.dtype != np.int32 or labels.shape != (capacity,):
        raise TypeError(f"cluster_labels must be ({capacity},) int32")
    out.cluster_labels = labels.copy()
    out._next = int(next_slot)
    out._tombstones = int(tombstones)
    out.generation = int(generation)
    out.stats = ArenaStats(**stats)
    return out


def cluster_index(centroids, sums, counts, *, generation: int, seed: int = 0,
                  iters: int = 8, device=None) -> ClusterIndex:
    """The reference `ClusterIndex`'s state: its centroids (K, D) int8
    (None while untrained), running sums (K, D) float64, counts (K,)
    int64 and generation."""
    sums = np.asarray(sums)
    counts = np.asarray(counts)
    if sums.dtype != np.float64 or counts.dtype != np.int64:
        raise TypeError("sums must be float64 and counts int64")
    out = ClusterIndex(sums.shape[0], sums.shape[1], seed=seed, iters=iters,
                       device=device)
    if centroids is not None:
        cents = np.asarray(centroids)
        if cents.dtype != np.int8 or cents.shape != sums.shape:
            raise TypeError(f"centroids must be {sums.shape} int8")
        out._centroids = cents.copy()
    out._sums = sums.copy()
    out._counts = counts.copy()
    out.generation = int(generation)
    return out


def _float_leaf(a, name: str, dev: torch.device) -> torch.Tensor:
    """A float32 or bfloat16 leaf; bfloat16 crosses as its uint16 bits
    (torch.from_numpy takes no ml_dtypes bfloat16)."""
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        bits = np.array(arr.view(np.uint16), order="C", copy=True)
        return torch.from_numpy(bits).view(torch.bfloat16).to(dev)
    if arr.dtype != np.float32:
        raise TypeError(f"{name} must be float32 or bfloat16, got "
                        f"{arr.dtype}")
    return _tensor(arr, np.float32, name, dev)


def _param_tree(tree, keys: dict, dev: torch.device, where: str) -> dict:
    """A nested dict of float32 or bfloat16 numpy leaves -> the same dict
    of tensors; `keys` names the required leaves (a dict for a subtree,
    None for a leaf) and the optional ones in `_OPTIONAL`."""
    if not isinstance(tree, dict):
        raise TypeError(f"{where or 'params'} must be a dict")
    missing = sorted(set(keys) - set(tree))
    extra = sorted(set(tree) - set(keys) - _OPTIONAL)
    if missing or extra:
        raise ValueError(f"{where or 'params'}: missing {missing}, "
                         f"unexpected {extra}")
    return {name: (_param_tree(leaf, keys[name], dev, f"{where}{name}.")
                   if isinstance(keys.get(name), dict)
                   else _float_leaf(leaf, f"{where}{name}", dev))
            for name, leaf in tree.items()}


_BLOCK = dict.fromkeys(("ln1", "wq", "wk", "wv", "wo", "ln2", "w_gate",
                        "w_up", "w_down"))
_ATTN = dict.fromkeys(("ln1", "wq", "wk", "wv", "wo", "ln2"))
_FFN = dict.fromkeys(("w_gate", "w_up", "w_down"))
_DEC = dict.fromkeys((*_BLOCK, "lnx", "xwq", "xwk", "xwv", "xwo"))
_MOE = dict.fromkeys(("router", "w_gate", "w_up", "w_down"))
_SSM = dict.fromkeys(("ln", "in_proj", "conv_w", "conv_b", "A_log",
                      "dt_bias", "D", "norm", "out_proj"))
# qwen2's QKV bias, an untied head, the MoE's shared expert
_OPTIONAL = frozenset(("bq", "bk", "bv", "lm_head", "sh_gate", "sh_up",
                       "sh_down"))


def dense_params(params, *, device=None) -> dict:
    """The reference dense model's parameters (`repro.models.dense`; a
    nested dict of float32 numpy arrays with the per-layer arrays stacked
    on axis 0) as the port's, on `device`."""
    return _param_tree(params, {"embed": None, "blocks": _BLOCK,
                                "final_norm": None},
                       resolve_device(device), "")


def moe_params(params, *, device=None) -> dict:
    """The reference MoE model's parameters (`repro.models.moe`: `embed`,
    `blocks` of attention only, `dense_ffn` ((SB, period-1, ...), or {}
    when the period is 1), `moe` (router, expert banks, `sh_*` with a
    shared expert), `final_norm`, `lm_head` where untied; float32 or
    bfloat16 numpy leaves) as the port's, on `device`. A bfloat16 leaf
    stays torch.bfloat16, bit for bit."""
    if not isinstance(params, dict):
        raise TypeError("params must be a dict")
    keys = {"embed": None, "blocks": _ATTN, "dense_ffn": _FFN, "moe": _MOE,
            "final_norm": None}
    no_dense = params.get("dense_ffn") == {}        # period 1
    if no_dense:
        params = {k: v for k, v in params.items() if k != "dense_ffn"}
        del keys["dense_ffn"]
    out = _param_tree(params, keys, resolve_device(device), "")
    if no_dense:
        out["dense_ffn"] = {}
    return out


def ssm_params(params, *, device=None) -> dict:
    """The reference mamba2 model's parameters (`repro.models.mamba2`:
    `embed`, `blocks` of stacked mamba2 blocks, `final_norm`, `lm_head`
    where untied) as the port's, on `device`. Each leaf keeps its dtype:
    `A_log`, `dt_bias` and `D` are float32 in a bfloat16 tree, as the
    reference keeps them."""
    return _param_tree(params, {"embed": None, "blocks": _SSM,
                                "final_norm": None},
                       resolve_device(device), "")


def hybrid_params(params, *, device=None) -> dict:
    """The reference zamba2 model's parameters (`repro.models.zamba2`: the
    mamba2 tree of `ssm_params` plus `shared`, one dense block with no
    layer axis) as the port's, on `device`."""
    return _param_tree(params, {"embed": None, "blocks": _SSM,
                                "shared": _BLOCK, "final_norm": None},
                       resolve_device(device), "")


def encdec_params(params, *, device=None) -> dict:
    """The reference enc-dec model's parameters (`repro.models.encdec`:
    `enc_blocks` of stacked encoder blocks, `dec_blocks` of stacked
    decoder blocks with their cross-attention (`lnx`, `xwq`, `xwk`,
    `xwv`, `xwo`), `embed`, `enc_norm`, `final_norm`, `lm_head`) as the
    port's, on `device`. A bfloat16 leaf stays torch.bfloat16, bit for
    bit."""
    return _param_tree(params, {"enc_blocks": _BLOCK, "dec_blocks": _DEC,
                                "embed": None, "enc_norm": None,
                                "final_norm": None, "lm_head": None},
                       resolve_device(device), "")


def embedder_params(params, *, device=None) -> dict:
    """The reference embedder's parameters (`repro.models.embedder`) as the
    port's, on `device`."""
    return _param_tree(params, {"embed": None, "blocks": _BLOCK,
                                "final_norm": None, "proj": None},
                       resolve_device(device), "")


def optimizer_state(state, *, device=None) -> dict:
    """The reference optimizer's state (`repro.train.optim`; numpy leaves)
    as the port's, on `device`: AdamW's {"step", "mu", "nu"} or
    Adafactor's {"step", "v"} (per parameter {"vr", "vc"} or {"v"}). The
    step is an int32 scalar, every other leaf float32."""
    dev = resolve_device(device)
    if not isinstance(state, dict) or set(state) not in (
            {"step", "mu", "nu"}, {"step", "v"}):
        raise ValueError("optimizer state must be AdamW's {step, mu, nu} "
                         "or Adafactor's {step, v}")
    step = _tensor(state["step"], np.int32, "step", dev)
    if step.ndim:
        raise ValueError("step must be a scalar")

    def tree(t, where):
        if isinstance(t, dict):
            return {k: tree(v, f"{where}{k}.") for k, v in t.items()}
        return _tensor(t, np.float32, where.rstrip("."), dev)
    return {k: step if k == "step" else tree(v, f"{k}.")
            for k, v in state.items()}
