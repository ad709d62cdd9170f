"""Optimizers over dict trees of tensors: AdamW and Adafactor (port of
`repro.train.optim`).

The reference's contract and state layout: `init(params) -> state` and
`update(grads, state, params) -> (params, state)`, functional (new
tensors, nothing written in place). AdamW keeps f32 first and second
moments per parameter, state {"step", "mu", "nu"}. Adafactor keeps
row/col-factored second moments for >= 2-D parameters, factored over the
LAST TWO dims (leading layer-stack dims kept), state {"step", "v"} with
{"vr", "vc"} or {"v"} per parameter.

AdamW adds `weight_decay * p` to the normalized update, as the reference
does; `torch.optim.AdamW` decays weights decoupled (`p *= 1 - lr * wd`),
a different optimizer. The step's scalars are f32 tensors (`b1 ** t` in
f32, as the reference computes it), and every division by a Python
number divides by a tensor (`true_div`: on the card torch turns `/ 2.0`
into a multiply by the reciprocal).

On a sharded state, `update(..., shardings=)` takes each rank's blocks of
the grads, state and params and a NamedSharding per parameter. AdamW is
elementwise and ignores it; Adafactor's row and column means, the mean
of its row statistics and its two RMS means reduce over dims that a mesh
axis may split, so each sums its block and all-reduces the sum over
exactly the axes that split the dims it reduces.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch import _tree
from repro_torch.core.quantization import true_div
from repro_torch.distributed import collectives as coll

F32 = torch.float32


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    # (grads, state, params, shardings=None) -> (params, state)
    update: Callable[..., tuple[Any, Any]]


def _step(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=_tree.leaves(params)[0].device)


def _pow(base: float, t: torch.Tensor) -> torch.Tensor:
    """base ** t in f32 (the reference's weakly typed Python base)."""
    return torch.pow(torch.tensor(base, dtype=F32, device=t.device), t)


def _split(params, out, n: int) -> list:
    """`out`, shaped like `params` with an n-tuple at each leaf -> n trees."""
    return [_tree.tree_map(lambda _, o, i=i: o[i], params, out)
            for i in range(n)]


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw(lr: float = 1e-3, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        def zeros():
            return _tree.tree_map(
                lambda p: torch.zeros(p.shape, dtype=F32, device=p.device),
                params)
        return {"step": _step(params), "mu": zeros(), "nu": zeros()}

    def update(grads, state, params, shardings=None):
        step = state["step"] + 1
        t = step.to(F32)
        c1 = 1.0 - _pow(b1, t)
        c2 = 1.0 - _pow(b2, t)

        def upd(p, g, m, v):
            g = g.to(F32)
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * torch.square(g)
            u = (m / c1) / (torch.sqrt(v / c2) + eps)
            u = u + weight_decay * p.to(F32)
            return (p - lr * u.to(p.dtype)).to(p.dtype), m, v

        out = _tree.tree_map(upd, params, grads, state["mu"], state["nu"])
        new_p, new_m, new_v = _split(params, out, 3)
        return new_p, {"step": step, "mu": new_m, "nu": new_v}

    return Optimizer(init=init, update=update)


# ---------------------------------------------------------------------------
# Adafactor (Shazeer & Stern 2018), factored over the last two dims
# ---------------------------------------------------------------------------

def _mean(x: torch.Tensor, dims, sharding, param_dims, keepdim=False
          ) -> torch.Tensor:
    """torch.mean of x over `dims` (None: all); with a sharding, x is a
    block and `param_dims` are the parameter dims that `dims` stand for,
    whose split axes the block sum is all-reduced over."""
    if sharding is None:
        return torch.mean(x, dim=dims, keepdim=keepdim)
    mesh, spec = sharding.mesh, sharding.spec
    axes = {a for d in param_dims if d < len(spec)
            for a in coll.axes_of(spec[d])}
    axes = tuple(a for a in mesh.axis_names if a in axes)
    total = (torch.sum(x) if dims is None
             else torch.sum(x, dim=dims, keepdim=keepdim))
    count = (x.numel() if dims is None else x.shape[dims])
    if axes:
        total = coll.all_reduce(total, mesh, axes)
        count *= mesh.axes_size(axes)
    return true_div(total, count)


def adafactor(lr: float = 1e-3, decay: float = 0.8, eps1: float = 1e-30,
              eps2: float = 1e-3, clip_threshold: float = 1.0) -> Optimizer:
    def init(params):
        def leaf(p):
            if p.ndim >= 2:
                return {"vr": torch.zeros(p.shape[:-1], dtype=F32,
                                          device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          dtype=F32, device=p.device)}
            return {"v": torch.zeros(p.shape, dtype=F32, device=p.device)}
        return {"step": _step(params), "v": _tree.tree_map(leaf, params)}

    def update(grads, state, params, shardings=None):
        step = state["step"] + 1
        t = step.to(F32)
        beta = 1.0 - t ** -decay                 # increasing decay schedule

        def upd(p, g, s, sh=None):
            g = g.to(F32)
            g2 = torch.square(g) + eps1
            every = tuple(range(p.ndim))
            if p.ndim >= 2:
                last, penult = p.ndim - 1, p.ndim - 2
                vr = beta * s["vr"] + (1 - beta) * _mean(g2, -1, sh, (last,))
                vc = beta * s["vc"] + (1 - beta) * _mean(g2, -2, sh,
                                                         (penult,))
                denom = _mean(vr, -1, sh, (penult,), keepdim=True)
                u = g / (torch.sqrt(vr / denom)[..., None]
                         * torch.sqrt(vc)[..., None, :] + eps1)
                ns = {"vr": vr, "vc": vc}
            else:
                v = beta * s["v"] + (1 - beta) * g2
                u = g / (torch.sqrt(v) + eps1)
                ns = {"v": v}
            # update clipping (RMS)
            rms = torch.sqrt(_mean(torch.square(u), None, sh, every) + eps1)
            u = u / torch.clamp(true_div(rms, clip_threshold), min=1.0)
            scale = torch.clamp(torch.sqrt(
                _mean(torch.square(p.to(F32)), None, sh, every)), min=eps2)
            return (p - (lr * scale * u).to(p.dtype)).to(p.dtype), ns

        if shardings is None:
            out = _tree.tree_map(upd, params, grads, state["v"])
        else:
            out = _tree.tree_map(upd, params, grads, state["v"], shardings)
        new_p, new_s = _split(params, out, 2)
        return new_p, {"step": step, "v": new_s}

    return Optimizer(init=init, update=update)


def get_optimizer(name: str, lr: float = 1e-3, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(lr=lr, **kw)
    if name == "adafactor":
        return adafactor(lr=lr, **kw)
    raise ValueError(name)
