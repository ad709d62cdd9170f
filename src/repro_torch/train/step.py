"""train_step factory: value and grad + microbatch accumulation +
optimizer (port of `repro.train.step`).

The returned function maps (params, opt_state, batch) to (params,
opt_state, metrics) without writing its inputs. Autograd takes the place
of `jax.value_and_grad`: the loss is evaluated on detached leaves that
require grad, so the caller's parameters need not. Gradient accumulation
splits the batch axis into `grad_accum` microbatches and sums their f32
gradients in a loop, in the reference's order; the sums are divided by a
tensor (`true_div`).

`grad_transform` is an optional hook applied to the gradient tree before
clipping and the optimizer (the INT8 error-feedback compression of
`repro_torch.distributed.compression`).

`make_sharded_train_step` is the same step over a state sharded across
the ranks of a `collectives.RankMesh` (the reference jits its step with
the shardings of `repro.distributed.sharding`). Storage is ZeRO-3 over
the whole mesh: each rank holds its blocks of the parameters and the
optimizer state, as `param_spec`/`opt_state_shardings` lay them out.
Compute is data-parallel over the batch axes and repeated across the
model axis (ROADMAP C24). Per step: all-gather each parameter, run
forward and backward on the rank's batch block (`batch_spec`),
reduce-scatter the gradients back to each parameter's block, update the
local blocks. The loss is the reference's global masked mean: each rank
weighs its block's mean by its share of the global count of labelled
positions, so the sum over ranks of the weighted losses (and grads) is
the mean over the whole batch, not a mean of per-rank means. Global-norm
clipping sums each element once over the mesh (`sharding.owns`). Each
microbatch runs under `batch_block`, so a layer that acts on the whole
microbatch (the MoE's capacity per batch shard) sees which of its rows
the rank runs.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch import _tree
from repro_torch.core.quantization import true_div
from repro_torch.data.synthetic import shard_batch
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding as sh
from repro_torch.models.common import batch_block, set_mesh
from repro_torch.train.optim import Optimizer

F32 = torch.float32


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(leaf.to(F32)))
                          for leaf in _tree.leaves(tree)))


def clip_by_global_norm(tree, max_norm: float, norm=None):
    """(tree scaled to a global norm of at most max_norm, the norm); `norm`
    when the caller has it (a sharded tree's `sharded_global_norm`)."""
    norm = global_norm(tree) if norm is None else norm
    scale = torch.clamp(torch.full_like(norm, max_norm)
                        / torch.clamp(norm, min=1e-9), max=1.0)
    return _tree.tree_map(lambda leaf: (leaf * scale).to(leaf.dtype),
                          tree), norm


def value_and_grad(loss_fn: Callable[[Any, Any], torch.Tensor], params,
                   batch) -> tuple[torch.Tensor, Any]:
    """(loss, grads of loss w.r.t. every leaf of params); a leaf the loss
    does not reach gets zeros, as in JAX."""
    live = [leaf.detach().requires_grad_(True)
            for leaf in _tree.leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(_tree.unflatten(params, live), batch)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(live, grads)]
    return loss.detach(), _tree.unflatten(params, grads)


def make_train_step(loss_fn: Callable[[Any, Any], torch.Tensor],
                    optimizer: Optimizer, *, grad_accum: int = 1,
                    clip_norm: float | None = 1.0,
                    grad_transform: Callable | None = None):
    """loss_fn(params, batch) -> scalar. Returns train_step fn."""

    def train_step(params, opt_state, batch):
        if grad_accum > 1:
            rows = {len(v) for v in batch.values()}
            if len(rows) != 1 or next(iter(rows)) % grad_accum:
                raise ValueError(f"batch rows {sorted(rows)} do not split "
                                 f"into {grad_accum} microbatches")
            mb = next(iter(rows)) // grad_accum
            loss_sum = torch.zeros((), dtype=F32,
                                   device=_tree.leaves(params)[0].device)
            grads = _tree.tree_map(
                lambda p: torch.zeros(p.shape, dtype=F32, device=p.device),
                params)
            for i in range(grad_accum):
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                loss, g = value_and_grad(loss_fn, params, micro)
                grads = _tree.tree_map(lambda a, b: a + b.to(F32), grads, g)
                loss_sum = loss_sum + loss
            loss = true_div(loss_sum, grad_accum)
            grads = _tree.tree_map(lambda g: true_div(g, grad_accum), grads)
        else:
            loss, grads = value_and_grad(loss_fn, params, batch)

        if grad_transform is not None:
            grads = grad_transform(grads)
        gnorm = torch.zeros((), dtype=F32, device=loss.device)
        if clip_norm is not None:
            grads, gnorm = clip_by_global_norm(grads, clip_norm)
        params, opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step


def sharded_global_norm(blocks, shardings) -> torch.Tensor:
    """The global norm of a tree held as this rank's blocks: each block's
    squared norm counted by its owner only, summed over the mesh."""
    mesh = None
    total = None
    for g, s in zip(_tree.leaves(blocks), _tree.leaves(shardings),
                    strict=True):
        mesh = s.mesh
        sq = torch.sum(torch.square(g.to(F32)))
        if not sh.owns(s):
            sq = torch.zeros_like(sq)
        total = sq if total is None else total + sq
    return torch.sqrt(coll.all_reduce(total, mesh, mesh.axis_names))


def make_sharded_train_step(loss_fn: Callable[[Any, Any], torch.Tensor],
                            optimizer: Optimizer, mesh, shardings, *,
                            grad_accum: int = 1,
                            clip_norm: float | None = 1.0,
                            grad_transform: Callable | None = None):
    """loss_fn(params, batch) -> the mean loss over the positions whose
    label is >= 0 (`cross_entropy_loss`'s contract); `shardings` a
    NamedSharding per parameter on `mesh`. Returns train_step(params,
    opt_state, batch): params and opt_state are this rank's blocks, batch
    the whole host batch (the same on every rank); it returns the new
    blocks and metrics equal on every rank. Microbatches are the global
    batch's, as on one device: microbatch i is rows [i*m, (i+1)*m) of the
    whole batch, and each rank runs its rows of it."""

    def train_step(params, opt_state, batch):
        rows = {len(v) for v in batch.values()}
        if len(rows) != 1:
            raise ValueError(f"batch leaves have {sorted(rows)} rows")
        rows = rows.pop()
        if rows % grad_accum:
            raise ValueError(f"batch rows {rows} do not split into "
                             f"{grad_accum} microbatches")
        bsh = sh.batch_shardings(batch, mesh)
        axes = coll.axes_of(bsh["labels"].spec[0])
        per = rows // mesh.axes_size(axes)
        lo = mesh.index(axes) * per
        local = shard_batch(batch, bsh)
        mb = rows // grad_accum
        spans = [(max(lo, i * mb) - lo, min(lo + per, (i + 1) * mb) - lo)
                 for i in range(grad_accum)]
        labelled = (local["labels"] >= 0).to(F32)
        counts = torch.stack([labelled[a:b].sum() if a < b
                              else torch.zeros((), device=mesh.device)
                              for a, b in spans])
        totals = coll.all_reduce(counts, mesh, axes)
        full = sh.gather_tree(params, shardings)
        loss = torch.zeros((), dtype=F32, device=mesh.device)
        grads = None
        with set_mesh(mesh):
            for i, (a, b) in enumerate(spans):
                if a >= b:
                    continue
                w = (torch.clamp(counts[i], min=1.0)
                     / torch.clamp(totals[i], min=1.0))
                micro = {k: v[a:b] for k, v in local.items()}
                with batch_block(mb, lo + a - i * mb):
                    part, g = value_and_grad(
                        lambda p, m, w=w: loss_fn(p, m) * w, full, micro)
                grads = g if grads is None else _tree.tree_map(
                    lambda x, y: x + y.to(F32), grads, g)
                loss = loss + part
        del full
        if grads is None:
            raise ValueError(f"rank {mesh.rank} holds no rows of the batch")
        loss = coll.all_reduce(loss, mesh, axes)
        grads = _tree.tree_map(
            lambda g, s: sh.reduce_to_block(g, s, axes), grads, shardings)
        if grad_accum > 1:
            loss = true_div(loss, grad_accum)
            grads = _tree.tree_map(lambda g: true_div(g, grad_accum), grads)
        if grad_transform is not None:
            grads = grad_transform(grads)
        gnorm = torch.zeros((), dtype=F32, device=mesh.device)
        if clip_norm is not None:
            grads, gnorm = clip_by_global_norm(
                grads, clip_norm, sharded_global_norm(grads, shardings))
        params, opt_state = optimizer.update(grads, opt_state, params,
                                             shardings=shardings)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step
