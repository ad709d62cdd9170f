"""Training launcher, the port of `repro.launch.train`.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        [--smoke] --steps 20 [--data 1 --model 1] [--grad-accum 2] \\
        [--compress-grads] [--ckpt-dir DIR] [--save-every 10] [--device cpu]

Trains on the synthetic LM stream (`data.lm_batches`) through the elastic
driver (`runtime.ElasticTrainer`): a step is the model's loss, its grads,
the optional INT8 error-feedback compression and the config's optimizer;
checkpoints go to --ckpt-dir every --save-every steps, and a run resumes
from the newest one there. Runs on the CUDA device unless `--device`
names another.

With `--data D --model M` and D * M > 1 the launcher spawns D * M ranks
(`collectives.spawn`), each on the same device (all on cuda:0 on a
one-card machine, talking over gloo), and the training state is sharded
over their (data, model) mesh by `distributed.sharding`'s rules (the
sharded step: `train.make_sharded_train_step`); a rank's failure ends the
run with a non-zero status. Every architecture of `configs.ARCH_IDS`
trains: an enc-dec batch carries zero frames (`frames` of (batch, seq,
d_model)) and a vlm batch zero patch embeddings (`prefix_embeds` of
(batch, num_prefix_embeds, d_model)), as in the reference; the SSM and
hybrid families read `tokens` and `labels` only.
"""
from __future__ import annotations

import argparse
import importlib
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch import _tree
from repro_torch._device import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data import LMTaskConfig, lm_batches, shard_batch
from repro_torch.distributed import collectives, compression
from repro_torch.distributed import sharding as sh
from repro_torch.models import get_model
from repro_torch.runtime import ElasticTrainer
from repro_torch.train import (get_optimizer, make_sharded_train_step,
                               make_train_step)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true",
                    help="INT8 error-feedback gradient compression")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--save-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    return ap


def _model(args):
    cfg = get_config(args.arch, smoke=args.smoke)
    return cfg, get_model(cfg), get_optimizer(cfg.optimizer, lr=args.lr)


def _batches(cfg, args):
    """The LM stream's batches; an enc-dec's with zero frames, a vlm's with
    zero patch embeddings."""
    for batch in lm_batches(LMTaskConfig(vocab_size=cfg.vocab_size,
                                         seq_len=args.seq,
                                         batch_size=args.batch)):
        if cfg.family == "encdec":
            batch["frames"] = np.zeros((args.batch, args.seq, cfg.d_model),
                                       np.float32)
        if cfg.family == "vlm":
            batch["prefix_embeds"] = np.zeros(
                (args.batch, cfg.num_prefix_embeds, cfg.d_model), np.float32)
        yield batch


def _trainer(args, make_state) -> ElasticTrainer:
    return ElasticTrainer(make_state=make_state,
                          ckpt=CheckpointManager(args.ckpt_dir, keep=3),
                          save_every=args.save_every,
                          model_parallel=args.model)


def _train_one(args, dev) -> dict:
    """One process on one device."""
    cfg, api, opt = _model(args)
    err_state = {}

    def make_state(mesh):
        slot = mesh.slots()[0]
        params = api.init(torch.Generator(device=slot).manual_seed(0),
                          device=slot)
        opt_state = opt.init(params)

        grad_transform = None
        if args.compress_grads:
            err_state["e"] = compression.init_error_state(params)

            def grad_transform(grads):  # noqa: F811
                g, err_state["e"] = compression.apply_error_feedback(
                    grads, err_state["e"])
                return g

        raw = make_train_step(api.loss_fn, opt, grad_accum=args.grad_accum,
                              grad_transform=grad_transform)

        def step_fn(p, o, b, mesh):
            return raw(p, o, b)

        return params, opt_state, step_fn, None

    batches = (shard_batch(b, dev) for b in _batches(cfg, args))
    return _trainer(args, make_state).run(batches, num_steps=args.steps,
                                          devices=[dev])


def _train_rank(world: collectives.World, args) -> dict:
    """One rank of a sharded run: every rank draws the whole initial state
    from the same seed and keeps its blocks."""
    cfg, api, opt = _model(args)
    err_state = {}

    def make_state(mesh):
        full = api.init(torch.Generator(device=mesh.device).manual_seed(0),
                        device=mesh.device)
        pshard = sh.param_shardings(full, mesh, cfg)
        params = sh.shard_tree(full, pshard)
        meta = _tree.tree_map(lambda t: t.to("meta"), full)
        del full
        oshard = sh.opt_state_shardings(opt.init(meta), meta, mesh, cfg)
        opt_state = opt.init(params)

        grad_transform = None
        if args.compress_grads:
            err_state["e"] = compression.init_error_state(params)

            def grad_transform(grads):  # noqa: F811
                g, err_state["e"] = compression.apply_error_feedback(
                    grads, err_state["e"], pshard)
                return g

        raw = make_sharded_train_step(api.loss_fn, opt, mesh, pshard,
                                      grad_accum=args.grad_accum,
                                      grad_transform=grad_transform)

        def step_fn(p, o, b, mesh):
            return raw(p, o, b)

        return params, opt_state, step_fn, (pshard, oshard)

    return _trainer(args, make_state).run(_batches(cfg, args),
                                          num_steps=args.steps, world=world)


def main(argv=None):
    args = _parser().parse_args(argv)
    if args.data < 1 or args.model < 1:
        raise ValueError(f"mesh axes must be >= 1, got ({args.data}, "
                         f"{args.model})")
    _model(args)                      # refuse a bad config, up front
    dev = resolve_device(args.device)
    t0 = time.time()
    ranks = args.data * args.model
    if ranks > 1:
        # by module name, so the ranks can import it under `-m` too
        fn = importlib.import_module("repro_torch.launch.train")._train_rank
        out = collectives.spawn(fn, ranks, args, device=dev)[0]
    else:
        out = _train_one(args, dev)
    dt = time.time() - t0
    losses = out["losses"]
    loss = (f"loss {losses[0]:.3f} -> {losses[-1]:.3f}" if losses
            else f"no step run (resumed at step {args.steps})")
    print(f"{args.arch}: {args.steps} steps in {dt:.1f}s; {loss}; "
          f"restarts {out['restarts']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
