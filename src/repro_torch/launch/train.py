"""Training launcher, the port of `repro.launch.train`.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        [--smoke] --steps 20 [--grad-accum 2] [--compress-grads] \\
        [--ckpt-dir DIR] [--save-every 10] [--device cpu]

Trains on the synthetic LM stream (`data.lm_batches`) through the elastic
driver (`runtime.ElasticTrainer`): a step is the model's loss, its grads,
the optional INT8 error-feedback compression and the config's optimizer;
checkpoints go to --ckpt-dir every --save-every steps, and a run resumes
from the newest one there. Runs on the CUDA device unless `--device`
names another. One device: `--data`/`--model` above 1 (a sharded
training state) wait for ROADMAP A2's training half, and the families
the port lacks for A3.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch._device import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCH_IDS, NOT_PORTED, get_config
from repro_torch.data import LMTaskConfig, lm_batches, shard_batch
from repro_torch.distributed import compression
from repro_torch.models import get_model
from repro_torch.runtime import ElasticTrainer
from repro_torch.train import get_optimizer, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS + NOT_PORTED,
                    default="qwen2-0.5b")
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
    args = ap.parse_args(argv)

    if args.data * args.model > 1:
        raise NotImplementedError(
            f"--data {args.data} --model {args.model}: a training state "
            "sharded over a mesh waits for ROADMAP A2's training half "
            "(the sharding rules, the two-level all-reduce, "
            "torch.distributed); the port trains on one device")
    cfg = get_config(args.arch, smoke=args.smoke)
    api = get_model(cfg)
    opt = get_optimizer(cfg.optimizer, lr=args.lr)
    dev = resolve_device(args.device)

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

    gen = lm_batches(LMTaskConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                                  batch_size=args.batch))
    batches = (shard_batch(b, dev) for b in gen)

    trainer = ElasticTrainer(make_state=make_state,
                             ckpt=CheckpointManager(args.ckpt_dir, keep=3),
                             save_every=args.save_every,
                             model_parallel=args.model)
    t0 = time.time()
    out = trainer.run(batches, num_steps=args.steps, devices=[dev])
    dt = time.time() - t0
    losses = out["losses"]
    loss = (f"loss {losses[0]:.3f} -> {losses[-1]:.3f}" if losses
            else f"no step run (resumed at step {args.steps})")
    print(f"{args.arch}: {args.steps} steps in {dt:.1f}s; {loss}; "
          f"restarts {out['restarts']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
