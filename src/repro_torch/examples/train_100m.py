"""Training example: a ~100M-parameter dense LM on the synthetic learnable
stream, with checkpointing + the elastic restart harness (the port of
examples/train_100m.py).

The default is a small smoke run; pass --full for the ~100M model (12
layers x 768, a 32k vocabulary).

    PYTHONPATH=src python -m repro_torch.examples.train_100m \\
        [--steps 20] [--full] [--batch 8] [--seq 128] [--ckpt-dir DIR] \\
        [--device cpu]

A run resumes from the newest checkpoint in --ckpt-dir.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch._device import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import LMTaskConfig, lm_batches, shard_batch
from repro_torch.examples import seeded_params
from repro_torch.models import get_model
from repro_torch.models.common import ModelConfig, param_count
from repro_torch.runtime import ElasticTrainer
from repro_torch.train import adamw, make_train_step

# ~100M params: 12L x 768 with a 32k vocab
CFG_100M = ModelConfig(name="lm-100m", family="dense", num_layers=12,
                       d_model=768, num_heads=12, num_kv_heads=4,
                       d_ff=2048, vocab_size=32768, attn_chunk=512)

CFG_SMOKE = CFG_100M.with_(num_layers=4, d_model=256, d_ff=512,
                           num_heads=8, num_kv_heads=4, vocab_size=2048)


def run(cfg: ModelConfig, params, *, steps: int, batch: int, seq: int,
        ckpt_dir: str, device: torch.device) -> dict:
    """Trains `cfg` from `params` (the initial state, on `device`, left
    untouched) for `steps` steps and prints the log. Returns the trainer's
    result ({"losses", "restarts", ...})."""
    api = get_model(cfg)
    opt = adamw(lr=3e-4, weight_decay=0.01)
    print(f"model: {cfg.name} ({param_count(params)/1e6:.1f}M params, "
          f"{'full' if cfg == CFG_100M else 'smoke'})")
    raw = make_train_step(api.loss_fn, opt)

    def make_state(mesh):
        # the update and a restore make new tensors: `params` stays as given
        return params, opt.init(params), (
            lambda p, o, b, mesh: raw(p, o, b)), None

    gen = lm_batches(LMTaskConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                  batch_size=batch))
    batches = (shard_batch(b, device) for b in gen)

    trainer = ElasticTrainer(make_state=make_state,
                             ckpt=CheckpointManager(ckpt_dir, keep=2),
                             save_every=max(5, steps // 4))
    t0 = time.time()
    out = trainer.run(batches, num_steps=steps, devices=[device])
    dt = time.time() - t0
    losses = out["losses"]
    print(f"{steps} steps in {dt:.1f}s ({dt/steps:.2f}s/step)")
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"(mean first 5: {sum(losses[:5])/5:.3f}, "
          f"last 5: {sum(losses[-5:])/5:.3f})")
    print(f"checkpoints under {ckpt_dir} (atomic, latest-2)")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--full", action="store_true",
                    help="use the real 100M config (slow on the CPU)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt_100m"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = CFG_100M if args.full else CFG_SMOKE
    run(cfg, seeded_params(get_model(cfg).init, 0, dev), steps=args.steps,
        batch=args.batch, seq=args.seq, ckpt_dir=args.ckpt_dir, device=dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
