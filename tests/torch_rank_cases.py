"""Rank-side halves of tests/test_torch_sharded_train.py.

Each function runs in one rank spawned by `repro_torch.distributed.
collectives.spawn` (gloo on the CPU, a file store), imports only torch,
numpy and the port (no JAX: a rank imports this module, not the test
file), and returns numpy results for the test to hold against the
one-process port and the reference.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from repro_torch import _tree, convert
from repro_torch.checkpoint import (CheckpointManager, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import get_config
from repro_torch.distributed import compression
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import get_model
from repro_torch.runtime import ElasticTrainer, FailureInjector
from repro_torch.train import adafactor, adamw, make_sharded_train_step

# name -> (optimizer, steps, grad_accum, clip_norm, compress). With
# grad_accum 2 on 2 data ranks each rank's rows are one microbatch, so the
# grads equal the one-process step's bit for bit (the "aligned" cases);
# with grad_accum 1 the batch's two halves are summed across ranks, in
# another order than one process sums them.
STEP_CASES = {
    "adamw": (lambda: adamw(lr=1e-3, weight_decay=0.1), 2, 1, 1.0, False),
    # no clipping where the parameters are held: a clip scale an ulp
    # apart moves near-zero grads' Adam updates at the next step
    "adamw_accum2": (lambda: adamw(lr=1e-3, weight_decay=0.1), 2, 2, None,
                     False),
    "adafactor": (lambda: adafactor(lr=1e-3), 1, 2, 1.0, False),
    # no clipping: its norm sums in another order on a sharded state, and
    # a 1-ulp scale can move an INT8 code across its rounding boundary
    "adamw_compressed": (lambda: adamw(lr=1e-3), 2, 2, None, True),
}


# The MoE SMOKE model (scout's, capacity 1.0 so tokens drop) one AdamW
# step on the (2, 2) mesh: grad_accum 1, each data rank's rows one chunk
# of the microbatch's capacity; grad_accum 2, each rank's rows a whole
# microbatch of two chunks (the reference's shard-aligned dispatch).
MOE_CASES = {"moe": 1, "moe_accum2": 2}


# The SSM, hybrid and enc-dec SMOKE models (f32 compute) one AdamW step
# on the (2, 2) mesh with grad_accum 1: each data rank's rows are half of
# the microbatch, and the two halves' grads are summed across ranks. The
# enc-dec's batch carries frames (`family_batch`).
FAMILY_CASES = {"ssm": "mamba2-2.7b", "hybrid": "zamba2-2.7b",
                "encdec": "seamless-m4t-medium"}
FAMILY_TO_PORT = {"ssm": convert.ssm_params,
                  "hybrid": convert.hybrid_params,
                  "encdec": convert.encdec_params}


def aligned(name) -> bool:
    return STEP_CASES[name][2] == 2


def transform_with(grads_seen, compress, params, shardings=None):
    """A grad_transform that records the grads it is given (as numpy, whole
    leaves) and then applies INT8 error feedback when asked."""
    err = {"e": compression.init_error_state(params)}

    def transform(g):
        whole = g if shardings is None else sh.gather_tree(g, shardings)
        grads_seen.append(_numpy(whole))
        if compress:
            g, err["e"] = compression.apply_error_feedback(g, err["e"],
                                                           shardings)
        return g
    return transform


def smoke():
    cfg = get_config("qwen2-0.5b", smoke=True).with_(
        vocab_size=64, compute_dtype="float32")
    return cfg, get_model(cfg)


def moe_smoke():
    cfg = get_config("llama4-scout-17b-a16e", smoke=True).with_(
        compute_dtype="float32", capacity_factor=1.0)
    return cfg, get_model(cfg)


def family_smoke(family):
    cfg = get_config(FAMILY_CASES[family], smoke=True).with_(
        compute_dtype="float32")
    return cfg, get_model(cfg)


def batch(frames_dim: int = 0):
    """The (8, 16) batch every case trains on; two rows carry padding
    labels, so the global count of labelled positions matters. With
    `frames_dim`, (8, 16, frames_dim) source frames drawn from the same
    seed after the tokens."""
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 64, (8, 16)).astype(np.int32)
    labels = toks.copy()
    labels[1, :5] = -1
    labels[6, 3:] = -1
    out = {"tokens": toks, "labels": labels}
    if frames_dim:
        out["frames"] = rng.standard_normal((8, 16, frames_dim)).astype(
            np.float32)
    return out


def family_batch(family):
    """`batch()` as a FAMILY_CASES model takes it: the enc-dec's with
    frames of its d_model."""
    cfg, _ = family_smoke(family)
    return batch(cfg.d_model if cfg.family == "encdec" else 0)


def abstract(tree):
    return _tree.tree_map(lambda t: torch.empty_like(t, device="meta"), tree)


def sharded_state(mesh, cfg, opt, host, to_port=convert.dense_params):
    """(param blocks, opt-state blocks, param shardings, opt shardings)
    from the whole host params, on every rank alike."""
    full = to_port(host, device="cpu")
    meta = abstract(full)
    pshard = sh.param_shardings(full, mesh, cfg)
    oshard = sh.opt_state_shardings(opt.init(meta), meta, mesh, cfg)
    params = sh.shard_tree(full, pshard)
    return params, opt.init(params), pshard, oshard


def whole_state(host, opt):
    """(params, opt state) of whole-leaf shapes, as meta tensors."""
    meta = abstract(convert.dense_params(host, device="cpu"))
    return meta, opt.init(meta)


def _numpy(tree):
    return _tree.tree_map(lambda t: t.detach().cpu().numpy(), tree)


def moe_steps(mesh, host, batch) -> dict:
    """Each MOE_CASES entry: (loss, grads) of one sharded AdamW step."""
    cfg, api = moe_smoke()
    out = {}
    for name, accum in MOE_CASES.items():
        opt = adamw(lr=1e-3)
        params, state, pshard, _ = sharded_state(mesh, cfg, opt, host,
                                                 convert.moe_params)
        grads = []
        step = make_sharded_train_step(
            api.loss_fn, opt, mesh, pshard, grad_accum=accum, clip_norm=None,
            grad_transform=transform_with(grads, False, params, pshard))
        m = step(params, state, batch)[2]
        out[name] = {"loss": float(m["loss"]), "grads": grads[0]}
    return out


def family_steps(mesh, hosts) -> dict:
    """Each FAMILY_CASES entry in `hosts` (family -> its SMOKE params):
    (loss, grads) of one sharded AdamW step on its `family_batch`."""
    out = {}
    for family, host in hosts.items():
        cfg, api = family_smoke(family)
        opt = adamw(lr=1e-3)
        params, state, pshard, _ = sharded_state(mesh, cfg, opt, host,
                                                 FAMILY_TO_PORT[family])
        grads = []
        step = make_sharded_train_step(
            api.loss_fn, opt, mesh, pshard, clip_norm=None,
            grad_transform=transform_with(grads, False, params, pshard))
        m = step(params, state, family_batch(family))[2]
        out[family] = {"loss": float(m["loss"]), "grads": grads[0]}
    return out


def step_cases(world, host, batch, ref_ckpt, out_ckpt, moe_host=None,
               family_hosts=None):
    """Every STEP_CASES entry on a (2, 2) mesh from the same host params
    and batch; then a sharded save of the AdamW state into `out_ckpt` and
    a sharded restore of the reference-written `ref_ckpt`; with
    `moe_host` (the MoE SMOKE params) the MOE_CASES too, and with
    `family_hosts` the FAMILY_CASES."""
    mesh = make_test_mesh(2, 2, world=world)
    cfg, api = smoke()
    out = {} if moe_host is None else moe_steps(mesh, moe_host, batch)
    if family_hosts:
        out.update(family_steps(mesh, family_hosts))
    for name, (make_opt, steps, accum, clip, compress) in STEP_CASES.items():
        opt = make_opt()
        params, state, pshard, oshard = sharded_state(mesh, cfg, opt, host)
        grads = []
        step = make_sharded_train_step(
            api.loss_fn, opt, mesh, pshard, grad_accum=accum, clip_norm=clip,
            grad_transform=transform_with(grads, compress, params, pshard))
        losses, norms = [], []
        for _ in range(steps):
            params, state, m = step(params, state, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        whole = whole_state(host, opt)
        out[name] = {
            "losses": losses, "grads": grads, "norms": norms,
            "params": _numpy(sh.gather_tree(params, pshard)),
            "state": _numpy(sh.gather_tree(state, oshard)),
            "resident": sh.resident_bytes((params, state)),
            "blocks": sh.block_bytes(whole, (pshard, oshard)),
            "whole": sum(t.numel() * t.element_size()
                         for t in _tree.leaves(whole))}
        if name == "adamw":
            save_checkpoint(out_ckpt, 2, (params, state), (pshard, oshard))
            written = (params, state)
    opt = adamw(lr=1e-3)
    params, state, pshard, oshard = sharded_state(mesh, cfg, opt, host)
    got, step = restore_checkpoint(ref_ckpt, (params, state),
                                   shardings=(pshard, oshard))
    out["restored"] = {"step": step, "leaves": [
        (block.numpy(), sh.block_slices(tuple(whole.shape), s))
        for block, whole, s in zip(_tree.leaves(got),
                                   _tree.leaves(whole_state(host, opt)),
                                   _tree.leaves((pshard, oshard)),
                                   strict=True)]}
    out["written_blocks"] = _numpy(written)
    return out


def two_level(world, g):
    """This rank's row of `g` through make_two_level_all_reduce on a
    (pod 2, data 4) mesh (or (1, 1) for one rank)."""
    shape = (2, 4) if world.size == 8 else (1, 1)
    mesh = world.join(range(world.size), shape, ("pod", "data"), "two_level")
    fn = compression.make_two_level_all_reduce(mesh)
    row = torch.from_numpy(np.array(g[world.rank:world.rank + 1]))
    return fn({"w": row})["w"].numpy()


def elastic(world, host, batch, ckpt_dir, steps, save_every, fail_at, drop):
    """The sharded ElasticTrainer on a (2, 2) mesh that loses `drop` ranks
    at step `fail_at`; also each generation's resident and block bytes."""
    cfg, api = smoke()
    opt = adamw(lr=1e-3)
    sizes = []

    def make_state(mesh):
        params, state, pshard, oshard = sharded_state(mesh, cfg, opt, host)
        sizes.append((dict(mesh.shape), sh.resident_bytes((params, state)),
                      sh.block_bytes(whole_state(host, opt),
                                     (pshard, oshard))))
        raw = make_sharded_train_step(api.loss_fn, opt, mesh, pshard)
        return (params, state, lambda p, o, b, mesh: raw(p, o, b),
                (pshard, oshard))

    trainer = ElasticTrainer(make_state=make_state,
                             ckpt=CheckpointManager(ckpt_dir, keep=5),
                             save_every=save_every, model_parallel=2)
    out = trainer.run(itertools.repeat(batch), num_steps=steps,
                      injector=FailureInjector({fail_at: drop}), world=world)
    out["sizes"] = sizes
    return out


def fail_on_rank_one(world):
    if world.rank == 1:
        raise ValueError("rank one fails")
    return world.rank


def device_of(world):
    return str(world.device)
