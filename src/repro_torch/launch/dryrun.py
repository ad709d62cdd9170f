"""Dry run: one step of every (arch x shape x mesh) cell on meta tensors
(the port's counterpart of `repro.launch.dryrun`).

For each cell it builds abstract parameters, optimizer state, batches and
caches (meta tensors: shape and dtype, nothing allocated), runs the
port's own step on them once under `hlo_analysis.analyze`, and records
per rank:

    memory    argument, output and peak bytes; whether the peak fits the
              card (`fits`, against `card_bytes()`)
    cost      dot FLOPs (in total and by dtype) and the aten ops dispatched
    comms     collective result bytes and counts by kind, ring bytes sent

It answers, without a card, which steps fit an 80 GB H100 as the port
runs them, and feeds `launch/roofline.py`. What each kind of cell runs:

  * train: `make_sharded_train_step` on rank 0 of the mesh through a
    `collectives.DryMesh`, on its blocks of the parameters and optimizer
    state (`param_shardings`/`opt_state_shardings`); its batch block
    comes from `batch_shardings`. The step gathers every parameter whole
    and repeats compute across the model axis (ROADMAP C24), so its
    FLOPs and peak are the port's, not the reference's.
  * prefill / decode: `api.prefill` / `api.decode_step` on rank 0's batch
    block with whole parameters, as the port serves today (no
    model-parallel serving step, C24). `memory.spec_argument_bytes` is
    what the rules' blocks would hold (`param_shardings(serve=)`,
    `cache_shardings`, the batch block): the number the reference's
    `argument_size_in_bytes` corresponds to.
  * variant "opt": the reference's settings (bf16 weights and no remat
    for serving, the (64, 4) mesh for non-MoE training); "kvq": decode
    through `dense.decode_step_quant` on the paged + prescreen schedule
    (`KVQ`), whose kernels count as launches, not dots.

A cell that raises is recorded with status "error" and the run exits 1.

Usage (host only, no card):
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \\
        --shape decode_32k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Any, Callable

import torch

from repro_torch import _tree
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.collectives import DryMesh
from repro_torch.launch import hlo_analysis
from repro_torch.launch import shapes as shp
from repro_torch.launch.mesh import make_production_mesh, make_train_opt_mesh
from repro_torch.models import dense
from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import abstract_params, get_model
from repro_torch.train import (get_optimizer, make_sharded_train_step,
                               make_train_step)

# NVIDIA H100 80GB HBM3 (SXM5, 700 W): its `total_memory` as
# torch.cuda.get_device_properties reads it on the card (the `card_bytes`
# that chip_smoke.py's dryrun sweep prints; PERF.md section 6), so a sweep
# without a card gives the same `fits` as one on it.
H100_BYTES = 85_017_493_504
RESULTS = os.path.join("results", "dryrun_torch.json")
# decode_step_quant's schedule in the kvq variant: the card's decode phase
# (page rows, pages kept, sign-prescreen survivors, exact top-k).
KVQ = {"page_rows": 16, "npages_div": 8, "prescreen_c0": 1024, "top_k": 256}
VARIANTS = ("baseline", "opt", "kvq")


def card_bytes() -> int:
    """The card's memory: the CUDA device's where one is present, else an
    NVIDIA H100 80GB HBM3's as the card reads it."""
    if torch.cuda.is_available():
        return int(torch.cuda.get_device_properties(0).total_memory)
    return H100_BYTES


@dataclasses.dataclass
class Step:
    """One cell's step: fn(*args) on meta tensors, the DryMesh it runs on
    (train cells), the bytes one rank holds of each argument tensor (by
    id), and the argument bytes the sharding rules give a rank."""
    fn: Callable
    args: tuple
    mesh: Any = None
    hold: dict = dataclasses.field(default_factory=dict)
    argument_bytes: int = 0
    spec_argument_bytes: int | None = None


def serving_config(cfg: ModelConfig, kind: str, variant: str) -> ModelConfig:
    """The reference's per-variant settings: "opt" and "kvq" serve bf16
    weights without remat."""
    if variant in ("opt", "kvq") and kind != "train":
        return cfg.with_(param_dtype="bfloat16", remat=False)
    return cfg


def kvq_kwargs(seq: int) -> dict:
    """decode_step_quant's schedule at a cache of `seq` positions."""
    pr = KVQ["page_rows"]
    return {"top_k": KVQ["top_k"], "npages": seq // pr // KVQ["npages_div"],
            "prescreen_c0": KVQ["prescreen_c0"]}


def step_fn(cfg: ModelConfig, kind: str, *, seq: int = 0,
            variant: str = "baseline", mesh=None, shardings=None,
            lr: float = 1e-3) -> tuple[Callable, Any]:
    """(the step a cell runs, its optimizer or None): the function the
    dry run counts on meta and the card check runs for real."""
    api = get_model(cfg)
    if kind == "train":
        opt = get_optimizer(cfg.optimizer, lr=lr)
        if mesh is None:
            return make_train_step(api.loss_fn, opt), opt
        return make_sharded_train_step(api.loss_fn, opt, mesh,
                                       shardings), opt
    if kind == "prefill":
        def prefill(params, batch):
            with torch.no_grad():
                return api.prefill(params, batch, max_len=seq)
        return prefill, None
    if variant == "kvq":
        kw = kvq_kwargs(seq)

        def decode_quant(params, cache, tokens):
            with torch.no_grad():
                return dense.decode_step_quant(params, cache, tokens, cfg,
                                               **kw)
        return decode_quant, None

    def decode(params, cache, tokens):
        with torch.no_grad():
            return api.decode_step(params, cache, tokens)
    return decode, None


def _meta_like(t: torch.Tensor, shape=None) -> torch.Tensor:
    return torch.empty(tuple(t.shape) if shape is None else shape,
                       dtype=t.dtype, device="meta")


def cache_tree(cache) -> dict:
    """A cache dataclass as a dict of its tensor fields (the reference's
    cache pytree leaves, by name)."""
    return {f.name: getattr(cache, f.name) for f in dataclasses.fields(cache)
            if isinstance(getattr(cache, f.name), torch.Tensor)}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _rows(case: shp.ShapeCase, mesh) -> int:
    """Rows of the global batch that rank 0 runs (`batch_spec`)."""
    if mesh is None:
        return case.batch
    spec = sh.batch_spec((case.batch,), mesh)
    return case.batch // mesh.axes_size(spec[0])


def build_step(cfg: ModelConfig, case: shp.ShapeCase, mesh=None,
               variant: str = "baseline", src_len: int | None = None
               ) -> Step:
    """The cell's step on meta inputs. `mesh` a slot Mesh (its shape and
    axis names; rank 0 of it runs) or None for one device; `src_len` the
    enc-dec cache's source length (default: the case's seq)."""
    cfg = serving_config(cfg, case.kind, variant)
    dry = None if mesh is None else DryMesh(
        tuple(mesh.shape.values()), mesh.axis_names)
    aparams = abstract_params(cfg)
    if case.kind == "train":
        return _train(cfg, case, dry, aparams)
    if variant == "kvq" and (case.kind != "decode"
                             or cfg.family not in ("dense", "vlm")):
        raise ValueError("the kvq variant runs dense/vlm decode cells only")
    rows = _rows(case, dry)
    block = dataclasses.replace(case, batch=rows)
    fn, _ = step_fn(cfg, case.kind, seq=case.seq, variant=variant)
    serve = variant in ("opt", "kvq") and case.kind == "decode"
    spec = None
    if dry is not None:
        spec = sh.block_bytes(aparams, sh.param_shardings(aparams, dry, cfg,
                                                        serve=serve))
    pbytes = sum(_nbytes(t) for t in _tree.leaves(aparams))
    if case.kind == "prefill":
        batch = shp.abstract_batch(cfg, block)
        batch.pop("labels", None)
        bbytes = sum(_nbytes(t) for t in batch.values())
        return Step(fn, (aparams, batch), argument_bytes=pbytes + bbytes,
                    spec_argument_bytes=None if spec is None
                    else spec + bbytes)
    tokens = shp.abstract_decode_tokens(block)
    if variant == "kvq":
        cache = dense.init_quant_cache(cfg, rows, case.seq,
                                       page_rows=KVQ["page_rows"],
                                       device="meta")
        whole = dense.init_quant_cache(cfg, case.batch, case.seq,
                                       page_rows=KVQ["page_rows"],
                                       device="meta")
    else:
        api = get_model(cfg)
        cache = shp.abstract_cache(cfg, api, block, src_len)
        whole = shp.abstract_cache(cfg, api, case, src_len)
    cbytes = hlo_analysis.storage_bytes(cache)
    if spec is not None:
        tree = cache_tree(whole)
        spec += sh.block_bytes(tree, sh.cache_shardings(tree, dry, cfg))
        spec += _nbytes(tokens)
    return Step(fn, (aparams, cache, tokens),
                argument_bytes=pbytes + cbytes + _nbytes(tokens),
                spec_argument_bytes=spec)


def _train(cfg, case, dry, aparams) -> Step:
    batch = shp.abstract_batch(cfg, case)
    if dry is None:
        fn, opt = step_fn(cfg, "train")
        state = opt.init(aparams)
        nbytes = hlo_analysis.storage_bytes((aparams, state, batch))
        return Step(fn, (aparams, state, batch), argument_bytes=nbytes)
    pshard = sh.param_shardings(aparams, dry, cfg)
    fn, opt = step_fn(cfg, "train", mesh=dry, shardings=pshard)
    params = _tree.tree_map(
        lambda t, s: _meta_like(t, sh.local_shape(tuple(t.shape), s)),
        aparams, pshard)
    state = opt.init(params)
    bshard = sh.batch_shardings(batch, dry)
    hold = {id(t): 0 for t in batch.values()}     # the host batch
    nbytes = (hlo_analysis.storage_bytes((params, state))
              + sh.block_bytes(batch, bshard))
    return Step(fn, (params, state, batch), mesh=dry, hold=hold,
                argument_bytes=nbytes, spec_argument_bytes=nbytes)


def analyze_step(step: Step) -> dict:
    """The step run once on meta under the counting mode: its record."""
    t0 = time.perf_counter()
    _, rec = hlo_analysis.analyze(step.fn, *step.args, mesh=step.mesh,
                                  hold_bytes=step.hold)
    rec["trace_s"] = time.perf_counter() - t0
    return rec


def _mesh(arch_cfg, shape_name: str, mesh_kind: str, variant: str):
    multi = mesh_kind == "multi"
    if (variant == "opt" and shp.SHAPES[shape_name].kind == "train"
            and arch_cfg.family != "moe"):
        return make_train_opt_mesh(multi_pod=multi)
    return make_production_mesh(multi_pod=multi)


def record(cfg: ModelConfig, case: shp.ShapeCase, mesh=None,
           variant: str = "baseline", cap: int | None = None,
           src_len: int | None = None) -> dict:
    """The "ok" record of one step of `cfg` at `case` on rank 0 of `mesh`
    (None: one device): memory, `fits` (against `cap`, by default
    `card_bytes()`), dot FLOPs, kernel launches and collectives."""
    cap = card_bytes() if cap is None else cap
    t0 = time.perf_counter()
    step = build_step(cfg, case, mesh, variant, src_len)
    build_s = time.perf_counter() - t0
    an = analyze_step(step)
    mem = {"argument_size_in_bytes": int(step.argument_bytes),
           "output_size_in_bytes": an["output_bytes"],
           "peak_memory_in_bytes": an["peak_bytes"],
           "temp_size_in_bytes": an["peak_bytes"] - an["argument_bytes"]}
    if step.spec_argument_bytes is not None:
        mem["spec_argument_bytes"] = int(step.spec_argument_bytes)
    return {"status": "ok", "variant": variant,
            "devices": 1 if mesh is None else int(mesh.size), "rank": 0,
            "mesh_shape": None if mesh is None else dict(mesh.shape),
            "case": {"kind": case.kind, "batch": case.batch,
                     "seq": case.seq},
            "build_s": build_s, "trace_s": an["trace_s"], "memory": mem,
            "fits": an["peak_bytes"] <= cap, "card_bytes": cap,
            "cost": {"flops": an["dot_flops"], "ops": an["ops"]},
            "dot_flops": an["dot_flops"],
            "dot_flops_by_dtype": an["dot_flops_by_dtype"],
            "kernel_launches": an["kernel_launches"],
            "collectives": an["collectives"],
            "collective_counts": an["collective_counts"],
            "bytes_sent": an["bytes_sent"],
            "tensor_devices": an["tensor_devices"]}


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             verbose: bool = True, variant: str = "baseline",
             cap: int | None = None) -> dict:
    cfg = get_config(arch)
    ok, why = shp.applicable(cfg, shape_name)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "variant": variant}
    if ok and variant == "kvq" and (shp.SHAPES[shape_name].kind != "decode"
                                    or cfg.family not in ("dense", "vlm")):
        ok, why = False, ("skipped: the kvq variant runs dense/vlm decode "
                          "cells only")
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    mesh = _mesh(cfg, shape_name, mesh_kind, variant)
    rec.update(record(cfg, shp.SHAPES[shape_name], mesh, variant, cap))
    if verbose:
        print(f"  memory:        {rec['memory']} fits {rec['fits']}")
        print(f"  dot_flops/dev: {rec['dot_flops']:.3e} "
              f"{rec['dot_flops_by_dtype']}")
        print(f"  collectives:   {rec['collectives']} "
              f"sent {rec['bytes_sent']}")
        print(f"  trace_s:       {rec['trace_s']:.2f}")
    return rec


def _cell_job(cell) -> dict:
    """run_cell in a worker process; a cell that raises gives its error
    record (with the traceback)."""
    a, s, m, variant, cap = cell
    try:
        return run_cell(a, s, m, verbose=False, variant=variant, cap=cap)
    except Exception as e:  # noqa: BLE001 - recorded, the run exits 1
        return {"arch": a, "shape": s, "mesh": m, "variant": variant,
                "status": "error", "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()}


def sweep(cells, variant: str = "baseline", jobs: int = 1,
          cap: int | None = None):
    """Yield each cell's record as it ends: in this process, or over
    `jobs` spawned worker processes (each cell is independent host work;
    `cap`, the card's bytes, is read here so no worker touches a card)."""
    cap = card_bytes() if cap is None else cap
    todo = [(a, s, m, variant, cap) for a, s, m in cells]
    if jobs <= 1:
        for cell in todo:
            print(f"[dryrun] {cell[0]} x {cell[1]} x {cell[2]} ({variant})")
            yield _cell_job(cell)
        return
    import concurrent.futures as cf
    import multiprocessing as mp
    with cf.ProcessPoolExecutor(jobs, mp_context=mp.get_context("spawn")
                                ) as pool:
        futs = [pool.submit(_cell_job, cell) for cell in todo]
        for fut in cf.as_completed(futs):
            yield fut.result()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(shp.SHAPES))
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--variant", choices=VARIANTS, default="baseline")
    ap.add_argument("--out", default=RESULTS)
    ap.add_argument("--jobs", type=int, default=1,
                    help="worker processes for the cells (default 1)")
    args = ap.parse_args(argv)

    meshes = ("single", "multi") if args.mesh == "both" else (args.mesh,)
    if args.all:
        cells = [(a, s, m) for a in ARCH_IDS for s in shp.SHAPES
                 for m in meshes]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape, m) for m in meshes]

    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"]) for r in results
            if r.get("status") in ("ok", "skipped")
            and r.get("variant", "baseline") == args.variant}

    failures = 0
    t_all = time.perf_counter()
    for a, s, m in cells:
        if (a, s, m) in done:
            print(f"[cached] {a} x {s} x {m}")
    todo = [c for c in cells if c not in done]
    for rec in sweep(todo, args.variant, args.jobs):
        if rec["status"] == "error":
            print(rec.get("traceback", ""), file=sys.stderr)
            failures += 1
        key = (rec["arch"], rec["shape"], rec["mesh"])
        results = [r for r in results
                   if (r["arch"], r["shape"], r["mesh"]) != key]
        results.append(rec)
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"  {' x '.join(key)} -> {rec['status']}"
              + (f" ({rec['trace_s']:.1f} s)" if "trace_s" in rec else ""))
    print(f"done: {len(cells)} cells, {failures} failures, "
          f"{time.perf_counter() - t_all:.1f} s")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
