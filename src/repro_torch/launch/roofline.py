"""Roofline of the dry run's records on an NVIDIA H100 (the port of the
reference's `benchmarks/roofline.py`; it sits in the package because the
port has no benchmark folder of its own yet).

Per (arch x shape x mesh) cell, per rank:
    compute term    = sum over dtypes of dot FLOPs / the card's dense peak
                      for that dtype                               [s/step]
    memory term     = (argument + output bytes + act_bytes_estimate)
                      / HBM bandwidth                              [s/step]
    collective term = collective result bytes / link bandwidth     [s/step]
    bound           = the largest of the three, and which one it is.

Dot FLOPs and collective bytes come from `launch/hlo_analysis.py` (the
aten ops the port's step dispatches, on meta tensors); argument and
output bytes from the dry run's memory record. MODEL_FLOPS = 6·N·T
(train) / 2·N·T (serve), N the ACTIVE parameters of the abstract tree
(MoE top-1: 1/E of the routed experts), T the step's tokens; its ratio
to the counted FLOPs shows remat and repeated compute (the sharded train
step repeats compute across the model axis, ROADMAP C24).

Constants: the data sheet of the NVIDIA H100 80GB HBM3 (SXM5) at its 700 W
power limit. The link term is NVLink 4's rate, the hardware's: the port's
collectives run over gloo today, measured at 0.32-0.37 GB/s on one card
(PERF.md §5), so a step on real ranks would take far longer than this
term says.

Usage: PYTHONPATH=src python -m repro_torch.launch.roofline [--mesh multi]
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from repro_torch import _tree
from repro_torch.launch.dryrun import RESULTS

# NVIDIA H100 80GB HBM3 (SXM5), 700 W, dense (no sparsity), data sheet:
PEAK_FLOPS = {
    "bf16": 989.4e12,   # tensor cores, bf16 (H100 SXM5, 700 W)
    "f16": 989.4e12,    # tensor cores, fp16 (H100 SXM5, 700 W)
    "tf32": 494.7e12,   # tensor cores, TF32 (H100 SXM5, 700 W)
    "f32": 66.9e12,     # FP32 outside the tensor cores (H100 SXM5, 700 W)
    "f64": 66.9e12,     # FP64 tensor cores (H100 SXM5, 700 W)
    "int8": 1979e12,    # tensor cores, INT8 TOP/s (H100 SXM5, 700 W)
}
HBM_BW = 3.35e12        # HBM3 bytes/s (H100 SXM5, 700 W)
LINK_BW = 450e9         # NVLink 4, bytes/s per direction (H100 SXM5)


def peak_flops(dtype: str, tf32: bool | None = None) -> float:
    """The card's dense peak for dots of `dtype`; f32 dots run at the TF32
    rate only where torch lets matmuls use TF32 (off by default)."""
    if tf32 is None:
        tf32 = torch.backends.cuda.matmul.allow_tf32
    if dtype == "f32" and tf32:
        return PEAK_FLOPS["tf32"]
    return PEAK_FLOPS.get(dtype, PEAK_FLOPS["f32"])


def _active_params(cfg) -> float:
    """Active parameter count (MoE: top-1 => 1/E of routed experts)."""
    from repro_torch.models.registry import abstract_params
    total = 0.0
    for name, leaf in _tree.named_leaves(abstract_params(cfg)):
        keys = name.split("__")
        n = float(leaf.numel())
        if "moe" in keys and keys[-1] in ("w_gate", "w_up", "w_down"):
            n /= cfg.num_experts          # top-1 routing
        total += n
    return total


def tokens(case) -> float:
    return float(case["batch"] * (1 if case["kind"] == "decode"
                                  else case["seq"]))


def model_flops(cfg, case) -> float:
    mult = 6.0 if case["kind"] == "train" else 2.0
    return mult * _active_params(cfg) * tokens(case)


def _dp(rec) -> int:
    """The batch-sharded ways of the record's mesh (1 on one device)."""
    n = 1
    for axis, size in (rec.get("mesh_shape") or {}).items():
        if axis != "model":
            n *= size
    return n


def act_bytes_estimate(cfg, case, dp: int) -> float:
    """Activation HBM traffic per rank (the reference's napkin model):
    train: 3 passes (fwd/bwd/remat-fwd) x L x tokens_rank x 4D x 2B;
    prefill: 1 pass; decode: negligible (single token)."""
    if case["kind"] == "decode":
        return 0.0
    toks = case["batch"] * case["seq"] / max(dp, 1)
    passes = 3.0 if case["kind"] == "train" else 1.0
    return passes * cfg.num_layers * toks * 4 * cfg.d_model * 2


def analyze_cell(rec: dict, cfg=None) -> dict | None:
    """The roofline of one "ok" record (None otherwise); `cfg` the record's
    config when it is not its arch's full one (a card check's)."""
    if rec.get("status") != "ok":
        return None
    from repro_torch.configs import get_config
    cfg = cfg or get_config(rec["arch"])
    case = rec["case"]
    mem = rec.get("memory", {})
    hbm = (mem.get("argument_size_in_bytes", 0)
           + mem.get("output_size_in_bytes", 0)
           + act_bytes_estimate(cfg, case, _dp(rec)))
    compute_s = sum(f / peak_flops(dt)
                    for dt, f in rec["dot_flops_by_dtype"].items())
    memory_s = hbm / HBM_BW
    coll_s = rec["collectives"]["total"] / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s, "collective": coll_s}
    dominant = max(terms, key=terms.get)
    bound_s = terms[dominant]
    mf = model_flops(cfg, case)
    devices = rec["devices"]
    useful_s = (mf / devices) / PEAK_FLOPS["bf16"]
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "devices": devices, "compute_s": compute_s, "memory_s": memory_s,
        "collective_s": coll_s, "bound_s": bound_s, "dominant": dominant,
        "model_flops": mf, "dot_flops_dev": rec["dot_flops"],
        "useful_ratio": (mf / devices) / max(rec["dot_flops"], 1.0),
        "roofline_fraction": useful_s / bound_s if bound_s else 0.0,
        "peak_gb": mem.get("peak_memory_in_bytes", 0) / 1e9,
        "fits": rec.get("fits"),
    }


def run(verbose: bool = True, results_path: str = RESULTS,
        mesh: str = "single") -> dict:
    with open(results_path) as f:
        recs = json.load(f)
    rows = [analyze_cell(r) for r in recs if r.get("mesh") == mesh]
    rows = [r for r in rows if r]
    rows.sort(key=lambda r: (r["arch"], r["shape"]))
    if verbose:
        print(f"== Roofline ({mesh} mesh, per rank; NVIDIA H100 80GB HBM3 "
              "data sheet at 700 W) ==")
        print(f"{'arch':>26} {'shape':>11} {'compute_s':>10} "
              f"{'memory_s':>9} {'coll_s':>9} {'bound':>10} "
              f"{'useful':>7} {'roofl%':>7} {'peak_GB':>8} fits")
        for r in rows:
            print(f"{r['arch']:>26} {r['shape']:>11} "
                  f"{r['compute_s']:>10.4f} {r['memory_s']:>9.4f} "
                  f"{r['collective_s']:>9.4f} {r['dominant']:>10} "
                  f"{r['useful_ratio']:>7.2f} "
                  f"{100 * r['roofline_fraction']:>6.1f}% "
                  f"{r['peak_gb']:>8.1f} {r['fits']}")
    checks = {"all cells analyzed": len(rows) >= 30}
    if verbose:
        for k, v in checks.items():
            print(f"{k}: {v}")
    return {"rows": rows, "checks": checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default=RESULTS)
    ap.add_argument("--mesh", choices=("single", "multi"), default="single")
    args = ap.parse_args(argv)
    out = run(results_path=args.results, mesh=args.mesh)
    return 0 if all(out["checks"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
