"""Measured block-shape autotuner for the stage-1, sign and fused top-k
kernels (the port of `repro.kernels.autotune`).

Each tunable wrapper in `ops` takes a block knob and, when the caller
passes None, resolves it here:

    table = autotune.autotune()          # time candidates on this card
    autotune.install(table)              # ops.* wrappers now consult it
    table.save("BENCH_autotune.json")    # artifact, keyed by the card

What the knob is, per family (the reference's five names):

  stage1_single, stage1_batched, stage1_rows, stage0_sign — rows per
      thread block of the plane, rows and dense sign kernels (one of
      `stage1_int4.ROWS_CHOICES`, default `DEFAULT_ROWS` = 256). A pure
      schedule knob: it never changes a result.
  fused_topk — `block_n`, the segment each per-block top-k is taken over
      (default `fused_topk.DEFAULT_BLOCK_N` = 512), as in the reference.
      It changes the kernel's raw (B, N / block_n, k) output, but with
      k_per_block >= c the merged candidates of `ops.fused_candidates*`
      are the same at every block_n.

The search grid is (kernel, batch bucket) x candidates; batch buckets are
powers of two, as the serving runtime pads batches. The default is always
a candidate and wins ties, so `speedup_vs_default >= 1.0` holds in every
entry by construction. A candidate that does not launch (a rows count
that is not a compiled instance, or a block the kernel refuses) is left
out of the entry and its reason kept under "left_out". Every rep of a
timing ends in `torch.cuda.synchronize()`. Tables are stamped with
`device_signature()` (the CUDA device's name and a backend string naming
the framework), so an artifact written by the JAX autotuner, or on
another card, is refused, and a lookup without an installed table returns
the default: no table means exactly the untuned schedule.

Set ``REPRO_TORCH_AUTOTUNE_CACHE=/path/to/table.json`` to have every
`RetrievalEngine` load and install the artifact at construction.
"""
from __future__ import annotations

import functools
import json
import math
import os
import time
from typing import Callable

import torch

from repro_torch._device import resolve_device
from repro_torch.kernels import fused_topk as _fk
from repro_torch.kernels import stage1_int4 as _s1

SCHEMA_VERSION = 1

#: Kernels with a free block knob, by the names used in table entries.
KERNELS = ("stage1_single", "stage1_batched", "stage1_rows", "fused_topk",
           "stage0_sign")

DEFAULT_CANDIDATES = (128, 256, 512, 1024, 2048)
DEFAULT_BATCHES = (1, 8, 32)
ENV_CACHE = "REPRO_TORCH_AUTOTUNE_CACHE"


def default_block(kernel: str) -> int:
    """The knob every lookup falls back to for `kernel`."""
    return _fk.DEFAULT_BLOCK_N if kernel == "fused_topk" else _s1.DEFAULT_ROWS


def device_signature(device: torch.device | str | None = None) -> dict:
    """(device_kind, backend, interpret): the key a tuned table is valid
    for. On a CUDA device the card's name and "torch-cuda"; on the CPU,
    where the wrappers run their plain versions, "cpu" and "torch-cpu"
    (interpret True, as the reference marks its interpreter)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return {"device_kind": torch.cuda.get_device_name(dev),
                "backend": "torch-cuda", "interpret": False}
    return {"device_kind": dev.type, "backend": f"torch-{dev.type}",
            "interpret": True}


def _pow2_bucket(batch: int) -> int:
    return 1 << max(0, math.ceil(math.log2(max(1, int(batch)))))


class TuneTable:
    """A measured (kernel, batch bucket) -> block map for one device.

    entries: {"<kernel>/b<bucket>": {"kernel", "batch_bucket", "block_n",
    "timings_ms", "default_block_n", "default_ms", "speedup_vs_default"}}
    (plus "left_out" where a candidate did not launch).
    """

    def __init__(self, signature: dict, entries: dict | None = None,
                 meta: dict | None = None):
        self.signature = dict(signature)
        self.entries = dict(entries or {})
        self.meta = dict(meta or {})

    @staticmethod
    def key(kernel: str, batch_bucket: int) -> str:
        return f"{kernel}/b{batch_bucket}"

    def best(self, kernel: str, batch: int) -> int | None:
        """Tuned block for `kernel` at `batch`, or None if the kernel was
        never benched: the exact pow2 bucket first, else the nearest
        measured bucket (log distance)."""
        bucket = _pow2_bucket(batch)
        hit = self.entries.get(self.key(kernel, bucket))
        if hit is not None:
            return int(hit["block_n"])
        near = [e for e in self.entries.values() if e["kernel"] == kernel]
        if not near:
            return None
        pick = min(near, key=lambda e: abs(
            math.log2(max(1, e["batch_bucket"])) - math.log2(bucket)))
        return int(pick["block_n"])

    def to_json(self) -> dict:
        return {"schema": SCHEMA_VERSION, "signature": self.signature,
                "meta": self.meta, "entries": self.entries}

    @classmethod
    def from_json(cls, obj: dict, *, require_current_device: bool = True,
                  device: torch.device | str | None = None
                  ) -> "TuneTable | None":
        """Rebuild a table from its JSON form. None (never raises) when the
        payload is malformed, from another schema, or, with
        `require_current_device`, recorded on other hardware or by another
        framework than `device_signature(device)` names."""
        try:
            if obj.get("schema") != SCHEMA_VERSION:
                return None
            table = cls(obj["signature"], obj.get("entries", {}),
                        obj.get("meta", {}))
            for e in table.entries.values():
                int(e["block_n"]), str(e["kernel"]), int(e["batch_bucket"])
        except (AttributeError, KeyError, TypeError, ValueError):
            return None
        if (require_current_device
                and table.signature != device_signature(device)):
            return None
        return table

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)
            f.write("\n")


def load(path: str, device: torch.device | str | None = None
         ) -> TuneTable | None:
    """Load an artifact; None on a missing or corrupt file or a signature
    that does not match `device` (see `TuneTable.from_json`)."""
    try:
        with open(path) as f:
            obj = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    return TuneTable.from_json(obj, device=device)


# ---------------------------------------------------------------------------
# Install / lookup: the ops side of the contract
# ---------------------------------------------------------------------------

_INSTALLED: TuneTable | None = None


def install(table: TuneTable | None) -> None:
    """Make `table` the process-wide source the ops wrappers consult when
    their block argument is None."""
    global _INSTALLED
    _INSTALLED = table


def installed() -> TuneTable | None:
    return _INSTALLED


def clear_installed() -> None:
    install(None)


def lookup(kernel: str, batch: int, default: int) -> int:
    """The single resolution point: the installed table's choice for
    (kernel, batch bucket), else `default`."""
    if _INSTALLED is None:
        return default
    best = _INSTALLED.best(kernel, batch)
    return default if best is None else best


@functools.lru_cache(maxsize=None)
def _load_env_cache(path: str, device: str) -> TuneTable | None:
    return load(path, device)


def ensure_default_installed(device: torch.device | str | None = None
                             ) -> TuneTable | None:
    """Engine-construction hook: if ``REPRO_TORCH_AUTOTUNE_CACHE`` names a
    valid artifact for `device`, install it (once: memoized per path and
    device) unless a table is installed already. A stale or unreadable
    artifact leaves the default in place."""
    path = os.environ.get(ENV_CACHE)
    if not path:
        return _INSTALLED
    table = _load_env_cache(path, str(resolve_device(device)))
    if table is not None and _INSTALLED is None:
        install(table)
    return _INSTALLED


# ---------------------------------------------------------------------------
# Measurement
# ---------------------------------------------------------------------------

def _timed_ms(fn: Callable[[], object], reps: int,
              device: torch.device) -> float:
    """Median host-clock time of `fn` with every rep synchronized, so the
    time is the device's work and not the enqueue."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    fn()
    sync()
    ts = []
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        fn()
        sync()
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2] * 1e3


def _runner(kernel: str, gen: torch.Generator, *, n: int, d: int,
            batch: int, device: torch.device):
    """(make(block) -> thunk, max_block) for one (kernel, batch) point, or
    (None, 0) when the point is not meaningful (a batched single)."""
    from repro_torch.kernels import ops  # deferred: ops imports this module

    def rand(shape, lo, hi, dtype):
        return torch.randint(lo, hi, shape, generator=gen, device=device,
                             dtype=dtype)

    if kernel == "stage1_single" and batch != 1:
        return None, 0
    if kernel == "stage0_sign" and d % 8:
        return None, 0
    q = rand((batch, d), -8, 8, torch.int8)
    if kernel == "stage0_sign":
        sign_plane = rand((n, d // 8), 0, 256, torch.uint8)
        q_sign = ops.pack_query_signs(q)
        return (lambda bn: lambda: ops.stage0_sign_scores_batched(
            q_sign, sign_plane, block_n=bn)), n
    if kernel == "stage1_rows":
        # per-lane row views (arena windows, gathered probe rows)
        w = min(n, 2048)
        rows = rand((batch, w, d // 2), 0, 256, torch.uint8)
        return (lambda bn: lambda: ops.stage1_scores_rows(
            q, rows, block_w=bn)), w
    plane = rand((n, d // 2), 0, 256, torch.uint8)
    if kernel == "stage1_single":
        q0 = q[0]
        return (lambda bn: lambda: ops.stage1_scores(
            q0, plane, block_n=bn)), n
    if kernel == "stage1_batched":
        return (lambda bn: lambda: ops.stage1_scores_batched(
            q, plane, block_n=bn)), n
    if kernel == "fused_topk":
        # k_per_block == c keeps the fused candidates exact at every block
        c = min(16, n)
        if batch == 1:
            q0 = q[0]
            return (lambda bn: lambda: ops.fused_candidates(
                q0, plane, c=c, k_per_block=c, block_n=bn)), n
        return (lambda bn: lambda: ops.fused_candidates_batched(
            q, plane, c=c, k_per_block=c, block_n=bn)), n
    raise ValueError(f"unknown kernel {kernel!r}")


def autotune(*, n: int = 2048, d: int = 256,
             batches: tuple[int, ...] = DEFAULT_BATCHES,
             candidates: tuple[int, ...] = DEFAULT_CANDIDATES,
             reps: int = 3, seed: int = 0,
             kernels: tuple[str, ...] = KERNELS,
             device: torch.device | str | None = None,
             verbose: bool = False) -> TuneTable:
    """Time every (kernel, batch bucket, block) point on `device` (the
    CUDA device unless the caller asks for the CPU) and keep the argmin.

    The family's default is always a candidate and wins ties, so
    `speedup_vs_default >= 1.0` holds at every entry. The fused family's
    candidates are clamped to N, as the reference clamps them; a candidate
    whose first call raises (it does not launch) is left out, with its
    reason under the entry's "left_out"; the default never is."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    table = TuneTable(device_signature(dev),
                      meta={"n": n, "d": d, "reps": reps, "seed": seed,
                            "candidates": list(candidates),
                            "default_block_n": _s1.DEFAULT_ROWS,
                            "fused_default_block_n": _fk.DEFAULT_BLOCK_N})
    for kernel in kernels:
        default = default_block(kernel)
        for batch in batches:
            make, max_block = _runner(kernel, gen, n=n, d=d, batch=batch,
                                      device=dev)
            if make is None:
                continue
            if kernel == "fused_topk":
                clamp = max(8, max_block)
                cands = {min(int(c), clamp) for c in candidates}
                default = min(default_block(kernel), clamp)
            else:
                cands = {int(c) for c in candidates}
            left_out = {}
            timings = {}
            for c in sorted(cands | {default}):
                if c != default:
                    try:
                        make(c)()
                    except (ValueError, RuntimeError) as err:
                        left_out[str(c)] = str(err)
                        continue
                timings[c] = _timed_ms(make(c), reps, dev)
            # argmin; ties prefer the default
            chosen = min(timings, key=lambda c: (timings[c], c != default))
            bucket = _pow2_bucket(batch)
            entry = {"kernel": kernel, "batch_bucket": bucket,
                     "block_n": chosen,
                     "timings_ms": {str(c): timings[c] for c in timings},
                     "default_block_n": default,
                     "default_ms": timings[default],
                     "speedup_vs_default": timings[default] / timings[chosen]}
            if left_out:
                entry["left_out"] = left_out
            table.entries[TuneTable.key(kernel, bucket)] = entry
            if verbose:
                print(f"  autotune {kernel:>15s} b{bucket:<3d} -> block "
                      f"{chosen:>4d} ({entry['speedup_vs_default']:.3f}x vs "
                      f"default {default}); left out: "
                      f"{sorted(left_out, key=int) or 'none'}", flush=True)
                for c, why in left_out.items():
                    print(f"    candidate {c}: {why}", flush=True)
    return table
