"""Dot FLOPs, collective bytes, kernel launches and peak memory of one step
(the port's counterpart of `repro.launch.hlo_analysis`).

torch has no HLO to parse: a step is Python that dispatches aten ops one
at a time. So this module counts the aten ops a step dispatches, under a
`TorchDispatchMode` that is active through its forward and its backward
(autograd carries the mode into the backward's recomputed blocks too):

  * dot FLOPs: 2 * prod(result dims) * prod(contracting dims) for the
    matmul class of aten ops (`mm`, `addmm`, `bmm`, `baddbmm`, `_int_mm`,
    `mv`, `addmv`, `dot`: what `linear`, `matmul` and `einsum` decompose
    into). Only dots, as in the reference: no convolution, no elementwise
    op. Kept per operand dtype ("bf16", "f32", "int8", ...) as well as in
    total, since the card's peak differs by dtype.
  * trip counts: a Python loop over layers or attention chunks dispatches
    its body once per trip, so the count is per trip by construction (the
    reference multiplies a `while` body by its parsed trip count).
  * kernel launches: a hand-written kernel's wrapper given meta tensors
    launches nothing; it reports its launch by name
    (`kernels._build.abstract`) and adds nothing to the dot FLOPs, as the
    reference's HLO sees a custom call.
  * collectives: kind, count and result bytes per kind, plus the bytes a
    ring algorithm sends from this rank, from the mesh the step runs on
    (`distributed.collectives.DryMesh`, whose collectives move nothing).
  * peak memory: the most bytes held at once by live storages, counted by
    storage (a view adds nothing) and released when the storage dies, so a
    tensor that autograd saves counts until its backward frees it. The
    arguments are held from the start (`hold`), at the bytes the caller
    says one rank keeps of them.

`analyze(fn, *args)` runs fn once under the mode and returns its output
and the record. On meta tensors (the dry run) nothing is allocated; on the
card the same count runs around a real step.
"""
from __future__ import annotations

import dataclasses
import math
import weakref
from collections import defaultdict
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import _build

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32", torch.float16: "f16",
           torch.float64: "f64", torch.int8: "int8", torch.uint8: "uint8",
           torch.int32: "int32"}

_aten = torch.ops.aten
# op -> (index of the left operand, of the right operand)
_DOTS = {_aten.mm: (0, 1), _aten.bmm: (0, 1), _aten._int_mm: (0, 1),
         _aten.mv: (0, 1), _aten.dot: (0, 1), _aten.addmm: (1, 2),
         _aten.baddbmm: (1, 2), _aten.addmv: (1, 2)}


def dtype_name(dtype: torch.dtype) -> str:
    return _DTYPES.get(dtype, str(dtype).removeprefix("torch."))


def tensors(tree) -> list[torch.Tensor]:
    """The tensors of a tree of dicts, sequences and dataclasses (a cache)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tensors(v)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [t for f in dataclasses.fields(tree)
                for t in tensors(getattr(tree, f.name))]
    return []


def storage_bytes(tree) -> int:
    """The bytes of the distinct storages behind a tree's tensors."""
    seen = {}
    for t in tensors(tree):
        st = t.untyped_storage()
        seen[id(st)] = (st, st.nbytes())
    return sum(n for _, n in seen.values())


_PLAIN = (int, float, bool, str, type(None), torch.dtype, torch.device,
          torch.layout, torch.memory_format)


def _flat(x, out: list) -> None:
    """The leaves of an op's (args, kwargs), with markers for nesting."""
    if isinstance(x, (tuple, list)):
        out.append("(")
        for y in x:
            _flat(y, out)
        out.append(")")
    elif isinstance(x, dict):
        for k, v in x.items():
            out.append(k)
            _flat(v, out)
    else:
        out.append(x)


def _meta_key(func, leaves) -> tuple | None:
    """A hashable key of an op's inputs when every tensor among them is on
    meta and every other input is a plain value; None otherwise."""
    key = [func]
    seen = False
    for a in leaves:
        if isinstance(a, torch.Tensor):
            if not a.is_meta:
                return None
            seen = True
            key.append((tuple(a.shape), a.stride(), a.dtype))
        elif isinstance(a, _PLAIN):
            key.append((type(a), a))
        else:
            return None
    return tuple(key) if seen else None


def dot_flops(func, args) -> float:
    """2 * prod(result dims) * prod(contracting dims) of one matmul-class
    aten call; 0 for any other op."""
    idx = _DOTS.get(func.overloadpacket)
    if idx is None:
        return 0.0
    a, b = args[idx[0]], args[idx[1]]
    if a.ndim == 1 and b.ndim == 1:                      # dot
        return 2.0 * a.shape[0]
    if b.ndim == 1:                                      # mv: (M, K) x (K,)
        return 2.0 * a.shape[0] * a.shape[1]
    k = a.shape[-1]
    return 2.0 * math.prod(a.shape[:-1]) * b.shape[-1] * k


class StepCounter(TorchDispatchMode):
    """The counting mode. `hold(tree, nbytes)` registers arguments before
    the step; `record()` returns what was counted."""

    def __init__(self, top_ops: int = 0):
        super().__init__()
        self.top_ops = top_ops
        self.flops_by_dtype: dict[str, float] = defaultdict(float)
        self.launches: dict[str, int] = defaultdict(int)
        self._dots: dict[tuple, float] = defaultdict(float)
        self._live: dict[int, int] = {}
        self._refs: dict[int, Any] = {}
        self.current = 0
        self.peak = 0
        self.ops = 0
        self.devices: set[str] = set()
        self._shapes: dict[tuple, Any] = {}

    # -- memory --------------------------------------------------------
    def _freed(self, key: int) -> None:
        self.current -= self._live.pop(key, 0)
        self._refs.pop(key, None)

    def _track(self, t: torch.Tensor, nbytes: int | None = None) -> None:
        st = t.untyped_storage()
        key = id(st)
        n = st.nbytes() if nbytes is None else nbytes
        old = self._live.get(key)
        if old is None:
            self._refs[key] = weakref.ref(st, lambda _, k=key: self._freed(k))
            self._live[key] = n
            self.current += n
        elif nbytes is None and n > old:                 # resized in place
            self._live[key] = n
            self.current += n - old
        self.peak = max(self.peak, self.current)

    def hold(self, tree, nbytes: dict[int, int] | None = None) -> None:
        """Count the storages of `tree` as live from now on; `nbytes` maps
        a tensor's id to the bytes one rank holds of it (its block, or 0
        for a host batch that the step uploads block by block)."""
        for t in tensors(tree):
            n = None if nbytes is None else nbytes.get(id(t))
            self._track(t, n)

    # -- dispatch ------------------------------------------------------
    def _call(self, func, args, kwargs):
        """func(*args, **kwargs); on meta inputs an op whose outputs alias
        no input is answered from the shapes it gave before for the same
        input shapes, strides, dtypes and options (a meta kernel is Python
        and costs ~0.3 ms; most of a step repeats per layer and chunk)."""
        leaves: list = []
        _flat((args, kwargs), leaves)
        key = _meta_key(func, leaves)
        if key is not None:
            hit = self._shapes.get(key)
            if hit is not None:
                outs = [torch.empty_strided(s[0], s[1], dtype=s[2],
                                            device="meta")
                        if isinstance(s, tuple) else s for s in hit[0]]
                return outs[0] if hit[1] is None else hit[1](outs)
        out = func(*args, **kwargs)
        if key is not None:
            if isinstance(out, torch.Tensor):
                outs, kind = [out], None
            elif isinstance(out, (tuple, list)):
                outs, kind = list(out), type(out)
            else:
                return out
            inputs = {t.untyped_storage()._cdata for t in leaves
                      if isinstance(t, torch.Tensor)}
            if all(t is None or isinstance(t, torch.Tensor)
                   and t.untyped_storage()._cdata not in inputs
                   for t in outs):
                self._shapes[key] = ([
                    (tuple(t.shape), t.stride(), t.dtype)
                    if isinstance(t, torch.Tensor) else t for t in outs],
                    kind)
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = self._call(func, args, kwargs or {})
        self.ops += 1
        f = dot_flops(func, args)
        if f:
            dt = dtype_name(args[_DOTS[func.overloadpacket][0]].dtype)
            self.flops_by_dtype[dt] += f
            if self.top_ops:
                shapes = tuple(tuple(a.shape) for a in args
                               if isinstance(a, torch.Tensor))
                self._dots[(str(func.overloadpacket), dt, shapes)] += f
        for t in tensors(out):
            self.devices.add(t.device.type)
            self._track(t)
        return out

    def _launch(self, name: str) -> None:
        self.launches[name] += 1

    def __enter__(self):
        _build.ABSTRACT.append(self._launch)
        return super().__enter__()

    def __exit__(self, *exc):
        _build.ABSTRACT.remove(self._launch)
        return super().__exit__(*exc)

    def close(self) -> None:
        """Stop following storages (their deaths no longer count)."""
        self._refs.clear()

    def record(self) -> dict:
        by_dtype = {k: float(v) for k, v in sorted(self.flops_by_dtype.items())}
        out = {"dot_flops": float(sum(by_dtype.values())),
               "dot_flops_by_dtype": by_dtype,
               "kernel_launches": dict(sorted(self.launches.items())),
               "ops": self.ops, "tensor_devices": sorted(self.devices),
               "peak_bytes": int(self.peak)}
        if self.top_ops:
            top = sorted(([f, *key] for key, f in self._dots.items()),
                         reverse=True)
            out["top_dots"] = top[:self.top_ops]
        return out


def collective_record(mesh, top_ops: int = 0) -> dict:
    """The reference's collective keys from a mesh's counters: result
    bytes per kind with their total, counts per kind, and the ring-model
    bytes this rank sent (`comm["bytes_sent"]`)."""
    kinds = getattr(mesh, "kinds", None) or {}
    coll = {k: int(kinds.get(k, {}).get("bytes", 0)) for k in COLLECTIVES}
    coll["total"] = int(sum(coll.values()))
    out = {"collectives": coll,
           "collective_counts": {k: int(v["count"])
                                 for k, v in kinds.items()},
           "bytes_sent": int(mesh.comm["bytes_sent"]) if mesh is not None
           else 0}
    if top_ops:
        calls = getattr(mesh, "calls", None) or {}
        top = sorted(([n * size, kind, size, n]
                      for (kind, size), n in calls.items()), reverse=True)
        out["top_collectives"] = top[:top_ops]
    return out


def analyze(fn: Callable, *args, mesh=None, top_ops: int = 0,
            hold_bytes: dict[int, int] | None = None) -> tuple[Any, dict]:
    """Run fn(*args) once under the counting mode. Returns (its output,
    the record): `dot_flops` (per rank), `dot_flops_by_dtype`,
    `kernel_launches`, `ops` (aten calls), `tensor_devices` (the device
    types of their outputs), `collectives` / `collective_counts` /
    `bytes_sent` (zeros without a mesh), `peak_bytes`, `argument_bytes`
    (held at `hold_bytes` where given), `end_bytes` (live when fn
    returns) and `output_bytes` (the distinct storages of the output).
    With `top_ops` > 0, as the reference's `analyze(text, top_ops)`, the
    largest contributors: `top_dots` as [FLOPs, aten op, dtype, operand
    shapes] and `top_collectives` as [bytes, kind, result bytes of one
    call, calls], each summed over the calls of the same shapes (the
    reference multiplies one static op by its loop's trips)."""
    if mesh is not None and hasattr(mesh, "reset_comm"):
        mesh.reset_comm()
    counter = StepCounter(top_ops)
    counter.hold(args, hold_bytes)
    arg_bytes = counter.current
    with counter:
        out = fn(*args)
    end = counter.current
    counter.close()
    rec = counter.record()
    rec.update(collective_record(mesh, top_ops))
    rec["argument_bytes"] = int(arg_bytes)
    rec["end_bytes"] = int(end)
    rec["output_bytes"] = storage_bytes(out)
    return out, rec
