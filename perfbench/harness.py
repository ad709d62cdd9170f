"""One run of one cell: set-up, the measured window, the output check.

Everything a cell needs is found by name. `BENCHMARK.json` names the
cell's configuration (its file) and traffic mix; the mix is
`traffic/<mix>.json`, whose `kind` is the generator `traffic/<kind>.py`;
`workloads/<cell>.json` names the arena builder `builders/<kind>.py`, the
serving runtime's settings and the size of the output check; each
per-layer metric is read by `metrics/<metric>.py`, or, for a metric named
`<reader>.<suffix>`, by `metrics/<reader>.py`. An end-to-end metric named
`<metric>.<suffix>` is its base metric, reported under a bound of its own
in the cells it lists.

The system under test is `repro_torch`'s server: `ServingRuntime` over a
`MultiTenantIndex`, driven through `submit` and `poll`. The benchmark
gives it the queries and takes back its results, its tracer's spans, its
registry's launch histogram (traced runs only) and the profiler's kernel
names; nothing else of the program is read.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import os
import random
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from perfbench import profiled, yardstick
from perfbench.corpus import sub_seed
from perfbench.reference import retrieval as reference

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCH = ROOT / "BENCHMARK.json"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")
PROFILE_SLICE_S = 2.0


def load(kind: str, name: str):
    """The module `perfbench/<kind>/<name>.py`; failing that, for a name
    with a suffix (`step_mfu.closed`), `perfbench/<kind>/<base>.py`."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        path = HERE / kind / f"{name.split('.')[0]}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} {name!r} under {HERE / kind}")
    qual = f"perfbench.{kind}.{path.stem}"
    if qual in sys.modules:
        return sys.modules[qual]
    spec = importlib.util.spec_from_file_location(qual, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[qual] = mod
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> dict:
    return json.loads(path.read_text())


def load_spec(cell: str, bench_path: Path = BENCH) -> dict:
    """The cell's manifest entry with its configuration, traffic mix,
    workload file and the metrics it reports."""
    bench = read_json(bench_path)
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell not in cells:
        raise KeyError(f"no workload {cell!r} in {bench_path.name}")
    entry = cells[cell]
    config = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", cells)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (cell in m["workloads"] if "workloads" in m
                     else m["moves"] in reported)]
    return {"name": cell, "chips": entry["chips"],
            "config": read_json(ROOT / config["file"]),
            "traffic": read_json(HERE / "traffic" / f"{entry['traffic']}.json"),
            "workload": read_json(HERE / "workloads" / f"{cell}.json"),
            "end_to_end": e2e, "per_layer": per_layer}


def retrieval_config(cfg: dict, backend: str):
    from repro_torch.core.retrieval import RetrievalConfig
    return RetrievalConfig(k=cfg["k"], metric=cfg["metric"],
                           max_candidates=cfg["candidates"],
                           candidate_frac=1.0, backend=backend)


def process_start() -> float:
    """This process's start on the monotonic clock (from /proc; the
    import of this module where /proc cannot say)."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.monotonic() - (uptime - started)
    except (OSError, ValueError, IndexError):
        return _IMPORTED


_IMPORTED = time.monotonic()


@dataclasses.dataclass(slots=True)
class Request:
    """A request while it is outstanding, or one the check compares."""
    index: int            # its place in the window's order of submits
    user: int
    query: int            # row of the run's query array
    client: int = -1
    handle: object = None
    done: float = math.nan
    result: object = None        # its RetrievalResult, once resolved


class Window:
    """The measured window: submits through the runtime, and finds the
    requests it resolved. Every submit and poll passes the host clock as
    `now`: the runtime's own clock freezes after its first launch when
    it is not given one (`_launch` hands the time it resolved back to
    `_clock` as if a caller had set it, which switches the runtime to
    simulated time), and then no deadline ever fires. The runtime
    retires launches strictly in dispatch order, so every request whose
    launch index is below ``launches - in_flight()`` is resolved; the
    outstanding list is scanned only when that count moves.

    A resolved request leaves only numbers behind (its due and done
    times, user and launch, in lists of floats and ints, which the
    garbage collector does not track); only the requests the check will
    compare keep their result. So the records of a window of hundreds of
    thousands of requests give the program's collector nothing to walk,
    and its full collections come when the program's own allocations set
    them off. The check's requests are a sample drawn from the seed as
    requests arrive (Algorithm R: at every point each request so far is
    in it with the same chance)."""

    def __init__(self, rt, queries: np.ndarray, slice_, phase,
                 check_n: int, seed: int):
        self.rt, self.queries = rt, queries
        self.slice, self.phase = slice_, phase
        self.due: list[float] = []    # due (open loop) or submitted
        self.done: list[float] = []
        self.user: list[int] = []
        self.query: list[int] = []
        self.launch: list[int | None] = []   # the launch that served it
        self.outstanding: list[Request] = []
        self.kept: dict[int, object] = {}    # the sample: index -> result
        self._sample: list[int] = []
        self._check_n = check_n
        self._rng = random.Random(sub_seed(seed, 4))
        self._retired = 0
        self._fresh: list[Request] = []
        self.t0 = math.nan

    def start(self) -> float:
        self.t0 = time.monotonic()
        return self.t0

    def submit(self, user: int, query: int, due: float,
               client: int = -1) -> None:
        req = Request(len(self.due), user, query, client)
        self.due.append(due)
        self.done.append(math.nan)
        self.user.append(user)
        self.query.append(query)
        self.launch.append(None)
        self._choose(req.index)
        self.slice.tick(time.monotonic())
        with self.phase("submit"):
            req.handle = self.rt.submit(user, self.queries[query],
                                        now=time.monotonic())
        self.outstanding.append(req)
        self._harvest()

    def _choose(self, i: int) -> None:
        if len(self._sample) < self._check_n:
            self._sample.append(i)
        else:
            j = self._rng.randrange(i + 1)
            if j >= self._check_n:
                return
            del self.kept[self._sample[j]]
            self._sample[j] = i
        self.kept[i] = None

    def poll(self) -> None:
        """Launch what is due, retire what landed."""
        now = time.monotonic()
        self.slice.tick(now)
        with self.phase("poll"):
            self.rt.poll(now=now)
        self._harvest()

    def take(self) -> list[Request]:
        """The requests resolved since the last call."""
        fresh, self._fresh = self._fresh, []
        return fresh

    def _harvest(self) -> None:
        """Stamp the requests of newly retired launches. A submit can
        retire launches too (the runtime blocks on its oldest when too
        many are in flight), so this runs after every call."""
        retired = self.rt.launches - self.rt.in_flight()
        if retired == self._retired:
            return
        self._retired = retired
        now = time.monotonic()
        keep = []
        for req in self.outstanding:
            li = req.handle.launch_index
            if li is not None and li < retired:
                req.done = now
                self._settle(req)
                self._fresh.append(req)
            else:
                keep.append(req)
        self.outstanding = keep

    def _settle(self, req: Request) -> None:
        """Record a request's end (done or given up) and let go of it."""
        i = req.index
        self.done[i] = req.done
        self.launch[i] = req.handle.launch_index
        if i in self.kept:
            self.kept[i] = req.handle.result(wait=False)
        req.handle = None

    def close(self) -> list[Request]:
        """After the window: what never resolved is stamped now and keeps
        no result. Returns the check's sample, in request order."""
        now = time.monotonic()
        for req in self.outstanding:
            req.done = now
            self._settle(req)
        return [Request(i, self.user[i], self.query[i], result=self.kept[i])
                for i in sorted(self.kept)]


def percentile(values, q: float) -> float:
    """Nearest-rank percentile."""
    v = sorted(values)
    return v[max(0, math.ceil(q / 100 * len(v)) - 1)]


def _pow2_sizes(max_batch: int) -> list[int]:
    return [1 << i for i in range(max_batch.bit_length())
            if 1 << i <= max_batch]


def warm_up(index, rt_cls, rt_cfg, queries, users, device) -> None:
    """Every batch shape the runtime can launch (powers of two up to
    max_batch), twice each, then the runtime's own path once."""
    from repro_torch._device import upload
    from repro_torch.core.retrieval import NO_TENANT
    mb = rt_cfg.max_batch
    for b in _pow2_sizes(mb):
        for _ in range(2):
            q = np.zeros((b, queries.shape[1]), np.int8)
            t = np.full((b,), NO_TENANT, np.int32)
            q[:] = queries[:b]
            t[:] = users[:b]
            res = index.retrieve(upload(q, device), t)
            res.indices.cpu()
    rt = rt_cls(index, rt_cfg)
    handles = [rt.submit(int(users[i % len(users)]),
                         queries[i % len(queries)])
               for i in range(mb + 3)]
    rt.flush()
    for h in handles:
        h.result()


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def result_line(out: dict) -> str:
    """The result as its JSON line, once nothing more will load: exits
    instead, naming them, where JAX or the JAX package is loaded in this
    process (compared by whole top-level names: `repro_torch` is not
    `repro`)."""
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules that must not load: {', '.join(found)}")
    return json.dumps(out)


def check(built, chosen: list[Request], cfg: dict,
          control_bits: int | None = None) -> dict:
    """The compared counts: each chosen request's result held against the
    reference's. With `control_bits` the results held are the
    reference's own at that precision (the control), not the program's."""
    dev = built.corpus.device
    counts = {"unanswered": 0, "wrong_candidates": 0, "wrong_ids": 0,
              "wrong_scores": 0}
    by_user: dict[int, list[Request]] = {}
    for r in chosen:
        by_user.setdefault(r.user, []).append(r)
    users = sorted(by_user)
    kw = dict(k=cfg["k"], candidates=cfg["candidates"], metric=cfg["metric"])
    control = (built.reference_blocks(users) if control_bits is not None
               else None)
    for user, blocks in built.reference_blocks(users):
        reqs = by_user[user]
        q = torch.from_numpy(built.queries[[r.query for r in reqs]]).to(dev)
        want = reference.retrieve(q, blocks, **kw)
        if control is not None:
            _, cblocks = next(control)
            got = reference.retrieve(q, cblocks, bits=control_bits, **kw)
            answers = [(got[0][i], got[1][i], got[2][i])
                       for i in range(len(reqs))]
        else:
            answers = [None if r.result is None else
                       (np.asarray(r.result.indices),
                        np.asarray(r.result.scores),
                        np.asarray(r.result.candidate_indices))
                       for r in reqs]
        for i, ans in enumerate(answers):
            if ans is None:
                counts["unanswered"] += 1
                continue
            counts["wrong_ids"] += int(not np.array_equal(ans[0], want[0][i]))
            counts["wrong_scores"] += int(
                not np.array_equal(ans[1], want[1][i]))
            counts["wrong_candidates"] += int(
                not np.array_equal(ans[2], want[2][i]))
    return counts


@dataclasses.dataclass
class Cell:
    """A cell set up for one seed: the built arena and its traffic."""

    spec: dict
    device: torch.device
    gen: object
    plan: object
    targets: tuple
    built: object
    rt_cfg: object
    seed: int


def set_up(spec: dict, seed: int, seconds: float, *, device=None,
           backend: str = "cuda", log=print) -> Cell:
    """Kernels built, traffic drawn, arena built, every shape warmed."""
    from repro_torch.serve.runtime import RuntimeConfig, ServingRuntime
    from repro_torch.tenancy.tenants import MultiTenantIndex
    dev = torch.device(device or "cuda")
    cfg, mix, wl = spec["config"], spec["traffic"], spec["workload"]
    t = time.monotonic()

    def lap(what: str) -> None:
        nonlocal t
        now = time.monotonic()
        log(f"set-up: {what} {now - t:.2f} s")
        t = now
    if dev.type == "cuda":
        from repro_torch.kernels import _build
        _build.build()
        lap("kernel libraries")
    gen = load("traffic", mix["kind"])
    plan, targets = gen.schedule(mix, seconds, cfg, seed)
    builder = load("builders", wl["builder"])
    built = builder.build(cfg, wl["build"], targets, seed, dev,
                          MultiTenantIndex, retrieval_config(cfg, backend),
                          log)
    lap("traffic, corpus and arena")
    rt_cfg = RuntimeConfig(**wl["runtime"])
    warm_up(built.index, ServingRuntime, rt_cfg, built.queries, targets[0],
            dev)
    # Set-up's garbage is freed here, not at a random point of the
    # window; the program's own collections run in the window as they
    # would in a server.
    gc.collect()
    lap("warm-up")
    return Cell(spec, dev, gen, plan, targets, built, rt_cfg, seed)


def serve(cell: Cell, seconds: float, traced: bool) -> SimpleNamespace:
    """The measured window. Afterwards the window's numbers (due and done
    times, users, launches) and the check's sample with its results (None
    where one never came) are all that is left: the program's state is
    released, so the reference may take the card."""
    from repro_torch.serve.runtime import ServingRuntime
    dev = cell.device
    tracer = registry = None
    slice_ = profiled.ProfilerSlice(dev)
    if traced:
        from repro_torch.obs.metrics import MetricsRegistry
        from repro_torch.obs.tracing import Tracer
        tracer, registry = Tracer(), MetricsRegistry()
        profiled.warm_profiler(dev, lambda: warm_up(
            cell.built.index, ServingRuntime, cell.rt_cfg,
            cell.built.queries, cell.targets[0], dev))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    rt = ServingRuntime(cell.built.index, cell.rt_cfg, tracer=tracer,
                        registry=registry)
    win = Window(rt, cell.built.queries, slice_, profiled.phase(traced),
                 cell.spec["workload"]["check_sample"], cell.seed)
    if traced:
        slice_.start_at = time.monotonic() + seconds / 3
        slice_.length = min(PROFILE_SLICE_S, seconds / 3)
        slice_.state = "wait"
    cell.gen.drive(win, cell.plan, seconds)
    slice_.close()
    failed = len(win.outstanding)
    if not failed:
        rt.barrier()
    chosen = win.close()
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    launch_ts = ({e.attrs["index"]: e.ts for e in tracer.spans("launch")}
                 if traced else {})
    out = SimpleNamespace(
        due=win.due, done=win.done, user=win.user, launch=win.launch,
        chosen=chosen, failed=failed, t0=win.t0, window_s=seconds,
        peak=peak, tracer=tracer, registry=registry, launch_ts=launch_ts,
        profile=(profiled.summarize(slice_.prof)
                 if slice_.prof is not None else None),
        slice_t=(slice_.t_start, slice_.t_stop))
    del rt, win, slice_
    cell.built.index = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _least_s(cell: Cell, w, t_lo: float, t_hi: float) -> tuple[float, int]:
    """Least time of the launches dispatched in [t_lo, t_hi), and their
    number."""
    cfg = cell.spec["config"]
    batches: dict[int, list[int]] = {}
    for li, user in zip(w.launch, w.user):
        if li is not None and t_lo <= w.launch_ts.get(li, -math.inf) < t_hi:
            batches.setdefault(li, []).append(user)
    least = sum(yardstick.batch_least_seconds(
        tenants, cell.built.rows_of, cfg["dim"], cfg["k"], cfg["candidates"])
        for tenants in batches.values())
    return least, len(batches)


def run_cell(spec: dict, seed: int, seconds: float, traced: bool, *,
             device=None, backend: str = "cuda", log=print) -> dict:
    """One run; returns the result as a dict (the caller prints it by
    `result_line`)."""
    t_proc = process_start()
    log(f"set-up: interpreter, imports and manifest "
        f"{time.monotonic() - t_proc:.2f} s")
    cell = set_up(spec, seed, seconds, device=device, backend=backend,
                  log=log)
    w = serve(cell, seconds, traced)
    setup_s = w.t0 - t_proc
    end = w.t0 + seconds
    lat_ms = [(d - u) * 1e3 for d, u in zip(w.done, w.due)]
    t_check = time.monotonic()
    counts = check(cell.built, w.chosen, spec["config"])
    log(f"checked {len(w.chosen)} of {len(w.due)} requests in "
        f"{time.monotonic() - t_check:.1f} s")
    if traced:
        ctx = SimpleNamespace(window=w, latency_ms=lat_ms, profile=w.profile,
                              least_s=_least_s(cell, w, w.t0, end)[0],
                              slice_least_s=None, slice_batches=0)
        if w.profile is not None:
            ctx.slice_least_s, ctx.slice_batches = _least_s(
                cell, w, *w.slice_t)
        metrics = {}
        for m in spec["per_layer"]:
            value = load("metrics", m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        qps = sum(1 for d in w.done if d <= end) / seconds
        values = {"queries_per_s": qps,
                  "latency_p50_ms": percentile(lat_ms, 50),
                  "latency_p95_ms": percentile(lat_ms, 95),
                  "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"].split(".")[0]],
                               "unit": m["unit"]}
                   for m in spec["end_to_end"]}
    dev = cell.device
    device_out = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                  "kind": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else "cpu"),
                  "count": 1, "memory_peak_bytes": w.peak}
    out = {"correct": w.failed == 0 and not any(counts.values()),
           "attempted": len(w.due), "failed": w.failed, "metrics": metrics,
           "device": device_out}
    if traced:
        prof = w.profile or {}
        device_out["busy_s"] = prof.get("busy_s", 0.0)
        device_out["window_s"] = prof.get("slice_s", 0.0)
        out["breakdown"] = {"device_ops": prof.get("device_ops", []),
                            "idle_gaps": prof.get("idle_gaps", [])}
    out["checks"] = {name: {"value": v, "limit": 0}
                     for name, v in counts.items()}
    return out
