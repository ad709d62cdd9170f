"""Multi-tenant streaming-serving launcher: simulated ingest+query trace.
The port of `repro.launch.serve_tenants`.

    PYTHONPATH=src python -m repro_torch.launch.serve_tenants --tenants 8 \
        --capacity 1024 --steps 40 [--clusters 16 --cache-kb 256] \
        [--shards 4 --fail-at 20] [--generate] [--seed 0] [--device cpu]

Drives the wearable deployment shape end to end: T users share one
nibble-planar arena; every trace step either INGESTS a burst of new
personal records for one user (online quantize+pack — no rebuild),
DELETES some (tombstones), or serves a mixed QUERY batch for several
users through the SERVING RUNTIME (repro_torch.serve.runtime): requests get
future-style handles, batches launch on deadline-or-max-batch admission,
and with --clusters + --cache-kb the hot-cluster cache serves repeated
stage-1 views from on-chip memory instead of HBM. Compaction runs
whenever tombstones exceed a threshold. The driver checks isolation (a
user's results only ever come from their own corpus) and hit-rate
(queries are noisy re-encodings of ingested docs), and reports
queries/sec, ingest rows/sec, the cache's hit/byte ledger and the
per-query energy ledger. Everything runs on the CUDA device unless
--device names another; the sharded phase (--shards) deals its shards
over the visible devices the same way. The trace draws only from the
numpy generator of --seed, as the reference's does; the models' weights
come from seeded torch generators.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_config
from repro_torch.core import RetrievalConfig, energy, quantize_int8
from repro_torch.core.clustering import ClusterParams
from repro_torch.models import embedder, get_model
from repro_torch.obs import (MetricsRegistry, Tracer, prometheus_text,
                             write_chrome_trace)
from repro_torch.serve import (MultiTenantRAGPipeline, RuntimeConfig,
                               ServingRuntime)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tenants", type=int, default=8)
    ap.add_argument("--capacity", type=int, default=1024)
    ap.add_argument("--doc-len", type=int, default=12)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--burst", type=int, default=16,
                    help="docs per ingest event")
    ap.add_argument("--batch", type=int, default=8,
                    help="max queries per scheduler flush")
    ap.add_argument("--topk", type=int, default=3)
    ap.add_argument("--generate", action="store_true",
                    help="also run generator answers for the last batch")
    ap.add_argument("--clusters", type=int, default=0,
                    help="enable the cluster-pruned cascade with this "
                         "many centroids (0 = two-stage full scan)")
    ap.add_argument("--nprobe", type=int, default=4)
    ap.add_argument("--cache-kb", type=int, default=0,
                    help="hot-cluster cache budget in KiB — the size of "
                         "the device-resident slab carved next to the "
                         "arena plane (0 = off; needs --clusters)")
    ap.add_argument("--prescreen-c0", type=int, default=0,
                    help="1-bit sign-plane stage-0 prescreen: keep this "
                         "many survivor rows per lane before the nibble "
                         "gather (0 = off; needs --clusters). Cuts "
                         "stage-0+1 bytes by 4V/(V+4*C0) for a V-row "
                         "probe view")
    ap.add_argument("--precision-tiers", action="store_true",
                    help="per-cluster precision tiers in the hot-cluster "
                         "cache: cold clusters are admitted at the 1-bit "
                         "SIGN tier (sign bytes only, no slab rows) and "
                         "promoted to the full nibble slab on re-probe; "
                         "needs --cache-kb")
    ap.add_argument("--no-preload", action="store_true",
                    help="disable the EdgeRAG-style hot preload (pin a "
                         "session's clusters into the slab when the "
                         "budget fits; preloaded tenants are served "
                         "from the compact slab table)")
    ap.add_argument("--max-wait-ms", type=float, default=5.0,
                    help="deadline slack before a partial batch launches")
    ap.add_argument("--arrival", choices=("closed", "poisson", "bursty"),
                    default="closed",
                    help="closed (default): the mixed trace's query events "
                         "flush inline. poisson/bursty: after the trace, "
                         "run an OPEN-LOOP query phase — request bursts "
                         "arrive on a seeded wall-clock schedule at "
                         "--rate, and per-burst latency (arrival -> all "
                         "resolved) is reported with the queue-wait vs "
                         "compute-wait split")
    ap.add_argument("--rate", type=float, default=200.0,
                    help="open-loop arrival rate in requests/sec "
                         "(bursts of --batch arrive at rate/batch per sec)")
    ap.add_argument("--async-depth", type=int, default=2,
                    help="in-flight launch depth (0 = legacy synchronous "
                         "dispatch)")
    ap.add_argument("--autotune", action="store_true",
                    help="run the measured kernel block autotuner before "
                         "serving and install the winning table")
    ap.add_argument("--autotune-cache", type=str, default=None,
                    help="autotuner artifact path: load it if valid for "
                         "this device, else (with --autotune) save the "
                         "fresh search there")
    ap.add_argument("--shards", type=int, default=0,
                    help="after the main trace, run the SHARDED serving "
                         "phase: the tenants' corpora placed over this "
                         "many shards (rendezvous-hashed placement, one "
                         "ServingRuntime per shard, host-side tournament "
                         "merge), parity-checked bit-for-bit against a "
                         "single-shard baseline (0 = off)")
    ap.add_argument("--fail-at", type=int, default=-1,
                    help="inject an elastic failover in the sharded "
                         "phase: kill one shard before request #N of the "
                         "sharded trace — its tenants re-place onto the "
                         "survivors, in-flight requests resubmit, and "
                         "the exactly-once ledger is asserted (needs "
                         "--shards >= 2)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    ap.add_argument("--metrics-out", type=str, default=None,
                    help="write the end-of-run metrics registry here in "
                         "Prometheus text exposition format")
    ap.add_argument("--trace-out", type=str, default=None,
                    help="write the request-lifecycle trace here as Chrome "
                         "trace_event JSON (open in ui.perfetto.dev)")
    args = ap.parse_args(argv)
    if args.tenants < 1 or args.capacity < args.burst:
        ap.error("need --tenants >= 1 and --capacity >= --burst")
    if args.cache_kb and not args.clusters:
        ap.error("--cache-kb caches CLUSTER views: it needs --clusters > 0 "
                 "(without clustering every flush scans windows/masks and "
                 "the cache would silently never be consulted)")
    if args.prescreen_c0 and not args.clusters:
        ap.error("--prescreen-c0 gates the CASCADE's nibble gather: it "
                 "needs --clusters > 0 (the two-stage full scan has no "
                 "stage-0)")
    if args.precision_tiers and not args.cache_kb:
        ap.error("--precision-tiers tiers the hot-cluster cache: it needs "
                 "--cache-kb > 0")
    if args.fail_at >= 0 and args.shards < 2:
        ap.error("--fail-at injects a shard loss: it needs --shards >= 2 "
                 "(there must be a survivor to re-place onto)")

    dev = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    _maybe_autotune(args, dev)
    gcfg = get_config("qwen2-0.5b", smoke=True)
    gen_api = get_model(gcfg) if args.generate else None
    gen_params = (gen_api.init(torch.Generator(device=dev).manual_seed(0),
                               device=dev) if args.generate else None)
    ecfg = embedder.MINILM_CFG.with_(num_layers=2, d_model=64, num_heads=4,
                                     num_kv_heads=4, d_ff=128,
                                     vocab_size=gcfg.vocab_size,
                                     pooled_dim=64)
    eparams = embedder.init_params(
        ecfg, torch.Generator(device=dev).manual_seed(1), device=dev)

    pipe = MultiTenantRAGPipeline.create(
        ecfg, eparams, gen_api, gen_params, capacity=args.capacity,
        doc_len=args.doc_len,
        retrieval_cfg=RetrievalConfig(k=args.topk, metric="cosine",
                                      prescreen_c0=(args.prescreen_c0
                                                    or None)),
        clusters=(ClusterParams(num_clusters=args.clusters,
                                nprobe=args.nprobe, block_rows=32)
                  if args.clusters else None), device=dev)
    # The launcher always serves through a REAL registry (per-event cost
    # is one int add; it also feeds the energy/latency report below);
    # tracing records one event per request lifecycle stage, so it is
    # opt-in via --trace-out.
    registry = MetricsRegistry()
    tracer = Tracer() if args.trace_out else None
    runtime = ServingRuntime(pipe.index, RuntimeConfig(
        max_batch=args.batch, max_wait=args.max_wait_ms / 1e3,
        cache_bytes=args.cache_kb * 1024,
        preload=args.cache_kb > 0 and not args.no_preload,
        auto_flush=False, async_depth=args.async_depth,
        precision_tiers=args.precision_tiers),
        registry=registry, tracer=tracer)

    docs_of: dict[int, list[tuple[int, np.ndarray]]] = {
        t: [] for t in range(args.tenants)}     # (slot, tokens) live docs
    ingested = queries = hits = leaks = 0
    t_ingest = t_query = 0.0

    for step in range(args.steps):
        event = rng.choice(["ingest", "ingest", "query", "query", "delete"])
        tenant = int(rng.integers(args.tenants))
        if event == "ingest" or not docs_of[tenant]:
            toks = rng.integers(0, gcfg.vocab_size,
                                (args.burst, args.doc_len)).astype(np.int32)
            if pipe.index.arena.num_free < args.burst:
                pipe.compact()
                # refresh recorded slots after the move
                for t in docs_of:
                    mapped = pipe.index.table.slots(t)
                    docs_of[t] = [(s, d[1]) for s, d in
                                  zip(mapped, docs_of[t])]
            if pipe.index.arena.num_free < args.burst:
                continue                        # arena genuinely full
            t0 = time.perf_counter()
            slots = pipe.ingest(tenant, toks)
            t_ingest += time.perf_counter() - t0
            docs_of[tenant].extend(zip((int(s) for s in slots), toks))
            ingested += args.burst
        elif event == "delete" and len(docs_of[tenant]) > args.burst:
            victims = [docs_of[tenant].pop(0)[0] for _ in range(4)]
            pipe.delete(tenant, victims)
        else:                                   # query burst, mixed tenants
            want = []
            for _ in range(args.batch):
                t = int(rng.integers(args.tenants))
                if not docs_of[t]:
                    continue
                slot, toks = docs_of[t][int(rng.integers(len(docs_of[t])))]
                q_codes, _ = quantize_int8(pipe._embed(toks[None]),
                                           per_vector=True)
                want.append((runtime.submit(t, q_codes[0].cpu().numpy()),
                             t, slot))
            t0 = time.perf_counter()
            runtime.flush()
            t_query += time.perf_counter() - t0
            owner = pipe.index.arena.owner.cpu().numpy()
            for handle, t, slot in want:
                got = handle.result().indices.numpy()
                valid = got[got >= 0]
                leaks += int(np.sum(owner[valid] != t))
                hits += int(len(valid) > 0 and valid[0] == slot)
                queries += 1

    st = pipe.index.arena.stats
    print(f"[trace] {args.steps} steps: {ingested} docs ingested "
          f"({st.deletes} tombstoned, {st.compactions} compactions, "
          f"{st.rebuilds} rebuilds), {queries} queries in "
          f"{runtime.launches} launches")
    if queries:
        print(f"[query ] {queries / max(t_query, 1e-9):8.1f} q/s   top-1 hit "
              f"{hits}/{queries}   cross-tenant leaks {leaks} (must be 0)")
    if ingested:
        print(f"[ingest] {ingested / max(t_ingest, 1e-9):8.1f} rows/s online "
              f"(no rebuild; arena {pipe.index.num_live}/"
              f"{pipe.index.capacity} live)")
    if runtime.cache is not None and queries:
        cs = runtime.cache_stats()
        served = runtime.stage1_bytes_streamed + runtime.stage1_bytes_sram
        print(f"[cache ] {cs['hits']}/{cs['hits'] + cs['misses']} cluster "
              f"hits, {runtime.stage1_bytes_sram:,}/{max(served, 1):,} "
              f"stage-1 bytes from cache "
              f"({cs['stale_evictions']} stale evictions)")
        if args.precision_tiers:
            print(f"[cache ] precision tiers: {cs['demotions']} demotions "
                  f"-> SIGN, {cs['promotions']} promotions -> FULL, "
                  f"resident full/sign {cs['full_entries']}/"
                  f"{cs['sign_entries']}")
    # Per-query energy from the ACTUAL served trace: every launch priced
    # its measured SchedulePlan into the registry's µJ/query histogram
    # (weighted by real batch occupancy), so the medians below describe
    # the distribution the trace experienced — not whichever launch
    # happened to run last. The analytic fallback covers --steps traces
    # that never served a query.
    ehist = registry.get("histogram", "energy_uj_per_query")
    if ehist is not None and ehist.count:
        ep = ehist.percentiles((50, 99))
        print(f"[energy] {ep['p50']:.2f} uJ/query median "
              f"(p99 {ep['p99']:.2f}, {ehist.count} queries served)")
        # Stage split (from the per-stage ledger histogram): how much of
        # each query went to the 1-bit stage-0 prescreen vs the nibble
        # stage-1 gather it gates.
        s0 = registry.get("histogram", "energy_uj_per_query_stage",
                          stage="prescreen")
        s1 = registry.get("histogram", "energy_uj_per_query_stage",
                          stage="approx")
        if s0 is not None and s0.count and s1 is not None and s1.count:
            m0 = s0.percentiles((50,))["p50"]
            m1 = s1.percentiles((50,))["p50"]
            print(f"[energy] stage-0 sign prescreen {m0:.3f} uJ/query vs "
                  f"stage-1 nibble gather {m1:.3f} uJ/query (medians; "
                  f"the 1-bit pass costs {m0 / max(m1, 1e-12):.1%} of the "
                  f"stage it gates)")
    else:
        ledger = energy.cost_hierarchical(pipe.index.capacity,
                                          ecfg.pooled_dim)
        print(f"[energy] {ledger.total_uj:.2f} uJ/query (analytic "
              f"full-corpus estimate; no query was served)")
    # Decode-side energy at the deployment's reference context: the same
    # cost_cascade pricing applied to the KV cascade's StagePlan ledger,
    # so the generator's per-token HBM bill prints next to the
    # retrieval-side per-query bill it shares a runtime with.
    from repro_torch.core import engine as engine_mod
    from repro_torch.serve import sparse_kv as skv
    dt, dhd, dk = 4096, 64, 256
    dplan = engine_mod.kv_plan(
        engine_mod.KVCascadeConfig(top_k=dk), batch=1, kv_heads=4,
        q_heads=8, seq_len=dt, head_dim=dhd, layers=4)
    dcost = energy.cost_cascade(dplan.stages, dhd, batch=dplan.batch)
    dbytes = sum(st.bytes_hbm for st in dplan.stages)
    dense_b = skv.dense_bytes_per_step(dt, dhd) * 4 * 4   # x layers x kv-heads
    print(f"[decode] {dcost.total_uj:.3f} uJ/token at T={dt} "
          f"(top-{dk} cascade: {dbytes:,} B/step vs "
          f"{dense_b:,} dense, {dense_b / max(dbytes, 1):.1f}x cut)")
    if args.arrival != "closed":
        _openloop_phase(args, pipe, runtime, docs_of, rng)
    sharded_ok = _sharded_phase(args, rng, dev) if args.shards else True
    _obs_report(args, registry, tracer)

    if args.generate and queries:
        tids = np.asarray([t for t in range(args.tenants)
                           if docs_of[t]][:4], np.int32)
        qtoks = np.stack([docs_of[int(t)][0][1] for t in tids])
        out, ids, _ = pipe.answer(tids, qtoks, max_new=8)
        print(f"[gen   ] answered {out.shape[0]} users, "
              f"{out.shape[1]} tokens each")
    return 1 if (leaks or not sharded_ok) else 0


def _sharded_phase(args, rng, dev) -> bool:
    """--shards: pod-scale sharded serving over the elastic failover path.

    A synthetic per-tenant INT8 corpus (codes are what the placement
    layer moves; the embedding front end is exercised by the main trace
    above) is placed over --shards rendezvous-hashed shards and serves a
    mixed trace; the SAME trace on a single shard is the parity
    baseline — results must be bit-identical, since placement may never
    change answers. --fail-at N kills a shard mid-trace: its tenants
    re-place onto the survivors from the host-side corpus log, in-flight
    requests resubmit under the new placement, and the ledger must prove
    zero dropped / duplicated."""
    from repro_torch._device import visible_devices
    from repro_torch.serve.sharded import (ShardedRuntimeConfig,
                                           ShardedServingRuntime)
    tenants, dpt, dim = args.tenants, max(args.burst, 8), 64
    docs = {t: rng.integers(-40, 41, (dpt, dim), dtype=np.int8)
            for t in range(tenants)}
    trace = [(t, rng.integers(-40, 41, (dim,), dtype=np.int8))
             for t in list(range(tenants)) * max(2, args.steps // tenants)]
    rcfg = RetrievalConfig(k=args.topk, metric="mips", candidate_frac=1.0,
                           max_candidates=max(50, dpt))

    def build(s):
        rt = ShardedServingRuntime(ShardedRuntimeConfig(
            num_shards=s, capacity_per_shard=tenants * dpt, dim=dim,
            retrieval=rcfg,
            runtime=RuntimeConfig(max_batch=args.batch, max_wait=1.0,
                                  cache_bytes=0, auto_flush=False)),
            devices=visible_devices(dev))
        for t in range(tenants):
            rt.ingest_codes(t, docs[t])
        return rt

    def drive(rt, fail_at=-1):
        handles, now, report = [], 0.0, None
        for i, (t, q) in enumerate(trace):
            if i == fail_at:
                # kill the shard owning THIS request's tenant, so the
                # failover demonstrably moves tenants and re-routes work
                report = rt.fail_shard(rt.placement.shard_of(t), now=now)
            now += 1e-3
            handles.append(rt.submit(t, q, now=now))
            if i % args.batch == args.batch - 1:
                rt.poll(now=now)
        rt.flush(now=now + 1)
        return [(np.asarray(h.result().indices),
                 np.asarray(h.result().scores)) for h in handles], report

    t0 = time.perf_counter()
    base, _ = drive(build(1))
    rt = build(args.shards)
    got, report = drive(rt, fail_at=args.fail_at)
    wall = time.perf_counter() - t0
    led = rt.ledger()
    parity = all(np.array_equal(s1, s2) and (args.fail_at >= 0
                                             or np.array_equal(i1, i2))
                 for (i1, s1), (i2, s2) in zip(base, got))
    once = (led["submitted"] == led["resolved"] == len(trace)
            and led["dropped"] == 0 and led["duplicated"] == 0)
    print(f"[shard ] {args.shards} shards, {tenants} tenants x {dpt} docs, "
          f"{len(trace)} requests in {wall:.2f}s   placement "
          f"{ {t: rt.placement.shard_of(t) for t in range(tenants)} }")
    if report is not None:
        print(f"[shard ] failover at request {args.fail_at}: lost shard "
              f"{report['shard']}, moved tenants {report['moved_tenants']}, "
              f"restored {report['docs_restored']} docs, resubmitted "
              f"{report['requests_resubmitted']} in-flight")
    print(f"[shard ] parity vs single shard: {parity}   exactly-once: "
          f"{once} ({led['resolved']}/{led['submitted']} resolved, "
          f"dropped {led['dropped']}, duplicated {led['duplicated']})")
    return parity and once


def _maybe_autotune(args, dev) -> None:
    """--autotune / --autotune-cache: install a measured block-shape
    table before any engine compiles, so serving traces with the tuned
    shapes. A cached artifact is loaded when valid for THIS device;
    otherwise --autotune runs the search (and saves it if a cache path
    was given)."""
    from repro_torch.kernels import autotune
    if args.autotune_cache:
        table = autotune.load(args.autotune_cache, dev)
        if table is not None:
            autotune.install(table)
            print(f"[tune  ] loaded {args.autotune_cache} "
                  f"({len(table.entries)} tuned points)")
            return
        if not args.autotune:
            print(f"[tune  ] {args.autotune_cache} missing/stale for this "
                  "device; serving with DEFAULT_BLOCK_N (pass --autotune "
                  "to re-measure)")
            return
    if not args.autotune:
        return
    table = autotune.autotune(reps=3, device=dev)
    autotune.install(table)
    worst = min((e["speedup_vs_default"] for e in table.entries.values()),
                default=1.0)
    print(f"[tune  ] measured {len(table.entries)} points "
          f"(worst speedup vs default {worst:.2f}x)")
    if args.autotune_cache:
        table.save(args.autotune_cache)
        print(f"[tune  ] saved -> {args.autotune_cache}")


def _openloop_phase(args, pipe, runtime, docs_of, rng) -> None:
    """Open-loop query phase: bursts of --batch requests arrive on a
    seeded wall-clock schedule (--arrival poisson|bursty at --rate
    requests/sec) against the still-warm runtime. Per-burst latency is
    arrival -> all handles resolved, so a backlogged server pays its
    queue in the tail; between arrivals the driver reaps finished
    launches (the async pipeline's lazy-retire path)."""
    live = [t for t in docs_of if docs_of[t]]
    if not live:
        print("[openlp] no live docs; skipping open-loop phase")
        return
    bursts = max(4, args.steps // 2)
    batches = []                            # precomputed off the clock
    for _ in range(bursts):
        batch = []
        for _ in range(args.batch):
            t = int(rng.choice(live))
            _, toks = docs_of[t][int(rng.integers(len(docs_of[t])))]
            codes, _ = quantize_int8(pipe._embed(toks[None]),
                                     per_vector=True)
            batch.append((t, codes[0].cpu().numpy()))
        batches.append(batch)
    gap = args.batch / max(args.rate, 1e-9)
    if args.arrival == "poisson":
        arrivals = np.cumsum(rng.exponential(gap, size=bursts))
    else:                                   # bursty: two-state MMPP
        arrivals, t, state = [], 0.0, 0
        for _ in range(bursts):
            t += float(rng.exponential(gap * (0.4 if state == 0 else 1.6)))
            arrivals.append(t)
            if rng.random() < 0.3:
                state = 1 - state
        arrivals = np.asarray(arrivals)
    for batch in batches[:2]:               # untimed warm pass
        for t, q in batch:
            runtime.submit(t, q)
        runtime.flush()

    pending, lat = [], []
    t0 = time.perf_counter()

    def now():
        return time.perf_counter() - t0

    def harvest():
        while pending and all(h.done() for h in pending[0][1]):
            arr, _ = pending.pop(0)
            lat.append(now() - arr)

    for batch, arr in zip(batches, arrivals):
        while True:
            remaining = arr - now()
            if remaining <= 0:
                break
            runtime.reap()
            harvest()
            # yield between probes — a hot-spinning driver starves the
            # launching thread of the cycles the in-flight launches need
            time.sleep(min(2e-4, max(remaining, 0.0)))
        hs = [runtime.submit(t, q, now=now()) for t, q in batch]
        runtime.flush()                     # partial bursts must not strand
        pending.append((arr, hs))
        harvest()
    runtime.flush()
    harvest()
    p50, p95, p99 = (float(np.percentile(lat, p)) * 1e3
                     for p in (50, 95, 99))
    print(f"[openlp] {args.arrival} arrivals, {bursts} bursts x "
          f"{args.batch} req @ {args.rate:.0f} req/s "
          f"(async_depth={args.async_depth})")
    print(f"[openlp] burst latency p50/p95/p99 {p50:.2f}/{p95:.2f}/"
          f"{p99:.2f} ms")


def _obs_report(args, registry, tracer) -> None:
    """End-of-run observability summary + optional artifact exports."""
    rows = []
    for hname, label, unit, scale in (
            ("serve_queue_wait_seconds", "queue wait", "ms", 1e3),
            ("serve_launch_wall_seconds", "launch wall", "ms", 1e3),
            ("serve_resolve_lag_seconds", "resolve lag", "ms", 1e3),
            ("serve_batch_occupancy", "batch occupancy", "req", 1.0),
            ("energy_uj_per_query", "energy/query", "uJ", 1.0)):
        h = registry.get("histogram", hname)
        if h is None or not h.count:
            continue
        pc = h.percentiles((50, 95, 99))
        rows.append((label, h.count, pc["p50"] * scale, pc["p95"] * scale,
                     pc["p99"] * scale, unit))
    for stage, label in (("prescreen", "energy stage-0"),
                         ("approx", "energy stage-1")):
        h = registry.get("histogram", "energy_uj_per_query_stage",
                         stage=stage)
        if h is None or not h.count:
            continue
        pc = h.percentiles((50, 95, 99))
        rows.append((label, h.count, pc["p50"], pc["p95"], pc["p99"], "uJ"))
    if rows:
        print(f"[obs   ] {'metric':<16} {'count':>7} {'p50':>9} "
              f"{'p95':>9} {'p99':>9}")
        for label, count, p50, p95, p99, unit in rows:
            print(f"[obs   ] {label:<16} {count:>7} {p50:>9.3f} "
                  f"{p95:>9.3f} {p99:>9.3f}  {unit}")
    # where did request time go: waiting in the batch window (scheduling)
    # vs launch + retire (compute)? The split tells an operator whether
    # to tune --window/--batch (queue-bound) or block shapes (compute-bound)
    qw = registry.get("histogram", "serve_queue_wait_seconds")
    lw = registry.get("histogram", "serve_launch_wall_seconds")
    rl = registry.get("histogram", "serve_resolve_lag_seconds")
    queue_s = qw.total if qw is not None and qw.count else 0.0
    compute_s = sum(h.total for h in (lw, rl)
                    if h is not None and h.count)
    split = queue_s + compute_s
    if split > 0:
        print(f"[obs   ] time split: queue wait {queue_s * 1e3:.1f} ms "
              f"({100 * queue_s / split:.0f}%) vs compute "
              f"(launch+resolve) {compute_s * 1e3:.1f} ms "
              f"({100 * compute_s / split:.0f}%)")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            f.write(prometheus_text(registry))
        print(f"[obs   ] metrics -> {args.metrics_out} (prometheus text)")
    if args.trace_out and tracer is not None:
        n = write_chrome_trace(args.trace_out, tracer)
        print(f"[obs   ] trace   -> {args.trace_out} "
              f"({n} events; open in ui.perfetto.dev)")


if __name__ == "__main__":
    raise SystemExit(main())
