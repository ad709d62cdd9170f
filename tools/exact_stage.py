"""The engine's exact stage (`ExactRescore.run`) and the whole B = 32 batch
around it, in one tree of the port, on the card.

    python3 tools/exact_stage.py [--src DIR]

`--src` names the tree's `src` directory (default: this checkout's), so
the same measurement runs in a parent's tree unpacked beside this one
(`git archive` into `build/parent`) and in this tree, in turns, one
process each: the tree's `repro_torch` is imported first, and the helpers
of this checkout's `chip_smoke.py` then measure it through the engine
both trees have. On the main phase's corpus (N = 2^20, D = 512, seeded as
`chip_smoke.phase_corpus` seeds it), per variant (Plain and Masked,
cosine and MIPS): the stage's launches and device microseconds per call
with the kernels that make them (torch.profiler), its event time
(`time_ms`), its host microseconds per call (`_host_us`), and each of
two batches' launches per batch by kernel name, with the kernels whose
count differs between the two batches. Exits 1 without a card.
"""
from __future__ import annotations

import argparse
import collections
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST_CALLS = 200          # back-to-back stage calls per host reading
BATCH_PROFILES = 2        # batches whose launches are compared


def _by_name(rows) -> collections.Counter:
    """Launches per call by kernel name from `device_profile` rows."""
    return collections.Counter({name: round(n) for name, _, n in rows})


def _short(name: str) -> str:
    return name if len(name) <= 60 else name[:57] + "..."


def variants(cs, gold, dev):
    from repro_torch.core.engine import MaskedPolicy, PlainPolicy
    from repro_torch.core.retrieval import RetrievalConfig
    owner = (cs.torch.arange(cs.N, device=dev)
             // cs.DOCS_PER_USER).to(cs.torch.int32)
    tids = (gold // cs.DOCS_PER_USER).to(cs.torch.int32)
    for metric in ("cosine", "mips"):
        cfg = RetrievalConfig(k=cs.K, metric=metric)
        yield f"plain_{metric}", cfg, lambda sl: PlainPolicy()
        yield (f"masked_{metric}", cfg,
               lambda sl: MaskedPolicy(owner=owner, tenant_ids=tids[sl]))


def stage(cs, card, db, q_codes, gold, dev) -> None:
    from repro_torch.core import engine as eng
    from repro_torch.core import quantization
    from repro_torch.core.engine import RetrievalEngine
    for name, cfg, policy_for in variants(cs, gold, dev):
        engine = RetrievalEngine(cfg, dev)
        sl = slice(0, cs.B)
        q = q_codes[sl]
        ctx = eng._CascadeCtx(query_codes=q,
                              q_msb=quantization.msb_nibble(q), db=db,
                              policy=policy_for(sl), cfg=cfg,
                              fns=eng.stage_fns(cfg.backend))
        state = eng.ApproxScan().run(eng._CascadeState(), ctx)
        exact = eng.ExactRescore()

        def run(state=state, ctx=ctx, exact=exact):
            return exact.run(state, ctx)
        want = engine.retrieve(q, db, policy_for(sl))
        got = run().result
        for field in ("indices", "scores", "candidate_indices"):
            if not cs.torch.equal(getattr(got, field), getattr(want, field)):
                raise AssertionError(f"{name}: the stage alone differs from "
                                     f"the engine in {field}")
        rows = cs.device_profile(run, reps=5)
        busy = sum(t for _, t, _ in rows)
        launched = sum(n for _, _, n in rows)
        kinds = _by_name(rows)
        top = ", ".join(f"{_short(n)} x{c}" for n, c in kinds.most_common(8))
        cs.log(f"stage {name} ({card}): launches_per_call {launched:.0f} of "
               f"{len(rows)} kinds; device_us_per_call {busy:.1f}; "
               f"event_ms {cs.time_ms(run):.4f}; host_us_per_call "
               f"{cs._host_us(run, calls=HOST_CALLS)} (median of 3 rounds "
               f"of {HOST_CALLS}); most launched: {top}")
        seen = []
        for i in range(BATCH_PROFILES):
            bl = slice(i * cs.B, (i + 1) * cs.B)
            prof = cs.device_profile(
                lambda bl=bl: engine.retrieve(q_codes[bl], db,
                                              policy_for(bl)))
            seen.append(_by_name(prof))
            cs.log(f"batch {name} #{i} ({card}): launches_per_batch "
                   f"{sum(seen[-1].values())} device_busy_us "
                   f"{sum(t for _, t, _ in prof):.1f}")
        diff = {_short(k): (seen[0][k], seen[1][k])
                for k in set(seen[0]) | set(seen[1])
                if seen[0][k] != seen[1][k]}
        cs.log(f"batch {name}: kernels whose launches differ between the "
               f"two batches: {diff or 'none'}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src", default=os.path.join(ROOT, "src"))
    args = parser.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    import repro_torch  # noqa: F401  the tree measured, imported first
    if not torch.cuda.is_available():
        print("exact_stage: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    t0 = time.perf_counter()
    card = cs.phase_card()
    cs.log(f"exact_stage: the tree {os.path.abspath(args.src)} "
           f"({os.path.dirname(repro_torch.__file__)})")
    dev = torch.device("cuda", 0)
    qdb, db, q_codes, gold = cs.phase_corpus(dev)
    del qdb
    stage(cs, card, db, q_codes, gold, dev)
    cs.log(f"exact_stage: done in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
