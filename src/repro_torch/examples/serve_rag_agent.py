"""End-to-end example (the paper's kind: SERVING), the port of
examples/serve_rag_agent.py: a RAG-enabled agent answering batched
requests.

Pipeline (paper Fig. 1): personal-record corpus -> MiniLM-style embedder
-> INT8 nibble-planar database -> per request batch: encode query ->
TWO-STAGE HIERARCHICAL RETRIEVAL -> augmented prompt -> batched
prefill+decode on the generator LM. Logs the paper's per-query retrieval
energy ledger alongside the generations.

    PYTHONPATH=src python -m repro_torch.examples.serve_rag_agent \\
        [--requests 8] [--num-docs 256] [--max-new 16] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import RetrievalConfig
from repro_torch.examples import agent_models
from repro_torch.serve import RAGPipeline


def run(ecfg, eparams, gen_api, gen_params, *, requests: int, num_docs: int,
        max_new: int, device: torch.device) -> dict:
    """Builds the index, answers `requests` queries and prints the log.
    Returns the pipeline and the answer: {"pipe", "tokens", "ids",
    "ledger", "gold"}."""
    rng = np.random.default_rng(0)
    # offline phase: the "personal medical record" corpus (synthetic tokens)
    doc_tokens = rng.integers(0, gen_api.cfg.vocab_size,
                              (num_docs, 12)).astype(np.int32)
    t0 = time.time()
    pipe = RAGPipeline.build(ecfg, eparams, gen_api, gen_params, doc_tokens,
                             RetrievalConfig(k=2, metric="cosine"),
                             device=device)
    print("[offline] built INT8 nibble-planar index over "
          f"{num_docs} docs in {time.time()-t0:.1f}s")

    # online phase: batched requests (queries = copies of docs so the
    # retrieval ground truth is visible in the log)
    gold = rng.integers(0, num_docs, requests)
    t0 = time.time()
    out, ids, ledger = pipe.answer(doc_tokens[gold], max_new=max_new)
    out, ids = out.cpu().numpy(), ids.cpu().numpy()
    dt = time.time() - t0
    hits = int(np.sum(ids[:, 0] == gold))
    print(f"[online] {requests} requests in {dt:.1f}s "
          f"({dt/requests:.2f}s/req incl. retrieval + "
          f"{max_new}-token decode)")
    print(f"  retrieval top-1 hit rate: {hits}/{requests}")
    print("  retrieval energy (paper cost model): "
          f"{ledger.total_uj:.2f} uJ/query, "
          f"DRAM share {100*ledger.proportions()['DRAM']:.1f}%")
    for i in range(min(3, requests)):
        print(f"  req{i}: retrieved docs {ids[i].tolist()} "
              f"(gold {gold[i]}) -> tokens {out[i][:8].tolist()}…")
    return {"pipe": pipe, "tokens": out, "ids": ids, "ledger": ledger,
            "gold": gold}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--num-docs", type=int, default=256)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    run(*agent_models(dev), requests=args.requests, num_docs=args.num_docs,
        max_new=args.max_new, device=dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
