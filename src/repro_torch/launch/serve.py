"""Serving launcher: RAG pipeline (retrieval + generation), the port of
`repro.launch.serve`.

    PYTHONPATH=src python -m repro_torch.launch.serve --num-docs 256 \\
        --requests 8 [--arch qwen2-0.5b] [--metric cosine] [--topk 3] \\
        [--device cpu] [--data 2 --model 2]

Builds the offline index (MiniLM-style embedder -> INT8 nibble-planar DB,
split over a (data, model) mesh of shard slots when --data x --model > 1;
the slots are dealt round-robin over the visible devices), then serves
batched requests through the paper's two-stage hierarchical retrieval
and the generator's prefill + decode, logging the
Table-II-calibrated energy ledger per query. `--arch` takes every
decoder LM (dense, vlm, MoE, SSM and hybrid): the pipeline drives the
generator through `generate`, which is family-agnostic. The enc-dec
`seamless-m4t-medium` is refused with the reference's message: it
decodes from frames, not augmented text. Runs on the CUDA device
unless `--device` names another. `--smoke` is on always, as in the
reference (ROADMAP C17); the full widths are driven through the library
(`chip_smoke.py`).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import RetrievalConfig
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import embedder, get_model
from repro_torch.serve import RAGPipeline


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--num-docs", type=int, default=256)
    ap.add_argument("--doc-len", type=int, default=12)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--topk", type=int, default=3)
    ap.add_argument("--metric", choices=("cosine", "mips"), default="cosine")
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(0)
    gcfg = get_config(args.arch, smoke=args.smoke)
    if gcfg.family == "encdec":
        raise SystemExit("RAG serving drives decoder-LM archs; "
                         "seamless decodes from frames, not augmented text")
    dev = resolve_device(args.device)
    gen_api = get_model(gcfg)
    gen_params = gen_api.init(torch.Generator(device=dev).manual_seed(0),
                              device=dev)

    ecfg = embedder.MINILM_CFG.with_(num_layers=2, d_model=64, num_heads=4,
                                     num_kv_heads=4, d_ff=128,
                                     vocab_size=gcfg.vocab_size,
                                     pooled_dim=64)
    eparams = embedder.init_params(
        ecfg, torch.Generator(device=dev).manual_seed(1), device=dev)

    docs = rng.integers(0, gcfg.vocab_size,
                        (args.num_docs, args.doc_len)).astype(np.int32)
    mesh = (make_test_mesh(args.data, args.model, dev)
            if args.data * args.model > 1 else None)
    t0 = time.time()
    pipe = RAGPipeline.build(
        ecfg, eparams, gen_api, gen_params, docs,
        RetrievalConfig(k=args.topk, metric=args.metric), mesh=mesh,
        device=dev)
    print(f"[offline] index over {args.num_docs} docs in "
          f"{time.time() - t0:.1f}s (device={pipe.device}, "
          f"mesh={'none' if mesh is None else mesh.shape})")

    gold = rng.integers(0, args.num_docs, args.requests)
    t0 = time.time()
    out, ids, ledger = pipe.answer(docs[gold], max_new=args.max_new)
    dt = time.time() - t0
    hits = int(np.sum(ids[:, 0].cpu().numpy() == gold))
    print(f"[online] {args.requests} reqs in {dt:.1f}s; top-1 hit "
          f"{hits}/{args.requests}; retrieval energy "
          f"{ledger.total_uj:.2f} uJ/query "
          f"(DRAM {100 * ledger.proportions()['DRAM']:.1f}%)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
