"""End-to-end RAG pipelines (Fig. 1 of the paper; single- and multi-tenant;
port of `repro.serve.rag`).

offline:  doc tokens --MiniLM embedder--> float embeddings --INT8 quant-->
          nibble-planar DB (optionally split over a mesh's shard slots)
online:   query tokens -> query embedding -> INT8 codes
          -> TWO-STAGE HIERARCHICAL RETRIEVAL (the paper's core)
          -> augmented prompt = [retrieved doc tokens; query tokens]
          -> generator prefill + decode

`MultiTenantRAGPipeline` is the streaming variant: per-user corpora are
ingested online into one shared arena (`repro_torch.tenancy`) and a mixed
batch of users is served by one retrieval launch. `RAGAgent` runs a turn
through a `ServingRuntime`: retrieval, then decode over the
quantized-KV cascade, both charged to the runtime's ledgers.

Every pipeline runs on one device: the CUDA device unless the caller
passes ``device="cpu"`` (with a mesh: the mesh's first device); the
parameters must already be there. Each retrieval is priced as the
reference prices it: `energy.cost_cascade` of the launch's SchedulePlan.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import (BitPlanarDB, RetrievalConfig, build_database,
                              energy, quantize_int8)
from repro_torch.core import engine as engine_mod
from repro_torch.core.index import ShardedIndex
from repro_torch.models import dense, registry
from repro_torch.models import embedder as emb_mod
from repro_torch.models.common import ModelConfig
from repro_torch.serve import sparse_kv
from repro_torch.serve.sampler import decode_loop, generate
from repro_torch.tenancy import MultiTenantIndex


def _on(params, dev: torch.device, what: str) -> None:
    """Refuse parameters that are not on the pipeline's device."""
    got = params["embed"].device
    if got.type != dev.type:
        raise ValueError(f"{what} parameters are on {got}, the pipeline "
                         f"runs on {dev}")


def _prompt(docs: torch.Tensor, query_tokens: torch.Tensor,
            vocab: int) -> torch.Tensor:
    """[retrieved doc tokens; query tokens], clipped to the vocabulary."""
    return torch.cat([docs, query_tokens.to(docs.dtype)],
                     dim=1).clamp(0, vocab - 1)


@dataclasses.dataclass
class RAGPipeline:
    emb_cfg: ModelConfig
    emb_params: Any
    gen_api: registry.ModelApi
    gen_params: Any
    retrieval_cfg: RetrievalConfig
    doc_tokens: torch.Tensor               # (N, doc_len) int32
    db: BitPlanarDB | None = None          # single-device DB
    index: ShardedIndex | None = None      # DB split over a mesh
    # (config, retrieve function): the engine's, or the sharded index's,
    # built once per retrieval config; replacing `retrieval_cfg` after
    # construction builds a new one instead of serving the old
    # k/metric/backend.
    _retrieve: Any = dataclasses.field(default=None, repr=False,
                                       compare=False)

    @property
    def device(self) -> torch.device:
        return self.doc_tokens.device

    @classmethod
    def build(cls, emb_cfg, emb_params, gen_api, gen_params, doc_tokens,
              retrieval_cfg: RetrievalConfig | None = None, mesh=None, *,
              encode_batch: int = 64, device=None):
        """Offline phase: embed + quantize the document corpus; with a
        `mesh` (`repro_torch.distributed.Mesh`) the DB is split over its
        shard slots and the pipeline runs on the mesh's first device."""
        if mesh is None:
            dev = resolve_device(device)
        else:
            dev = mesh.slots()[0]
            if device is not None and torch.device(device).type != dev.type:
                raise ValueError(f"device {device} is not the mesh's "
                                 f"{dev}")
        _on(emb_params, dev, "embedder")
        _on(gen_params, dev, "generator")
        doc_tokens = torch.as_tensor(doc_tokens, device=dev).to(torch.int32)
        embs = torch.cat([
            emb_mod.encode(emb_params, doc_tokens[i:i + encode_batch],
                           emb_cfg)
            for i in range(0, doc_tokens.shape[0], encode_batch)])
        if mesh is not None:
            index, db = ShardedIndex.build(embs, mesh), None
        else:
            index = None
            db = BitPlanarDB.from_quantized(build_database(embs, device=dev))
        return cls(emb_cfg=emb_cfg, emb_params=emb_params, gen_api=gen_api,
                   gen_params=gen_params,
                   retrieval_cfg=retrieval_cfg or RetrievalConfig(),
                   doc_tokens=doc_tokens, db=db, index=index)

    # -- retrieval ---------------------------------------------------------

    def retrieve(self, query_tokens):
        """query_tokens (B, L) -> (batched RetrievalResult, energy ledger)."""
        q_emb = emb_mod.encode(self.emb_params,
                               torch.as_tensor(query_tokens,
                                               device=self.device),
                               self.emb_cfg)
        q_codes, _ = quantize_int8(q_emb, per_vector=True)
        # One launch for the batch (one per shard with a mesh): the plane is
        # streamed once for all queries. Charge what the schedule streams
        # (the plain plan's per-stage ledger), as the reference does.
        cfg = self.retrieval_cfg
        if self._retrieve is None or self._retrieve[0] != cfg:
            if self.index is not None:
                fn = self.index.retrieve_fn(cfg)
            else:
                engine = engine_mod.RetrievalEngine(cfg, self.device)
                fn = functools.partial(engine.retrieve, db=self.db)
            self._retrieve = (cfg, fn)
        res = self._retrieve[1](q_codes)
        n_docs = (self.db.num_docs if self.index is None
                  else self.index.n_global)
        dim = q_emb.shape[-1]
        plan = engine_mod.plan(self.retrieval_cfg, num_docs=n_docs,
                               dim=dim, batch=int(q_codes.shape[0]),
                               kind="plain")
        return res, energy.cost_cascade(plan.stages, dim, batch=plan.batch)

    # -- generation --------------------------------------------------------

    def answer(self, query_tokens, *, max_new: int = 32,
               temperature: float = 0.0,
               generator: torch.Generator | None = None):
        """Full RAG answer: retrieve, augment, generate.

        Returns (generated tokens (B, max_new), retrieved ids (B, k),
        energy ledger for the retrieval stage)."""
        query_tokens = torch.as_tensor(query_tokens, device=self.device)
        res, ledger = self.retrieve(query_tokens)
        ids = res.indices                                 # (B, k)
        b, k = ids.shape
        docs = self.doc_tokens[ids.reshape(-1)].reshape(
            b, k * self.doc_tokens.shape[1])
        prompt = _prompt(docs, query_tokens, self.gen_api.cfg.vocab_size)
        out, _ = generate(self.gen_api, self.gen_params, {"tokens": prompt},
                          max_new=max_new, temperature=temperature,
                          generator=generator)
        return out, ids, ledger


@dataclasses.dataclass
class AgentTurnReport:
    """Accounting for one end-to-end agent turn (retrieve + decode)."""
    tokens: torch.Tensor         # (B, max_new) generated ids
    retrieved: np.ndarray        # (B, k) arena slot ids (-1 = no hit)
    retrieval_cost: Any          # energy.CostBreakdown, PER QUERY
    decode_cost: Any             # energy.CostBreakdown, PER TOKEN
    decode_plan: Any             # engine.SchedulePlan (kind="decode")
    uj_per_query: float
    uj_per_token: float
    decode_bytes_per_token: int      # measured ledger, whole batch
    dense_bytes_per_token: int       # dense-decode baseline, whole batch


@dataclasses.dataclass
class RAGAgent:
    """End-to-end agent turn: ONE `ServingRuntime` schedules both the
    retrieval launch and the decode-step KV cascade, and both land in its
    registry (µJ/query from the retrieval plan, µJ/token from the
    `kv_plan` ledger through `runtime.account_decode`). The generator
    must be a dense-family model (the quantized-KV decode lives in
    models/dense)."""

    pipeline: "MultiTenantRAGPipeline"
    runtime: Any                      # serve.runtime.ServingRuntime
    # decode cascade knobs (see sparse_kv.sparse_decode_attention)
    top_k: int = 64
    npages: int | None = None
    prescreen_c0: int | None = None
    page_rows: int = 8
    backend: str = "cuda"

    def __post_init__(self):
        api = self.pipeline.gen_api
        if api is None or api.cfg.family != "dense":
            raise ValueError("RAGAgent needs a dense-family generator "
                             "(quantized-KV decode lives in models/dense)")
        if self.runtime.index is not self.pipeline.index:
            raise ValueError("runtime must serve the pipeline's index — "
                             "one runtime schedules retrieval AND decode")

    def _total_len(self, prompt_len: int, max_new: int) -> int:
        total = prompt_len + max_new
        if self.npages is not None:
            total = -(-total // self.page_rows) * self.page_rows
        return total

    def turn(self, tenant_ids, query_tokens, *, max_new: int = 16,
             temperature: float = 0.0,
             generator: torch.Generator | None = None,
             now: float | None = None) -> AgentTurnReport:
        """Retrieve through the runtime, generate with the KV cascade,
        charge both against one registry. Returns an AgentTurnReport."""
        pipe = self.pipeline
        api, cfg = pipe.gen_api, pipe.gen_api.cfg
        query_tokens = torch.as_tensor(query_tokens, device=pipe.device)
        # 1. retrieval: per-request admission through the runtime (the
        # scheduler batches the tenants into one launch).
        q_emb = pipe._embed(query_tokens)
        q_codes, _ = quantize_int8(q_emb, per_vector=True)
        codes = q_codes.cpu().numpy()
        handles = [self.runtime.submit(int(t), codes[i], now=now)
                   for i, t in enumerate(np.asarray(tenant_ids))]
        self.runtime.flush(now=now)
        ids = np.stack([h.result().indices.numpy() for h in handles])
        retrieval_cost = self.runtime.energy_ledger(q_emb.shape[-1])
        # 2. prompt assembly (invalid hits contribute zero tokens).
        prompt = pipe._prompt(ids, query_tokens)
        # 3. prefill, then the cache converted to the nibble-planar
        # QuantCache once.
        total = self._total_len(prompt.shape[1], max_new)
        logits, cache = api.prefill(pipe.gen_params, {"tokens": prompt},
                                    max_len=total)
        qcache = dense.quantize_cache(
            cache, page_rows=self.page_rows if self.npages else None)
        del cache
        # 4. decode loop: every step's attention is the engine cascade.
        toks, _ = decode_loop(
            logits, qcache,
            lambda c, t: dense.decode_step_quant(
                pipe.gen_params, c, t, cfg, top_k=self.top_k,
                npages=self.npages, prescreen_c0=self.prescreen_c0,
                backend=self.backend),
            max_new, temperature=temperature, generator=generator)
        # 5. decode accounting: one kv_plan prices the run (the stage
        # geometry is fixed at the cache's allocated length), charged
        # through the SAME runtime as the retrieval launch.
        b = ids.shape[0]
        kv_cfg = engine_mod.KVCascadeConfig(
            top_k=self.top_k, npages=self.npages, page_rows=self.page_rows,
            prescreen_c0=self.prescreen_c0, backend=self.backend)
        plan = engine_mod.kv_plan(kv_cfg, batch=b,
                                  kv_heads=cfg.num_kv_heads,
                                  q_heads=cfg.num_heads, seq_len=total,
                                  head_dim=cfg.hd, layers=cfg.num_layers)
        decode_cost = self.runtime.account_decode(plan, dim=cfg.hd,
                                                  tokens=max_new)
        dense_bytes = (b * cfg.num_layers * cfg.num_kv_heads
                       * sparse_kv.dense_bytes_per_step(total, cfg.hd))
        return AgentTurnReport(
            tokens=toks, retrieved=ids, retrieval_cost=retrieval_cost,
            decode_cost=decode_cost, decode_plan=plan,
            uj_per_query=retrieval_cost.total_uj,
            uj_per_token=decode_cost.total_uj,
            decode_bytes_per_token=sum(s.bytes_hbm for s in plan.stages),
            dense_bytes_per_token=dense_bytes)


@dataclasses.dataclass
class MultiTenantRAGPipeline:
    """Streaming RAG serving many per-user corpora from ONE shared arena.

    No offline build: tenants ingest documents online (encode -> fixed-scale
    INT8 quantize -> pack into free arena slots) and a mixed batch of
    tenants' queries runs as one retrieval launch. Document tokens live in
    a host-side slot-addressed store kept in lockstep with the arena
    (across compactions too)."""

    emb_cfg: ModelConfig
    emb_params: Any
    gen_api: registry.ModelApi | None
    gen_params: Any
    index: MultiTenantIndex
    doc_tokens: np.ndarray                 # (capacity, doc_len) int32

    @property
    def device(self) -> torch.device:
        return self.index.device

    @classmethod
    def create(cls, emb_cfg, emb_params, gen_api, gen_params, *,
               capacity: int, doc_len: int,
               retrieval_cfg: RetrievalConfig | None = None,
               clusters=None, device=None):
        """clusters: optional `core.clustering.ClusterParams` — enables the
        cluster-pruned cascade for this pipeline's index."""
        index = MultiTenantIndex(capacity, emb_cfg.pooled_dim,
                                 retrieval_cfg or RetrievalConfig(),
                                 clusters=clusters, device=device)
        _on(emb_params, index.device, "embedder")
        if gen_api is not None:
            _on(gen_params, index.device, "generator")
        return cls(emb_cfg=emb_cfg, emb_params=emb_params, gen_api=gen_api,
                   gen_params=gen_params, index=index,
                   doc_tokens=np.zeros((capacity, doc_len), np.int32))

    def _embed(self, tokens) -> torch.Tensor:
        return emb_mod.encode(self.emb_params,
                              torch.as_tensor(tokens, device=self.device),
                              self.emb_cfg)

    def _prompt(self, ids: np.ndarray, query_tokens) -> torch.Tensor:
        """The augmented prompt of (B, k) slot ids; an invalid hit (-1)
        contributes all-zero context tokens."""
        b, k = ids.shape
        flat = ids.reshape(-1)
        docs = np.where((flat >= 0)[:, None],
                        self.doc_tokens[np.maximum(flat, 0)], 0)
        docs = torch.from_numpy(docs.reshape(
            b, k * self.doc_tokens.shape[1])).to(self.device)
        return _prompt(docs, torch.as_tensor(query_tokens,
                                             device=self.device),
                       self.gen_api.cfg.vocab_size)

    # -- online corpus mutation -------------------------------------------

    def ingest(self, tenant_id: int, doc_tokens) -> np.ndarray:
        """Add (B, doc_len) docs to one tenant's corpus; returns slot ids."""
        doc_tokens = np.asarray(doc_tokens, np.int32)
        slots = self.index.ingest(tenant_id,
                                  self._embed(torch.from_numpy(doc_tokens)))
        self.doc_tokens[slots] = doc_tokens
        return slots

    def delete(self, tenant_id: int, slots) -> None:
        self.index.delete(tenant_id, slots)

    def compact(self) -> np.ndarray:
        """Reclaim tombstones; remaps the token store with the arena."""
        mapping = self.index.compact()
        moved = np.nonzero(mapping >= 0)[0]
        new_tokens = np.zeros_like(self.doc_tokens)
        new_tokens[mapping[moved]] = self.doc_tokens[moved]
        self.doc_tokens = new_tokens
        return mapping

    # -- query -------------------------------------------------------------

    def retrieve(self, tenant_ids, query_tokens):
        """(B,) tenant ids + (B, L) query tokens -> (results, energy ledger).

        Queries of different tenants batch together: one embedder forward,
        one retrieval launch over the shared arena."""
        q_emb = self._embed(query_tokens)
        # Per-vector query quantization: only the doc rows must share the
        # arena's fixed scale; a query-side scale cannot change a query's
        # ranking.
        q_codes, _ = quantize_int8(q_emb, per_vector=True)
        res = self.index.retrieve(q_codes, tenant_ids)
        # Charge what the launch's SchedulePlan streams.
        plan = self.index.last_plan
        if plan is not None:
            ledger = energy.cost_cascade(plan.stages, q_emb.shape[-1],
                                         batch=plan.batch)
        else:
            ledger = energy.cost_hierarchical(self.index.capacity,
                                              q_emb.shape[-1])
        return res, ledger

    def answer(self, tenant_ids, query_tokens, *, max_new: int = 32,
               temperature: float = 0.0,
               generator: torch.Generator | None = None):
        """Retrieve per-tenant context and generate, one mixed batch.
        Returns (tokens, slot ids, ledger)."""
        if self.gen_api is None:
            raise ValueError("pipeline was created without a generator")
        res, ledger = self.retrieve(tenant_ids, query_tokens)
        ids = res.indices.cpu().numpy()                   # (B, k)
        out, _ = generate(self.gen_api, self.gen_params,
                          {"tokens": self._prompt(ids, query_tokens)},
                          max_new=max_new, temperature=temperature,
                          generator=generator)
        return out, ids, ledger
