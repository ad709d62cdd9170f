"""Serving layer: the deadline batcher, the hot-cluster cache, sparse-KV
decode, the sampler and the RAG pipelines.

Port of `repro.serve`: the runtime (`serve/runtime.py`), the sparse KV
cache (`serve/sparse_kv.py`), the sampler (`serve/sampler.py`) and the
RAG front ends (`serve/rag.py`), and the tenant-sharded runtime with
elastic failover (`serve/sharded.py`).
"""
from repro_torch.serve.runtime import (HotClusterCache, RequestHandle,
                                       RuntimeConfig, ServingRuntime)
from repro_torch.serve import sparse_kv
from repro_torch.serve.sampler import decode_loop, generate, sample_tokens
from repro_torch.serve.rag import (AgentTurnReport, MultiTenantRAGPipeline,
                                   RAGAgent, RAGPipeline)
from repro_torch.serve.sharded import (ShardedHandle, ShardedRuntimeConfig,
                                       ShardedServingRuntime)

__all__ = ["AgentTurnReport", "HotClusterCache", "MultiTenantRAGPipeline",
           "RAGAgent", "RAGPipeline", "RequestHandle", "RuntimeConfig",
           "ServingRuntime", "ShardedHandle", "ShardedRuntimeConfig",
           "ShardedServingRuntime", "decode_loop", "generate",
           "sample_tokens", "sparse_kv"]
