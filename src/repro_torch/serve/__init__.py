"""Serving layer: the deadline batcher, the hot-cluster cache and sparse-KV
decode.

Port of `repro.serve`'s runtime (`serve/runtime.py`) and sparse KV cache
(`serve/sparse_kv.py`); the RAG pipelines, sampler and sharded runtime of
the reference package are not ported yet (ROADMAP queue A).
"""
from repro_torch.serve.runtime import (HotClusterCache, RequestHandle,
                                       RuntimeConfig, ServingRuntime)
from repro_torch.serve import sparse_kv

__all__ = ["HotClusterCache", "RequestHandle", "RuntimeConfig",
           "ServingRuntime", "sparse_kv"]
