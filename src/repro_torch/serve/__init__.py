"""Serving layer: the deadline batcher and hot-cluster cache.

Port of `repro.serve`'s runtime (`serve/runtime.py`); the RAG pipelines,
sampler, sharded runtime and sparse KV cache of the reference package are
not ported yet (ROADMAP queue A).
"""
from repro_torch.serve.runtime import (HotClusterCache, RequestHandle,
                                       RuntimeConfig, ServingRuntime)

__all__ = ["HotClusterCache", "RequestHandle", "RuntimeConfig",
           "ServingRuntime"]
