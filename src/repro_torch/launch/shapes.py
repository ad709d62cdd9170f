"""The dry run's input-shape cells and their abstract inputs (port of
`repro.launch.shapes`).

Every (arch x shape) cell runs ONE step of the port on meta tensors
(shape and dtype only, nothing allocated; the counterpart of the
reference's `ShapeDtypeStruct` stand-ins):

  train_4k     -> the sharded train step (loss + grads + optimizer update)
  prefill_32k  -> prefill      (prompt pass, returns primed cache)
  decode_32k   -> decode_step  (1 new token, KV/SSM cache of seq_len)
  long_500k    -> decode_step  (sub-quadratic archs only: ssm / hybrid;
                  the full-attention archs are skipped, as in the
                  reference)
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import ModelApi


@dataclasses.dataclass(frozen=True)
class ShapeCase:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq: int
    batch: int


SHAPES = {
    "train_4k": ShapeCase("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCase("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCase("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCase("long_500k", "decode", 524288, 1),
}

SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


def applicable(cfg: ModelConfig, shape_name: str) -> tuple[bool, str]:
    if shape_name == "long_500k" and cfg.family not in SUBQUADRATIC_FAMILIES:
        return False, ("skipped: 500k-token decode needs sub-quadratic "
                       f"attention; {cfg.family} is full-attention")
    return True, ""


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def abstract_batch(cfg: ModelConfig, case: ShapeCase) -> dict:
    """Training/prefill batch stand-ins for one global batch."""
    b, s = case.batch, case.seq
    if cfg.family == "encdec":
        return {"frames": _meta((b, s, cfg.d_model), torch.bfloat16),
                "tokens": _meta((b, s), torch.int32),
                "labels": _meta((b, s), torch.int32)}
    if cfg.family == "vlm":
        p = cfg.num_prefix_embeds
        return {"tokens": _meta((b, s - p), torch.int32),
                "labels": _meta((b, s - p), torch.int32),
                "prefix_embeds": _meta((b, p, cfg.d_model), torch.bfloat16)}
    return {"tokens": _meta((b, s), torch.int32),
            "labels": _meta((b, s), torch.int32)}


def abstract_cache(cfg: ModelConfig, api: ModelApi, case: ShapeCase,
                   src_len: int | None = None):
    """Abstract KV/SSM cache of seq_len for decode cells (meta tensors);
    the enc-dec's source length is `src_len`, by default seq_len."""
    kw = ({"src_len": src_len or case.seq} if cfg.family == "encdec"
          else {})
    return api.init_cache(case.batch, case.seq, device="meta", **kw)


def abstract_decode_tokens(case: ShapeCase):
    return _meta((case.batch, 1), torch.int32)
