"""The port's sampler, RAG front ends and serving launcher
(`repro_torch.serve.sampler`, `repro_torch.serve.rag`,
`repro_torch.launch.serve`) against the reference's, on the CPU.

Both packages get the same numpy tokens and the reference's parameters
(carried across by `repro_torch.convert`); the port runs with
``device="cpu"``, where its kernel backend takes the plain versions. Held
exactly: greedy tokens, retrieved ids, arena slots and compaction
mappings, the token store, `decode_plan`, `decode_steps` and registry
histogram counts; the energy ledgers to a relative 1e-12 (the same
Python float arithmetic on the same plans). Sampling at temperature > 0
draws from a `torch.Generator`, which cannot replay
`jax.random.categorical`: it is held to its shape, range and
determinism under one seed. The cases mirror tests/test_serve.py:25-100,
tests/test_tenancy.py:245 and tests/test_decode_cascade.py:268.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as jget_config
from repro.core import RetrievalConfig as JRetrievalConfig
from repro.models import embedder as jembedder
from repro.models import get_model as jget_model
from repro.models.common import ModelConfig as JModelConfig
from repro.obs import MetricsRegistry as JMetricsRegistry
from repro.serve import MultiTenantRAGPipeline as JMultiTenantRAGPipeline
from repro.serve import RAGAgent as JRAGAgent
from repro.serve import RAGPipeline as JRAGPipeline
from repro.serve import RuntimeConfig as JRuntimeConfig
from repro.serve import ServingRuntime as JServingRuntime
from repro.serve import generate as jgenerate
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import RetrievalConfig, energy, engine
from repro_torch.launch import serve as launch_serve
from repro_torch.models import embedder, get_model
from repro_torch.models.common import ModelConfig
from repro_torch.obs import MetricsRegistry
from repro_torch.serve import (MultiTenantRAGPipeline, RAGAgent, RAGPipeline,
                               RuntimeConfig, ServingRuntime, generate,
                               sample_tokens)
from repro_torch.tenancy import MultiTenantIndex

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def tiny_gen():
    """(reference api, reference params, port api, port params): the
    qwen2-0.5b smoke model."""
    japi = jget_model(jget_config("qwen2-0.5b", smoke=True))
    jp = japi.init(jax.random.PRNGKey(0))
    api = get_model(get_config("qwen2-0.5b", smoke=True))
    return japi, jp, api, convert.dense_params(_np(jp), device=CPU)


def tiny_embedder(**kw):
    widths = dict(num_layers=2, d_model=32, num_heads=4, num_kv_heads=4,
                  d_ff=64, vocab_size=128, pooled_dim=32, **kw)
    jcfg = jembedder.MINILM_CFG.with_(**widths)
    jp = jembedder.init_params(jcfg, jax.random.PRNGKey(7))
    return (jcfg, jp, embedder.MINILM_CFG.with_(**widths),
            convert.embedder_params(_np(jp), device=CPU))


def _toks(shape, vocab=128, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _same_ledger(got, want):
    assert got.total_uj == pytest.approx(want.total_uj, rel=1e-12)
    assert dataclasses.asdict(got) == pytest.approx(
        dataclasses.asdict(want), rel=1e-12)


# -- the sampler ---------------------------------------------------------------

def test_generate_batched_matches_reference():
    japi, jp, api, tp = tiny_gen()
    toks = _toks((3, 8))
    out, cache = generate(api, tp, {"tokens": torch.from_numpy(toks)},
                          max_new=5)
    assert tuple(out.shape) == (3, 5) and out.dtype == torch.int32
    # the LAST generated token is sampled but never fed back
    assert cache.length.tolist() == [8 + 5 - 1] * 3
    want, _ = jgenerate(japi, jp, {"tokens": jnp.asarray(toks)}, max_new=5)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_generate_repeat_calls_rebuild_nothing():
    """What the reference's cached jits protect (no per-call rebuild):
    repeat calls issue the same operators, leave the parameters where they
    are, and give the same greedy tokens."""
    _, _, api, tp = tiny_gen()
    toks = torch.from_numpy(_toks((2, 8)))
    ptrs = {k: v.data_ptr() for k, v in tp["blocks"].items()}
    generate(api, tp, {"tokens": toks}, max_new=3)              # warm
    runs = []
    for _ in range(2):
        with _OpCount() as count:
            out, _ = generate(api, tp, {"tokens": toks}, max_new=3)
        runs.append((count.ops, out))
    assert runs[0][0] == runs[1][0]
    assert not any("normal" in op or "uniform" in op for op in runs[0][0])
    np.testing.assert_array_equal(runs[0][1].numpy(), runs[1][1].numpy())
    assert ptrs == {k: v.data_ptr() for k, v in tp["blocks"].items()}


def test_sampling_at_temperature_is_seeded_and_in_range():
    _, _, api, tp = tiny_gen()
    toks = torch.from_numpy(_toks((3, 8)))

    def draw(seed):
        gen = torch.Generator().manual_seed(seed)
        return generate(api, tp, {"tokens": toks}, max_new=6,
                        temperature=1.5, generator=gen)[0]
    a, b, c = draw(0), draw(0), draw(1)
    assert tuple(a.shape) == (3, 6) and a.dtype == torch.int32
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < api.cfg.vocab_size
    logits = torch.tensor([[[0.0, 5.0, 1.0]]])
    assert sample_tokens(logits).tolist() == [[1]]
    # a peaked distribution at a small temperature picks its mode
    assert sample_tokens(logits, torch.Generator().manual_seed(0),
                         0.01).tolist() == [[1]]


# -- RAGPipeline ---------------------------------------------------------------

def _pipelines(k=2):
    jecfg, jep, tecfg, tep = tiny_embedder()
    japi, jgp, api, tgp = tiny_gen()
    docs = _toks((40, 12), seed=3)
    jpipe = JRAGPipeline.build(jecfg, jep, japi, jgp, jnp.asarray(docs),
                               JRetrievalConfig(k=k))
    pipe = RAGPipeline.build(tecfg, tep, api, tgp, docs, RetrievalConfig(k=k),
                             device=CPU)
    return jpipe, pipe, docs


def test_rag_pipeline_matches_reference_end_to_end():
    """Queries are copies of documents 5, 17 and 23: top-1 is the copied
    doc, every retrieved id equals the reference's, and the ledger is
    cost_cascade of the engine's plain plan (below the full scan)."""
    jpipe, pipe, docs = _pipelines()
    q = docs[[5, 17, 23]]
    res, ledger = pipe.retrieve(q)
    jres, jledger = jpipe.retrieve(jnp.asarray(q))
    np.testing.assert_array_equal(res.indices.numpy(),
                                  np.asarray(jres.indices))
    assert res.indices[:, 0].tolist() == [5, 17, 23]
    _same_ledger(ledger, jledger)
    plan = engine.plan(pipe.retrieval_cfg, num_docs=40, dim=32, batch=3,
                       kind="plain")
    assert ledger.total_uj == energy.cost_cascade(plan.stages, 32,
                                                  batch=3).total_uj
    assert ledger.total_uj < energy.cost_hierarchical(40, 32).total_uj
    out, ids, _ = pipe.answer(q, max_new=4)
    jout, jids, _ = jpipe.answer(jnp.asarray(q), max_new=4)
    assert tuple(out.shape) == (3, 4)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))


def test_rag_pipeline_rebuilds_its_engine_for_a_new_config():
    jpipe, pipe, docs = _pipelines()
    q = docs[[5, 17]]
    pipe.retrieve(q)
    pipe.retrieval_cfg = RetrievalConfig(k=4, metric="mips")
    jpipe.retrieval_cfg = JRetrievalConfig(k=4, metric="mips")
    res, ledger = pipe.retrieve(q)
    jres, jledger = jpipe.retrieve(jnp.asarray(q))
    assert tuple(res.indices.shape) == (2, 4)
    np.testing.assert_array_equal(res.indices.numpy(),
                                  np.asarray(jres.indices))
    _same_ledger(ledger, jledger)


# -- MultiTenantRAGPipeline ------------------------------------------------------

def test_multi_tenant_rag_pipeline_matches_reference():
    """tests/test_tenancy.py:245 in lockstep: ingest, retrieve, answer,
    delete, compact, with the token store kept slot-aligned."""
    japi, jgp, api, tgp = tiny_gen()
    jecfg, jep, tecfg, tep = tiny_embedder()
    jpipe = JMultiTenantRAGPipeline.create(
        jecfg, jep, japi, jgp, capacity=128, doc_len=10,
        retrieval_cfg=JRetrievalConfig(k=2))
    pipe = MultiTenantRAGPipeline.create(
        tecfg, tep, api, tgp, capacity=128, doc_len=10,
        retrieval_cfg=RetrievalConfig(k=2), device=CPU)
    rng = np.random.default_rng(0)
    tok = {t: rng.integers(0, 128, (20, 10)).astype(np.int32)
           for t in range(3)}
    slots = {}
    for t in range(3):
        slots[t] = pipe.ingest(t, tok[t])
        np.testing.assert_array_equal(slots[t], jpipe.ingest(t, tok[t]))
    np.testing.assert_array_equal(pipe.doc_tokens, jpipe.doc_tokens)
    tids = np.asarray([0, 1, 2], np.int32)
    q = np.stack([tok[t][4] for t in range(3)])
    res, ledger = pipe.retrieve(tids, q)
    jres, jledger = jpipe.retrieve(tids, jnp.asarray(q))
    np.testing.assert_array_equal(res.indices.numpy(),
                                  np.asarray(jres.indices))
    assert res.indices[:, 0].tolist() == [int(slots[t][4]) for t in range(3)]
    _same_ledger(ledger, jledger)
    out, ids, _ = pipe.answer(tids, q, max_new=4)
    jout, jids, _ = jpipe.answer(tids, jnp.asarray(q), max_new=4)
    assert tuple(out.shape) == (3, 4)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))

    # delete + compact keeps the token store slot-aligned
    pipe.delete(0, slots[0][:3])
    jpipe.delete(0, slots[0][:3])
    np.testing.assert_array_equal(pipe.compact(), jpipe.compact())
    np.testing.assert_array_equal(pipe.doc_tokens, jpipe.doc_tokens)
    res, _ = pipe.retrieve(np.asarray([0], np.int32), tok[0][4][None])
    top = int(res.indices[0, 0])
    assert np.array_equal(pipe.doc_tokens[top], tok[0][4])
    with pytest.raises(ValueError, match="without a generator"):
        dataclasses.replace(pipe, gen_api=None).answer(tids, q)


# -- RAGAgent ----------------------------------------------------------------

def _agents(dtype="bfloat16", **knobs):
    """tests/test_decode_cascade.py:268's agent, in both packages (its
    generator computes in bf16; `dtype` may ask for f32)."""
    widths = dict(name="e", family="dense", num_layers=1, d_model=32,
                  num_heads=2, num_kv_heads=2, d_ff=64, vocab_size=64,
                  pooled_dim=32)
    gwidths = dict(name="g", family="dense", num_layers=2, d_model=64,
                   num_heads=4, num_kv_heads=2, d_ff=96, vocab_size=64,
                   compute_dtype=dtype)
    jecfg, jgcfg = JModelConfig(**widths), JModelConfig(**gwidths)
    jep = jembedder.init_params(jecfg, jax.random.PRNGKey(7))
    japi = jget_model(jgcfg)
    jgp = japi.init(jax.random.PRNGKey(1))
    jpipe = JMultiTenantRAGPipeline.create(jecfg, jep, japi, jgp,
                                           capacity=64, doc_len=4)
    pipe = MultiTenantRAGPipeline.create(
        ModelConfig(**widths), convert.embedder_params(_np(jep), device=CPU),
        get_model(ModelConfig(**gwidths)),
        convert.dense_params(_np(jgp), device=CPU), capacity=64, doc_len=4,
        device=CPU)
    rng = np.random.default_rng(0)
    for t in range(2):
        docs = rng.integers(0, 64, size=(6, 4))
        np.testing.assert_array_equal(pipe.ingest(t, docs),
                                      jpipe.ingest(t, docs))
    jreg, reg = JMetricsRegistry(), MetricsRegistry()
    jrt = JServingRuntime(jpipe.index,
                          JRuntimeConfig(max_batch=2, auto_flush=False),
                          registry=jreg)
    rt = ServingRuntime(pipe.index,
                        RuntimeConfig(max_batch=2, auto_flush=False),
                        registry=reg)
    return (JRAGAgent(pipeline=jpipe, runtime=jrt, **knobs),
            RAGAgent(pipeline=pipe, runtime=rt, **knobs), jreg, reg,
            rng.integers(0, 64, size=(2, 4)))


def _hist_counts(reg):
    return {k: v["count"] for k, v in reg.snapshot()["histograms"].items()}


def _plan_fields(plan):
    return (plan.kind, plan.batch, plan.rows_scanned, plan.candidates,
            plan.stage1_bytes, plan.stage1_bytes_vmapped, plan.stage2_bytes,
            tuple(dataclasses.astuple(s) for s in plan.stages),
            plan.stage1_bytes_sram)


PAGED = dict(top_k=16, npages=4, prescreen_c0=24, page_rows=8)


@pytest.mark.parametrize("dtype,knobs", [("float32", PAGED),
                                         ("float32", dict(top_k=8)),
                                         ("bfloat16", PAGED)])
def test_rag_agent_turn_in_lockstep_with_reference(dtype, knobs):
    """Two turns, each held to the reference's: retrieved ids, greedy
    tokens, µJ/query and µJ/token, the decode plan and its byte counts,
    decode_steps and every registry histogram's count.

    At the reference config's bf16 compute only the first token (sampled
    from the prefill's logits) is compared: the two packages' bf16 keys
    differ by up to a bf16 ulp, so about a fifth of the INT8 key codes
    round the other way, the cascade keeps other positions and the
    quantized steps' logits part (ROADMAP C16). At f32 no code differs
    and every token is equal."""
    jagent, agent, jreg, reg, q = _agents(dtype, **knobs)
    for turn, now in enumerate((0.0, 1.0)):
        rep = agent.turn(np.array([0, 1]), q, max_new=6, now=now)
        jrep = jagent.turn(np.array([0, 1]), jnp.asarray(q), max_new=6,
                           now=now)
        np.testing.assert_array_equal(rep.retrieved, jrep.retrieved)
        assert tuple(rep.tokens.shape) == (2, 6)
        upto = 6 if dtype == "float32" else 1
        np.testing.assert_array_equal(rep.tokens.numpy()[:, :upto],
                                      np.asarray(jrep.tokens)[:, :upto])
        assert rep.uj_per_query == pytest.approx(jrep.uj_per_query,
                                                 rel=1e-12)
        assert rep.uj_per_token == pytest.approx(jrep.uj_per_token,
                                                 rel=1e-12)
        assert rep.uj_per_query > 0 and rep.uj_per_token > 0
        assert _plan_fields(rep.decode_plan) == _plan_fields(
            jrep.decode_plan)
        assert rep.decode_plan.kind == "decode"
        assert (rep.decode_bytes_per_token, rep.dense_bytes_per_token) == (
            jrep.decode_bytes_per_token, jrep.dense_bytes_per_token)
        assert agent.runtime.decode_steps == jagent.runtime.decode_steps \
            == 6 * (turn + 1)
        assert _hist_counts(reg) == _hist_counts(jreg)
    hist = reg.snapshot()["histograms"]
    assert hist["energy_uj_per_token"]["count"] == 12
    assert hist["energy_uj_per_query"]["count"] >= 2


def test_rag_agent_backends_agree_and_checks_its_wiring():
    """The kernel backend ("cuda", the default: plain versions on CPU
    tensors) and the plain one give the same turn; the agent refuses a
    runtime over another index and a non-dense generator."""
    _, agent, _, _, q = _agents(top_k=16, npages=4, prescreen_c0=24,
                                page_rows=8)
    assert agent.backend == "cuda"
    a = agent.turn(np.array([0, 1]), q, max_new=4, now=0.0)
    plain = dataclasses.replace(agent, backend="torch")
    b = plain.turn(np.array([0, 1]), q, max_new=4, now=1.0)
    assert torch.equal(a.tokens, b.tokens)
    np.testing.assert_array_equal(a.retrieved, b.retrieved)
    other = ServingRuntime(MultiTenantIndex(64, 32, device=CPU))
    with pytest.raises(ValueError, match="runtime must serve"):
        RAGAgent(pipeline=agent.pipeline, runtime=other)
    vlm = dataclasses.replace(
        agent.pipeline,
        gen_api=get_model(agent.pipeline.gen_api.cfg.with_(family="vlm")))
    with pytest.raises(ValueError, match="dense-family"):
        RAGAgent(pipeline=vlm, runtime=agent.runtime)


# -- the launcher, devices, imports ----------------------------------------------

def test_launcher_serves_on_the_cpu(capsys):
    assert launch_serve.main(["--device", "cpu", "--requests", "2",
                              "--num-docs", "32", "--max-new", "2"]) == 0
    out = capsys.readouterr().out
    assert "[offline] index over 32 docs" in out
    assert "top-1 hit 2/2" in out


def test_pipelines_run_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    _, _, api, tgp = tiny_gen()
    _, _, tecfg, tep = tiny_embedder()
    docs = _toks((8, 4))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RAGPipeline.build(tecfg, tep, api, tgp, docs)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MultiTenantRAGPipeline.create(tecfg, tep, api, tgp, capacity=8,
                                      doc_len=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main(["--requests", "1", "--num-docs", "4"])
    with pytest.raises(ValueError, match="parameters are on cpu"):
        RAGPipeline.build(tecfg, tep, api, tgp, docs, device="meta")


def test_models_and_rag_import_neither_jax_nor_the_reference():
    code = (
        "import sys\n"
        "import repro_torch.models, repro_torch.configs\n"
        "import repro_torch.configs.qwen2_0_5b\n"
        "import repro_torch.configs.minilm_embedder\n"
        "import repro_torch.serve.rag, repro_torch.launch.serve\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'repro')\n"
        "             or m.startswith(('jax.', 'repro.')))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
