"""The port's agent and training examples (`repro_torch.examples.
multi_user_agent`, `serve_rag_agent`, `train_100m`) against the
reference's `examples/*.py`, on the CPU.

Each reference example runs as it is (its `main()` loaded from its path,
stdout captured), and its pipeline, answer and initial parameters are
captured as it runs. The port's work function gets the reference's
parameters, carried across by `repro_torch.convert`, and the same seeds.
Held:

  * the agents: the log lines (wall times masked), the retrieved slots
    and ids, the owners, the answer tokens and the energy ledger (to a
    relative 1e-12); the port's embeddings come out of its own f32
    products, so an INT8 code of a document or a query may round the other
    way: a differing code is exempted only where the port's value before
    rounding lies within NEAR_HALF of a .5 boundary (and then by one), and
    the count is printed (`-s`) as ROADMAP C19 counts them;
  * the greedy tokens run at the example's bf16 compute, where two logits
    can round to one value: a row whose first differing token has the
    reference's top two logits within TIE_REL of the larger (two bf16
    ulps) is exempted from that token on and counted (`-s`), as
    tests/test_torch_system.py exempts its near ties;
  * training: the optimizer's arguments equal; the losses within
    LOSS_RTOL, one bf16 rounding (2^-8) of the loss (bf16 compute, as the
    example runs; the grads' roundings reach the later losses through
    AdamW), over 7 steps, two past the save at step 5; the checkpoints
    both runs keep, and the state each saved at step 7 (parameters, AdamW's
    moments and step) leaf by leaf: the step equal, and each float leaf
    within STATE_RTOL of the reference's, relative to how far the
    reference's leaf moved from where it started (the initial parameters,
    zero moments), so the bound is on the training's updates. The worst
    leaf measured is the embedding at 0.135 (rows of rare tokens, whose
    small bf16 grads AdamW's normalisation turns into full steps; the
    median leaf 0.0155); an AdamW with b2 0.999 in place of 0.95 puts the
    second moments at 0.98. A weight decay of 0.1 in place of 0.01 moves
    the worst leaf only to 0.21, and 0 not at all, so the optimizer's
    arguments are held as recorded, exactly.

The port's side of each lockstep is its `main` with `--device cpu` and
CUDA reported absent, the reference's parameters given to it in place of
those `main` draws; `main([])` raises without CUDA.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses
import os

import jax
import numpy as np

import jax.numpy as jnp

import repro.serve.rag as jrag
from repro.core import quantize_int8 as jquantize_int8
from repro.models import dense as jdense
from repro.models import embedder as jembedder
from repro.models import get_model as jget_model
from repro.runtime import ElasticTrainer as JElasticTrainer
from repro_torch import _tree, convert
from repro_torch.checkpoint import restore_checkpoint
from repro_torch.core import bitplanar, quantize_int8
from repro_torch.examples import (agent_models, multi_user_agent,
                                  serve_rag_agent, train_100m)
from repro_torch.models import embedder
from repro_torch.train import adamw
from torch_examples_ref import lines as _lines
from torch_examples_ref import no_cuda, reference, run_main

CPU = torch.device("cpu")
NEAR_HALF = 1e-3
TIE_REL = 2.0 ** -6
LOSS_RTOL = 2.0 ** -8
STATE_RTOL = 2.0 ** -2
RAG_FLAGS = ["--requests", "4", "--num-docs", "48", "--max-new", "6"]
TRAIN_STEPS = 7


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _codes(msb, lsb):
    return bitplanar.reconstruct_int8(
        torch.from_numpy(np.array(msb)), torch.from_numpy(np.array(lsb))
    ).numpy()


def _exempt(got, want, pre, what) -> int:
    """Equal codes but where `pre`, the port's value before rounding, lies
    within NEAR_HALF of a .5 boundary (and then by one); the count."""
    diff = got != want
    near = np.abs(np.abs(pre) - np.floor(np.abs(pre)) - 0.5) < NEAR_HALF
    assert not (diff & ~near).any(), (what, np.argwhere(diff & ~near)[:4])
    assert (np.abs(got.astype(int) - want.astype(int))[diff] <= 1).all()
    return int(diff.sum())


def _query_exemptions(eparams, jeparams, ecfg, jecfg, tokens) -> int:
    emb = embedder.encode(eparams, torch.from_numpy(tokens), ecfg)
    codes, scale = quantize_int8(emb, per_vector=True)
    jcodes, _ = jquantize_int8(jembedder.encode(jeparams, tokens, jecfg),
                               per_vector=True)
    return _exempt(codes.numpy(), np.asarray(jcodes),
                   (emb / scale[:, None]).numpy(), "query codes")


def _same_tokens(seen, prompts, got) -> int:
    """Greedy tokens equal to the reference's but for rows exempted at a
    near tie (see the module docstring); the count of such rows."""
    japi, jparams = seen["args"][2:4]
    want = np.asarray(seen["answers"][0][0])
    exempt = 0
    for row in np.flatnonzero((got != want).any(axis=1)):
        pos = int(np.argmax(got[row] != want[row]))
        seq = np.concatenate([prompts[row], want[row, :pos]])[None]
        logits = np.asarray(jdense.forward(jparams, jnp.asarray(seq),
                                           japi.cfg)[0, -1], np.float32)
        top2 = np.sort(logits)[-2:]
        assert top2[1] - top2[0] <= TIE_REL * abs(top2[1]), (
            f"row {row} token {pos}: {got[row, pos]} against "
            f"{want[row, pos]}, top-2 {top2}")
        exempt += 1
    return exempt


def _prompts(doc_tokens, ids, queries):
    """The augmented prompts, [retrieved docs; query], of (B, k) ids."""
    return np.concatenate([np.asarray(doc_tokens)[ids].reshape(
        len(ids), -1), queries], axis=1)


def _same_ledger(got, want):
    assert got.total_uj == pytest.approx(want.total_uj, rel=1e-12)
    assert got.proportions() == pytest.approx(want.proportions(), rel=1e-12)


def _capture_reference_pipeline(monkeypatch, cls, factory):
    """Records the reference pipeline `cls.<factory>` builds, the arguments
    it got, and every `answer` it gives."""
    seen = {"answers": []}
    build, answer = getattr(cls, factory), cls.answer

    def built(*args, **kw):
        seen["args"] = args
        seen["pipe"] = build(*args, **kw)
        return seen["pipe"]

    def answered(self, *args, **kw):
        seen["answers"].append(answer(self, *args, **kw))
        return seen["answers"][-1]
    monkeypatch.setattr(cls, factory, built)
    monkeypatch.setattr(cls, "answer", answered)
    return seen


def _port_models(seen):
    """The port's agent models carrying the reference's parameters."""
    ecfg, _, gen_api, _ = agent_models(CPU)
    jecfg, jeparams, _, jgparams = seen["args"][:4]
    return (ecfg, convert.embedder_params(_np(jeparams), device=CPU),
            gen_api, convert.dense_params(_np(jgparams), device=CPU)), jecfg


# -- multi_user_agent ------------------------------------------------------

def test_multi_user_agent_in_lockstep_with_reference(monkeypatch, capsys):
    seen = _capture_reference_pipeline(
        monkeypatch, jrag.MultiTenantRAGPipeline, "create")
    reference("multi_user_agent").main()
    want = capsys.readouterr().out
    models, jecfg = _port_models(seen)
    got = run_main(monkeypatch, multi_user_agent, ["--device", "cpu"],
                   agent_models=lambda dev: models)
    assert _lines(capsys.readouterr().out) == _lines(want)

    jpipe, pipe = seen["pipe"], got["pipe"]
    _, jids, jledger = seen["answers"][0]
    np.testing.assert_array_equal(got["ids"], np.asarray(jids))
    _same_ledger(got["ledger"], jledger)
    np.testing.assert_array_equal(pipe.index.arena.owner.numpy(),
                                  np.asarray(jpipe.index.arena.owner))
    np.testing.assert_array_equal(pipe.doc_tokens, jpipe.doc_tokens)

    live = np.flatnonzero(pipe.index.arena.owner.numpy() >= 0)
    arena = pipe.index.arena
    emb = embedder.encode(pipe.emb_params,
                          torch.from_numpy(pipe.doc_tokens[live]), models[0])
    exempt = _exempt(arena.read_codes(live).numpy(),
                     np.asarray(jpipe.index.arena.read_codes(live)),
                     (emb / arena.scale).numpy(), "arena codes")
    queries = pipe.doc_tokens[got["ids"][:, 0]]       # each user's #7
    exempt += _query_exemptions(pipe.emb_params, jpipe.emb_params, models[0],
                                jecfg, queries)
    ties = _same_tokens(seen, _prompts(pipe.doc_tokens, got["ids"], queries),
                        got["tokens"])
    print(f"multi_user_agent: {exempt} INT8 codes exempted as within "
          f"NEAR_HALF of a rounding boundary, {ties} token rows at a near "
          "tie")


def test_multi_user_agent_needs_cuda_unless_told_cpu(monkeypatch):
    """The lockstep above runs `--device cpu` with CUDA absent."""
    no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multi_user_agent.main([])


# -- serve_rag_agent -------------------------------------------------------

def test_serve_rag_agent_in_lockstep_with_reference(monkeypatch, capsys):
    seen = _capture_reference_pipeline(monkeypatch, jrag.RAGPipeline,
                                       "build")
    monkeypatch.setattr("sys.argv", ["serve_rag_agent.py", *RAG_FLAGS])
    reference("serve_rag_agent").main()
    want = capsys.readouterr().out
    models, jecfg = _port_models(seen)
    got = run_main(monkeypatch, serve_rag_agent, ["--device", "cpu",
                                                  *RAG_FLAGS],
                   agent_models=lambda dev: models)
    # the tokens a line shows are held below, with the near ties exempted
    assert [line.split(" -> tokens")[0] for line in _lines(
        capsys.readouterr().out)] == [
        line.split(" -> tokens")[0] for line in _lines(want)]

    jpipe, pipe = seen["pipe"], got["pipe"]
    _, jids, jledger = seen["answers"][0]
    np.testing.assert_array_equal(got["ids"], np.asarray(jids))
    _same_ledger(got["ledger"], jledger)

    emb = embedder.encode(pipe.emb_params, pipe.doc_tokens, models[0])
    exempt = _exempt(_codes(pipe.db.msb_plane, pipe.db.lsb_plane),
                     _codes(jpipe.db.msb_plane, jpipe.db.lsb_plane),
                     (emb / pipe.db.scale).numpy(), "document codes")
    queries = pipe.doc_tokens[got["gold"]].numpy()
    exempt += _query_exemptions(pipe.emb_params, jpipe.emb_params, models[0],
                                jecfg, queries)
    ties = _same_tokens(seen, _prompts(pipe.doc_tokens, got["ids"], queries),
                        got["tokens"])
    print(f"serve_rag_agent: {exempt} INT8 codes exempted as within "
          f"NEAR_HALF of a rounding boundary, {ties} token rows at a near "
          "tie")


def test_serve_rag_agent_needs_cuda_unless_told_cpu(monkeypatch):
    """The lockstep above runs `--device cpu` with CUDA absent."""
    no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_rag_agent.main([])


# -- train_100m ------------------------------------------------------------

def _recording(calls, fn):
    def call(*args, **kw):
        calls.append((args, kw))
        return fn(*args, **kw)
    return call


def _state_errors(got_dir, want_dir, like):
    """{leaf name: error} of the state saved at TRAIN_STEPS under got_dir
    (the port's) against want_dir's (the reference's), both restored by
    the port into `like`, the state at step 0: an int leaf's error is 0 if
    equal else inf, a float leaf's is |got - want| / |want - start|."""
    got, _ = restore_checkpoint(got_dir, like, step=TRAIN_STEPS)
    want, _ = restore_checkpoint(want_dir, like, step=TRAIN_STEPS)
    errs = {}
    for (name, a), b, b0 in zip(_tree.named_leaves(got), _tree.leaves(want),
                                _tree.leaves(like), strict=True):
        if not a.dtype.is_floating_point:
            errs[name] = 0.0 if torch.equal(a, b) else float("inf")
            continue
        a, b, b0 = a.double(), b.double(), b0.double()
        errs[name] = float(torch.linalg.norm(a - b)
                           / torch.linalg.norm(b - b0))
    return errs


def test_train_100m_in_lockstep_with_reference(monkeypatch, capsys,
                                               tmp_path):
    ref = reference("train_100m")
    runs, ref_opt, port_opt = [], [], []

    class Recording(JElasticTrainer):
        def run(self, *args, **kw):
            runs.append(super().run(*args, **kw))
            return runs[-1]
    monkeypatch.setattr(ref, "ElasticTrainer", Recording)
    monkeypatch.setattr(ref, "adamw", _recording(ref_opt, ref.adamw))
    flags = ["--steps", str(TRAIN_STEPS), "--batch", "2", "--seq", "32"]
    monkeypatch.setattr("sys.argv", ["train_100m.py", *flags, "--ckpt-dir",
                                     str(tmp_path / "ref")])
    ref.main()
    want = capsys.readouterr().out
    assert dataclasses.asdict(train_100m.CFG_SMOKE) == dataclasses.asdict(
        ref.CFG_SMOKE)
    host = _np(jget_model(ref.CFG_SMOKE).init(jax.random.PRNGKey(0)))
    params = convert.dense_params(host, device=CPU)
    monkeypatch.setattr(train_100m, "adamw",
                        _recording(port_opt, train_100m.adamw))
    out = run_main(monkeypatch, train_100m,
                   ["--device", "cpu", *flags, "--ckpt-dir",
                    str(tmp_path / "port")],
                   seeded_params=lambda init, seed, dev: params)
    got = capsys.readouterr().out
    assert port_opt == ref_opt == [((), {"lr": 3e-4, "weight_decay": 0.01})]
    assert got.splitlines()[0] == want.splitlines()[0]     # the model line
    assert len(out["losses"]) == len(runs[0]["losses"]) == TRAIN_STEPS
    np.testing.assert_allclose(out["losses"], runs[0]["losses"],
                               rtol=LOSS_RTOL)
    err = np.max(np.abs(np.subtract(out["losses"], runs[0]["losses"]))
                 / np.abs(runs[0]["losses"]))
    assert out["losses"][-1] < out["losses"][0]
    kept = sorted(os.listdir(tmp_path / "port"))
    assert kept == sorted(os.listdir(tmp_path / "ref")) == [
        "step_00000005", "step_00000007"]
    errs = _state_errors(str(tmp_path / "port"), str(tmp_path / "ref"),
                         (params, adamw().init(params)))
    worst = max(errs, key=errs.get)
    print(f"train_100m: losses within {err:.3g} relative of the "
          f"reference's (LOSS_RTOL {LOSS_RTOL}); the step-{TRAIN_STEPS} "
          f"state's {len(errs)} leaves within {errs[worst]:.3g} of the "
          f"reference's, relative to its move, at worst {worst} "
          f"(STATE_RTOL {STATE_RTOL})")
    assert errs[worst] <= STATE_RTOL, errs


def test_train_100m_needs_cuda_unless_told_cpu(monkeypatch):
    """The lockstep above runs `--device cpu` with CUDA absent."""
    no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_100m.main([])
