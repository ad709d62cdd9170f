"""The port's block autotuner: table semantics, artifact lifecycle and ops
wiring, counterparts of tests/test_autotune.py, run on the CPU (where the
wrappers take their plain versions).

The contract pinned here, as in the reference: (a) with no table
installed every wrapper resolves to the kernel's default block; (b) a
tuned table reroutes block choices, never results; (c) artifacts are
keyed to the device and the framework that measured them, so an artifact
written on another card, or by the JAX autotuner, is refused; (d) every
entry times the chosen block at >= 1.0x the default. Candidates that do
not launch are left out with their reason.
"""
import json

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.kernels import autotune as jautotune
from repro.kernels import ops as jops
from repro_torch.core.engine import RetrievalEngine
from repro_torch.core.retrieval import RetrievalConfig
from repro_torch.kernels import autotune, ops
from repro_torch.kernels.fused_topk import DEFAULT_BLOCK_N as FUSED_DEFAULT
from repro_torch.kernels.stage1_int4 import DEFAULT_ROWS

CPU = "cpu"


@pytest.fixture(autouse=True)
def _clean_table():
    """Installation is process-global; never leak it across tests."""
    autotune.clear_installed()
    autotune._load_env_cache.cache_clear()
    yield
    autotune.clear_installed()


def tiny_table(entries=None):
    return autotune.TuneTable(
        autotune.device_signature(CPU),
        entries or {"stage1_batched/b8": {
            "kernel": "stage1_batched", "batch_bucket": 8, "block_n": 512,
            "timings_ms": {"512": 1.0, "256": 2.0}, "default_block_n": 256,
            "default_ms": 2.0, "speedup_vs_default": 2.0}})


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# ---------------------------------------------------------------------------
# Lookup and fallback semantics
# ---------------------------------------------------------------------------

def test_lookup_without_table_is_deterministic_default():
    assert autotune.installed() is None
    assert autotune.lookup("stage1_batched", 8, DEFAULT_ROWS) == DEFAULT_ROWS
    assert autotune.lookup("no_such_kernel", 1, 77) == 77
    assert autotune.default_block("fused_topk") == FUSED_DEFAULT == 512
    assert autotune.default_block("stage0_sign") == DEFAULT_ROWS == 256


def test_installed_table_resolves_bucket_and_falls_back():
    autotune.install(tiny_table())
    # exact pow2 bucket hit (batch 5 pads to bucket 8)
    assert autotune.lookup("stage1_batched", 8, 256) == 512
    assert autotune.lookup("stage1_batched", 5, 256) == 512
    # nearest measured bucket when the exact one was never benched
    assert autotune.lookup("stage1_batched", 64, 256) == 512
    # un-benched kernel: deterministic default
    assert autotune.lookup("fused_topk", 8, FUSED_DEFAULT) == FUSED_DEFAULT
    autotune.clear_installed()
    assert autotune.lookup("stage1_batched", 8, 256) == 256


def test_bucket_resolution_matches_reference():
    """The port's bucket and nearest-bucket rules give the reference's
    answers on the same entries."""
    entries = {f"stage1_rows/b{bb}": {"kernel": "stage1_rows",
                                      "batch_bucket": bb, "block_n": bn}
               for bb, bn in ((1, 128), (8, 512), (64, 1024))}
    port = autotune.TuneTable(autotune.device_signature(CPU), entries)
    ref = jautotune.TuneTable(jautotune.device_signature(), entries)
    for batch in (1, 2, 3, 5, 8, 9, 20, 33, 64, 100, 1000):
        assert port.best("stage1_rows", batch) == ref.best("stage1_rows",
                                                           batch)
    assert port.best("fused_topk", 4) is None


# ---------------------------------------------------------------------------
# Artifact lifecycle: round-trip, corruption, stale-device invalidation
# ---------------------------------------------------------------------------

def test_table_json_round_trip(tmp_path):
    t = tiny_table()
    path = str(tmp_path / "tune.json")
    t.save(path)
    back = autotune.load(path, CPU)
    assert back is not None
    assert back.signature == t.signature
    assert back.entries == t.entries
    assert back.best("stage1_batched", 8) == 512
    assert json.loads(open(path).read())["schema"] == autotune.SCHEMA_VERSION


def test_stale_device_artifact_is_refused(tmp_path):
    t = tiny_table()
    obj = t.to_json()
    obj["signature"]["device_kind"] = "NVIDIA H9000"
    path = tmp_path / "stale.json"
    path.write_text(json.dumps(obj))
    assert autotune.load(str(path), CPU) is None          # wrong hardware
    # ...but the payload itself is intact: opting out of the device check
    # (offline inspection) still parses it
    assert autotune.TuneTable.from_json(
        obj, require_current_device=False) is not None


def test_reference_artifact_is_refused(tmp_path):
    """An artifact written by the JAX autotuner names the JAX backend, so
    the port refuses it, on the CPU as on a card."""
    path = str(tmp_path / "jax_tune.json")
    jautotune.TuneTable(jautotune.device_signature(), {
        "stage1_batched/b8": {"kernel": "stage1_batched", "batch_bucket": 8,
                              "block_n": 512}}).save(path)
    assert autotune.load(path, CPU) is None
    obj = json.loads(open(path).read())
    assert obj["signature"] != autotune.device_signature(CPU)
    parsed = autotune.TuneTable.from_json(obj, require_current_device=False)
    assert parsed is not None and parsed.best("stage1_batched", 8) == 512


def test_malformed_artifacts_degrade_to_none(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert autotune.load(str(bad), CPU) is None
    assert autotune.load(str(tmp_path / "missing.json"), CPU) is None
    assert autotune.TuneTable.from_json({"schema": 999}) is None
    assert autotune.TuneTable.from_json(
        {"schema": autotune.SCHEMA_VERSION, "signature": {},
         "entries": {"x": {"kernel": "k"}}},     # entry missing block_n
        require_current_device=False) is None


def test_env_cache_installs_at_engine_construction(tmp_path, monkeypatch):
    path = str(tmp_path / "env_tune.json")
    tiny_table().save(path)
    monkeypatch.setenv(autotune.ENV_CACHE, path)
    assert autotune.ENV_CACHE == "REPRO_TORCH_AUTOTUNE_CACHE"
    assert autotune.installed() is None
    RetrievalEngine(RetrievalConfig(k=2), CPU)
    got = autotune.installed()
    assert got is not None and got.best("stage1_batched", 8) == 512
    # a stale artifact installs nothing
    autotune.clear_installed()
    obj = tiny_table().to_json()
    obj["signature"]["backend"] = "cpu"
    stale = tmp_path / "stale.json"
    stale.write_text(json.dumps(obj))
    monkeypatch.setenv(autotune.ENV_CACHE, str(stale))
    RetrievalEngine(RetrievalConfig(k=2), CPU)
    assert autotune.installed() is None


def test_device_signature_needs_the_card_unless_asked_for_the_cpu():
    assert autotune.device_signature(CPU) == {
        "device_kind": "cpu", "backend": "torch-cpu", "interpret": True}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            autotune.device_signature()


# ---------------------------------------------------------------------------
# Measured search: the >= 1.0x invariant and ops bit parity
# ---------------------------------------------------------------------------

def test_autotune_speedup_vs_default_at_least_one():
    """The default is always a candidate and the argmin picks, so every
    entry's speedup is >= 1.0; a rows count that is not a compiled
    instance is left out, with its reason."""
    table = autotune.autotune(n=256, d=32, batches=(1, 4),
                              candidates=(64, 256, 512), reps=1,
                              kernels=("stage1_batched", "fused_topk",
                                       "stage0_sign", "stage1_single"),
                              device=CPU)
    assert set(table.entries) == {
        "stage1_batched/b1", "stage1_batched/b4", "fused_topk/b1",
        "fused_topk/b4", "stage0_sign/b1", "stage0_sign/b4",
        "stage1_single/b1"}
    for key, e in table.entries.items():
        assert e["speedup_vs_default"] >= 1.0
        assert str(e["default_block_n"]) in e["timings_ms"]
        assert str(e["block_n"]) in e["timings_ms"]
        if e["kernel"] == "fused_topk":
            assert e["default_block_n"] == 256          # clamped to N
            assert "left_out" not in e
        else:
            assert e["default_block_n"] == DEFAULT_ROWS
            assert set(e["timings_ms"]) == {"256", "512"}
            assert "rows per thread block" in e["left_out"]["64"]
    assert table.signature == autotune.device_signature(CPU)


def test_tuned_ops_bit_identical_to_default():
    """A tuned table reroutes blocks only: stage-1 scores and fused
    candidates under an installed table are bitwise what the default
    blocks produce, and what the reference wrappers produce."""
    rng = np.random.default_rng(0)
    n, d, b = 512, 32, 4
    plane = rng.integers(0, 256, (n, d // 2)).astype(np.uint8)
    q = rng.integers(-8, 8, (b, d)).astype(np.int8)
    base_scores = ops.stage1_scores_batched(_t(q), _t(plane))
    base_cand = ops.fused_candidates_batched(_t(q), _t(plane), c=8,
                                             k_per_block=8)
    autotune.install(autotune.TuneTable(autotune.device_signature(CPU), {
        "stage1_batched/b4": {"kernel": "stage1_batched", "batch_bucket": 4,
                              "block_n": 128},
        "fused_topk/b4": {"kernel": "fused_topk", "batch_bucket": 4,
                          "block_n": 64}}))
    tuned_scores = ops.stage1_scores_batched(_t(q), _t(plane))
    tuned_cand = ops.fused_candidates_batched(_t(q), _t(plane), c=8,
                                              k_per_block=8)
    assert torch.equal(base_scores, tuned_scores)
    assert torch.equal(base_cand, tuned_cand)
    # explicit block_n bypasses the table entirely
    assert torch.equal(ops.stage1_scores_batched(_t(q), _t(plane),
                                                 block_n=256), base_scores)
    want = np.asarray(jops.fused_candidates_batched(
        jnp.asarray(q), jnp.asarray(plane), c=8, k_per_block=8, block_n=64))
    np.testing.assert_array_equal(tuned_cand.numpy(), want)
    np.testing.assert_array_equal(
        base_scores.numpy(),
        np.asarray(jops.stage1_scores_batched(jnp.asarray(q),
                                              jnp.asarray(plane))))
