"""The port's two-stage retrieval against the JAX engine on the golden
corpus of tests/test_recall_regression.py (N=4096, D=256, Q=80, seed 1234):
Plain (cosine and MIPS), Masked (two tenants) and Windowed, on both of the
port's backends. Final indices and scores must be bit-identical; stage-1
candidates too, except at positions the reference's own f32 keys put
within 2 ulp of a neighbour (the rsqrt rounding divergence). Also: the
golden pins from the port alone, the analytic plans, the energy model,
and import hygiene."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np

from repro.core import BitPlanarDB as JBitPlanarDB
from repro.core import RetrievalConfig as JConfig
from repro.core import build_database as j_build
from repro.core import energy as jenergy
from repro.core import engine as jengine
from repro.core import quantize_int8 as j_quantize
from repro.core import retrieval as jretrieval
from repro.core import similarity as jsim
from repro_torch import convert
from repro_torch.core import energy as tenergy
from repro_torch.core import engine as tengine
from repro_torch.core import retrieval as tretrieval
from repro_torch.core.bitplanar import BitPlanarDB
from repro_torch.core.quantization import build_database, quantize_int8
from repro_torch.core.retrieval import NO_TENANT, RetrievalConfig
from repro_torch.core.similarity import _ordered_i32
from repro_torch.data import retrieval_corpus

N, D, Q, K = 4096, 256, 80, 5
SEED = 1234
HALF = N // 2
GOLDEN_HITS = 80
GOLDEN_PLAIN_INDEX_SUM = 881698
GOLDEN_PLAIN_SCORE_SUM = 119156404
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def golden():
    docs, queries, gold = retrieval_corpus(
        N, D, num_queries=Q, noise=0.1, cluster_size=64, cluster_spread=0.2,
        seed=SEED)
    jdb = JBitPlanarDB.from_quantized(j_build(jnp.asarray(docs)))
    jq, _ = j_quantize(jnp.asarray(queries), per_vector=True)
    db = BitPlanarDB.from_quantized(build_database(docs, device="cpu"))
    q, _ = quantize_int8(torch.from_numpy(queries), per_vector=True)
    owner = np.repeat([0, 1], HALF).astype(np.int32)
    tids = (gold >= HALF).astype(np.int32)
    return dict(docs=docs, gold=gold, jdb=jdb, jq=jq, db=db, q=q,
                owner=owner, tids=tids, starts=tids * HALF)


VARIANTS = ("plain_cosine", "plain_mips", "masked", "windowed")


def _metric(variant):
    return "mips" if variant == "plain_mips" else "cosine"


def _run_port(g, variant, backend):
    cfg = RetrievalConfig(k=K, metric=_metric(variant), backend=backend)
    owner, tids = torch.from_numpy(g["owner"]), torch.from_numpy(g["tids"])
    if variant.startswith("plain"):
        return tretrieval.batched_retrieve(g["q"], g["db"], cfg, device="cpu")
    if variant == "masked":
        return tretrieval.batched_retrieve_masked(g["q"], g["db"], owner,
                                                  tids, cfg, device="cpu")
    return tretrieval.windowed_retrieve_masked(
        g["q"], g["db"], owner, tids, torch.from_numpy(g["starts"]), cfg,
        HALF, device="cpu")


def _jax_keys(g, variant):
    """The reference's own stage-1 keys (what its top-C ranks)."""
    jdb, jq = g["jdb"], g["jq"]
    q_msb = jq >> 4
    if variant == "windowed":
        rows = jnp.asarray(g["starts"])[:, None] + jnp.arange(HALF)
        scores = jengine.stage1_rows_batched_jnp(q_msb, jdb.msb_plane[rows])
        norms = jdb.norms_sq[rows]
        member = jnp.asarray(g["owner"])[rows] == jnp.asarray(
            g["tids"])[:, None]
    else:
        scores = jengine.stage1_plane_batched_jnp(q_msb, jdb.msb_plane)
        norms = jdb.norms_sq[None, :]
        member = (jnp.asarray(g["owner"])[None, :]
                  == jnp.asarray(g["tids"])[:, None])
        if variant.startswith("plain"):
            member = jnp.ones_like(member)
    if variant == "plain_mips":
        return scores
    return jnp.where(member, jsim.cosine_key_f32(scores, norms), -jnp.inf)


@pytest.fixture(scope="module")
def reference(golden):
    g = golden
    out = {}
    for variant in VARIANTS:
        cfg = JConfig(k=K, metric=_metric(variant))
        if variant.startswith("plain"):
            res = jretrieval.batched_retrieve(g["jq"], g["jdb"], cfg)
        elif variant == "masked":
            res = jretrieval.batched_retrieve_masked(
                g["jq"], g["jdb"], jnp.asarray(g["owner"]),
                jnp.asarray(g["tids"]), cfg)
        else:
            res = jretrieval.windowed_retrieve_masked(
                g["jq"], g["jdb"], jnp.asarray(g["owner"]),
                jnp.asarray(g["tids"]), jnp.asarray(g["starts"]), cfg,
                window=HALF)
        c = res.candidate_indices.shape[1]
        keys, _ = jax.lax.top_k(_jax_keys(g, variant), c + 1)
        out[variant] = (res, np.asarray(keys))
    return out


def _exempt(keys: np.ndarray) -> np.ndarray:
    """(B, C+1) reference keys in rank order -> (B, C) positions whose key
    is finite and within 2 ulp of its rank neighbour (the (C+1)-th key
    included, which covers the candidate-set boundary)."""
    if keys.dtype != np.float32:
        return np.zeros((keys.shape[0], keys.shape[1] - 1), bool)
    o = _ordered_i32(torch.from_numpy(keys.copy())).numpy().astype(np.int64)
    near = np.abs(np.diff(o, axis=1)) <= 2                   # (B, C)
    before = np.concatenate([np.zeros((o.shape[0], 1), bool),
                             near[:, :-1]], axis=1)
    return (near | before) & np.isfinite(keys[:, :-1])


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_slice_matches_reference(golden, reference, variant, backend,
                                 request):
    res = _run_port(golden, variant, backend)
    jres, keys = reference[variant]
    np.testing.assert_array_equal(res.indices.numpy(),
                                  np.asarray(jres.indices))
    np.testing.assert_array_equal(res.scores.numpy(), np.asarray(jres.scores))
    assert res.indices.dtype == torch.int32 and res.scores.dtype == torch.int32
    got_c = res.candidate_indices.numpy()
    want_c = np.asarray(jres.candidate_indices)
    assert got_c.shape == want_c.shape
    exempt = _exempt(keys)
    differ = got_c != want_c
    # Reported beside the result (`-rA` or the junit report shows them).
    request.node.user_properties += [("exempt_positions", int(exempt.sum())),
                                     ("differing_positions",
                                      int(differ.sum()))]
    print(f"{variant}/{backend}: {int(exempt.sum())} candidate positions "
          f"exempted, {int(differ.sum())} differ")
    assert not (differ & ~exempt).any(), (
        f"{int((differ & ~exempt).sum())} candidate positions differ "
        f"outside the {int(exempt.sum())} exempted near-tie positions")


def test_golden_pins_from_the_port_alone(golden):
    g = golden
    hits = lambda res: int(sum(g["gold"][i] in res.indices[i].tolist()  # noqa
                               for i in range(Q)))
    res = _run_port(g, "plain_cosine", "cuda")
    assert hits(res) == GOLDEN_HITS
    assert int(res.indices.long().sum()) == GOLDEN_PLAIN_INDEX_SUM
    assert int(res.scores.long().sum()) == GOLDEN_PLAIN_SCORE_SUM
    assert hits(_run_port(g, "masked", "cuda")) == GOLDEN_HITS
    assert hits(_run_port(g, "windowed", "cuda")) == GOLDEN_HITS


def test_state_carried_from_the_reference_gives_the_same_results(golden):
    g, jdb = golden, golden["jdb"]
    db = convert.bitplanar_db(*(np.asarray(x) for x in (
        jdb.msb_plane, jdb.lsb_plane, jdb.norms_sq, jdb.scale,
        jdb.sign_plane)), device="cpu")
    q = convert.query_codes(np.asarray(g["jq"]), device="cpu")
    cfg = RetrievalConfig(k=K)
    want = tretrieval.batched_retrieve(g["q"], g["db"], cfg, device="cpu")
    got = tretrieval.batched_retrieve(q, db, cfg, device="cpu")
    assert torch.equal(got.indices, want.indices)
    assert torch.equal(got.scores, want.scores)


def test_single_query_paths_match_reference(golden):
    g = golden
    cfg, jcfg = RetrievalConfig(k=K), JConfig(k=K)
    for i in (0, 17):
        res = tretrieval.two_stage_retrieve(g["q"][i], g["db"], cfg,
                                            device="cpu")
        jres = jretrieval.two_stage_retrieve(g["jq"][i], g["jdb"], jcfg)
        np.testing.assert_array_equal(res.indices.numpy(),
                                      np.asarray(jres.indices))
        np.testing.assert_array_equal(res.scores.numpy(),
                                      np.asarray(jres.scores))


@pytest.mark.parametrize("metric", ["cosine", "mips"])
def test_paper_baselines_match_reference(golden, metric):
    g = golden
    docs = g["docs"][:512]
    qdb = build_database(docs, device="cpu")
    jqdb = j_build(jnp.asarray(docs))
    cfg, jcfg = RetrievalConfig(k=K, metric=metric), JConfig(k=K,
                                                             metric=metric)
    res = tretrieval.exact_retrieve(g["q"][3], qdb, cfg)
    jres = jretrieval.exact_retrieve(g["jq"][3], jqdb, jcfg)
    np.testing.assert_array_equal(res.indices.numpy(),
                                  np.asarray(jres.indices))
    np.testing.assert_array_equal(res.scores.numpy(), np.asarray(jres.scores))
    bp = BitPlanarDB.from_quantized(qdb)
    res = tretrieval.int4_retrieve(g["q"][3], bp, cfg)
    jres = jretrieval.int4_retrieve(g["jq"][3], JBitPlanarDB.from_quantized(
        jqdb), jcfg)
    np.testing.assert_array_equal(res.indices.numpy(),
                                  np.asarray(jres.indices))
    np.testing.assert_array_equal(res.scores.numpy(), np.asarray(jres.scores))


def test_padding_lanes_and_fragmented_tenants_match_reference(golden):
    """NO_TENANT lanes return nothing; a tenant with fewer live rows than k
    fills the rest with -1 / 0, exactly as the reference does."""
    g = golden
    owner = g["owner"].copy()
    owner[10:4000] = -1                     # tenant 0 keeps 10 rows: C > 10
    tids = np.array([0, 1, NO_TENANT, 0], np.int32)
    cfg = RetrievalConfig(k=K)
    res = tretrieval.batched_retrieve_masked(
        g["q"][:4], g["db"], torch.from_numpy(owner), torch.from_numpy(tids),
        cfg, device="cpu")
    jres = jretrieval.batched_retrieve_masked(
        g["jq"][:4], g["jdb"], jnp.asarray(owner), jnp.asarray(tids),
        JConfig(k=K))
    for field in ("indices", "scores", "candidate_indices"):
        np.testing.assert_array_equal(getattr(res, field).numpy(),
                                      np.asarray(getattr(jres, field)))
    assert (res.indices[2] == -1).all()


def test_windowed_starts_are_clamped_like_the_reference(golden):
    g = golden
    starts = np.array([-50, N - 10, 100, 3000], np.int32)
    tids = np.array([0, 1, 0, 1], np.int32)
    res = tretrieval.windowed_retrieve_masked(
        g["q"][:4], g["db"], torch.from_numpy(g["owner"]),
        torch.from_numpy(tids), torch.from_numpy(starts),
        RetrievalConfig(k=K, metric="mips"), 512, device="cpu")
    jres = jretrieval.windowed_retrieve_masked(
        g["jq"][:4], g["jdb"], jnp.asarray(g["owner"]), jnp.asarray(tids),
        jnp.asarray(starts), JConfig(k=K, metric="mips"), window=512)
    for field in ("indices", "scores", "candidate_indices"):
        np.testing.assert_array_equal(getattr(res, field).numpy(),
                                      np.asarray(getattr(jres, field)))
    with pytest.raises(ValueError, match="window"):
        tretrieval.windowed_retrieve_masked(
            g["q"][:4], g["db"], torch.from_numpy(g["owner"]),
            torch.from_numpy(tids), torch.from_numpy(starts),
            RetrievalConfig(k=K), 3, device="cpu")


# ---------------------------------------------------------------------------
# Plans and the energy model
# ---------------------------------------------------------------------------

PLAN_CASES = [
    dict(kind="plain", num_docs=4096, dim=256, batch=8),
    dict(kind="masked", num_docs=1 << 20, dim=512, batch=32),
    dict(kind="windowed", num_docs=1 << 20, dim=512, batch=32, window=2048),
    dict(kind="windowed", num_docs=100, dim=64, batch=3, window=40),
    dict(kind="cluster", num_docs=4096, dim=256, batch=4, num_clusters=64,
         view_rows=512),
    dict(kind="view", num_docs=4096, dim=256, batch=2, view_rows=256),
]


@pytest.mark.parametrize("case", PLAN_CASES, ids=lambda c: c["kind"])
@pytest.mark.parametrize("c0", [None, 64])
def test_plan_matches_reference(case, c0):
    got = tengine.plan(RetrievalConfig(k=K, prescreen_c0=c0), **case)
    want = jengine.plan(JConfig(k=K, prescreen_c0=c0), **case)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    split = dict(hbm_bytes=1000, sram_bytes=24, prescreen_hbm=7,
                 prescreen_sram=3)
    assert dataclasses.asdict(tengine.cache_split_plan(got, **split)) == \
        dataclasses.asdict(jengine.cache_split_plan(want, **split))


def test_plan_for_and_publish_match_reference(golden):
    g = golden
    eng = tengine.RetrievalEngine(RetrievalConfig(k=K), device="cpu")
    jeng = jengine.RetrievalEngine(JConfig(k=K))
    owner, tids = g["owner"], g["tids"]
    pairs = [
        (tengine.PlainPolicy(), jengine.PlainPolicy()),
        (tengine.MaskedPolicy(torch.from_numpy(owner), torch.from_numpy(tids)),
         jengine.MaskedPolicy(jnp.asarray(owner), jnp.asarray(tids))),
        (tengine.WindowedPolicy(torch.from_numpy(owner),
                                torch.from_numpy(tids),
                                torch.from_numpy(g["starts"]), HALF),
         jengine.WindowedPolicy(jnp.asarray(owner), jnp.asarray(tids),
                                jnp.asarray(g["starts"]), HALF)),
    ]

    class Registry:
        enabled = True

        def __init__(self):
            self.counts = {}

        def counter(self, name, **labels):
            key = (name, tuple(sorted(labels.items())))
            reg = self

            class _C:
                def inc(self, v):
                    reg.counts[key] = reg.counts.get(key, 0) + v
            return _C()

    for pol, jpol in pairs:
        got, want = eng.plan_for(g["db"], Q, pol), jeng.plan_for(g["jdb"], Q,
                                                                 jpol)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        r, jr = Registry(), Registry()
        got.publish(r)
        want.publish(jr)
        assert r.counts == jr.counts and r.counts


def test_energy_model_matches_reference():
    for consts in ("PAPER_28NM", "TPU_V5E"):
        tc, jc = getattr(tenergy, consts), getattr(jenergy, consts)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        for n in (2048, 1 << 20):
            for fn in ("cost_int8", "cost_int4", "cost_hierarchical"):
                assert dataclasses.asdict(getattr(tenergy, fn)(
                    n, 512, consts=tc)) == dataclasses.asdict(
                        getattr(jenergy, fn)(n, 512, consts=jc))
            assert tenergy.memory_reduction(n) == jenergy.memory_reduction(n)
            assert tenergy.compute_reduction(n) == \
                jenergy.compute_reduction(n)
    cfg = RetrievalConfig(k=K)
    plan = tengine.plan(cfg, num_docs=1 << 20, dim=512, batch=32)
    jplan = jengine.plan(JConfig(k=K), num_docs=1 << 20, dim=512, batch=32)
    assert dataclasses.asdict(tenergy.cost_cascade(plan.stages, 512,
                                                   batch=32)) == \
        dataclasses.asdict(jenergy.cost_cascade(jplan.stages, 512, batch=32))
    for s, js in zip(plan.stages, jplan.stages):
        assert tenergy.stage_cost_uj(s, 512, batch=32) == \
            jenergy.stage_cost_uj(js, 512, batch=32)
    assert tenergy.docs_for_db_mb(1) == jenergy.docs_for_db_mb(1) == 2048


# ---------------------------------------------------------------------------
# Devices and imports
# ---------------------------------------------------------------------------

def test_engine_refuses_to_run_on_the_cpu_unasked(golden):
    g = golden
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tengine.RetrievalEngine(RetrievalConfig())
        with pytest.raises(RuntimeError):
            tretrieval.batched_retrieve(g["q"], g["db"], RetrievalConfig())
    eng = tengine.RetrievalEngine(RetrievalConfig(), device="cpu")
    with pytest.raises(ValueError, match="engine runs on"):
        eng.retrieve(g["q"].to("meta"), g["db"])
    with pytest.raises(ValueError, match="backend"):
        tengine.stage_fns("pallas")


_FORBIDDEN = ("import jax", "from jax", "import repro.", "from repro ",
              "from repro.", "import repro\n")


def test_port_sources_import_neither_jax_nor_the_reference():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, names in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path) as f:
            text = f.read()
        for bad in _FORBIDDEN:
            assert bad not in text, f"{path} contains {bad!r}"


def test_port_imports_leave_jax_and_the_reference_unloaded():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.core, repro_torch.convert\n"
        "import repro_torch.data, repro_torch.kernels.ops\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'repro')\n"
        "             or m.startswith(('jax.', 'repro.')))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_chip_smoke_fails_without_a_gpu_or_without_the_repo(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
