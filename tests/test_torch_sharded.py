"""The port's sharded index, serving mesh, fault monitors and
`RAGPipeline.build(mesh=)` (`repro_torch.core.index`,
`repro_torch.distributed`, `repro_torch.launch.mesh`,
`repro_torch.runtime`, `repro_torch.serve.rag`) against the reference's,
on the CPU.

Both packages get the same numpy inputs. `ShardedIndex` results are held
bit for bit: indices, scores and candidate ids. The one allowed
difference is ROADMAP C1's: a cosine candidate position whose reference
stage-1 key lies within 2 ulp of a rank neighbour, counted and printed
(`-s`). The reference's multi-device meshes need forced host devices, so
one module-scoped subprocess runs it on the (4, 2) test mesh and on a
(3,) mesh (which pads 2 rows) and the port's 8 and 3 CPU shard slots are
held to what it saved. The port's S-slot index must also equal its own
unsharded engine, the invariant of tests/test_multidevice.py:23-45.
"""
import pytest

torch = pytest.importorskip("torch")

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np

from repro.compat import make_mesh as jmake_mesh
from repro.core import build_database as j_build
from repro.core import engine as jengine
from repro.core import quantization as jquant
from repro.core import quantize_int8 as j_quantize
from repro.core import similarity as jsim
from repro.core.bitplanar import BitPlanarDB as JBitPlanarDB
from repro.core.index import ShardedIndex as JShardedIndex
from repro.core.index import pad_database as jpad
from repro.core.index import shard_database as jshard
from repro.core.retrieval import RetrievalConfig as JConfig
from repro.launch.mesh import make_test_mesh as jmake_test_mesh
from repro.runtime import fault as jfault
from repro.serve import RAGPipeline as JRAGPipeline
from repro_torch import convert
from repro_torch.core import RetrievalConfig, RetrievalEngine
from repro_torch.core.bitplanar import BitPlanarDB
from repro_torch.core.index import ShardedIndex, pad_database
from repro_torch.core.quantization import build_database
from repro_torch.distributed import Mesh, serving_shard_mesh
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.runtime import fault as tfault
from repro_torch.serve import RAGPipeline
from test_torch_engine import _exempt
from test_torch_rag import tiny_embedder, tiny_gen

CPU = "cpu"
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
N, D, K = 1000, 512, 5
METRICS = ("cosine", "mips")
# The reference's subprocess meshes: (4, 2) over 8 devices, (3,) over 3.
MESHES = {8: (4, 2), 3: (3, 1)}


# -- the fault monitors, call for call ----------------------------------------

def _heartbeat(fault):
    now = [0.0]
    mon = fault.HeartbeatMonitor(timeout_s=5.0, clock=lambda: now[0])
    out = []
    mon.beat("w0")
    mon.beat("w1")
    now[0] = 3.0
    mon.beat("w0")
    out.append((mon.workers(), mon.failed(), mon.alive()))
    now[0] = 7.0
    out.append((mon.workers(), mon.failed(), mon.alive()))
    mon.beat("w2", at=6.5)
    mon.remove("w1")
    mon.remove("absent")
    out.append((mon.workers(), mon.failed(), mon.alive()))
    return out


def _stragglers(fault, remove):
    det = fault.StragglerDetector(k_sigma=2.0, min_steps=5)
    out = []
    for i in range(10):
        for w in ("w0", "w1", "w2", "w3"):
            det.record(w, 1.0 + 0.01 * i)
        det.record("slow", 3.0)
        out.append(det.stragglers())
    if remove:
        det.remove("slow")
        out.append(det.stragglers())
    return out


@pytest.mark.parametrize("case", [
    _heartbeat,
    lambda fault: _stragglers(fault, remove=False),
    lambda fault: _stragglers(fault, remove=True),
], ids=["heartbeat", "straggler", "straggler_remove"])
def test_fault_monitors_call_for_call(case):
    """tests/test_runtime.py:15-44's three cases, every answer compared."""
    got, want = case(tfault), case(jfault)
    assert got == want
    assert want[-1] in (["slow"], [], (["w0", "w2"], [], ["w0", "w2"]))


def test_straggler_window_and_small_cohorts_match():
    for fault in (jfault, tfault):
        det = fault.StragglerDetector(window=3, k_sigma=1.0, min_steps=2)
        for v in (5.0, 5.0, 1.0, 1.0, 1.0):
            det.record("a", v)
        det.record("b", 1.0)
        det.record("b", 1.0)
        assert det._times["a"] == [1.0, 1.0, 1.0]
        assert det.stragglers() == []          # fewer than 3 eligible


# -- the serving mesh ------------------------------------------------------------

def test_make_test_mesh_deals_slots_round_robin():
    m = make_test_mesh(4, 2, CPU)
    assert isinstance(m, Mesh) and m.axis_names == ("data", "model")
    assert m.shape == {"data": 4, "model": 2}
    assert m.size == m.devices.size == 8
    assert m.devices.shape == (4, 2)
    assert m.slots() == [torch.device(CPU)] * 8
    j = jmake_test_mesh(1, 1)
    assert dict(j.shape) == make_test_mesh(1, 1, CPU).shape
    with pytest.raises(ValueError):
        make_test_mesh(0, 2, CPU)


def test_make_test_mesh_resolves_to_cuda():
    if torch.cuda.is_available():
        assert make_test_mesh(2, 1).slots()[0].type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_test_mesh(2, 1)


def test_serving_shard_mesh_drops_repeats_in_order():
    a, b = torch.device("cuda", 1), torch.device(CPU)
    m = serving_shard_mesh([a, b, a, "cpu"])
    assert m.axis_names == ("shard",) and m.slots() == [a, b]
    assert m.shape == {"shard": 2} and m.devices.size == 2
    with pytest.raises(ValueError):
        serving_shard_mesh([])


# -- ShardedIndex in-process, on the reference's one-device mesh ----------------

@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(1)
    emb = rng.normal(size=(N, D)).astype(np.float32)
    qs = rng.normal(size=(4, D)).astype(np.float32)
    jq, _ = j_quantize(jnp.asarray(qs), per_vector=True)
    jbp = JBitPlanarDB.from_quantized(j_build(jnp.asarray(emb)))
    return dict(emb=emb, q=np.asarray(jq), jbp=jbp)


def _ref_keys(jbp, q, c):
    """The reference's cosine stage-1 keys over the whole DB, in rank
    order, C + 1 of them (what its global top-C ranks)."""
    scores = jengine.stage1_plane_batched_jnp(jnp.asarray(q) >> 4,
                                              jbp.msb_plane)
    key = jsim.cosine_key_f32(scores, jbp.norms_sq[None, :])
    keys, _ = jax.lax.top_k(key, c + 1)
    return np.asarray(keys)


def _held(res, want, keys, metric, label):
    """indices and scores bit for bit; candidates bit for bit outside the
    reference's near ties (cosine), counted and printed."""
    idx, sc, cand = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(res.indices.numpy(), idx, err_msg=label)
    np.testing.assert_array_equal(res.scores.numpy(), sc, err_msg=label)
    assert res.indices.dtype == torch.int32 and res.scores.dtype == torch.int32
    got = res.candidate_indices.numpy()
    assert got.shape == cand.shape and got.dtype == cand.dtype
    differ = got != cand
    exempt = (_exempt(keys) if metric == "cosine"
              else np.zeros_like(differ))
    print(f"{label}: {int(exempt.sum())} candidate positions exempted, "
          f"{int(differ.sum())} differ")
    assert not (differ & ~exempt).any(), label


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("metric", METRICS)
def test_sharded_index_matches_reference_on_one_device(corpus, metric,
                                                       batch):
    jidx = JShardedIndex.build(jnp.asarray(corpus["emb"]),
                               jmake_mesh((1,), ("data",)))
    idx = ShardedIndex.build(torch.from_numpy(corpus["emb"]),
                             make_test_mesh(1, 1, CPU))
    assert idx.n_global == jidx.n_global == N
    cfg, jcfg = RetrievalConfig(k=K, metric=metric), JConfig(k=K,
                                                            metric=metric)
    q = corpus["q"][:batch]
    c = cfg.num_candidates(N)
    keys = _ref_keys(corpus["jbp"], q, c)
    if batch == 1:                      # the single-query form: (D,) in
        res = idx.retrieve_fn(cfg)(torch.from_numpy(q[0].copy()))
        jres = jidx.retrieve_fn(jcfg)(jnp.asarray(q[0]))
        assert tuple(res.indices.shape) == (K,)
        res = type(res)(*(x[None] for x in (res.indices, res.scores,
                                            res.candidate_indices)))
        jres = [np.asarray(x)[None] for x in (jres.indices, jres.scores,
                                               jres.candidate_indices)]
    else:
        res = idx.retrieve_fn(cfg)(torch.from_numpy(q.copy()))
        jres = jidx.retrieve_fn(jcfg)(jnp.asarray(q))
        jres = (jres.indices, jres.scores, jres.candidate_indices)
    _held(res, jres, keys, metric, f"one device {metric} B={batch}")


def test_pad_rows_masked_for_all_negative_corpus():
    """tests/test_sharded_serving.py:106-135 carried across: six docs
    anti-correlated with the query, padded to 4 shards (2 zero rows). The
    reference's padded arrays cross by `convert.sharded_index`; both
    packages return no pad id and only negative scores, the same ones."""
    rng = np.random.default_rng(7)
    q = rng.normal(size=(64,)).astype(np.float32)
    emb = (-q[None, :] + 0.05 * rng.normal(size=(6, 64))).astype(np.float32)
    bp = JBitPlanarDB.from_quantized(jquant.build_database(jnp.asarray(emb)))
    jmesh = jmake_mesh((1,), ("data",))
    padded = jpad(bp, 4)
    jidx = JShardedIndex(db=jshard(padded, jmesh), mesh=jmesh, n_global=6)
    qc = np.asarray(jquant.quantize_int8_fixed(jnp.asarray(q), bp.scale),
                    np.int8)
    jcfg, cfg = JConfig(k=3, metric="mips"), RetrievalConfig(k=3,
                                                             metric="mips")
    jr = jidx.retrieve_fn(jcfg)(qc)
    for slots in (1, 2, 4):
        idx = convert.sharded_index(
            np.asarray(padded.msb_plane), np.asarray(padded.lsb_plane),
            np.asarray(padded.norms_sq), np.asarray(padded.scale),
            n_global=6, mesh=make_test_mesh(slots, 1, CPU))
        r = idx.retrieve_fn(cfg)(torch.from_numpy(qc.copy()))
        assert (r.indices.numpy() < 6).all(), r.indices
        assert (r.scores.numpy() < 0).all()
        np.testing.assert_array_equal(r.indices.numpy(),
                                      np.asarray(jr.indices))
        np.testing.assert_array_equal(r.scores.numpy(), np.asarray(jr.scores))
    # the port's own padding gives the reference's padded arrays
    tbp = BitPlanarDB.from_quantized(build_database(emb, device=CPU))
    tpad = pad_database(tbp, 4)
    for name in ("msb_plane", "lsb_plane", "norms_sq"):
        np.testing.assert_array_equal(getattr(tpad, name).numpy(),
                                      np.asarray(getattr(padded, name)))
    with pytest.raises(ValueError, match="pad_database"):
        convert.sharded_index(
            np.asarray(bp.msb_plane), np.asarray(bp.lsb_plane),
            np.asarray(bp.norms_sq), np.asarray(bp.scale), n_global=6,
            mesh=make_test_mesh(4, 1, CPU))


# -- ShardedIndex against the reference on multi-device meshes ------------------

_SUB = """
import sys
import numpy as np, jax, jax.numpy as jnp
from repro.compat import make_mesh, mesh_from_device_array
from repro.core import quantize_int8
from repro.core.index import ShardedIndex
from repro.core.retrieval import RetrievalConfig
assert len(jax.devices()) == 8, jax.devices()
rng = np.random.default_rng(1)
emb = rng.normal(size=(%d, %d)).astype(np.float32)
qs = rng.normal(size=(4, %d)).astype(np.float32)
q, _ = quantize_int8(jnp.asarray(qs), per_vector=True)
out = {}
meshes = {8: make_mesh((4, 2), ('data', 'model')),
          3: mesh_from_device_array(np.asarray(jax.devices()[:3]),
                                    ('shard',))}
for s, mesh in meshes.items():
    idx = ShardedIndex.build(jnp.asarray(emb), mesh)
    out[f'{s}_n_global'] = np.asarray(idx.n_global)
    for name in ('msb_plane', 'lsb_plane', 'norms_sq', 'scale'):
        out[f'{s}_{name}'] = np.asarray(getattr(idx.db, name))
    for metric in ('cosine', 'mips'):
        fn = idx.retrieve_fn(RetrievalConfig(k=%d, metric=metric))
        for tag, r in (('batch', fn(q)), ('single', fn(q[0]))):
            for f in ('indices', 'scores', 'candidate_indices'):
                out[f'{s}_{metric}_{tag}_{f}'] = np.asarray(getattr(r, f))
np.savez(sys.argv[1], **out)
print('OK')
""" % (N, D, D, K)


@pytest.fixture(scope="module")
def multidevice(tmp_path_factory):
    """The reference's ShardedIndex on 8 forced host devices, (4, 2) and
    (3,) meshes: results and padded arrays, saved as npz."""
    path = str(tmp_path_factory.mktemp("sharded") / "ref.npz")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    out = subprocess.run([sys.executable, "-c", _SUB, path], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    return dict(np.load(path))


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("slots", sorted(MESHES))
def test_sharded_index_matches_reference_multidevice(corpus, multidevice,
                                                     slots, metric):
    ref = multidevice
    mesh = make_test_mesh(*MESHES[slots], CPU)
    idx = ShardedIndex.build(torch.from_numpy(corpus["emb"]), mesh)
    assert idx.n_global == int(ref[f"{slots}_n_global"]) == N
    n_pad = ref[f"{slots}_msb_plane"].shape[0]
    assert n_pad == N + (-N) % slots and len(idx.db) == slots
    # the same padded rows, split in the reference's order
    for name in ("msb_plane", "lsb_plane", "norms_sq"):
        got = torch.cat([getattr(s, name) for s in idx.db]).numpy()
        np.testing.assert_array_equal(got, ref[f"{slots}_{name}"])
    carried = convert.sharded_index(
        ref[f"{slots}_msb_plane"], ref[f"{slots}_lsb_plane"],
        ref[f"{slots}_norms_sq"], ref[f"{slots}_scale"], n_global=N,
        mesh=mesh)
    cfg = RetrievalConfig(k=K, metric=metric)
    q = torch.from_numpy(corpus["q"].copy())
    keys = _ref_keys(corpus["jbp"], corpus["q"], cfg.num_candidates(N))
    for which, index in (("built", idx), ("carried", carried)):
        fn = index.retrieve_fn(cfg)
        want = [ref[f"{slots}_{metric}_batch_{f}"] for f in
                ("indices", "scores", "candidate_indices")]
        _held(fn(q), want, keys, metric, f"{slots} slots {metric} {which}")
        single = fn(q[0])
        for f in ("indices", "scores", "candidate_indices"):
            np.testing.assert_array_equal(
                getattr(single, f).numpy(),
                ref[f"{slots}_{metric}_single_{f}"])


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("shape", [(1, 1), (3, 1), (4, 2), (7, 1)])
def test_sharded_index_equals_the_unsharded_engine(corpus, shape, metric):
    """tests/test_multidevice.py:23-45 on the port: S shard slots give the
    unsharded engine's indices, scores and candidates exactly."""
    emb = torch.from_numpy(corpus["emb"])
    idx = ShardedIndex.build(emb, make_test_mesh(*shape, CPU))
    db = BitPlanarDB.from_quantized(build_database(emb, device=CPU))
    cfg = RetrievalConfig(k=K, metric=metric)
    q = torch.from_numpy(corpus["q"].copy())
    got = idx.retrieve_fn(cfg)(q)
    want = RetrievalEngine(cfg, CPU).retrieve(q, db)
    for f in ("indices", "scores", "candidate_indices"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert (got.indices < N).all()


def test_sharded_index_backends_agree_and_refuse_a_missing_card(corpus):
    emb = torch.from_numpy(corpus["emb"][:200])
    idx = ShardedIndex.build(emb, make_test_mesh(3, 1, CPU))
    q = torch.from_numpy(corpus["q"].copy())
    a = idx.retrieve_fn(RetrievalConfig(k=K, backend="cuda"))(q)
    b = idx.retrieve_fn(RetrievalConfig(k=K, backend="torch"))(q)
    for f in ("indices", "scores", "candidate_indices"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    if not torch.cuda.is_available():
        mesh = Mesh(np.array([torch.device("cuda")], dtype=object),
                    ("shard",))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ShardedIndex(db=idx.db[:1], mesh=mesh, n_global=200)
    with pytest.raises(ValueError, match="row blocks"):
        ShardedIndex(db=idx.db[:2], mesh=make_test_mesh(3, 1, CPU),
                     n_global=200)


# -- RAGPipeline.build(mesh=) ----------------------------------------------------

def _mesh_pipelines(mesh):
    jecfg, jep, tecfg, tep = tiny_embedder()
    japi, jgp, api, tgp = tiny_gen()
    docs = np.random.default_rng(3).integers(0, 128, (40, 12)).astype(
        np.int32)
    jpipe = JRAGPipeline.build(jecfg, jep, japi, jgp, jnp.asarray(docs),
                               JConfig(k=3), mesh=jmake_test_mesh(1, 1))
    pipe = RAGPipeline.build(tecfg, tep, api, tgp, docs, RetrievalConfig(k=3),
                             mesh=mesh)
    plain = RAGPipeline.build(tecfg, tep, api, tgp, docs,
                              RetrievalConfig(k=3), device=CPU)
    return jpipe, pipe, plain, docs


def test_rag_pipeline_with_a_mesh_matches_reference():
    """The reference's one-device mesh against the port's, parameters
    carried across: ids, ledgers and greedy tokens; then the port's
    8-slot mesh against its unsharded pipeline."""
    jpipe, pipe, plain, docs = _mesh_pipelines(make_test_mesh(1, 1, CPU))
    assert pipe.db is None and pipe.index is not None
    assert jpipe.db is None and jpipe.index is not None
    q = docs[[5, 17, 23]]
    res, ledger = pipe.retrieve(q)
    jres, jledger = jpipe.retrieve(jnp.asarray(q))
    np.testing.assert_array_equal(res.indices.numpy(),
                                  np.asarray(jres.indices))
    np.testing.assert_array_equal(res.scores.numpy(), np.asarray(jres.scores))
    assert res.indices[:, 0].tolist() == [5, 17, 23]
    assert ledger.total_uj == pytest.approx(jledger.total_uj, rel=1e-12)
    out, ids, _ = pipe.answer(q, max_new=4)
    jout, jids, _ = jpipe.answer(jnp.asarray(q), max_new=4)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    # the retrieve function is built once per config
    fn = pipe._retrieve
    pipe.retrieve(q)
    assert pipe._retrieve is fn
    pipe.retrieval_cfg = RetrievalConfig(k=2, metric="mips")
    assert tuple(pipe.retrieve(q)[0].indices.shape) == (3, 2)
    assert pipe._retrieve is not fn


def test_rag_pipeline_on_eight_slots_equals_unsharded():
    _, pipe, plain, docs = _mesh_pipelines(make_test_mesh(4, 2, CPU))
    assert len(pipe.index.db) == 8 and pipe.index.n_global == 40
    q = docs[[1, 9, 33, 38]]
    (res, ledger), (want, wledger) = pipe.retrieve(q), plain.retrieve(q)
    for f in ("indices", "scores", "candidate_indices"):
        assert torch.equal(getattr(res, f), getattr(want, f)), f
    assert ledger.total_uj == wledger.total_uj
    out, ids, _ = pipe.answer(q, max_new=4)
    wout, wids, _ = plain.answer(q, max_new=4)
    assert torch.equal(ids, wids) and torch.equal(out, wout)
    with pytest.raises(ValueError, match="mesh"):
        RAGPipeline.build(pipe.emb_cfg, pipe.emb_params, pipe.gen_api,
                          pipe.gen_params, docs,
                          mesh=make_test_mesh(2, 1, CPU), device="cuda")
