"""The port's training sharding rules (`repro_torch.distributed.sharding`)
and GSPMD hint specs (`repro_torch.models.common`) against the
reference's, on the CPU with no processes: the rules are pure metadata.

For every leaf of every reference architecture (abstract parameters by
`jax.eval_shape`, as tests/test_sharding_rules.py builds them) the port's
`param_spec` equals the reference's, with serve False and True, on the
meshes (16, 16), (2, 16, 16), (2, 2), (1, 4) and (4, 1); likewise
`opt_state_shardings` for AdamW and Adafactor states, `batch_spec`,
`cache_spec` (the reference's two cases and the k_scale, state and conv
leaves), and the specs `constrain`/`constrain_kv` pin, captured from the
reference's `with_sharding_constraint` under a fake mesh. Held exactly.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

import repro.compat as jcompat
import repro.distributed.sharding as jsh
from repro.configs import ARCH_IDS, get_config as jget_config
from repro.models import common as jcommon
from repro.models import get_model as jget_model
from repro.train import get_optimizer as jget_optimizer
from repro_torch import _tree
from repro_torch.distributed import sharding as sh
from repro_torch.models import common
from repro_torch.train import adafactor, adamw

MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((2, 2), ("data", "model")),
          ((1, 4), ("data", "model")),
          ((4, 1), ("data", "model"))]
MESH_IDS = ["16x16", "2x16x16", "2x2", "1x4", "4x1"]


def fake_mesh(shape, names):
    """A stub with the two attributes the rules read (and `empty`, which
    the reference's hints read)."""
    class M:
        axis_names = tuple(names)
        empty = False

        def __init__(self):
            self.shape = dict(zip(names, shape))
    return M()


def _key(e):
    return getattr(e, "key", getattr(e, "name", getattr(e, "idx", e)))


def _port_path(path) -> tuple:
    return tuple(_key(e) for e in path)


@functools.lru_cache(maxsize=None)
def _abstract(arch):
    cfg = jget_config(arch)
    return cfg, jax.eval_shape(jget_model(cfg).init, jax.random.PRNGKey(0))


def _meta(abstract):
    """The abstract params as a tree of torch meta tensors (same keys)."""
    return jax.tree.map(
        lambda l: torch.empty(l.shape, dtype=torch.float32, device="meta"),
        abstract)


@pytest.mark.parametrize("mshape,mnames", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_the_reference(arch, mshape, mnames):
    cfg, aparams = _abstract(arch)
    mesh = fake_mesh(mshape, mnames)
    n = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(aparams)[0]:
        itemsize = jnp.dtype(leaf.dtype).itemsize
        for serve in (False, True):
            want = jsh.param_spec(path, leaf.shape, mesh, cfg, serve=serve,
                                  dtype_bytes=itemsize)
            got = sh.param_spec(_port_path(path), leaf.shape, mesh, cfg,
                                serve=serve, dtype_bytes=itemsize)
            assert isinstance(got, sh.PartitionSpec)
            assert tuple(got) == tuple(want), (path, leaf.shape, serve)
            n += 1
    assert n > 0


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_opt_state_specs_equal_the_reference(arch, opt_name, monkeypatch):
    cfg, aparams = _abstract(arch)
    astate = jax.eval_shape(jget_optimizer(opt_name).init, aparams)
    meta = _meta(aparams)
    pstate = {"adamw": adamw, "adafactor": adafactor}[opt_name]().init(meta)
    # the reference's NamedSharding needs a real mesh: take its specs
    monkeypatch.setattr(jsh, "NamedSharding", lambda m, spec: spec)
    for mshape, mnames in MESHES:
        mesh = fake_mesh(mshape, mnames)
        want = jsh.opt_state_shardings(astate, aparams, mesh, cfg)
        got = sh.opt_state_shardings(pstate, meta, mesh, cfg)
        wflat = jax.tree_util.tree_flatten_with_path(
            want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)
        )[0]
        gflat = _tree.named_leaves(got)
        assert [n for n, _ in gflat] == [
            "__".join(map(str, _port_path(p))) for p, _ in wflat]
        for (name, g), (_, w) in zip(gflat, wflat, strict=True):
            assert g.mesh is mesh
            assert tuple(g.spec) == tuple(w), (mnames, name)


@pytest.mark.parametrize("mshape,mnames", MESHES, ids=MESH_IDS)
def test_batch_specs_equal_the_reference(mshape, mnames):
    mesh = fake_mesh(mshape, mnames)
    for shape in [(), (1,), (8,), (8, 64), (3, 64), (16, 7, 5), (32, 1),
                  (512, 2048), (2, 4)]:
        want = jsh.batch_spec(shape, mesh)
        assert tuple(sh.batch_spec(shape, mesh)) == tuple(want), shape
    batch = {"tokens": torch.zeros((8, 16), dtype=torch.int32),
             "labels": torch.zeros((8, 16), dtype=torch.int32)}
    got = sh.batch_shardings(batch, mesh)
    for k in batch:
        assert tuple(got[k].spec) == tuple(jsh.batch_spec((8, 16), mesh))


CACHE_CASES = [
    # the reference's two cases (tests/test_sharding_rules.py:93-111)
    ("deepseek-67b", "k", (95, 128, 32768, 8, 128)),
    ("zamba2-2.7b", "k", (9, 1, 524288, 32, 80)),
    ("qwen2-0.5b", "v", (24, 8, 4096, 2, 64)),
    ("qwen2-0.5b", "k_msb", (24, 1, 3, 2, 32)),
    ("qwen2-0.5b", "self_k", (24, 6, 4096, 16, 64)),
    ("seamless-m4t-medium", "cross_v", (12, 3, 1500, 16, 64)),
    ("qwen2-0.5b", "k_scale", (24, 8, 4096, 2)),
    ("qwen2-0.5b", "k_scale", (24, 1, 4096, 16)),
    ("qwen2-0.5b", "k_scale", (24, 1, 3, 5)),
    ("mamba2-2.7b", "state", (64, 8, 80, 64, 128)),
    ("mamba2-2.7b", "state", (64, 1, 7, 64, 128)),
    ("mamba2-2.7b", "conv", (64, 8, 3, 5376)),
    ("mamba2-2.7b", "conv", (64, 3, 3, 7)),
    ("qwen2-0.5b", "length", (8,)),
    ("qwen2-0.5b", "other", (8, 16)),
]


@pytest.mark.parametrize("mshape,mnames", MESHES, ids=MESH_IDS)
def test_cache_specs_equal_the_reference(mshape, mnames):
    from jax.tree_util import DictKey
    mesh = fake_mesh(mshape, mnames)
    for arch, name, shape in CACHE_CASES:
        cfg = jget_config(arch)
        want = jsh.cache_spec((DictKey(name),), shape, mesh, cfg)
        got = sh.cache_spec((name,), shape, mesh, cfg)
        assert tuple(got) == tuple(want), (arch, name, shape)
    cache = {"k": torch.empty((95, 128, 32768, 8, 128), device="meta"),
             "length": torch.empty((128,), device="meta")}
    got = sh.cache_shardings(cache, mesh)
    assert tuple(got["k"].spec) == tuple(jsh.cache_spec(
        (DictKey("k"),), (95, 128, 32768, 8, 128), mesh, None))
    assert tuple(got["length"].spec) == ()


def test_reference_cache_cases_hold_on_the_port():
    """tests/test_sharding_rules.py's two cache assertions, on the port."""
    mesh = fake_mesh((16, 16), ("data", "model"))
    spec = sh.cache_spec(("k",), (95, 128, 32768, 8, 128), mesh)
    assert spec[2] == "model" and spec[3] is None and spec[1] == "data"
    spec = sh.cache_spec(("k",), (9, 1, 524288, 32, 80), mesh)
    assert spec[3] == "model" or spec[2] is not None


# --- GSPMD hints --------------------------------------------------------------

HINT_CASES = [
    ((8, 64, 14, 64), ("dp", None, "mp", None)),
    ((8, 64, 2, 64), ("dp", None, "mp", None)),
    ((3, 64, 16, 64), ("dp", None, "mp", None)),
    ((8, 64, 896), ("dp", None, None)),
    ((8, 64, 896), ("dp", "mp", None)),
    ((8, 64, 151936), ("dp", None, "mp")),
    ((1, 7, 4864), ("dp", None, "mp")),
    ((16, 32), ("mp", "dp")),
    ((16, 32), ("dp", "dp")),
    ((4, 0, 8), ("dp", "mp", "mp")),
    ((8,), ("dp", None, "mp")),
]
KV_CASES = [(8, 4096, 2, 64), (8, 4096, 16, 64), (1, 4096, 2, 64),
            (32, 7, 3, 64), (2, 32768, 8, 128)]


def _captured(monkeypatch, mesh, fn, x):
    seen = []
    monkeypatch.setattr(jcompat, "get_abstract_mesh", lambda: mesh)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda a, spec: seen.append(spec) or a)
    fn(x)
    assert len(seen) == 1
    return tuple(seen[0])


@pytest.mark.parametrize("mshape,mnames", MESHES, ids=MESH_IDS)
def test_constrain_specs_equal_the_reference(mshape, mnames, monkeypatch):
    mesh = fake_mesh(mshape, mnames)
    for shape, pattern in HINT_CASES:
        want = _captured(monkeypatch, mesh,
                         lambda x: jcommon.constrain(x, *pattern),
                         jnp.zeros(shape))
        assert common.constrain_spec(shape, pattern, mesh) == want, (
            shape, pattern)
    for shape in KV_CASES:
        want = _captured(monkeypatch, mesh, jcommon.constrain_kv,
                         jnp.zeros(shape))
        assert common.constrain_kv_spec(shape, mesh) == want, shape


def test_residual_pattern_equals_the_reference():
    cfg = jget_config("qwen2-0.5b", smoke=True)
    for seq_shard in (False, True):
        assert common.residual_pattern(cfg.with_(seq_shard=seq_shard)) == \
            jcommon.residual_pattern(cfg.with_(seq_shard=seq_shard))


def test_hints_return_their_input_with_or_without_a_mesh():
    """C24: the port realizes no pin; the forward under a sharded mesh is
    the forward without one."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    cfg = get_config("qwen2-0.5b", smoke=True).with_(compute_dtype="float32")
    api = get_model(cfg)
    params = api.init(torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(
        np.random.default_rng(0).integers(0, 128, (4, 16)).astype(np.int32))
    batch = {"tokens": toks, "labels": toks}
    x = torch.zeros((8, 16, 4, 16))
    assert common.active_mesh() is None
    assert common.constrain(x, "dp", None, "mp", None) is x
    want = api.loss_fn(params, batch)
    mesh = fake_mesh((2, 2), ("data", "model"))
    with common.set_mesh(mesh):
        assert common.active_mesh() is mesh
        assert common.constrain(x, "dp", None, "mp", None) is x
        assert common.constrain_kv(x) is x
        got = api.loss_fn(params, batch)
    assert common.active_mesh() is None
    assert torch.equal(got, want)
