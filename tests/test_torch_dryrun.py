"""The port's dry run (`repro_torch.launch.dryrun`, `shapes`, the
production meshes, `compat`, `collectives.DryMesh`, `roofline`) against
the reference's dry-run tooling and against hand counts.

The reference's sharded numbers come from one subprocess with 512 forced
host devices (the reference's production meshes need 256 and 512; its
(4, 2) and (8, 1) meshes take the first 8), as `tests/test_multidevice.py`
runs its meshes, so this process keeps its single device.
"""
import json
import math
import os
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_config as jget_config
from repro.launch import shapes as jshapes
from repro.models import get_model as jget_model
from repro_torch import _tree, compat
from repro_torch.configs import get_config
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding as sh
from repro_torch.launch import dryrun, hlo_analysis, roofline
from repro_torch.launch import shapes as shp
from repro_torch.launch.mesh import (make_production_mesh, make_test_mesh,
                                     make_train_opt_mesh)
from repro_torch.models import common, get_model
from repro_torch.models.registry import abstract_params
from repro_torch.train import adamw

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))

# The reference's side: production meshes; per-device argument bytes of
# the smoke train step (B 8 x 16) on (4, 2) and (8, 1) and of the decode
# step (B 8, cache 32) on (4, 2); per-device dot FLOPs of the train step.
REFERENCE = r"""
import json
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.compat import make_mesh, set_mesh
from repro.configs import get_config
from repro.distributed import sharding as sh
from repro.launch import hlo_analysis, shapes as shp
from repro.launch.mesh import make_production_mesh, make_train_opt_mesh
from repro.models import get_model
from repro.train import get_optimizer, make_train_step

out = {"meshes": {}}
for name, fn in (("production", make_production_mesh),
                 ("train_opt", make_train_opt_mesh)):
    for multi in (False, True):
        m = fn(multi_pod=multi)
        out["meshes"][f"{name} {multi}"] = [list(m.devices.shape),
                                            list(m.axis_names)]

def mesh(d, m):
    return make_mesh((d, m), ("data", "model"), devices=jax.devices()[:8])

def train(arch, msh):
    cfg = get_config(arch, smoke=True)
    api = get_model(cfg)
    ap = jax.eval_shape(api.init, jax.random.PRNGKey(0))
    ps = sh.param_shardings(ap, msh, cfg)
    opt = get_optimizer(cfg.optimizer)
    ast = jax.eval_shape(opt.init, ap)
    ost = sh.opt_state_shardings(ast, ap, msh, cfg)
    batch = shp.abstract_batch(cfg, shp.ShapeCase("x", "train", 16, 8))
    bs = sh.batch_shardings(batch, msh)
    repl = NamedSharding(msh, P())
    with set_mesh(msh):
        c = jax.jit(make_train_step(api.loss_fn, opt),
                    in_shardings=(ps, ost, bs),
                    out_shardings=(ps, ost, {"loss": repl, "grad_norm": repl}),
                    donate_argnums=(0, 1)).lower(ap, ast, batch).compile()
    return [c.memory_analysis().argument_size_in_bytes,
            hlo_analysis.analyze(c.as_text())["dot_flops"]]

def decode(arch, msh):
    cfg = get_config(arch, smoke=True)
    api = get_model(cfg)
    ap = jax.eval_shape(api.init, jax.random.PRNGKey(0))
    ps = sh.param_shardings(ap, msh, cfg)
    cache = jax.eval_shape(lambda: api.init_cache(8, 32))
    cs = sh.cache_shardings(cache, msh, cfg)
    tok = jax.ShapeDtypeStruct((8, 1), jnp.int32)
    with set_mesh(msh):
        c = jax.jit(api.decode_step,
                    in_shardings=(ps, cs, sh.batch_shardings(tok, msh)),
                    donate_argnums=(1,)).lower(ap, cache, tok).compile()
    return c.memory_analysis().argument_size_in_bytes

# a toy with collectives on (8,): three trips of a dot then a psum, and
# one tiled all-gather; the largest contributors (`top_ops`)
from repro.compat import shard_map

def toy(x, w):
    def step(c, _):
        return jax.lax.psum(c @ w, "data"), None
    c = jax.lax.scan(step, x, None, length=3)[0]
    return jax.lax.all_gather(c, "data", tiled=True)

toy_mesh = make_mesh((8,), ("data",), devices=jax.devices()[:8])
c = jax.jit(shard_map(toy, mesh=toy_mesh, in_specs=(P("data"), P()),
                      out_specs=P())).lower(
    jax.ShapeDtypeStruct((128, 32), jnp.float32),
    jax.ShapeDtypeStruct((32, 32), jnp.float32)).compile()
top = hlo_analysis.analyze(c.as_text(), top_ops=4)
out["toy"] = {"top_collectives": [t[:2] for t in top["top_collectives"]],
              "top_dots": [t[0] for t in top["top_dots"]]}

for arch in ("qwen2-0.5b", "llama4-scout-17b-a16e"):
    out[arch] = {"train 4x2": train(arch, mesh(4, 2)),
                 "train 8x1": train(arch, mesh(8, 1)),
                 "decode 4x2": decode(arch, mesh(4, 2))}
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    out = subprocess.run([sys.executable, "-c", REFERENCE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + "\n" + out.stderr
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("RESULT ")]
    return json.loads(line[-1][len("RESULT "):])


def _slots(d, m):
    return compat.make_mesh((d, m), ("data", "model"), devices="meta")


# -- shapes, abstract parameters, meshes ---------------------------------------

def test_shapes_and_applicability_equal_the_reference():
    assert {k: tuple(vars(v).values()) for k, v in shp.SHAPES.items()} == {
        k: tuple(vars(v).values()) for k, v in jshapes.SHAPES.items()}
    assert shp.SUBQUADRATIC_FAMILIES == jshapes.SUBQUADRATIC_FAMILIES
    for arch in ARCH_IDS:
        for name in shp.SHAPES:
            assert shp.applicable(get_config(arch), name) == \
                jshapes.applicable(jget_config(arch), name), (arch, name)


def _jdtype(x) -> str:
    return str(jnp.dtype(x.dtype))


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_abstract_params_equal_init(smoke):
    """Names, shapes and dtypes: against the port's `api.init` at the
    smoke configs (drawn on the CPU) and against the reference's
    `jax.eval_shape(api.init)` at both."""
    for arch in ARCH_IDS:
        cfg = get_config(arch, smoke=smoke)
        ab = _tree.named_leaves(abstract_params(cfg))
        assert all(t.is_meta for _, t in ab), arch
        got = [(n, tuple(t.shape), str(t.dtype).removeprefix("torch."))
               for n, t in ab]
        if smoke:
            real = get_model(cfg).init(torch.Generator().manual_seed(0),
                                       device="cpu")
            assert got == [(n, tuple(t.shape),
                            str(t.dtype).removeprefix("torch."))
                           for n, t in _tree.named_leaves(real)], arch
        jtree = jax.eval_shape(jget_model(jget_config(arch, smoke=smoke)).init,
                               jax.random.PRNGKey(0))
        want = sorted(("__".join(str(getattr(k, "key", k)) for k in path),
                       tuple(x.shape), _jdtype(x))
                      for path, x in jax.tree_util.tree_flatten_with_path(
                          jtree)[0])
        assert sorted(got) == want, arch


def test_production_meshes_equal_the_reference(reference):
    for name, fn in (("production", make_production_mesh),
                     ("train_opt", make_train_opt_mesh)):
        for multi in (False, True):
            m = fn(multi_pod=multi)
            assert [list(m.devices.shape), list(m.axis_names)] == \
                reference["meshes"][f"{name} {multi}"]
            assert {d.type for d in m.slots()} == {"meta"}
            assert m.size == math.prod(m.devices.shape)


# -- the sharded step: bytes, collectives, FLOPs ---------------------------------

@pytest.mark.parametrize("arch", ["qwen2-0.5b", "llama4-scout-17b-a16e"])
def test_argument_bytes_equal_the_references_memory_analysis(reference,
                                                             arch):
    cfg = get_config(arch, smoke=True)
    ref = reference[arch]
    for (d, m) in ((4, 2), (8, 1)):
        step = dryrun.build_step(cfg, shp.ShapeCase("x", "train", 16, 8),
                                 _slots(d, m))
        assert step.argument_bytes == ref[f"train {d}x{m}"][0], (d, m)
    step = dryrun.build_step(cfg, shp.ShapeCase("x", "decode", 32, 8),
                             _slots(4, 2))
    assert step.spec_argument_bytes == ref["decode 4x2"]


def test_dot_flops_on_a_data_only_mesh_and_the_model_axis(reference):
    """(8, 1): rank 0's FLOPs equal the reference's per device. (4, 2): the
    port repeats compute across the model axis (ROADMAP C24), so rank 0
    runs B/4 rows whole: m = 2 times the reference's (8, 1) count."""
    cfg = get_config("qwen2-0.5b", smoke=True)
    ref = reference["qwen2-0.5b"]
    case = shp.ShapeCase("x", "train", 16, 8)
    flops = {dm: dryrun.analyze_step(dryrun.build_step(
        cfg, case, _slots(*dm)))["dot_flops"] for dm in ((8, 1), (4, 2))}
    assert flops[(8, 1)] == ref["train 8x1"][1]
    assert flops[(4, 2)] == 2 * ref["train 8x1"][1]


def _hand_count(cfg, mesh):
    """Collectives of the (2, 2) AdamW step with clipping, from the rules:
    each parameter gathered over its split dims (in order), each grad
    reduce-scattered along the dim split over exactly the batch axes or
    else all-reduced over them; plus the label counts, the loss and the
    global norm (4 bytes each). Result bytes, counts and ring bytes."""
    kinds = {"all-gather": [0, 0], "all-reduce": [0, 0],
             "reduce-scatter": [0, 0]}
    sent = 0

    def add(kind, result, ring):
        nonlocal sent
        kinds[kind][0] += 1
        kinds[kind][1] += result
        sent += ring
    params = abstract_params(cfg)
    shardings = sh.param_shardings(params, mesh, cfg)
    for t, s in zip(_tree.leaves(params), _tree.leaves(shardings)):
        shape = list(sh.local_shape(tuple(t.shape), s))
        for d, entry in enumerate(s.spec):
            if entry is None:
                continue
            k = mesh.axes_size(entry)
            src = math.prod(shape) * 4
            shape[d] *= k
            add("all-gather", src * k, (k - 1) * src)
        whole = t.numel() * 4
        dims = [d for d, e in enumerate(s.spec) if coll.axes_of(e) == ("data",)]
        if dims:
            add("reduce-scatter", whole // 2, whole // 2)
        else:
            add("all-reduce", whole, whole)          # 2 (k-1) n / k, k = 2
    add("all-reduce", 4, 4)       # the labelled counts (grad_accum 1)
    add("all-reduce", 4, 4)       # the loss
    add("all-reduce", 4, 3 * 4 * 2 // 4)          # the norm, over 4 ranks
    return kinds, sent


def test_dry_mesh_counts_the_sharded_steps_collectives():
    """The (2, 2) step `tests/test_torch_sharded_train.py` runs on four
    ranks (qwen2 smoke, vocab 64, f32 compute, AdamW, B 8 x 16), run once
    on rank 0 of a DryMesh, against the hand count."""
    cfg = get_config("qwen2-0.5b", smoke=True).with_(
        vocab_size=64, compute_dtype="float32")
    step = dryrun.build_step(cfg, shp.ShapeCase("x", "train", 16, 8),
                             _slots(2, 2))
    mesh = step.mesh
    assert isinstance(mesh, coll.DryMesh) and mesh.coords == {
        "data": 0, "model": 0}
    rec = dryrun.analyze_step(step)
    kinds, sent = _hand_count(cfg, mesh)
    assert rec["collective_counts"] == {k: v[0] for k, v in kinds.items()}
    assert {k: rec["collectives"][k] for k in kinds} == {
        k: v[1] for k, v in kinds.items()}
    assert rec["collectives"]["total"] == sum(v[1] for v in kinds.values())
    assert rec["bytes_sent"] == sent
    assert rec["tensor_devices"] == ["meta"]


def test_top_ops_equal_the_references_on_a_toy(reference):
    """The reference's collective toy on (8,) (three trips of a dot and a
    psum, then a tiled all-gather) as one rank of a DryMesh: the largest
    dot and collective contributors equal the reference's `top_ops`."""
    mesh = coll.DryMesh((8,), ("data",))

    def toy(x, w):
        for _ in range(3):
            x = coll.all_reduce(x @ w, mesh, ("data",))
        return coll.all_gather(x, mesh, ("data",))
    x = torch.empty((16, 32), device="meta")
    w = torch.empty((32, 32), device="meta")
    _, rec = hlo_analysis.analyze(toy, x, w, mesh=mesh, top_ops=4)
    want = reference["toy"]
    assert [t[:2] for t in rec["top_collectives"]] == want["top_collectives"]
    assert rec["top_collectives"] == [[16384, "all-gather", 16384, 1],
                                      [6144, "all-reduce", 2048, 3]]
    assert [t[0] for t in rec["top_dots"]] == want["top_dots"]
    assert rec["top_dots"] == [[3 * 2 * 16 * 32 * 32, "aten.mm", "f32",
                                ((16, 32), (32, 32))]]
    _, rec = hlo_analysis.analyze(toy, x, w, mesh=mesh)
    assert "top_dots" not in rec and "top_collectives" not in rec


def test_dry_mesh_is_one_rank_without_a_process_group():
    mesh = coll.DryMesh((2, 4), ("data", "model"), rank=6)
    assert mesh.coords == {"data": 1, "model": 2}
    assert mesh.index("model") == 2 and mesh.index(("data", "model")) == 6
    assert mesh.group("data") == ("dry", ("data",))
    assert coll.DryMesh((1, 4), ("data", "model")).group("data") is None
    x = torch.empty((8, 3), device="meta")
    y = coll.all_gather(x, mesh, "model", dim=0)
    z = coll.reduce_scatter(y, mesh, ("data", "model"), dim=0)
    w = coll.all_reduce(z, mesh, "data")
    assert (tuple(y.shape), tuple(z.shape), tuple(w.shape)) == (
        (32, 3), (4, 3), (4, 3))
    assert mesh.comm["calls"] == 3
    assert mesh.kinds == {"all-gather": {"count": 1, "bytes": 384},
                          "reduce-scatter": {"count": 1, "bytes": 48},
                          "all-reduce": {"count": 1, "bytes": 48}}
    assert mesh.comm["bytes_sent"] == 3 * 96 + 7 * 48 + 48
    with pytest.raises(ValueError):
        coll.DryMesh((2, 2), ("data", "model"), rank=4)


# -- the dry run on meta against the same step on the CPU --------------------------

def test_meta_step_counts_what_the_real_step_dispatches():
    """The card check's logic at smoke size on the CPU: the same step on
    real tensors dispatches the same dots and peaks at the same bytes."""
    cfg = get_config("qwen2-0.5b", smoke=True)
    case = shp.ShapeCase("x", "train", 64, 8)
    rec = dryrun.record(cfg, case)
    fn, _ = dryrun.step_fn(cfg, "train", lr=3e-4)
    params = get_model(cfg).init(torch.Generator().manual_seed(0),
                                 device="cpu")
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (8, 64), generator=gen,
                         dtype=torch.int32)
    args = (params, adamw(lr=3e-4).init(params),
            {"tokens": toks, "labels": toks.clone()})
    _, got = hlo_analysis.analyze(fn, *args)
    assert got["dot_flops_by_dtype"] == rec["dot_flops_by_dtype"]
    assert got["peak_bytes"] == rec["memory"]["peak_memory_in_bytes"]
    assert got["argument_bytes"] == rec["memory"]["argument_size_in_bytes"]
    assert got["tensor_devices"] == ["cpu"] and rec["tensor_devices"] == [
        "meta"]


def test_kvq_decode_counts_its_kernels_as_launches():
    cfg = get_config("qwen2-0.5b", smoke=True)
    rec = dryrun.record(cfg, shp.ShapeCase("x", "decode", 4096, 4), None,
                        "kvq")
    assert rec["kernel_launches"] == {"stage0_sign_gather": cfg.num_layers,
                                      "stage1_rows": cfg.num_layers}
    # the flat decode on the same cache length launches nothing
    assert dryrun.record(cfg, shp.ShapeCase("x", "decode", 4096, 4)
                         )["kernel_launches"] == {}


# -- whole cells, the CLI, the roofline -----------------------------------------

KEYS = {"arch", "shape", "mesh", "variant", "status", "devices", "rank",
        "mesh_shape", "case", "build_s", "trace_s", "memory", "fits",
        "card_bytes", "cost", "dot_flops", "dot_flops_by_dtype",
        "kernel_launches", "collectives", "collective_counts", "bytes_sent",
        "tensor_devices"}


def test_full_width_cell_stays_on_meta():
    rec = dryrun.run_cell("seamless-m4t-medium", "decode_32k", "single",
                          verbose=False)
    assert set(rec) == KEYS and rec["status"] == "ok"
    assert rec["tensor_devices"] == ["meta"]
    assert rec["devices"] == 256 and rec["mesh_shape"] == {"data": 16,
                                                           "model": 16}
    mem = rec["memory"]
    assert mem["peak_memory_in_bytes"] >= mem["argument_size_in_bytes"] > \
        mem["spec_argument_bytes"] > 0
    assert rec["fits"] == (mem["peak_memory_in_bytes"] <= rec["card_bytes"])
    row = roofline.analyze_cell(rec)
    assert row["dominant"] == "memory" and row["bound_s"] == pytest.approx(
        (mem["argument_size_in_bytes"] + mem["output_size_in_bytes"])
        / roofline.HBM_BW)


def test_a_failing_cell_is_an_error_and_exits_1(tmp_path, monkeypatch):
    def boom(*args, **kw):
        raise RuntimeError("no such step")
    monkeypatch.setattr(dryrun, "record", boom)
    out = tmp_path / "dry.json"
    rc = dryrun.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k",
                      "--out", str(out)])
    recs = json.loads(out.read_text())
    assert rc == 1 and [r["status"] for r in recs] == ["error"]
    assert recs[0]["error"] == "RuntimeError: no such step"
    rc = dryrun.main(["--arch", "qwen2-0.5b", "--shape", "long_500k",
                      "--out", str(out)])
    assert rc == 0 and {r["status"] for r in json.loads(out.read_text())} \
        == {"error", "skipped"}


def test_roofline_terms():
    rec = {"status": "ok", "arch": "qwen2-0.5b", "shape": "x", "mesh": "one",
           "devices": 1, "mesh_shape": None,
           "case": {"kind": "decode", "batch": 4, "seq": 128},
           "memory": {"argument_size_in_bytes": 3.35e9,
                      "output_size_in_bytes": 0},
           "dot_flops": 989.4e12 + 66.9e12,
           "dot_flops_by_dtype": {"bf16": 989.4e12, "f32": 66.9e12},
           "collectives": {"total": 450e9}}
    row = roofline.analyze_cell(rec)
    assert (row["compute_s"], row["memory_s"], row["collective_s"]) == (
        pytest.approx(2.0), pytest.approx(1e-3), pytest.approx(1.0))
    assert row["dominant"] == "compute" and row["bound_s"] == row["compute_s"]
    assert roofline.peak_flops("f32", tf32=True) == 494.7e12
    assert roofline.peak_flops("int8") == 1979e12
    cfg = get_config("llama4-scout-17b-a16e")
    total = sum(t.numel() for t in _tree.leaves(abstract_params(cfg)))
    routed = sum(t.numel() for n, t in _tree.named_leaves(
        abstract_params(cfg)) if n.split("__")[-1] in ("w_gate", "w_up",
                                                       "w_down")
        and "moe" in n.split("__"))
    assert roofline._active_params(cfg) == pytest.approx(
        total - routed + routed / cfg.num_experts)


# -- compat -----------------------------------------------------------------

def test_compat_meshes_are_the_launchers_slot_meshes():
    got = compat.make_mesh((2, 2), ("data", "model"), devices="cpu")
    want = make_test_mesh(2, 2, "cpu")
    assert got.axis_names == want.axis_names
    assert got.devices.tolist() == want.devices.tolist()
    arr = np.array([[torch.device("cpu")] * 3], dtype=object)
    m = compat.mesh_from_device_array(arr, ("data", "model"))
    assert m.shape == {"data": 1, "model": 3} and m.slots() == list(arr.flat)
    dealt = compat.make_mesh((3,), ("shard",), devices=["cpu", "meta"])
    assert [d.type for d in dealt.slots()] == ["cpu", "meta", "cpu"]


def test_compat_set_mesh_nests_as_common_does():
    a, b = _slots(2, 2), _slots(4, 1)
    assert compat.get_abstract_mesh() is None
    with compat.set_mesh(a):
        assert compat.get_abstract_mesh() is a is common.active_mesh()
        with common.set_mesh(b):
            assert compat.get_abstract_mesh() is b
        assert compat.get_abstract_mesh() is a
    assert compat.get_abstract_mesh() is None


def test_compat_quiet_drops_only_future_warnings():
    def warn(kind):
        warnings.warn("renamed", kind)
        return 7
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        assert compat._quiet(warn, FutureWarning) == 7
        assert not seen
        compat._quiet(warn, UserWarning)
        assert len(seen) == 1
    assert coll._quiet is compat._quiet
