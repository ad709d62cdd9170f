"""A training state sharded over a mesh of `torch.distributed` ranks, on
the CPU (gloo, a file store; the rank-side halves are in
tests/torch_rank_cases.py, which imports no JAX):

  * the 4-rank (data 2, model 2) sharded step against the one-process
    port step and the reference's step (AdamW two steps with grad_accum 1
    and 2, Adafactor one step, AdamW with INT8 error feedback): the loss
    and the clip norm within 1e-6 relative (the reference's loss: 1e-5),
    the first step's grads within 1e-5 of each leaf's largest |value|,
    and, where each rank's rows are one microbatch (grad_accum 2, no
    clipping where AdamW runs), every step's grads and every parameter
    within 1e-5 of its leaf's largest. With the batch's halves summed
    across ranks (grad_accum 1), or another package's arithmetic, the
    grads differ in their last bits, and Adam's per-element normalization
    turns that in near-zero grads (the key bias's) into lr-sized moves, so
    there the first step's grads carry the check; each rank's resident
    parameter and optimizer bytes equal its blocks;
  * the MoE SMOKE model (scout's, capacity 1.0) one step on the same
    mesh, each rank's rows half a microbatch (grad_accum 1) and a whole
    one (grad_accum 2): the loss within 1e-5 relative and the grads
    within 1e-5 of each leaf's largest against the reference's step with
    its shard-aligned dispatch on 2 batch shards (its `_dp_shards`
    patched to 2, a test-side patch; ROADMAP C25);
  * the SSM, hybrid and enc-dec SMOKE models (mamba2's, zamba2's and
    seamless's, f32 compute; the enc-dec's batch with frames) one AdamW
    step on the same mesh, grad_accum 1: the loss
    within 1e-6 relative and the grads within 1e-5 of each leaf's
    largest against the one-process port step, the loss within 1e-5
    relative of the reference's;
  * sharded checkpoints: written by 4 ranks, restored by the reference's
    `restore_checkpoint` bit for bit; written by the reference, restored
    on 4 ranks, each keeping its block bit for bit.

The other multi-rank runs (the two-level all-reduce, the elastic shrink,
the launcher) are in tests/test_torch_sharded_elastic.py. The spawned run
has a time limit, and so does each rank's process group (60 s).
"""

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

import torch_rank_cases as cases
from repro.checkpoint import restore_checkpoint as jrestore_checkpoint
from repro.checkpoint import save_checkpoint as jsave_checkpoint
from repro.configs import get_config as jget_config
from repro.distributed import compression as jcomp
from repro.models import get_model as jget_model
from repro.models import moe as jmoe
from repro.train import adafactor as jadafactor
from repro.train import adamw as jadamw
from repro.train import make_train_step as jmake_train_step
from repro_torch import _tree, convert
from repro_torch.distributed import collectives
from repro_torch.train import make_train_step
from repro_torch.train.step import value_and_grad

LOSS_RTOL, PARAM_TOL = 1e-6, 1e-5           # phase (a) of chip_smoke.py
REF_LOSS_RTOL = 1e-5                        # port against the reference
RUN_S = 240                                 # each spawned run's limit


def _reference_opts():
    return {"adamw": lambda: jadamw(lr=1e-3, weight_decay=0.1),
            "adamw_accum2": lambda: jadamw(lr=1e-3),
            "adafactor": lambda: jadafactor(lr=1e-3),
            "adamw_compressed": lambda: jadamw(lr=1e-3)}


@pytest.fixture(scope="module")
def ref():
    """The reference's smoke params (vocab 64, f32 compute) on the host,
    the batch, and the reference model."""
    cfg = jget_config("qwen2-0.5b", smoke=True).with_(
        vocab_size=64, compute_dtype="float32")
    api = jget_model(cfg)
    host = jax.tree.map(np.asarray, api.init(jax.random.PRNGKey(0)))
    return host, cases.batch(), api


@pytest.fixture(scope="module")
def moe_ref():
    """The reference's MoE SMOKE params on the host and its model."""
    cfg = jget_config("llama4-scout-17b-a16e", smoke=True).with_(
        compute_dtype="float32", capacity_factor=1.0)
    api = jget_model(cfg)
    return jax.tree.map(np.asarray, api.init(jax.random.PRNGKey(0))), api


@pytest.fixture(scope="module")
def family_ref():
    """The reference's SSM, hybrid and enc-dec SMOKE params on the host,
    and its models, at f32 compute."""
    out = {}
    for family, arch in cases.FAMILY_CASES.items():
        api = jget_model(jget_config(arch, smoke=True).with_(
            compute_dtype="float32"))
        out[family] = (jax.tree.map(np.asarray,
                                    api.init(jax.random.PRNGKey(0))), api)
    return out


@pytest.fixture(scope="module")
def steps(ref, moe_ref, family_ref, tmp_path_factory):
    """Rank results of tests/torch_rank_cases.py::step_cases, plus the
    checkpoint paths: the reference writes one the ranks restore, the
    ranks write one the reference restores."""
    host, batch, api = ref
    root = tmp_path_factory.mktemp("sharded_steps")
    opt = jadamw(lr=1e-3)
    params = jax.tree.map(jnp.asarray, host)
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, p.dtype), params)
    _, state = opt.update(grads, opt.init(params), params)
    jsave_checkpoint(str(root / "ref"), 7, (params, state))
    outs = collectives.spawn(cases.step_cases, 4, host, batch,
                             str(root / "ref"), str(root / "ranks"),
                             moe_ref[0],
                             {f: h for f, (h, _) in family_ref.items()},
                             timeout_s=RUN_S)
    return outs, root, (params, state)


def _rel(got, want) -> float:
    """Largest |got - want| over each leaf's largest |want|."""
    worst = 0.0
    for a, b in zip(_tree.leaves(got), jax.tree.leaves(want), strict=True):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        worst = max(worst, float(np.abs(a - b).max())
                    / max(float(np.abs(b).max()), 1e-30))
    return worst


def _one_process(host, batch, name):
    """(losses, grads per step, params, clip norms) of the port's
    one-process step on the same case."""
    make_opt, n, accum, clip, compress = cases.STEP_CASES[name]
    cfg, api = cases.smoke()
    opt = make_opt()
    params = convert.dense_params(host, device="cpu")
    state = opt.init(params)
    grads = []
    step = make_train_step(
        api.loss_fn, opt, grad_accum=accum, clip_norm=clip,
        grad_transform=cases.transform_with(grads, compress, params))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    losses, norms = [], []
    for _ in range(n):
        params, state, m = step(params, state, tb)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return (losses, grads, _tree.tree_map(lambda t: t.numpy(), params),
            norms)


def _reference(host, batch, api, name):
    """(losses, grads per step) of the reference's jitted step; the hook's
    grads and error-feedback state are the jitted function's outputs."""
    _, n, accum, clip, compress = cases.STEP_CASES[name]
    opt = _reference_opts()[name]()

    @jax.jit
    def step(params, state, batch, err):
        seen = []

        def transform(g):
            seen.append(g)
            if compress:
                g, seen_err = jcomp.apply_error_feedback(g, err)
                seen.append(seen_err)
            return g
        params, state, m = jmake_train_step(
            api.loss_fn, opt, grad_accum=accum, clip_norm=clip,
            grad_transform=transform)(params, state, batch)
        return params, state, m, seen[0], seen[-1]

    params = jax.tree.map(jnp.asarray, host)
    state = opt.init(params)
    err = jcomp.init_error_state(params)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    losses, grads = [], []
    for _ in range(n):
        params, state, m, g, new_err = step(params, state, jb, err)
        if compress:
            err = new_err
        losses.append(float(m["loss"]))
        grads.append(jax.tree.map(np.asarray, g))
    return losses, grads


@pytest.mark.parametrize("name", list(cases.STEP_CASES))
def test_sharded_step_matches_one_process_and_reference(ref, steps, name):
    host, batch, api = ref
    outs = steps[0]
    got = outs[0][name]
    for other in outs[1:]:                  # every rank ends with one state
        assert other[name]["losses"] == got["losses"]
        for a, b in zip(_tree.leaves(other[name]["params"]),
                        _tree.leaves(got["params"])):
            np.testing.assert_array_equal(a, b)
    losses, grads, params, norms = _one_process(host, batch, name)
    np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["norms"], norms, rtol=LOSS_RTOL)
    assert len(got["grads"]) == len(grads) == len(losses)
    if cases.aligned(name):
        for g, want in zip(got["grads"], grads, strict=True):
            assert _rel(g, want) <= PARAM_TOL
        assert _rel(got["params"], params) <= PARAM_TOL
    else:
        assert _rel(got["grads"][0], grads[0]) <= PARAM_TOL
    # against the reference from the same parameters: its first step's
    # grads (later ones start from parameters Adam has moved apart)
    jlosses, jgrads = _reference(host, batch, api, name)
    np.testing.assert_allclose(got["losses"], jlosses, rtol=REF_LOSS_RTOL)
    assert _rel(got["grads"][0], convert.dense_params(
        jgrads[0], device="cpu")) <= PARAM_TOL


@pytest.mark.parametrize("name", list(cases.MOE_CASES))
def test_sharded_moe_step_matches_reference_shard_aligned(moe_ref, steps,
                                                          name, monkeypatch):
    host, api = moe_ref
    accum = cases.MOE_CASES[name]
    outs = steps[0]
    for other in outs[1:]:
        assert other[name]["loss"] == outs[0][name]["loss"]

    @jax.jit
    def one(params, batch):
        seen = []

        def transform(g):
            seen.append(g)
            return g
        opt = jadamw(lr=1e-3)
        *_, m = jmake_train_step(api.loss_fn, opt, grad_accum=accum,
                                 clip_norm=None, grad_transform=transform)(
            params, opt.init(params), batch)
        return m["loss"], seen[0]
    monkeypatch.setattr(jmoe, "_dp_shards", lambda: 2)
    loss, grads = one(jax.tree.map(jnp.asarray, host),
                      {k: jnp.asarray(v) for k, v in cases.batch().items()})
    got = outs[0][name]
    assert abs(got["loss"] - float(loss)) <= REF_LOSS_RTOL * abs(float(loss))
    assert _rel(got["grads"], convert.moe_params(
        jax.tree.map(np.asarray, grads), device="cpu")) <= PARAM_TOL


@pytest.mark.parametrize("family", list(cases.FAMILY_CASES))
def test_sharded_family_step_matches_one_process(family_ref, steps, family):
    host, api = family_ref[family]
    outs = steps[0]
    for other in outs[1:]:
        assert other[family]["loss"] == outs[0][family]["loss"]
    _, tapi = cases.family_smoke(family)
    params = cases.FAMILY_TO_PORT[family](host, device="cpu")
    loss, grads = value_and_grad(
        tapi.loss_fn, params,
        {k: torch.from_numpy(v)
         for k, v in cases.family_batch(family).items()})
    got = outs[0][family]
    assert abs(got["loss"] - float(loss)) <= LOSS_RTOL * abs(float(loss))
    assert _rel(got["grads"], _tree.tree_map(lambda t: t.numpy(),
                                             grads)) <= PARAM_TOL
    jloss = jax.jit(api.loss_fn)(
        jax.tree.map(jnp.asarray, host),
        {k: jnp.asarray(v) for k, v in cases.family_batch(family).items()})
    assert abs(got["loss"] - float(jloss)) <= REF_LOSS_RTOL * abs(
        float(jloss))


@pytest.mark.parametrize("name", list(cases.STEP_CASES))
def test_each_rank_holds_only_its_blocks(steps, name):
    """Resident parameter and optimizer bytes equal the rank's blocks:
    about a quarter of the whole state on a (2, 2) mesh, the replicated
    norms and step counter whole."""
    for out in steps[0]:
        case = out[name]
        assert case["resident"] == case["blocks"]
        assert case["whole"] / 4 <= case["blocks"] < case["whole"] / 3


def test_ranks_checkpoint_restores_in_the_reference(steps):
    outs, root, (params, state) = steps
    like = jax.tree.map(jnp.zeros_like, (params, state))
    got, step = jrestore_checkpoint(str(root / "ranks"), like)
    assert step == 2
    want = (outs[0]["adamw"]["params"], outs[0]["adamw"]["state"])
    assert len(jax.tree.leaves(got)) == len(_tree.leaves(want))
    for a, b in zip(jax.tree.leaves(got), _tree.leaves(want), strict=True):
        assert np.asarray(a).dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), b)


def test_reference_checkpoint_restores_on_four_ranks(steps):
    outs, _, ref_state = steps
    host = jax.tree.map(np.asarray, ref_state)
    port = (convert.dense_params(host[0], device="cpu"),
            convert.optimizer_state(host[1], device="cpu"))
    whole = _tree.leaves(port)
    for out in outs:
        assert out["restored"]["step"] == 7
        for full, (block, sl) in zip(whole, out["restored"]["leaves"],
                                     strict=True):
            assert block.dtype == full.numpy().dtype
            np.testing.assert_array_equal(block, full.numpy()[sl])
