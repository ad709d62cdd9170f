"""The port's checkpointing (`repro_torch.checkpoint`) against
`repro.checkpoint`, on the CPU: tests/test_checkpoint.py's five cases on
the port, and the on-disk format shared both ways. A reference-written
(params, AdamW state) restores in the port bit for bit and the reverse;
both packages write the same manifest (leaf names, files, shapes,
dtypes) for the same state."""
import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.checkpoint import restore_checkpoint as jrestore_checkpoint
from repro.checkpoint import save_checkpoint as jsave_checkpoint
from repro.configs import get_config as jget_config
from repro.models import get_model as jget_model
from repro.train import adamw as jadamw
from repro_torch import _tree, convert
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    restore_checkpoint, save_checkpoint)


def tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((4, 8), generator=g),
            "b": {"c": torch.arange(5, dtype=torch.int32),
                  "d": torch.tensor(3.5)}}


def _equal(got, want):
    for (n, a), (m, b) in zip(_tree.named_leaves(got),
                              _tree.named_leaves(want), strict=True):
        assert n == m and a.dtype == b.dtype
        assert torch.equal(a, b), n


# --- tests/test_checkpoint.py, on the port ----------------------------------

def test_roundtrip(tmp_path):
    t = tree()
    save_checkpoint(str(tmp_path), 7, t)
    got, step = restore_checkpoint(str(tmp_path), t)
    assert step == 7
    _equal(got, t)


def test_latest_step_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save_async(s, tree(s))
    mgr.wait()
    assert latest_step(str(tmp_path)) == 4
    assert sorted(os.listdir(tmp_path)) == ["step_00000003", "step_00000004"]


def test_crash_mid_save_never_corrupts_latest(tmp_path):
    save_checkpoint(str(tmp_path), 1, tree(1))
    os.makedirs(tmp_path / "step_00000002.tmp")
    with open(tmp_path / "step_00000002.tmp" / "junk", "w") as f:
        f.write("partial")
    assert latest_step(str(tmp_path)) == 1
    _, step = restore_checkpoint(str(tmp_path), tree(1))
    assert step == 1


def test_restore_to_a_device_or_a_tree_of_devices(tmp_path):
    """The reference's reshard-on-restore: every leaf to a device given,
    alone or as a tree shaped like the state."""
    t = tree(3)
    save_checkpoint(str(tmp_path), 1, t)
    for device in ("cpu", _tree.tree_map(lambda _: torch.device("cpu"), t)):
        got, _ = restore_checkpoint(str(tmp_path), t, device=device)
        _equal(got, t)


def test_restore_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "nope"), tree())


# --- the port's own guarantees ----------------------------------------------

def test_async_save_holds_the_state_at_the_call(tmp_path):
    """save_async copies the state before it returns: writing the
    tensors in place afterwards does not reach the checkpoint."""
    t = tree(4)
    want = _tree.tree_map(torch.clone, t)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_async(1, t)
    for leaf in _tree.leaves(t):
        leaf.add_(1)
    got, _ = mgr.restore_latest(t)
    _equal(got, want)


def test_other_dtypes_and_other_states_raise(tmp_path):
    with pytest.raises(TypeError, match="b__c is int64"):
        save_checkpoint(str(tmp_path), 1, {"a": torch.zeros(2),
                                           "b": {"c": torch.arange(3)}})
    with pytest.raises(TypeError, match="0__w is float16"):
        save_checkpoint(str(tmp_path), 1,
                        ({"w": torch.zeros(2, dtype=torch.float16)},))
    assert latest_step(str(tmp_path)) is None
    save_checkpoint(str(tmp_path), 2, tree())
    with pytest.raises(ValueError, match="holds leaves"):
        restore_checkpoint(str(tmp_path), {"a": torch.zeros(4, 8)})
    with pytest.raises(ValueError, match="has shape"):
        restore_checkpoint(str(tmp_path), dict(tree(), a=torch.zeros(2)))


def test_a_failed_write_raises_from_wait(tmp_path, monkeypatch):
    import repro_torch.checkpoint.checkpoint as ck

    def full_disk(*a, **kw):
        raise OSError("no space left on device")
    mgr = CheckpointManager(str(tmp_path))
    monkeypatch.setattr(ck.np, "save", full_disk)
    mgr.save_async(1, tree())
    with pytest.raises(OSError, match="no space"):
        mgr.wait()
    mgr.wait()                           # the error is raised once
    assert latest_step(str(tmp_path)) is None


# --- the format, shared with the reference -----------------------------------

def _reference_state():
    """The qwen2-0.5b smoke params and an AdamW state one step in."""
    api = jget_model(jget_config("qwen2-0.5b", smoke=True))
    params = api.init(jax.random.PRNGKey(0))
    opt = jadamw(lr=1e-3)
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, p.dtype), params)
    _, state = jax.jit(opt.update)(grads, opt.init(params), params)
    return params, state


def _port(params, state):
    host = jax.tree.map(np.asarray, (params, state))
    return (convert.dense_params(host[0], device="cpu"),
            convert.optimizer_state(host[1], device="cpu"))


def _same_as_reference(got, want):
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    names = ["__".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path) for path, _ in flat]
    assert [n for n, _ in _tree.named_leaves(got)] == names
    for (n, a), (_, b) in zip(_tree.named_leaves(got), flat):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype, n
        np.testing.assert_array_equal(a.numpy(), b, err_msg=n)


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    jstate = _reference_state()
    jsave_checkpoint(str(tmp_path), 3, jstate)
    like = _tree.tree_map(torch.zeros_like, _port(*jstate))
    got, step = restore_checkpoint(str(tmp_path), like)
    assert step == 3
    _same_as_reference(got, jstate)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    jstate = _reference_state()
    save_checkpoint(str(tmp_path), 5, _port(*jstate))
    like = jax.tree.map(jnp.zeros_like, jstate)
    got, step = jrestore_checkpoint(str(tmp_path), like)
    assert step == 5
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jstate),
                    strict=True):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_both_packages_write_the_same_manifest(tmp_path):
    jstate = _reference_state()
    jsave_checkpoint(str(tmp_path / "ref"), 1, jstate)
    save_checkpoint(str(tmp_path / "port"), 1, _port(*jstate))
    manifests = [json.load(open(tmp_path / d / "step_00000001" /
                                "manifest.json")) for d in ("ref", "port")]
    assert manifests[0] == manifests[1]
    names = [leaf["name"] for leaf in manifests[0]["leaves"]]
    assert names[0] == "0__blocks__bk" and "1__mu__embed" in names
    assert names[-1] == "1__step"


# --- bfloat16 leaves (ROADMAP C23) --------------------------------------------

def _bf16_state():
    """A reference state with a bfloat16 leaf: the smoke params with the
    embedding in bfloat16 (an ml_dtypes array, as the reference holds it)."""
    params, state = _reference_state()
    params = dict(params, embed=params["embed"].astype(jnp.bfloat16))
    return params, state


def test_reference_bfloat16_leaf_restores_in_the_port_bit_for_bit(tmp_path):
    jstate = _bf16_state()
    jsave_checkpoint(str(tmp_path / "ref"), 4, jstate)
    manifest = json.load(open(tmp_path / "ref" / "step_00000004" /
                              "manifest.json"))
    entry = next(leaf for leaf in manifest["leaves"]
                 if leaf["name"] == "0__embed")
    assert entry["dtype"] == "bfloat16"
    host = jax.tree.map(np.asarray, jstate)
    like = _tree.tree_map(torch.zeros_like, (
        dict(convert.dense_params(dict(host[0], embed=host[0]["embed"]
                                       .astype(np.float32)), device="cpu")),
        convert.optimizer_state(host[1], device="cpu")))
    like[0]["embed"] = like[0]["embed"].to(torch.bfloat16)
    got, step = restore_checkpoint(str(tmp_path / "ref"), like)
    assert step == 4 and got[0]["embed"].dtype == torch.bfloat16
    want_bits = np.asarray(jstate[0]["embed"]).view(np.uint16)
    np.testing.assert_array_equal(
        got[0]["embed"].view(torch.int16).numpy().view(np.uint16), want_bits)
    # and the port writes the same bytes back
    save_checkpoint(str(tmp_path / "port"), 4, got)
    for leaf in manifest["leaves"]:
        a = (tmp_path / "ref" / "step_00000004" / leaf["file"]).read_bytes()
        b = (tmp_path / "port" / "step_00000004" / leaf["file"]).read_bytes()
        assert a == b, leaf["name"]
    assert json.load(open(tmp_path / "port" / "step_00000004" /
                          "manifest.json")) == manifest


def test_port_bfloat16_leaf_restores_in_the_reference(tmp_path):
    """The reference's own restore hands a bfloat16 leaf back as its raw
    2-byte records (numpy `V2`), a property the port does not copy; the
    bits are the port's."""
    w = torch.randn((3, 5), generator=torch.Generator().manual_seed(1)
                    ).to(torch.bfloat16)
    save_checkpoint(str(tmp_path), 1, {"w": w, "s": torch.tensor(2)
                                       .to(torch.int32)})
    like = {"w": jnp.zeros((3, 5), jnp.bfloat16),
            "s": jnp.zeros((), jnp.int32)}
    got, _ = jrestore_checkpoint(str(tmp_path), like)
    assert np.asarray(got["w"]).dtype.str == "|V2"
    np.testing.assert_array_equal(np.asarray(got["w"]).view(np.uint16),
                                  w.view(torch.int16).numpy().view(np.uint16))
