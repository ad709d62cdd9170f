"""The port's elastic trainer (`repro_torch.runtime.elastic`) in lockstep
with `repro.runtime.elastic`, on the CPU: tests/test_runtime.py:46-145,
each case run by both packages on the same numpy batch and the same
initial parameters (carried across by `convert.dense_params`), at f32
compute. Held exactly: restarts, final_devices, monitored workers and the
history's length; the losses within a relative 1e-4 (Adam's normalized
update turns last-bit grad differences into lr-sized moves).

Workers: the reference names a worker by its JAX device id and its tests
hand it `FakeDev`s while monkeypatching `build_mesh_from` onto the one
real device; the port names a worker by its slot ordinal, and its slots
may repeat a device, so the same cases run on CPU slots (ROADMAP C22).
"""
import itertools

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

import repro.runtime.elastic as jel
import repro_torch.runtime.elastic as el
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs import get_config as jget_config
from repro.models import get_model as jget_model
from repro.runtime import ElasticTrainer as JElasticTrainer
from repro.runtime import FailureInjector as JFailureInjector
from repro.train import adamw as jadamw
from repro.train import make_train_step as jmake_train_step
from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.models import get_model
from repro_torch.runtime import (ElasticTrainer, FailureInjector,
                                 WorkerFailure, build_mesh_from)
from repro_torch.train import adamw, make_train_step

LOSS_RTOL = 1e-4


class FakeDev:
    def __init__(self, i):
        self.id = i


def _factories():
    """(reference make_state, port make_state, reference batch, port
    batch): the smoke model at vocab 64 and f32 compute, AdamW lr 1e-3,
    one (4, 16) batch; both start from the reference's PRNGKey(0) init."""
    jcfg = jget_config("qwen2-0.5b", smoke=True).with_(
        vocab_size=64, compute_dtype="float32")
    japi = jget_model(jcfg)
    api = get_model(get_config("qwen2-0.5b", smoke=True).with_(
        vocab_size=64, compute_dtype="float32"))
    jopt, opt = jadamw(lr=1e-3), adamw(lr=1e-3)
    host = jax.tree.map(np.asarray, japi.init(jax.random.PRNGKey(0)))
    jstep = jax.jit(jmake_train_step(japi.loss_fn, jopt))
    step = make_train_step(api.loss_fn, opt)

    def jmake_state(mesh):
        params = jax.tree.map(jnp.asarray, host)
        return (params, jopt.init(params),
                lambda p, o, b, mesh: jstep(p, o, b), None)

    def make_state(mesh):
        params = convert.dense_params(host, device=mesh.slots()[0])
        return (params, opt.init(params),
                lambda p, o, b, mesh: step(p, o, b), None)

    toks = np.random.default_rng(0).integers(0, 64, (4, 16)).astype(np.int32)
    return (jmake_state, make_state,
            {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)},
            {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(toks)})


def _run_both(tmp_path, monkeypatch, *, num_steps, save_every, keep=3,
              schedule=None, jdevices=None, devices=None, port_mesh=None):
    jmake, make, jbatch, batch = _factories()
    # the reference's own tests: fakes for bookkeeping, the real device
    # for compute
    jorig = jel.build_mesh_from
    monkeypatch.setattr(jel, "build_mesh_from",
                        lambda d, mp: jorig(jax.devices(), 1))
    if port_mesh is not None:
        orig = el.build_mesh_from
        monkeypatch.setattr(el, "build_mesh_from",
                            lambda d, mp: orig(port_mesh(d), mp))
    jtrainer = JElasticTrainer(make_state=jmake, ckpt=JCheckpointManager(
        str(tmp_path / "ref"), keep=keep), save_every=save_every)
    trainer = ElasticTrainer(make_state=make, ckpt=CheckpointManager(
        str(tmp_path / "port"), keep=keep), save_every=save_every)
    jout = jtrainer.run(itertools.repeat(jbatch), num_steps=num_steps,
                        injector=schedule and JFailureInjector(schedule),
                        devices=jdevices)
    out = trainer.run(itertools.repeat(batch), num_steps=num_steps,
                      injector=schedule and FailureInjector(schedule),
                      devices=devices)
    for key in ("restarts", "final_devices", "monitored", "stragglers"):
        assert out[key] == jout[key], key
    assert len(out["losses"]) == len(jout["losses"])
    np.testing.assert_allclose(out["losses"], jout["losses"],
                               rtol=LOSS_RTOL)
    return out


def test_elastic_trainer_monitors_only_in_mesh_devices(tmp_path, monkeypatch):
    """Two workers, a mesh of one: only the mesh's worker is monitored."""
    out = _run_both(tmp_path, monkeypatch, num_steps=4, save_every=4,
                    jdevices=[FakeDev(0), FakeDev(7)], devices=["cpu", "cpu"],
                    port_mesh=lambda d: d[:1])
    assert out["monitored"] == ["0"]


def test_build_mesh_from_survivors():
    devs = jax.devices()
    assert jel.build_mesh_from(devs, 1).devices.size == len(devs)
    assert build_mesh_from(["cpu"] * len(devs), 1).size == len(devs)
    for n in range(1, 9):
        for mp in (1, 2, 4):
            mesh = build_mesh_from(["cpu"] * n, mp)
            want_mp = mp
            while want_mp > 1 and n % want_mp:
                want_mp //= 2
            assert mesh.shape == {"data": n // want_mp, "model": want_mp}
            assert mesh.size == n and mesh.axis_names == ("data", "model")


def test_elastic_trainer_restarts_after_failure(tmp_path, monkeypatch):
    """A failure at step 12: restart from step 10 (the last save) and finish
    all 20 steps; the replayed steps' losses are truncated at the restore,
    and the dead worker leaves the monitors."""
    out = _run_both(tmp_path, monkeypatch, num_steps=20, save_every=5,
                    keep=2, schedule={12: 1},
                    jdevices=[FakeDev(0), FakeDev(1)], devices=["cpu", "cpu"])
    assert out["restarts"] == 1 and out["final_devices"] == 1
    assert len(out["losses"]) == 20
    assert "1" not in out["monitored"]
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == [
        "step_00000015", "step_00000020"]


def test_elastic_trainer_no_failure(tmp_path, monkeypatch):
    out = _run_both(tmp_path, monkeypatch, num_steps=8, save_every=4,
                    devices=["cpu"])
    assert out["restarts"] == 0 and len(out["losses"]) == 8


def test_failure_injector_names_the_dropped_workers():
    inj = FailureInjector({3: 1, 5: 2})
    assert inj.check(0, ["0", "1", "2"]) == ["0", "1", "2"]
    with pytest.raises(WorkerFailure) as e:
        inj.check(5, ["0", "1", "2"])
    assert e.value.workers == ["1", "2"]
    assert inj.check(3, ["0"]) == ["0"]   # the last worker is never dropped


def test_the_trainer_runs_on_the_card_unless_given_slots(monkeypatch):
    """Without devices the slots are every visible CUDA device; with none
    the run raises instead of training on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists")
    trainer = ElasticTrainer(make_state=None, ckpt=None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trainer.run(iter(()), num_steps=1)
