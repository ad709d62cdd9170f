"""Multi-rank runs of the sharded training path on the CPU (gloo, a file
store; the rank-side halves are in tests/torch_rank_cases.py, which
imports no JAX):

  * `make_two_level_all_reduce` on 8 ranks at (pod 2, data 4) against the
    reference's shard_map (8 forced host devices, in a subprocess, as
    tests/test_multidevice.py runs it): within one quantization step of
    it, and within scale + 1e-5 of the mean; and the (1, 1) identity case
    of tests/test_compression.py, bit for bit against the reference;
  * the elastic 4 -> 2 shrink against a one-process run of the same
    schedule (losses within 1e-5 relative), the survivors monitored, each
    generation's ranks holding only their blocks;
  * the launcher at --data 2 --model 2 --device cpu (the one-process
    launcher's losses), and a failing rank failing the run.

Every spawned run and subprocess has a time limit, and so does each rank's
process group (60 s).
"""
import itertools
import os
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

import torch_rank_cases as cases
from repro.configs import get_config as jget_config
from repro.distributed import compression as jcomp
from repro.models import get_model as jget_model
from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager
from repro_torch.distributed import collectives
from repro_torch.launch import train as launch_train
from repro_torch.runtime import ElasticTrainer, FailureInjector
from repro_torch.train import make_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
RUN_S = 240                                 # each spawned run's limit


def _reference_params():
    cfg = jget_config("qwen2-0.5b", smoke=True).with_(
        vocab_size=64, compute_dtype="float32")
    return jax.tree.map(np.asarray,
                        jget_model(cfg).init(jax.random.PRNGKey(0)))


_SHARD_MAP = """
import sys, numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.compat import make_mesh, shard_map
from repro.distributed import compression as comp
g = np.load(sys.argv[1])
mesh = make_mesh((2, 4), ('pod', 'data'))
fn = comp.make_two_level_all_reduce(mesh)
out = shard_map(lambda t: fn({'w': t})['w'], mesh=mesh,
                in_specs=P(('pod', 'data')), out_specs=P(('pod', 'data')),
                check_vma=False)(jnp.asarray(g))
np.save(sys.argv[2], np.asarray(out))
"""


def test_two_level_all_reduce_on_eight_ranks_matches_shard_map(tmp_path):
    g = np.random.default_rng(5).normal(size=(8, 33)).astype(np.float32)
    np.save(tmp_path / "g.npy", g)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    ref = subprocess.Popen([sys.executable, "-c", _SHARD_MAP,
                            str(tmp_path / "g.npy"), str(tmp_path / "o.npy")],
                           env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    try:
        rows = collectives.spawn(cases.two_level, 8, g, timeout_s=RUN_S)
        _, err = ref.communicate(timeout=RUN_S)
    finally:
        ref.kill()
    assert ref.returncode == 0, err[-4000:]
    got = np.concatenate(rows)
    want = np.load(tmp_path / "o.npy")
    # one quantization step of the mean: the largest agreed scale (the max
    # over pods of a data block's intra-pod sums, / 127) over npod * ndata
    sums = np.pad(g.reshape(2, 4, 33).sum(axis=1), ((0, 0), (0, 3)))
    step = max(float(np.abs(sums[:, j * 9:(j + 1) * 9]).max())
               for j in range(4)) / 127.0 / 8
    assert np.abs(got - want).max() <= step
    mean = np.broadcast_to(g.mean(axis=0, keepdims=True), g.shape)
    scale = float(np.abs(g).max()) / 127.0
    assert np.abs(got - mean).max() <= scale + 1e-5
    for r in rows:                              # one answer on every rank
        np.testing.assert_array_equal(r, rows[0])


def test_two_level_all_reduce_single_rank_mesh(tmp_path):
    """tests/test_compression.py:55-70 on a (pod 1, data 1) mesh: the
    identity mean, and the reference's shard_map output bit for bit."""
    from repro.compat import make_mesh, shard_map
    g = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (1, 33)))
    world = collectives.World(0, 1, str(tmp_path), torch.device("cpu"))
    got = cases.two_level(world, g)
    scale = float(np.abs(g).max()) / 127.0
    np.testing.assert_allclose(got, g, atol=scale * 0.5 + 1e-6)
    mesh = make_mesh((1, 1), ("pod", "data"))
    fn = jcomp.make_two_level_all_reduce(mesh)
    want = shard_map(lambda t: fn(t), mesh=mesh,
                     in_specs=jax.sharding.PartitionSpec(),
                     out_specs=jax.sharding.PartitionSpec(),
                     check_vma=False)({"w": jnp.asarray(g)})["w"]
    np.testing.assert_array_equal(got, np.asarray(want))


def test_elastic_shrink_from_four_ranks_to_two(tmp_path):
    """(2, 2) loses 2 ranks at step 3 -> (1, 2), restores step 2 and runs
    to step 6: the losses of a one-process run of the same schedule."""
    host, batch = _reference_params(), cases.batch()
    outs = collectives.spawn(cases.elastic, 4, host, batch,
                             str(tmp_path / "ranks"), 6, 2, 3, 2,
                             timeout_s=RUN_S)
    cfg, api = cases.smoke()
    opt = cases.adamw(lr=1e-3)
    raw = make_train_step(api.loss_fn, opt)

    def make_state(mesh):
        params = convert.dense_params(host, device="cpu")
        return params, opt.init(params), lambda p, o, b, m: raw(p, o, b), None
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    want = ElasticTrainer(make_state=make_state,
                          ckpt=CheckpointManager(str(tmp_path / "one")),
                          save_every=2, model_parallel=2).run(
        itertools.repeat(tb), num_steps=6,
        injector=FailureInjector({3: 2}), devices=["cpu"] * 4)
    assert want["restarts"] == 1 and len(want["losses"]) == 6
    for rank, out in enumerate(outs):
        assert out["dropped"] == (rank >= 2)
        assert out["restarts"] == 1 and out["final_devices"] == 2
    for out in outs[:2]:
        np.testing.assert_allclose(out["losses"], want["losses"], rtol=1e-5)
        assert out["monitored"] == ["0", "1"] == want["monitored"]
        (m0, res0, blk0), (m1, res1, blk1) = out["sizes"]
        assert (m0, m1) == ({"data": 2, "model": 2}, {"data": 1, "model": 2})
        assert res0 == blk0 and res1 == blk1 and blk0 < blk1
    for out in outs[2:]:
        assert len(out["losses"]) == 3 and len(out["sizes"]) == 1


def test_launcher_trains_on_two_by_two_ranks(tmp_path, capsys):
    env = dict(os.environ, PYTHONPATH=SRC)
    args = ["--smoke", "--steps", "4", "--save-every", "2", "--device", "cpu"]
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          *args, "--data", "2", "--model", "2", "--ckpt-dir",
                          str(tmp_path / "ranks")], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=RUN_S)
    assert out.returncode == 0, out.stderr[-4000:]
    line = re.compile(r"^qwen2-0\.5b: 4 steps in [0-9.]+s; (loss [0-9.]+ -> "
                      r"[0-9.]+); restarts 0$", re.M)
    got = line.search(out.stdout)
    assert got, out.stdout
    assert sorted(p.name for p in (tmp_path / "ranks").iterdir()) == [
        "step_00000002", "step_00000004"]
    assert launch_train.main(args + ["--ckpt-dir", str(tmp_path / "one")]) \
        == 0
    want = line.search(capsys.readouterr().out)
    assert got.group(1) == want.group(1)


def test_a_failing_rank_fails_the_run():
    with pytest.raises(RuntimeError, match="(?s)rank 1:.*rank one fails"):
        collectives.spawn(cases.fail_on_rank_one, 2, timeout_s=RUN_S)


def test_ranks_get_their_devices(monkeypatch):
    """A CUDA device without an index deals ranks over the cards (all on
    cuda:0 of a one-card machine); any other device is every rank's."""
    assert collectives.spawn(cases.device_of, 2, device="cpu",
                             timeout_s=RUN_S) == ["cpu", "cpu"]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert [collectives.rank_device("cuda", r) for r in range(3)] == \
        [torch.device("cuda", 0)] * 3
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert [collectives.rank_device("cuda", r).index for r in range(6)] == \
        [0, 1, 2, 3, 0, 1]
    assert collectives.rank_device("cuda:2", 5) == torch.device("cuda", 2)
