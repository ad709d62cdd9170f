"""The port's retrieval examples (`repro_torch.examples.quickstart`,
`pod_retrieval`) against the reference's `examples/quickstart.py` and
`examples/pod_retrieval.py`, on the CPU.

Both are exact integer arithmetic on the same seeded corpus, so their
logs are held line for line as printed. The reference's quickstart runs
in this process (its `main()` loaded from its path); its pod example runs
in a subprocess, where its own `XLA_FLAGS` give it 8 host devices (this
process has one). Three things may differ, as they name JAX objects or
times: the pod log's mesh line after "= 8" (the reference counts
devices, the port shard slots over devices), its "sharded" line after
"shards" (a PartitionSpec against rows per shard, and a wall time).

Each example's `main([])` raises without CUDA, and the port's side of
each lockstep is its `main(["--device", "cpu"])` with CUDA reported
absent.
"""
import pytest

torch = pytest.importorskip("torch")

import os
import subprocess
import sys

from torch_examples_ref import ROOT, no_cuda, reference, run_main

from repro_torch.examples import pod_retrieval, quickstart


def test_quickstart_lines_equal_the_reference(monkeypatch, capsys):
    reference("quickstart").main()
    want = capsys.readouterr().out
    out = run_main(monkeypatch, quickstart, ["--device", "cpu"])
    got = capsys.readouterr().out
    assert got.splitlines() == want.splitlines()
    assert len(got.splitlines()) == 7
    assert tuple(out["batched"].indices.shape) == (16, 5)
    assert tuple(out["pruned"].indices.shape) == (16, 5)


def _pod_lines(text):
    lines = text.strip().splitlines()
    lines[0] = lines[0].split(" = 8")[0]
    lines[1] = lines[1].split(" shards")[0]
    return lines


def test_pod_retrieval_lines_equal_the_reference(monkeypatch, capsys):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    # the reference runs in its subprocess while the port runs here
    with subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "examples",
                                          "pod_retrieval.py")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) as ref:
        try:
            out = run_main(monkeypatch, pod_retrieval, ["--device", "cpu"])
            want, err = ref.communicate(timeout=300)
        finally:
            ref.kill()
    assert ref.returncode == 0, err[-4000:]
    assert "= 8 devices" in want
    got = capsys.readouterr().out
    assert got.startswith("mesh: {'data': 4, 'model': 2} = 8 shard slots "
                          "over 1 device(s)\nsharded 20000 docs over 8 "
                          "shards in ")
    assert "(2500 rows/shard)" in got.splitlines()[1]
    assert _pod_lines(got) == _pod_lines(want)
    assert len(got.splitlines()) == 7
    assert tuple(out["tournament"].indices.shape) == (8, 3)


@pytest.mark.parametrize("example", [quickstart, pod_retrieval],
                         ids=["quickstart", "pod_retrieval"])
def test_retrieval_example_needs_cuda_unless_told_cpu(monkeypatch, example):
    """Without CUDA the default device raises before any work; the
    lockstep tests above run `--device cpu` with CUDA absent."""
    no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example.main([])
