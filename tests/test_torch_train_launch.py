"""The port's training launcher (`repro_torch.launch.train`) on the CPU,
as a user runs it (`python -m ...`, plain and with --grad-accum 2
--compress-grads, and the enc-dec `seamless-m4t-medium`), its refusals
(a mesh axis below 1), its resume from the newest checkpoint, and the
training modules' imports (no JAX, no reference). Its sharded runs (--data/--model
above 1) are in tests/test_torch_sharded_train.py.
The reference's launcher (`repro.launch.train`) prints the same closing
line."""
import pytest

torch = pytest.importorskip("torch")

import os
import re
import subprocess
import sys

from repro_torch.launch import train as launch_train

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LINE = re.compile(r"^qwen2-0\.5b: 4 steps in [0-9.]+s; loss ([0-9.]+) -> "
                  r"([0-9.]+); restarts 0$", re.M)


def _run(*args, timeout=300):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           *args], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=timeout)


@pytest.mark.parametrize("extra", [[], ["--grad-accum", "2",
                                        "--compress-grads"]],
                         ids=["plain", "accum2_compressed"])
def test_launcher_trains_on_the_cpu(tmp_path, extra):
    out = _run("--device", "cpu", "--smoke", "--steps", "4", "--ckpt-dir",
               str(tmp_path), "--save-every", "2", *extra)
    assert out.returncode == 0, out.stderr[-4000:]
    m = LINE.search(out.stdout)
    assert m, out.stdout
    assert float(m.group(2)) < float(m.group(1))
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000002", "step_00000004"]


def test_launcher_resumes_from_the_newest_checkpoint(tmp_path, capsys):
    args = ["--device", "cpu", "--smoke", "--ckpt-dir", str(tmp_path),
            "--save-every", "2"]
    assert launch_train.main(args + ["--steps", "2"]) == 0
    assert launch_train.main(args + ["--steps", "2"]) == 0
    assert "no step run (resumed at step 2)" in capsys.readouterr().out
    assert launch_train.main(args + ["--steps", "3"]) == 0
    out = capsys.readouterr().out
    assert re.search(r"3 steps in [0-9.]+s; loss [0-9.]+ -> [0-9.]+", out)


def test_launcher_trains_the_encdec_arch(tmp_path):
    """seamless-m4t-medium at SMOKE: its batches carry zero frames."""
    out = _run("--device", "cpu", "--smoke", "--arch", "seamless-m4t-medium",
               "--steps", "2", "--batch", "2", "--seq", "8", "--ckpt-dir",
               str(tmp_path))
    assert out.returncode == 0, out.stderr[-4000:]
    assert re.search(r"^seamless-m4t-medium: 2 steps in [0-9.]+s; loss "
                     r"[0-9.]+ -> [0-9.]+; restarts 0$", out.stdout,
                     re.M), out.stdout


@pytest.mark.parametrize("args,err,match", [
    (["--data", "0"], ValueError, "mesh axes must be >= 1"),
    (["--model", "0"], ValueError, "mesh axes must be >= 1")])
def test_launcher_refuses_what_is_not_ported(tmp_path, args, err, match):
    with pytest.raises(err, match=match):
        launch_train.main(["--device", "cpu", "--smoke", "--steps", "1",
                           "--ckpt-dir", str(tmp_path), *args])


def test_training_modules_import_neither_jax_nor_the_reference():
    code = (
        "import sys\n"
        "import repro_torch.train, repro_torch.checkpoint\n"
        "import repro_torch.runtime, repro_torch.distributed.compression\n"
        "import repro_torch.distributed.collectives\n"
        "import repro_torch.data, repro_torch.launch.train\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'repro')\n"
        "             or m.startswith(('jax.', 'repro.')))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_the_closing_line_is_the_reference_launchers(tmp_path, capsys):
    from repro.launch import train as jlaunch_train
    args = ["--smoke", "--steps", "4", "--save-every", "4"]
    assert jlaunch_train.main(args + ["--ckpt-dir", str(tmp_path / "r")]) == 0
    want = capsys.readouterr().out.strip().splitlines()[-1]
    assert launch_train.main(args + ["--ckpt-dir", str(tmp_path / "p"),
                                     "--device", "cpu"]) == 0
    got = capsys.readouterr().out.strip().splitlines()[-1]
    assert LINE.fullmatch(want) and LINE.fullmatch(got), (want, got)
