"""What the example tests (tests/test_torch_examples_*.py) share: the
reference's example loaded from its path, logs with wall times masked,
and the port's example run through its `main` with CUDA reported absent,
the result of its work function recorded."""
import importlib.util
import os
import re

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def reference(name):
    """The reference example `examples/<name>.py` as a fresh module."""
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}", os.path.join(ROOT, "examples",
                                                  f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def lines(text):
    """The log's lines with wall times masked."""
    return [re.sub(r"\d+\.\d+s\b", "<t>s", line)
            for line in text.strip().splitlines()]


def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def run_main(monkeypatch, module, argv, **patches):
    """`module.main(argv)` with CUDA reported absent and each of `patches`
    set on the module (e.g. the parameters `main` draws); returns what
    `module.run` returned."""
    no_cuda(monkeypatch)
    for name, value in patches.items():
        monkeypatch.setattr(module, name, value)
    out, run = [], module.run

    def recorded(*args, **kw):
        out.append(run(*args, **kw))
        return out[-1]
    monkeypatch.setattr(module, "run", recorded)
    assert module.main(argv) == 0
    assert len(out) == 1
    return out[0]
