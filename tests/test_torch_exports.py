"""The port's public surface against the reference's, read from source.

Every public name of a `src/repro/**/__init__.py` (by `ast`: what it
imports, defines or assigns) must be a public name of the port's
counterpart package, or a submodule of it, except the deliberate
differences listed in RENAMED and ABSENT. And no module of `repro_torch`
(its examples included) imports `jax` or `repro`.
"""
import ast
import importlib
import pathlib

import pytest

pytest.importorskip("torch")

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"

# The Pallas kernels' entry points map to the port's CUDA wrappers, named
# without the suffix.
RENAMED = {
    ("kernels", "stage1_int4_pallas"): "stage1_int4_single",
    ("kernels", "stage1_int4_gather_pallas"): "stage1_int4_gather",
    ("kernels", "stage2_int8_pallas"): "stage2_int8_single",
    ("kernels", "fused_topk_pallas"): "fused_topk_single",
}
# Names with no counterpart: the sampler's jit cache has no eager
# equivalent (ROADMAP C18).
ABSENT = {("serve", "jitted_fns")}

REFERENCE_INITS = sorted(SRC.glob("repro/**/__init__.py"))


def _public_names(path: pathlib.Path) -> set[str]:
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
        elif isinstance(node, ast.Import):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
    return {n for n in names if not n.startswith("_")
            and n != "annotations"}


def test_every_reference_package_is_read():
    packages = {p.parent.relative_to(SRC / "repro").as_posix()
                for p in REFERENCE_INITS}
    assert {"core", "kernels", "serve", "tenancy", "train"} <= packages


@pytest.mark.parametrize("init", REFERENCE_INITS,
                         ids=lambda p: p.parent.relative_to(SRC).as_posix())
def test_port_exports_every_public_name_of_the_reference(init):
    sub = init.parent.relative_to(SRC / "repro").parts
    port = importlib.import_module(".".join(("repro_torch", *sub)))
    key = "/".join(sub)
    missing = []
    for name in sorted(_public_names(init)):
        if (key, name) in ABSENT:
            assert not hasattr(port, name), f"{name} is no longer absent"
            continue
        ported = RENAMED.get((key, name), name)
        if hasattr(port, ported):
            continue
        try:
            importlib.import_module(f"{port.__name__}.{ported}")
        except ModuleNotFoundError:
            missing.append(name)
    assert not missing, f"{port.__name__} lacks {missing}"


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_port_module_imports_jax_or_the_reference():
    files = sorted((SRC / "repro_torch").rglob("*.py"))
    assert any(f.parent.name == "examples" for f in files)
    bad = {f.relative_to(SRC).as_posix(): sorted(r & {"jax", "repro"})
           for f in files if _imported_roots(f) & {"jax", "repro"}}
    assert not bad, bad
