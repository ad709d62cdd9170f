"""Build, load and launch the hand-written CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface and is compiled by `nvcc`
for sm_90a into its own shared library under the package's own `build/`
directory, named by a hash of the source, the shared headers
(`csrc/*.cuh`) and the flags, so a changed source rebuilds and an
unchanged one is reused. Libraries are loaded with
ctypes (pointers and the stream as ``c_void_p``). `build` starts one
`nvcc` per missing library, all at once, and waits for them.

A failed build or launch raises; nothing falls back to another path.
`LAUNCHES` counts, per kernel, the launches that went through `launch`.
A wrapper given meta tensors (the dry run's shapes-only step) builds and
launches nothing: it returns its empty output through `abstract`, which
tells the observers in `ABSTRACT` and leaves `LAUNCHES` as it is, or
raises where nothing observes.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable

import torch

_SRC = Path(__file__).resolve().parents[1] / "csrc"
_BUILD = Path(__file__).resolve().parents[1] / "build"
SOURCES = ("stage1_int4", "stage1_int4_tall", "stage1_rows", "stage1_mma",
           "stage1_gather", "stage2_int8", "stage0_sign", "stage0_sign_mma",
           "stage0_sign_gather", "fused_topk", "stage2_rerank")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES: dict[str, int] = {"stage1_plane": 0, "stage1_rows": 0,
                            "stage2_exact": 0, "stage1_gather": 0,
                            "stage0_sign_gather": 0, "stage1_single": 0,
                            "stage2_single": 0, "stage0_sign_plane": 0,
                            "fused_topk": 0, "fused_topk_single": 0,
                            "stage1_plane_mma": 0, "stage2_by_id": 0,
                            "fused_topk_mma": 0, "stage1_gather_dp4a": 0,
                            "stage0_sign_plane_mma": 0,
                            "stage1_gather_resident": 0,
                            "stage0_sign_gather_resident": 0,
                            "stage2_rerank_by_id": 0, "stage2_rerank": 0}

# Callables told the counter name of every launch asked for on meta.
ABSTRACT: list[Callable[[str], None]] = []

_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[str, Callable[..., int]] = {}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    src = (_SRC / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(_SRC.glob("*.cuh")))
    digest = hashlib.sha256(src + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return _BUILD / f"{name}-{digest[:16]}.so"


def build(names: tuple[str, ...] = SOURCES) -> dict[str, tuple[str, float]]:
    """Compile every named source whose library is missing, one `nvcc`
    process each, all started together. Returns, per compiled source, the
    compiler's output (register and shared-memory use per kernel) and the
    seconds its `nvcc` ran."""
    _BUILD.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        log = out.with_name(f"{out.stem}.{os.getpid()}.log")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SRC / f"{name}.cu")]
        with open(log, "w") as f:
            proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT)
        jobs.append((name, out, tmp, log, proc, time.perf_counter()))
    seconds = {}
    while len(seconds) < len(jobs):
        for name, _, _, _, proc, t0 in jobs:
            if name not in seconds and proc.poll() is not None:
                seconds[name] = time.perf_counter() - t0
        if len(seconds) < len(jobs):
            time.sleep(0.05)
    results = {}
    failed = []
    for name, out, tmp, log, proc, _ in jobs:
        text = log.read_text()
        log.unlink()
        results[name] = (text, seconds[name])
        if proc.returncode:
            failed.append(f"nvcc failed for {name}.cu:\n{text}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return results


def function(name: str, symbol: str, argtypes: list) -> Callable[..., int]:
    """The C launch function `symbol` of library `name`, built on first
    use, with its argument types declared and an int (cudaError_t)
    result."""
    key = f"{name}:{symbol}"
    fn = _fns.get(key)
    if fn is None:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return fn


def launch(counter: str, fn: Callable[..., int], *args,
           device: torch.device) -> None:
    """Call a C launch function on `device`'s current stream and count
    the launch; raises if the launch was refused. The device is made
    current only when it is not already (CUDA is initialised: the caller
    holds a tensor on it)."""
    index = device.index
    current = torch._C._cuda_getDevice()
    if index is None or index == current:
        err = fn(*args, torch._C._cuda_getCurrentRawStream(current))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"kernel {counter} failed to launch: CUDA error "
                           f"{err}")
    LAUNCHES[counter] += 1


def abstract(counter: str, shape: tuple[int, ...]) -> torch.Tensor:
    """A launch asked for on meta tensors: nothing is built or run; each
    observer in `ABSTRACT` hears `counter`. Returns an empty int32 meta
    tensor of `shape`. Raises where nothing observes (no kernel on meta
    outside the dry run)."""
    if not ABSTRACT:
        raise ValueError("no kernel for tensors on meta")
    for observe in ABSTRACT:
        observe(counter)
    return torch.empty(shape, dtype=torch.int32, device="meta")
