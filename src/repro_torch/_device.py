"""Device selection and host-to-device copies shared by the port."""
from __future__ import annotations

import contextlib

import numpy as np
import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another. Raises when CUDA is asked for (explicitly or by default) and
    no CUDA device exists — the port never falls back to the CPU silently.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch path on the CPU")
    return dev


def visible_devices(device: str | torch.device | None = None
                    ) -> list[torch.device]:
    """The devices shard slots are dealt over, as the reference deals them
    over `jax.devices()`: every visible CUDA device when `device` names
    CUDA without an index (the default), else `device` alone. Raises as
    `resolve_device` does."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def current(dev: torch.device):
    """A context in which `dev` is the current device (the counterpart of
    `jax.default_device`): launches on a CUDA device go to that card's own
    current stream. Nothing to switch for the CPU."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A copy of a host array on `device`. To a CUDA device the copy goes
    through page-locked memory and is queued on the current stream, so
    the host does not wait for the card (a copy from pageable memory
    synchronizes); the host array is copied once, into the page-locked
    buffer."""
    arr = np.asarray(arr)
    if device.type != "cuda":
        return torch.from_numpy(np.array(arr, copy=True)).to(device)
    staged = torch.empty(arr.shape, pin_memory=True,
                         dtype=torch.from_numpy(np.empty(0, arr.dtype)).dtype)
    staged.numpy()[...] = arr
    return staged.to(device, non_blocking=True)
