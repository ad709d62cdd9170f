"""State carried across from the JAX package: numpy leaves -> the port.

The reference's `QuantizedDB`, `BitPlanarDB` and `ClusterCodebook` are
pytrees of arrays; a caller turns their leaves into numpy (``np.asarray``)
and hands them here to get the port's objects on a chosen device. This
module imports no JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.bitplanar import BitPlanarDB
from repro_torch.core.clustering import ClusterCodebook
from repro_torch.core.quantization import QuantizedDB


def _tensor(a, dtype: np.dtype, name: str, dev: torch.device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype != dtype:
        raise TypeError(f"{name} must be {np.dtype(dtype).name}, "
                        f"got {arr.dtype}")
    return torch.from_numpy(np.array(arr, order="C", copy=True)).to(dev)


def quantized_db(values, scale, norms_sq, *, device=None) -> QuantizedDB:
    """values (N, D) int8, scale f32 () or (N,), norms_sq (N,) int32."""
    dev = resolve_device(device)
    return QuantizedDB(values=_tensor(values, np.int8, "values", dev),
                       scale=_tensor(scale, np.float32, "scale", dev),
                       norms_sq=_tensor(norms_sq, np.int32, "norms_sq", dev))


def bitplanar_db(msb_plane, lsb_plane, norms_sq, scale, sign_plane=None, *,
                 device=None) -> BitPlanarDB:
    """msb/lsb planes (N, D//2) uint8, norms_sq (N,) int32, scale f32,
    optional sign_plane (N, D//8) uint8."""
    dev = resolve_device(device)
    return BitPlanarDB(
        msb_plane=_tensor(msb_plane, np.uint8, "msb_plane", dev),
        lsb_plane=_tensor(lsb_plane, np.uint8, "lsb_plane", dev),
        norms_sq=_tensor(norms_sq, np.int32, "norms_sq", dev),
        scale=_tensor(scale, np.float32, "scale", dev),
        sign_plane=(None if sign_plane is None else
                    _tensor(sign_plane, np.uint8, "sign_plane", dev)))


def cluster_codebook(codes, msb_plane, norms_sq, *,
                     device=None) -> ClusterCodebook:
    """The reference `ClusterCodebook`'s leaves: codes (K, D) int8,
    msb_plane (K, D//2) uint8, norms_sq (K,) int32. The reference's numpy
    `labels` and `block_table` need no conversion: the cluster entry
    points take them as they are."""
    dev = resolve_device(device)
    return ClusterCodebook(codes=_tensor(codes, np.int8, "codes", dev),
                           msb_plane=_tensor(msb_plane, np.uint8,
                                             "msb_plane", dev),
                           norms_sq=_tensor(norms_sq, np.int32, "norms_sq",
                                            dev))


def query_codes(codes, *, device=None) -> torch.Tensor:
    """(..., D) int8 query codes -> an int8 tensor on `device`."""
    return _tensor(codes, np.int8, "query codes", resolve_device(device))
