"""NamedTuple state <-> dicts of numpy arrays keyed by field name.

The port's state tuples (``MapArrays``, ``FrameFeatures``, ``PoseObs``)
keep the JAX package's field names and shapes, so a dict from
``jax.device_get(x)._asdict()`` converts field by field.  Descriptors are
uint32 in the JAX package and int32 tensors here holding the same bits
(``>>`` is not implemented for ``torch.uint32``); they cross as
``ndarray.view``.  Floats become float32, other integers int32.

``pull`` is the other direction at run time: one device-to-host copy of
whatever the host must read after a dispatch (the facade's and the loop
closer's read-backs).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from orb_slam3_noted_tpu_torch.utils.timing import device_read


@functools.lru_cache(maxsize=256)
def const_tensor(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A small constant table (a tuple of numbers, or of tuples of them) as
    a tensor on ``device``, copied there once and shared by every later
    call: read it, never write it.  Keeps per-frame code free of
    host-to-device copies for values that never change."""
    return torch.tensor(values, dtype=dtype, device=device)


def set_scalar(t: torch.Tensor, idx, value) -> None:
    """``t[idx] = value`` in place for a Python number or bool.  Plain item
    assignment wraps the value in a CPU tensor and copies that to a CUDA
    ``t``, one host-to-device copy an assignment; this fills a scalar on
    ``t``'s device instead."""
    t[idx] = torch.full((), value, dtype=t.dtype, device=t.device)


def to_numpy(t, uint32_fields=()) -> dict:
    """NamedTuple of tensors -> {field: ndarray}; ``uint32_fields`` are
    returned as uint32 views of their int32 bits.  None fields are skipped."""
    out = {}
    for name, v in zip(t._fields, t):
        if v is None:
            continue
        a = v.detach().cpu().numpy()
        out[name] = a.view(np.uint32) if name in uint32_fields else a
    return out


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype.kind == "f":
        a = a.astype(np.float32)
    elif a.dtype.kind in "iu":
        a = a.astype(np.int32)
    return torch.tensor(a, device=device)  # a copy: never aliases the caller's buffer


def from_numpy(cls, d: dict, device=None):
    """{field: array} -> ``cls`` of tensors on ``device``; fields absent from
    ``d`` (or None) are left None, which only optional fields may be."""
    return cls(**{
        name: None if d.get(name) is None else _tensor(d[name], device)
        for name in cls._fields
    })


def pull(*xs: torch.Tensor) -> list:
    """One device-to-host copy of several tensors: flattened to float32
    (every value that passes here is a float32 or an integer below 2^24),
    copied at once, and split back into numpy arrays of their shapes and
    kinds (bool, int64 or float32).  The copy is a ``device_read`` span."""
    flat = torch.cat([x.reshape(-1).to(torch.float32) for x in xs])
    with device_read():
        flat = flat.cpu().numpy()
    out, o = [], 0
    for x in xs:
        a = flat[o:o + x.numel()].reshape(x.shape)
        o += x.numel()
        if x.dtype == torch.bool:
            a = a != 0
        elif not x.is_floating_point():
            a = a.astype(np.int64)
        out.append(a)
    return out
