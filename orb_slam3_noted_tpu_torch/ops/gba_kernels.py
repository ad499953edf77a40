"""The global BA's reduced camera system on the card: its product in every
PCG iteration, the CG update and the LM step's pose-side sums as
hand-written CUDA kernels (``csrc/gba_schur.cu``), their wrappers and their
plain PyTorch versions.

========================  ==================================  ================================
wrapper                   what it computes                    plain version
========================  ==================================  ================================
:func:`schur_point_pass`  y = Cinv U^T x, a warp per point    :func:`schur_point_pass_plain`
:func:`schur_pose_pass`   U y, a block per keyframe slot      :func:`schur_pose_pass_plain`
:func:`pose_sum`          (O, C) rows summed by slot          :func:`pose_sum_plain`
:func:`pcg_start`         the PCG's first residual, direction :func:`pcg_start_plain`
:func:`pcg_step`          one CG update, in place             :func:`pcg_step_plain`
========================  ==================================  ================================

U is the (K, 6) x (M, 3) pose-point coupling of the normal equations, one
(6, 3) block ``W[o]`` an observation.  :func:`schur_pcg` solves the reduced
camera system with these kernels, three launches an iteration, nothing read
back.  The plain versions are the port's first code for these sums, kept as
it was: sums over keyframe slots are products with the (K, O) float32
one-hot of the observations' slots (:class:`PoseSegments`), sums over
points fixed-order segment sums (``ops/segsum.py``).  Every sum runs in a
fixed order on both paths, so a GBA call repeats bit for bit.

Dispatch is by the tensor's device, as for K1-K4 (``ops/cuda_kernels.py``,
whose library the kernels are built into): a CPU tensor goes to the plain
version, a CUDA tensor launches the kernel or raises.  Each kernel has one
launcher, which the wrapper and :func:`schur_pcg` both call and which
counts every launch in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from orb_slam3_noted_tpu_torch.ops import cuda_kernels as ck
from orb_slam3_noted_tpu_torch.ops.segsum import segment_order, segment_sum
from orb_slam3_noted_tpu_torch.utils.timing import count


class PoseSegments(NamedTuple):
    """The observations' rows grouped by keyframe slot, in the form the
    device sums them in.  On the CPU ``onehot``, the (K, O) float32 one-hot
    of each row's slot, which the plain versions multiply by.  On the card
    ``perm`` (O,) int64, the rows sorted by slot (stable, rows that are not
    valid dealt round-robin over the slots as ``segment_order`` deals them),
    and ``starts`` (K + 1,) int64: slot k's rows are
    ``perm[starts[k]:starts[k + 1]]``."""

    onehot: torch.Tensor | None = None
    perm: torch.Tensor | None = None
    starts: torch.Tensor | None = None


def segment_starts(lengths: torch.Tensor) -> torch.Tensor:
    """(S + 1,) first row of each segment (then the row count) from the (S,)
    rows per segment of ``segment_order``."""
    return torch.cat([lengths.new_zeros(1), torch.cumsum(lengths, 0)])


def pose_order(pose_idx: torch.Tensor, K: int, valid: torch.Tensor) -> PoseSegments:
    """The card's :class:`PoseSegments` of rows with these slots: made once
    a GBA call, as the point order is."""
    perm, lengths = segment_order(pose_idx, K, valid)
    return PoseSegments(perm=perm, starts=segment_starts(lengths))


# ---------------------------------------------------------------------------
# the plain versions

def schur_point_pass_plain(W, Cinv, x, pose_idx, point_idx, pt_order):
    """y (Mb, 3) = Cinv[m] sum over point m's rows of W[o]^T x[pose_idx[o]]."""
    Mb = Cinv.shape[0]
    utx = segment_sum(torch.einsum("oij,oi->oj", W, x[pose_idx]), point_idx, Mb, pt_order)
    return torch.einsum("mij,mj->mi", Cinv, utx)


def schur_pose_pass_plain(W, y, point_idx, onehot):
    """(K, 6) sum over slot k's rows of W[o] y[point_idx[o]]."""
    return onehot @ torch.einsum("oij,oj->oi", W, y[point_idx])


def pose_sum_plain(data, onehot):
    """(K, C) sums of the (O, C) rows by slot."""
    return onehot @ data


def _precond(Pinv, r):
    return torch.einsum("kij,kj->ki", Pinv, r)


def pcg_start_plain(Pinv, b):
    """(x, r, p, rz) before the first iteration: x = 0, r = b, p = Pinv r,
    rz = r.p."""
    x = torch.zeros_like(b)
    r = b
    z = _precond(Pinv, r)
    p = z
    rz = torch.sum(r * z)
    return x, r, p, rz


def pcg_step_plain(x, r, p, rz, Hpp_d, Pinv, uy):
    """One block-Jacobi preconditioned CG iteration on S = Hpp_d - U Cinv
    U^T, whose product with p is ``Hpp_d p - uy``; returns (x, r, p, rz)."""
    Ap = torch.einsum("kij,kj->ki", Hpp_d, p) - uy
    pAp = torch.sum(p * Ap)
    alpha = torch.where(torch.abs(pAp) > 1e-20, rz / pAp, 0.0)
    x = x + alpha * p
    r = r - alpha * Ap
    z = _precond(Pinv, r)
    rz_new = torch.sum(r * z)
    beta = torch.where(torch.abs(rz) > 1e-20, rz_new / rz, 0.0)
    p = z + beta * p
    return x, r, p, rz_new


# ---------------------------------------------------------------------------
# the kernels

@functools.cache
def _library() -> ctypes.CDLL:
    lib = ck._library()
    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.orb_gba_point_pass.argtypes = [p] * 7 + [i, i, q, p]
    lib.orb_gba_pose_pass.argtypes = [p] * 6 + [i, i, q, p]
    lib.orb_gba_pose_sum.argtypes = [p] * 4 + [i, i, q, p]
    lib.orb_gba_pcg_start.argtypes = [p] * 6 + [i, p]
    lib.orb_gba_pcg_step.argtypes = [p] * 8 + [i, p]
    for fn in (lib.orb_gba_point_pass, lib.orb_gba_pose_pass, lib.orb_gba_pose_sum,
               lib.orb_gba_pcg_start, lib.orb_gba_pcg_step):
        fn.restype = ctypes.c_int
    return lib


def _shaped(x: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple, device) -> None:
    """Raise unless ``x`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` (None in ``shape``: any length)."""
    ck._check(x, name, dtype, len(shape), len(shape), device)
    if any(s is not None and s != n for s, n in zip(shape, x.shape)):
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(x.shape)}")


def _check_rows(W, pose_idx, point_idx, name: str):
    """(O, device) of a (O, 6, 3) W and its rows' int64 slot and point ids."""
    dev = W.device
    _shaped(W, f"{name} W", torch.float32, (None, 6, 3), dev)
    O = W.shape[0]
    for t, n in ((pose_idx, "pose_idx"), (point_idx, "point_idx")):
        if t is not None:
            _shaped(t, f"{name} {n}", torch.int64, (O,), dev)
    return O, dev


def _check_order(perm, starts, O: int, dev, name: str) -> int:
    """The segment count of a (perm, starts) row order of O rows."""
    if perm is None or starts is None:
        raise ValueError(f"{name}: the card needs the rows' order (perm, starts)")
    _shaped(perm, f"{name} perm", torch.int64, (O,), dev)
    _shaped(starts, f"{name} starts", torch.int64, (None,), dev)
    if starts.shape[0] < 1:
        raise ValueError(f"{name}: starts needs S + 1 entries")
    return starts.shape[0] - 1


def _call(fn, name: str, *args) -> None:
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


# The launchers: one a kernel, the only place its C entry is called and its
# launch counted.  Outputs come preallocated and nothing is checked; the
# caller has checked the inputs and made the tensors' card current, and
# ``stream`` is that card's current stream.

def _launch_point_pass(W, Cinv, x, pose_idx, perm, starts, y, stream) -> None:
    _call(_library().orb_gba_point_pass, "schur_point_pass", W.data_ptr(), Cinv.data_ptr(),
          x.data_ptr(), pose_idx.data_ptr(), perm.data_ptr(), starts.data_ptr(), y.data_ptr(),
          Cinv.shape[0], x.shape[0], W.shape[0], stream)
    schur_point_pass.launches += 1


def _launch_pose_pass(W, y, point_idx, perm, starts, out, stream) -> None:
    _call(_library().orb_gba_pose_pass, "schur_pose_pass", W.data_ptr(), y.data_ptr(),
          point_idx.data_ptr(), perm.data_ptr(), starts.data_ptr(), out.data_ptr(),
          out.shape[0], y.shape[0], W.shape[0], stream)
    schur_pose_pass.launches += 1


def _launch_pose_sum(data, perm, starts, out, stream) -> None:
    _call(_library().orb_gba_pose_sum, "pose_sum", data.data_ptr(), perm.data_ptr(),
          starts.data_ptr(), out.data_ptr(), out.shape[0], out.shape[1], data.shape[0], stream)
    pose_sum.launches += 1


def _launch_pcg_start(Pinv, b, x, r, p, rz, stream) -> None:
    _call(_library().orb_gba_pcg_start, "pcg_start", Pinv.data_ptr(), b.data_ptr(), x.data_ptr(),
          r.data_ptr(), p.data_ptr(), rz.data_ptr(), b.shape[0], stream)
    pcg_start.launches += 1


def _launch_pcg_step(Hpp_d, Pinv, uy, x, r, p, z, rz, stream) -> None:
    _call(_library().orb_gba_pcg_step, "pcg_step", Hpp_d.data_ptr(), Pinv.data_ptr(),
          uy.data_ptr(), x.data_ptr(), r.data_ptr(), p.data_ptr(), z.data_ptr(), rz.data_ptr(),
          x.shape[0], stream)
    pcg_step.launches += 1


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


# ---------------------------------------------------------------------------
# the wrappers

def schur_point_pass(W, Cinv, x, pose_idx, point_idx, pt_order):
    """y (Mb, 3) = Cinv U^T x: for each point m, ``Cinv[m]`` times the sum
    of ``W[o]^T x[pose_idx[o]]`` over its rows.  ``W`` (O, 6, 3) and ``Cinv``
    (Mb, 3, 3) float32, ``x`` (K, 6), ``pose_idx`` and ``point_idx`` (O,)
    int64, ``pt_order`` the rows' ``segment_order`` by point."""
    if not ck._on_card(W, "schur_point_pass"):
        return schur_point_pass_plain(W, Cinv, x, pose_idx, point_idx, pt_order)
    O, dev = _check_rows(W, pose_idx, point_idx, "schur_point_pass")
    _shaped(Cinv, "schur_point_pass Cinv", torch.float32, (None, 3, 3), dev)
    _shaped(x, "schur_point_pass x", torch.float32, (None, 6), dev)
    perm, lengths = pt_order
    _shaped(lengths, "schur_point_pass lengths", torch.int64, (Cinv.shape[0],), dev)
    starts = segment_starts(lengths)
    _check_order(perm, starts, O, dev, "schur_point_pass")
    y = torch.empty((Cinv.shape[0], 3), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _launch_point_pass(W, Cinv, x, pose_idx, perm, starts, y, _stream(dev))
    return y


schur_point_pass.launches = 0


def schur_pose_pass(W, y, point_idx, seg: PoseSegments):
    """(K, 6) U y: for each keyframe slot the sum of ``W[o] y[point_idx[o]]``
    over its rows; ``y`` (Mb, 3) float32, ``seg`` the rows' slots."""
    if not ck._on_card(W, "schur_pose_pass"):
        return schur_pose_pass_plain(W, y, point_idx, seg.onehot)
    O, dev = _check_rows(W, None, point_idx, "schur_pose_pass")
    _shaped(y, "schur_pose_pass y", torch.float32, (None, 3), dev)
    K = _check_order(seg.perm, seg.starts, O, dev, "schur_pose_pass")
    out = torch.empty((K, 6), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _launch_pose_pass(W, y, point_idx, seg.perm, seg.starts, out, _stream(dev))
    return out


schur_pose_pass.launches = 0


def pose_sum(data, seg: PoseSegments):
    """(K, C) sums by keyframe slot of the (O, C) float32 rows ``data``."""
    if not ck._on_card(data, "pose_sum"):
        return pose_sum_plain(data, seg.onehot)
    dev = data.device
    _shaped(data, "pose_sum data", torch.float32, (None, None), dev)
    O, C = data.shape
    K = _check_order(seg.perm, seg.starts, O, dev, "pose_sum")
    out = torch.empty((K, C), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _launch_pose_sum(data, seg.perm, seg.starts, out, _stream(dev))
    return out


pose_sum.launches = 0


def _start(Pinv, b, stream):
    """(x, r, p, rz), new tensors, after the start kernel."""
    x, r, p = (torch.empty_like(b) for _ in range(3))
    rz = torch.empty((), dtype=torch.float32, device=b.device)
    _launch_pcg_start(Pinv, b, x, r, p, rz, stream)
    return x, r, p, rz


def pcg_start(Pinv, b):
    """:func:`pcg_start_plain` in one launch: (x, r, p, rz), new tensors,
    ``rz`` 0-dimensional."""
    if not ck._on_card(b, "pcg_start"):
        return pcg_start_plain(Pinv, b)
    dev = b.device
    _shaped(b, "pcg_start b", torch.float32, (None, 6), dev)
    _shaped(Pinv, "pcg_start Pinv", torch.float32, (b.shape[0], 6, 6), dev)
    with torch.cuda.device(dev):
        return _start(Pinv, b, _stream(dev))


pcg_start.launches = 0


def pcg_step(x, r, p, rz, Hpp_d, Pinv, uy):
    """:func:`pcg_step_plain` in one launch, updating ``x``, ``r``, ``p``
    and ``rz`` in place on the card; returns them."""
    if not ck._on_card(x, "pcg_step"):
        return pcg_step_plain(x, r, p, rz, Hpp_d, Pinv, uy)
    dev, K = x.device, x.shape[0]
    for t, n in ((x, "x"), (r, "r"), (p, "p"), (uy, "uy")):
        _shaped(t, f"pcg_step {n}", torch.float32, (K, 6), dev)
    for t, n in ((Hpp_d, "Hpp_d"), (Pinv, "Pinv")):
        _shaped(t, f"pcg_step {n}", torch.float32, (K, 6, 6), dev)
    _shaped(rz, "pcg_step rz", torch.float32, (), dev)
    with torch.cuda.device(dev):
        _launch_pcg_step(Hpp_d, Pinv, uy, x, r, p, torch.empty_like(x), rz, _stream(dev))
    return x, r, p, rz


pcg_step.launches = 0


def _same(x):
    return x


def schur_pcg(W, Cinv, Hpp_d, Pinv, b, pose_idx, point_idx, pt_order, seg: PoseSegments,
              n_iters: int, psum=_same):
    """dp (K, 6): ``n_iters`` block-Jacobi preconditioned CG iterations on
    the reduced camera system (Hpp_d - U Cinv U^T) dp = b, U applied row by
    row (``W`` (O, 6, 3), the rows' ``pose_idx`` and local ``point_idx``,
    ``pt_order`` and ``seg`` their point and slot orders).  ``psum`` sums a
    shard's (K, 6) partial U y over the mesh (``Mesh.psum``).  On the card
    one start, then three launches an iteration (point pass, pose pass, CG
    update) through the wrappers' launchers, nothing read back; the inputs
    are checked once.  Counts ``gba_pcg_iters``."""
    count("gba_pcg_iters", n_iters)
    if not ck._on_card(W, "schur_pcg"):
        x, r, p, rz = pcg_start_plain(Pinv, b)
        for _ in range(n_iters):
            y = schur_point_pass_plain(W, Cinv, p, pose_idx, point_idx, pt_order)
            uy = psum(schur_pose_pass_plain(W, y, point_idx, seg.onehot))
            x, r, p, rz = pcg_step_plain(x, r, p, rz, Hpp_d, Pinv, uy)
        return x
    O, dev = _check_rows(W, pose_idx, point_idx, "schur_pcg")
    Cinv, Hpp_d, Pinv, b = (t.contiguous() for t in (Cinv, Hpp_d, Pinv, b))
    _shaped(Cinv, "schur_pcg Cinv", torch.float32, (None, 3, 3), dev)
    _shaped(b, "schur_pcg b", torch.float32, (None, 6), dev)
    K = b.shape[0]
    for t, n in ((Hpp_d, "Hpp_d"), (Pinv, "Pinv")):
        _shaped(t, f"schur_pcg {n}", torch.float32, (K, 6, 6), dev)
    pt_perm, pt_starts = pt_order[0], segment_starts(pt_order[1])
    if _check_order(pt_perm, pt_starts, O, dev, "schur_pcg") != Cinv.shape[0]:
        raise ValueError(f"schur_pcg: point order of {pt_starts.shape[0] - 1} points, Cinv "
                         f"{tuple(Cinv.shape)}")
    if _check_order(seg.perm, seg.starts, O, dev, "schur_pcg") != K:
        raise ValueError(f"schur_pcg: slot order of {seg.starts.shape[0] - 1} slots, K = {K}")
    with torch.cuda.device(dev):  # launches on the stream of the tensors' card
        stream = _stream(dev)
        x, r, p, rz = _start(Pinv, b, stream)
        # every iteration writes the same buffers, in stream order (``psum``
        # over a group returns a new uy)
        z, uy_part = torch.empty_like(x), torch.empty_like(x)
        y = torch.empty((Cinv.shape[0], 3), dtype=torch.float32, device=dev)
        for _ in range(n_iters):
            _launch_point_pass(W, Cinv, p, pose_idx, pt_perm, pt_starts, y, stream)
            _launch_pose_pass(W, y, point_idx, seg.perm, seg.starts, uy_part, stream)
            _launch_pcg_step(Hpp_d, Pinv, psum(uy_part), x, r, p, z, rz, stream)
    return x


KERNELS = (schur_point_pass, schur_pose_pass, pose_sum, pcg_start, pcg_step)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}
