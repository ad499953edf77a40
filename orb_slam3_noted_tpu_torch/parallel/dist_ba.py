"""Distributed bundle adjustment over a mesh of ranks (port of
:mod:`orb_slam3_noted_tpu.parallel.dist_ba`).

A mesh of n devices is n processes in a ``torch.distributed`` group, one
device each (two ranks may share a card over gloo).  Every rank holds the
whole problem, takes its own shard of the observation table and evaluates
only that; pose-side sums are reduced with one ``all_reduce`` and the small
pose system is solved on every rank alike, so all ranks stay in lockstep.

Two collectives exist, both ``all_reduce(SUM)``: :meth:`Mesh.psum`, and
:meth:`Mesh.gather_rows`, the tiled ``all_gather`` of a row block written
into a zeroed buffer (each row has one non-zero contributor, so the sum is
exact).  ``all_reduce`` runs on NCCL, on gloo with CPU tensors and on gloo
with CUDA tensors; gloo has no CUDA ``all_gather``.

:func:`spawn_mesh` starts n ranks (the spawn start method), meets them
through a ``FileStore`` in a temporary directory and returns every rank's
result; a rank that raises, dies or outwaits the group timeout in a
collective makes it raise in the caller with that rank's traceback.
:class:`Group` makes the calling process a group of its own (a one-rank
NCCL group on one card, for instance).

:func:`distributed_bundle_adjust` delegates to the matrix-free
:func:`..optim.gba.distributed_global_ba`.
"""

from __future__ import annotations

import datetime
import multiprocessing.connection as mp_connection
import os
import pickle
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from orb_slam3_noted_tpu_torch.models import cameras as cam_mod
from orb_slam3_noted_tpu_torch.optim import factors

GROUP_TIMEOUT_S = 300.0


class Mesh:
    """The first ``size`` ranks of the process group (``group`` None: the
    calling process alone, whose collectives are the identity), with this
    rank's device.  ``collectives`` counts the reductions made through it."""

    def __init__(self, size: int, rank: int, device, group=None, axis: str = "obs"):
        self.size, self.rank = size, rank
        self.device = torch.device(device)
        self.group = group
        self.axis_names = (axis,)
        self.collectives = 0

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the mesh's ranks (``x`` itself is left as it was)."""
        if self.group is None:
            return x
        y = x.clone(memory_format=torch.contiguous_format)  # NCCL wants dense rows
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=self.group)
        self.collectives += 1
        return y

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """(size * B, ...) concatenation of every rank's (B, ...) block, in
        rank order: this rank's block written into zeros, summed over the mesh."""
        if self.group is None:
            return x
        B = x.shape[0]
        buf = torch.zeros((self.size * B, *x.shape[1:]), dtype=x.dtype, device=x.device)
        buf[self.rank * B:(self.rank + 1) * B] = x
        return self.psum(buf)


def group_size() -> int:
    """Ranks of the initialised default process group; 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(n_devices: int | None = None, axis: str = "obs", device="cuda") -> Mesh:
    """The mesh of the group's first ``n_devices`` ranks (all of them by
    default) on ``device``.  Without an initialised group, the one-rank mesh
    of the calling process.  Inside a group every rank calls it (a smaller
    mesh is a new group); a rank outside the first ``n_devices`` raises."""
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(f"a mesh of {n_devices} ranks needs a process group")
        return Mesh(1, 0, device, axis=axis)
    world, rank = dist.get_world_size(), dist.get_rank()
    n = world if n_devices is None else n_devices
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} ranks in a group of {world}")
    group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    if rank >= n:
        raise ValueError(f"rank {rank} is not among the mesh's first {n} ranks")
    return Mesh(n, rank, device, group, axis)


def rank_device(device, rank: int) -> torch.device:
    """``cuda`` without an index is this rank's own card (rank modulo the
    cards there are: ranks share cards when there are fewer); any other
    device is taken as it is."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", rank % torch.cuda.device_count())
    return device


class Group:
    """``with Group(store_dir, rank, n, backend, device) as mesh``: this
    process joins a group of ``n`` ranks that meet through a ``FileStore``
    under ``store_dir``, and leaves it at the end of the block; ``backend``
    NCCL on CUDA and gloo on the CPU unless named.  A failed initialisation
    raises."""

    def __init__(self, store_dir: str, rank: int, n: int, backend: str | None = None,
                 device="cuda", timeout_s: float = GROUP_TIMEOUT_S):
        self.store_path = os.path.join(store_dir, "store")
        self.rank, self.n = rank, n
        self.device = rank_device(device, rank)
        self.backend = backend or ("nccl" if self.device.type == "cuda" else "gloo")
        self.timeout = datetime.timedelta(seconds=timeout_s)

    def __enter__(self) -> Mesh:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        dist.init_process_group(self.backend, store=dist.FileStore(self.store_path, self.n),
                                rank=self.rank, world_size=self.n, timeout=self.timeout)
        return make_mesh(self.n, device=self.device)

    def __exit__(self, *exc):
        dist.destroy_process_group()
        return False


def to_cpu(x):
    """Tensors anywhere in tuples, lists, dicts and NamedTuples moved to the CPU."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: to_cpu(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_cpu(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(to_cpu(v) for v in x)
    return x


def _rank_main(rank, n, tmp, backend, device, timeout_s, fn, args):
    torch.set_num_threads(1)  # ranks side by side on one host's cores
    with Group(tmp, rank, n, backend, device, timeout_s) as mesh:
        out = to_cpu(fn(mesh, *args))
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


def _join(ctx, grace_s: float = 10.0) -> None:
    """Wait for every rank.  At the first failure give the others
    ``grace_s`` to end (a rank waiting on the failed one in a collective
    fails too), end the rest, and raise the failure that came first: the
    earliest traceback a rank wrote, else the first non-zero exit."""
    procs = ctx.processes
    while (all(p.exitcode in (None, 0) for p in procs)
           and any(p.exitcode is None for p in procs)):
        mp_connection.wait([p.sentinel for p in procs if p.exitcode is None])
    failed = [i for i, p in enumerate(procs) if p.exitcode not in (None, 0)]
    if not failed:
        return
    deadline = time.monotonic() + grace_s
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join()
    wrote = sorted((os.stat(f).st_mtime_ns, i) for i, f in enumerate(ctx.error_files)
                   if os.path.exists(f))
    if wrote:
        i = wrote[0][1]
        with open(ctx.error_files[i], "rb") as fh:
            trace = pickle.load(fh)  # written by this call's own rank
        for _, k in wrote:
            os.remove(ctx.error_files[k])
        raise mp.ProcessRaisedException(
            f"\n\n-- rank {i} of {len(procs)} terminated with the following error:\n{trace}",
            i, procs[i].pid)
    i = failed[0]
    raise mp.ProcessExitedException(f"rank {i} of {len(procs)} exited with code "
                                    f"{procs[i].exitcode}", i, procs[i].pid,
                                    procs[i].exitcode)


def spawn_mesh(n: int, fn, *args, backend: str | None = None, device="cuda",
               timeout_s: float = GROUP_TIMEOUT_S) -> list:
    """Run ``fn(mesh, *args)`` on ``n`` new ranks and return their results
    in rank order, tensors on the CPU.  ``fn`` must be importable by name
    (a module-level function; the ranks start from a fresh interpreter);
    ``args`` are pickled to every rank.  ``device`` as :func:`rank_device`;
    ``backend`` NCCL on CUDA and gloo on the CPU unless named.  A rank's
    exception, a non-zero exit, or a collective that waits longer than
    ``timeout_s`` raises here and ends the other ranks:
    ``torch.multiprocessing.ProcessRaisedException`` with the traceback of
    the rank that failed first, or ``ProcessExitedException``."""
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(_rank_main, args=(n, tmp, backend, device, timeout_s, fn, args),
                                 nprocs=n, join=False, start_method="spawn")
        _join(ctx)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(n)]


# ---------------------------------------------------------------------------
# observation layouts (host index arithmetic, as the JAX package's)

def _obs_like(obs: factors.ReprojObs, place, valid: np.ndarray, point_idx=None):
    dev = obs.valid.device
    return factors.ReprojObs(
        pose_idx=place(obs.pose_idx),
        point_idx=place(obs.point_idx) if point_idx is None
        else torch.from_numpy(point_idx).to(dev),
        uv=place(obs.uv), uv_r=place(obs.uv_r), inv_sigma2=place(obs.inv_sigma2),
        is_stereo=place(obs.is_stereo), valid=torch.from_numpy(valid).to(dev),
        uv2=place(obs.uv2), is_right=place(obs.is_right))


def pad_obs_for_mesh(obs: factors.ReprojObs, n_devices: int) -> factors.ReprojObs:
    """The observation table padded to a multiple of the mesh size with
    zero rows that are not valid."""
    pad = (-obs.pose_idx.shape[0]) % n_devices
    if pad == 0:
        return obs

    def place(x):
        if x is None:
            return None
        return torch.cat([x, torch.zeros((pad, *x.shape[1:]), dtype=x.dtype, device=x.device)])

    valid = np.concatenate([obs.valid.cpu().numpy(), np.zeros(pad, bool)])
    return _obs_like(obs, place, valid)


def _layout(obs: factors.ReprojObs, owner: np.ndarray, n_devices: int):
    """(rows per shard, the destination row of each sorted row, the sort
    order): shard s takes the rows with ``owner == s``, in their order,
    padded to a multiple of 8 rows."""
    O = len(owner)
    counts = np.bincount(owner, minlength=n_devices)
    cap = max(int(counts.max()), 1)
    cap = -(-cap // 8) * 8
    order = np.argsort(owner, kind="stable")
    off = np.concatenate([[0], np.cumsum(counts)])[:-1]
    rank = np.arange(O) - off[owner[order]]
    return cap, owner[order] * cap + rank, order


def _placer(n_rows: int, dest: np.ndarray, order: np.ndarray):
    def place(x):
        if x is None:
            return None
        a = x.cpu().numpy()
        out = np.zeros((n_rows, *a.shape[1:]), a.dtype)
        out[dest] = a[order]
        return torch.from_numpy(out).to(x.device)
    return place


def shard_obs_by_point(obs: factors.ReprojObs, n_devices: int) -> factors.ReprojObs:
    """The observation table laid out so that shard s owns every row of the
    points with ``point_idx % n_devices == s``; a (n * cap,)-row table whose
    leading axis splits evenly into the shards' blocks."""
    pi = obs.point_idx.cpu().numpy()
    cap, dest, order = _layout(obs, pi % n_devices, n_devices)
    valid = np.zeros(n_devices * cap, bool)
    valid[dest] = obs.valid.cpu().numpy()[order]
    return _obs_like(obs, _placer(n_devices * cap, dest, order), valid)


def shard_obs_by_point_block(obs: factors.ReprojObs, n_devices: int,
                             block: int) -> factors.ReprojObs:
    """The observation table laid out so that shard s owns every row of the
    points in the contiguous block [s * block, (s + 1) * block), so that
    each shard keeps only its own block's landmark state
    (``optim.gba._gba_lm_step_ptblock``).  Pad rows carry the point id
    ``s * block`` of their shard, so a local index stays in range."""
    pi = obs.point_idx.cpu().numpy()
    cap, dest, order = _layout(obs, np.clip(pi // block, 0, n_devices - 1), n_devices)
    valid = np.zeros(n_devices * cap, bool)
    valid[dest] = obs.valid.cpu().numpy()[order]
    pid = np.repeat(np.arange(n_devices) * block, cap)
    pid[dest] = pi[order]
    return _obs_like(obs, _placer(n_devices * cap, dest, order), valid, pid.astype(np.int32))


def distributed_bundle_adjust(cam: cam_mod.Camera, mesh: Mesh, Rcw, tcw, points, obs,
                              pose_fixed, point_fixed, n_iters: int = 10, bf: float = 0.0):
    """LM over the mesh; returns (Rcw, tcw, points, cost).  Delegates to
    the matrix-free ``distributed_global_ba``: half the steps Huber, the
    rest plain least squares, 32 PCG iterations each."""
    from orb_slam3_noted_tpu_torch.optim.ba import BAProblem
    from orb_slam3_noted_tpu_torch.optim.gba import distributed_global_ba

    prob = BAProblem(Rcw=Rcw, tcw=tcw, points=points, obs=obs, pose_fixed=pose_fixed,
                     point_fixed=point_fixed)
    n1 = max(n_iters // 2, 1)
    return distributed_global_ba(cam, mesh, prob, bf=bf, n_iters=n1,
                                 n_iters_final=n_iters - n1, cg_iters=32)
