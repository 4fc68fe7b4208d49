"""Process groups, multi-node initialisation and a local launcher.

Counterpart of ``ffvd_tpu/parallel/distributed.py``.  The JAX package
wires ``jax.distributed`` for multi-host pods and builds a hybrid mesh whose
'ep' axis stays within a host; one JAX process drives all of a host's
devices.  PyTorch runs one process per device, so here:

- ``initialize_multihost`` reads torchrun's variables (``MASTER_ADDR``,
  ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``) where JAX reads
  ``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID``,
  starts the process group and sets the rank's device;
- ``multihost_mesh`` keeps 'ep' within a node (``LOCAL_WORLD_SIZE``
  processes) and lets 'dp' span the nodes, with JAX's rule and errors;
- ``spawn_local`` starts ``world_size`` processes on this machine, the
  counterpart of the single-process mesh JAX builds from one host's
  devices; the tests and ``chip_smoke.py`` run their ranks through it;
- ``all_sum``, ``diff_sum`` and ``gather_blocks`` are the only collectives
  the port issues.  Each is an all-reduce, which both NCCL and gloo take on
  CUDA tensors (gloo's CUDA support covers broadcast and all-reduce): a
  gather is an all-reduce into a zero-filled buffer, exact because every
  slot has one non-zero contribution.

Every process group is created with a timeout, and ``spawn_local`` joins
its processes with a deadline, so a rank that raises fails the caller
instead of leaving the others waiting in a collective.
"""

from __future__ import annotations

import datetime
import os
import shutil
import sys
import tempfile
import time
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from ffvd_tpu_torch.utils.profiling import span

# Seconds a collective may wait for the other ranks before it raises.
GROUP_TIMEOUT = 300.0


def _backend_for(device: torch.device, backend: Optional[str]) -> str:
    return backend or ("nccl" if device.type == "cuda" else "gloo")


def initialize_multihost(init_method: Optional[str] = None,
                         world_size: Optional[int] = None,
                         rank: Optional[int] = None,
                         backend: Optional[str] = None, device=None,
                         timeout: float = GROUP_TIMEOUT) -> bool:
    """Start this process's group if a launcher configured one.

    Arguments default to torchrun's variables: ``init_method`` "env://"
    when ``MASTER_ADDR`` is set, ``WORLD_SIZE``, ``RANK``; the rank's device
    is ``cuda:LOCAL_RANK`` unless ``device`` says otherwise ("cpu" runs the
    ranks on the host).  The backend is NCCL on CUDA and gloo on the CPU
    unless ``backend`` names one.  Returns True when the group started,
    False when nothing is configured (one process), so callers can call it
    first thing in ``main()``."""
    if init_method is None:
        if "MASTER_ADDR" not in os.environ:
            return False
        init_method = "env://"
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None:
        rank = int(os.environ["RANK"])
    local = int(os.environ.get("LOCAL_RANK", "0"))
    dev = torch.device(device if device is not None else f"cuda:{local}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    _init_group(_backend_for(dev, backend), dev, init_method, world_size,
                rank, timeout)
    return True


def _init_group(backend, dev, init_method, world_size, rank, timeout):
    """``init_process_group`` with a timeout; NCCL is told the rank's card
    (else it guesses it from the rank)."""
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout),
        **({"device_id": dev} if backend == "nccl" else {}))


def _default_ep(n_avail: int, x_dim: int) -> int:
    """The largest power of two ≤ min(n_avail, x_dim) that divides
    n_avail (``ffvd_tpu/parallel/distributed.py:74-79``)."""
    e = 1
    while e * 2 <= min(n_avail, x_dim) and n_avail % (e * 2) == 0:
        e *= 2
    return e


def mesh_device_type() -> str:
    """The device type of this process's meshes: "cuda" under NCCL; gloo
    groups are built as "cpu" meshes and take CUDA tensors all the same."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def multihost_mesh(dp: Optional[int] = None, ep: Optional[int] = None,
                   x_dim: int = 4):
    """A ('dp', 'ep') mesh laid out for the nodes: 'ep' within a node's
    ``LOCAL_WORLD_SIZE`` processes (its collectives run every gradient
    evaluation), 'dp' across nodes (independent chains or datasets).  One
    node: ``sharding.make_mesh``'s shapes, with JAX's errors."""
    from torch.distributed.device_mesh import init_device_mesh

    from ffvd_tpu_torch.parallel.sharding import make_mesh
    n = dist.get_world_size()
    n_local = int(os.environ.get("LOCAL_WORLD_SIZE", n))
    n_proc = n // n_local
    if n_proc == 1:
        if dp is not None:
            if ep is None:
                if n % dp != 0:
                    raise ValueError(f"dp={dp} does not divide the "
                                     f"{n}-device platform")
                ep = _default_ep(n // dp, x_dim)
            return make_mesh(dp * ep, ep=ep, x_dim=x_dim)
        return make_mesh(None, ep=ep, x_dim=x_dim)
    if ep is None:
        ep = _default_ep(n_local, x_dim)
    if n_local % ep != 0:
        raise ValueError(f"ep={ep} must divide the {n_local} local devices "
                         "(ep stays within a node)")
    dp_local = n_local // ep
    if dp is None:
        dp = n_proc * dp_local
    if dp != n_proc * dp_local:
        raise ValueError(
            f"dp={dp} inconsistent with {n_proc} processes x {n_local} "
            f"local devices / ep={ep} (need dp = {n_proc * dp_local}); "
            "this builder always uses every device")
    # Ranks run node by node, so rows of ep consecutive ranks stay in a node.
    return init_device_mesh(mesh_device_type(), (dp, ep),
                            mesh_dim_names=("dp", "ep"))


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

def _trivial(group) -> bool:
    return group is None or dist.get_world_size(group) == 1


# The profiler's label of every collective the port issues (its host time:
# the whole all-reduce under gloo, the enqueue under NCCL).
COLLECTIVE_LABEL = "ffvd::all_sum"


def all_sum(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group``, in place (no autograd)."""
    if not _trivial(group):
        with span(COLLECTIVE_LABEL):
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


class _DiffSum(torch.autograd.Function):
    """All-reduce (sum) whose backward all-reduces the cotangents."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_sum(t.clone(memory_format=torch.contiguous_format), group)

    @staticmethod
    def backward(ctx, g):
        return all_sum(g.clone(memory_format=torch.contiguous_format),
                       ctx.group), None


def diff_sum(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group``, differentiable: the backward sums the
    cotangents of every rank, so every rank must run its backward too."""
    if _trivial(group):
        return t
    return _DiffSum.apply(t, group)


def all_sum_flat(tensors: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """Several tensors summed over ``group`` in one all-reduce."""
    if _trivial(group) or not tensors:
        return list(tensors)
    flat = all_sum(torch.cat([t.reshape(-1) for t in tensors]), group)
    return [f.view_as(t) for f, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


def gather_blocks(items, start: int, whole: int, group) -> List[torch.Tensor]:
    """Every rank's block of each (tensor, dim) of ``items`` in one tensor
    of size ``whole`` along dim: this rank's block at [start, start + len)
    of a zero buffer, all summed over ``group`` in one all-reduce."""
    if _trivial(group):
        return [t for t, _ in items]
    bufs = []
    for t, dim in items:
        shape = list(t.shape)
        shape[dim] = whole
        buf = t.new_zeros(shape)
        buf.narrow(dim, start, t.shape[dim]).copy_(t.detach())
        bufs.append(buf)
    return all_sum_flat(bufs, group)


# ---------------------------------------------------------------------------
# A local launcher
# ---------------------------------------------------------------------------

def rank_device(device: str, rank: int) -> torch.device:
    """The device of ``rank``: "cuda" spreads the ranks over the cards
    (rank r on card r mod count), "cuda:i" puts every rank on card i (gloo
    only: NCCL refuses two ranks on one card), "cpu" runs on the host."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def _rank_main(rank, fn, world_size, backend, device, init_file, out_dir,
               args):
    torch.set_num_threads(1)        # ranks share the host's cores
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    _init_group(_backend_for(dev, backend), dev, f"file://{init_file}",
                world_size, rank, GROUP_TIMEOUT)
    out = fn(dev, *args)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier()
    t0 = time.perf_counter()
    dist.destroy_process_group()
    # On stderr: where a rank's teardown waits, the others' lines show it.
    print(f"rank {rank}: destroy_process_group returned in "
          f"{time.perf_counter() - t0:.2f} s", file=sys.stderr, flush=True)


def spawn_local(fn: Callable, world_size: int, backend: Optional[str] = None,
                device: str = "cuda", args: tuple = (),
                timeout: float = 600.0, tmpdir: Optional[str] = None) -> list:
    """Run ``fn(device, *args)`` in ``world_size`` new processes of this
    machine, each with its process group started (``backend``: NCCL on
    CUDA, gloo on the CPU, unless named) over a ``file://`` store in a
    fresh directory under ``tmpdir``, its device set (``rank_device``) and
    one intra-op thread.  ``fn`` must be importable by name (a
    spawned process imports it anew), and its return value is saved with
    ``torch.save``.  Returns the ranks' return values, in rank order.

    Raises the first rank's exception (``torch.multiprocessing``'s
    ``ProcessRaisedException``; the other ranks are terminated) or, past
    ``timeout`` seconds, ``TimeoutError`` after killing every rank."""
    import torch.multiprocessing as mp
    work = tempfile.mkdtemp(prefix="ffvd_spawn_", dir=tmpdir)
    try:
        ctx = mp.start_processes(
            _rank_main, nprocs=world_size, join=False, start_method="spawn",
            args=(fn, world_size, backend, device,
                  os.path.join(work, "store"), work, tuple(args)))
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world_size} ranks of {fn.__name__} "
                                       f"still running after {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(timeout=10)
        return [torch.load(os.path.join(work, f"rank{r}.pt"),
                           weights_only=False) for r in range(world_size)]
    finally:
        shutil.rmtree(work, ignore_errors=True)
