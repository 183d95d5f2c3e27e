"""Multi-process data parallelism: the process group, its host-side
traffic, and the launcher the tests and the smoke run use.

Counterpart of ``sgg_tpu/parallel/distributed.py``. The JAX package joins
the processes with ``jax.distributed.initialize`` and lets XLA insert the
collectives into its jitted step; here each rank is one process that owns
one card (``torchrun --nproc_per_node N``) and the port's code calls the
collectives itself (``parallel/mesh.py``). A run has one ``Group``:

* ``group``: the device collectives (gradients, loss counts, BatchNorm
  moments), NCCL when every rank has a card of its own, gloo when ranks
  share a card (NCCL refuses two ranks on one device) or run on the CPU;
* ``host``: a gloo group on CPU tensors for what lives on the host anyway
  (eval outputs, metric scalars, agreement flags, barriers): gloo does not
  take every collective on CUDA tensors.

The code that reads the group (the losses, the synced BatchNorms, the
global-shape draws, the steps, the trainer and ``val_epoch``) reads the
active one, ``current()``: ``initialize`` activates the group it makes,
and ``using(group)`` activates one (or none) for a block. With no active
group every one of them is what it was for one process.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import pickle
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch

DEFAULT_TIMEOUT_S = 600


@dataclasses.dataclass
class Group:
    """One rank's view of the data-parallel job. ``group`` and ``host`` are
    ``torch.distributed`` process groups; both None in a stand-in that only
    places rows (the global-shape draws need no collective)."""

    rank: int
    world: int
    device: torch.device
    group: Any = None
    host: Any = None
    backend: str = "gloo"
    timeout_s: float = DEFAULT_TIMEOUT_S


_ACTIVE: List[Optional[Group]] = [None]


def current() -> Optional[Group]:
    """The active group, or None for a run of one process."""
    return _ACTIVE[0]


@contextlib.contextmanager
def using(group: Optional[Group]):
    """Activate ``group`` (None: none) inside the block."""
    prev = _ACTIVE[0]
    _ACTIVE[0] = group
    try:
        yield group
    finally:
        _ACTIVE[0] = prev


def rank() -> int:
    g = current()
    return 0 if g is None else g.rank


def world_size() -> int:
    g = current()
    return 1 if g is None else g.world


def local_device(device: str = "cuda") -> torch.device:
    """``cuda:LOCAL_RANK`` (``torchrun``'s), or the CPU when asked for."""
    if torch.device(device).type == "cpu":
        return torch.device("cpu")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    if local >= torch.cuda.device_count():
        raise RuntimeError(f"LOCAL_RANK {local} has no card of its own "
                           f"({torch.cuda.device_count()} visible); launch "
                           f"at most one rank a card")
    return torch.device("cuda", local)


def launched() -> bool:
    """True under a launcher's environment with more than one process
    (``torchrun`` sets ``RANK`` and ``WORLD_SIZE``)."""
    return "RANK" in os.environ and int(os.environ.get("WORLD_SIZE",
                                                       "1")) > 1


def init_group(init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               device=None, backend: Optional[str] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> Group:
    """Join the job and activate its group, whatever its size (a group of
    one runs every collective: ``chip_smoke.py`` holds it against no group).

    The arguments default to ``torchrun``'s environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT`` through ``env://``);
    ``device`` to ``local_device()``. ``backend`` defaults to NCCL when the
    ranks on this host have a card each, else gloo. A failure to connect
    raises; a default group that already exists is taken as it is when its
    rank and size are these."""
    import torch.distributed as dist
    world = int(world_size if world_size is not None
                else os.environ.get("WORLD_SIZE", "1"))
    rk = int(rank if rank is not None else os.environ.get("RANK", "0"))
    dev = torch.device(device) if device is not None else local_device()
    if backend is None:
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
        own_card = (dev.type == "cuda" and dev.index is not None
                    and torch.cuda.device_count() >= local_world)
        backend = "nccl" if own_card else "gloo"
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"NCCL needs a card, not {dev}")
    timeout = datetime.timedelta(seconds=timeout_s)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        if (dist.get_rank(), dist.get_world_size()) != (rk, world):
            raise RuntimeError(
                f"a process group of rank {dist.get_rank()} of "
                f"{dist.get_world_size()} exists; asked for {rk} of {world}")
        backend = dist.get_backend()
        print(f"[parallel] process group exists ({backend}); joining it")
    else:
        dist.init_process_group(backend, init_method=init_method or "env://",
                                world_size=world, rank=rk, timeout=timeout)
    host = (dist.group.WORLD if backend == "gloo"
            else dist.new_group(backend="gloo", timeout=timeout))
    group = Group(rk, world, dev, dist.group.WORLD, host, backend,
                  timeout_s)
    _ACTIVE[0] = group
    return group


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               device=None, backend: Optional[str] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> Optional[Group]:
    """``init_group`` for a job of more than one process; None (and
    nothing done) for one, as the JAX package's ``initialize``."""
    world = int(world_size if world_size is not None
                else os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return None
    return init_group(init_method, world, rank, device, backend, timeout_s)


def shutdown() -> None:
    """Leave the job (deactivates the group)."""
    import torch.distributed as dist
    _ACTIVE[0] = None
    if dist.is_initialized():
        dist.destroy_process_group()


def sync_processes(name: str, timeout_s: Optional[float] = None) -> None:
    """Barrier on the host group (replaces the JAX package's
    coordination-service barrier); a rank that does not arrive within
    ``timeout_s`` fails every rank waiting, naming ``name``. No-op without
    a group."""
    g = current()
    if g is None or g.host is None:
        return
    import torch.distributed as dist
    t = datetime.timedelta(seconds=timeout_s or g.timeout_s)
    try:
        dist.monitored_barrier(group=g.host, timeout=t)
    except RuntimeError as e:
        raise RuntimeError(f"rank {g.rank}: barrier '{name}' failed: {e}") \
            from e


def process_local_indices(n: int, batch_size: int) -> np.ndarray:
    """The rank's contiguous slice of each global batch of ``batch_size``
    (indices wrap modulo ``n`` for a dataset smaller than the batch).
    ``batch_size`` must divide by the ranks."""
    world, rk = world_size(), rank()
    if batch_size % world:
        raise ValueError(f"batch_size {batch_size} is not divisible by "
                         f"{world} processes")
    per = batch_size // world
    return np.arange(rk * per, (rk + 1) * per) % max(n, 1)


def host_all_reduce(values: Sequence[float], op: str = "sum",
                    group: Optional[Group] = None) -> np.ndarray:
    """``values`` reduced (``sum`` or ``min``) over the ranks of ``group``
    (default: the active one), float64, on its host group."""
    t = torch.tensor(np.asarray(values, np.float64))
    g = group or current()
    if g is not None and g.host is not None:
        import torch.distributed as dist
        dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM,
                               "min": dist.ReduceOp.MIN}[op], group=g.host)
    return t.numpy()


def host_mean(value: float) -> float:
    """The mean of a scalar over the ranks."""
    return float(host_all_reduce([value])[0] / world_size())


def all_agree(flag: bool) -> bool:
    """True when ``flag`` holds on every rank (so that every rank takes the
    same branch before a collective)."""
    return bool(host_all_reduce([float(bool(flag))], "min")[0])


def gather_rows(arrays: dict) -> dict:
    """Each host array of ``arrays`` concatenated over the ranks along its
    first axis, in rank order (every rank holds the same shapes)."""
    g = current()
    if g is None or g.host is None:
        return arrays
    import torch.distributed as dist
    out = {}
    for k, a in arrays.items():
        t = torch.from_numpy(np.ascontiguousarray(a))
        parts = [torch.empty_like(t) for _ in range(g.world)]
        dist.all_gather(parts, t, group=g.host)
        out[k] = torch.cat(parts).numpy()
    return out


# ---------------------------------------------------------------------------
# the launcher of the tests and of chip_smoke.py: ranks in processes of
# their own on one host, joined through a file store (no port, no network)

def _child(rk: int, world: int, store: str, device: str, backend,
           timeout_s: float, fn: Callable, args: tuple, out: str) -> None:
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)  # the ranks share the host's cores
    # the ranks are on one host: gloo's pairs meet on the loopback
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    try:
        group = init_group(f"file://{store}", world, rk, device, backend,
                           timeout_s)
        result = fn(group, *args)
        with open(f"{out}.{rk}", "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        traceback.print_exc()
        raise
    finally:
        shutdown()


def spawn(fn: Callable, world: int, args: tuple = (), *, device="cpu",
          backend: Optional[str] = None, timeout_s: float = 120.0,
          collective_timeout_s: float = 60.0) -> list:
    """``fn(group, *args)`` in ``world`` processes (``spawn``, never
    ``fork``), each a rank of a group on ``device`` joined through a file
    store in a temporary directory; returns each rank's (picklable) result.

    Every rank is joined within ``timeout_s`` of the start. A rank that
    exits with an error or runs out of time makes this raise, after the
    others are killed; nothing is run again on fewer ranks."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="sgg_ranks_")
    store, out = os.path.join(tmp, "store"), os.path.join(tmp, "result")
    procs = [ctx.Process(target=_child, args=(
        rk, world, store, str(device), backend, collective_timeout_s, fn,
        args, out), daemon=False) for rk in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    failed = None
    try:
        pending = list(enumerate(procs))
        while pending and failed is None:
            for i, (rk, p) in enumerate(pending):
                p.join(timeout=0.05)
                if p.exitcode is not None:
                    pending.pop(i)
                    if p.exitcode != 0:
                        failed = f"rank {rk} exited with code {p.exitcode}"
                    break
            if pending and time.monotonic() > deadline:
                failed = (f"rank(s) {[rk for rk, _ in pending]} did not end "
                          f"within {timeout_s} s")
        if failed is not None:
            raise RuntimeError(f"spawned group of {world}: {failed}")
        results = []
        for rk in range(world):
            with open(f"{out}.{rk}", "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        for name in os.listdir(tmp):
            os.remove(os.path.join(tmp, name))
        os.rmdir(tmp)
