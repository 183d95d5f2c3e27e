"""Data-parallel placement and the device collectives of a step.

Counterpart of what ``sgg_tpu/parallel/mesh.py``'s ``make_mesh``,
``replicate`` and ``shard_batch`` give the JAX package: there the batch is
one global array sharded over a 1-D mesh and XLA inserts the reductions;
here each rank holds its contiguous rows of the global batch
(``shard_rows``; the loader's ``shard=`` loads only those) and a replica of
the state (``replicate``), and the port reduces explicitly where the
global batch enters the arithmetic:

* ``GradReducer``: one flat SUM of a parameter group's gradients after
  each ``backward`` (each rank's loss is its share of the global
  loss: its local sums over the global counts, ``train/losses.py``);
* ``all_reduce``: a differentiable SUM (the BatchNorms' batch moments);
* ``all_reduce_scalars``: a SUM without gradient (the losses' counts, the
  logged losses);
* ``global_rand``: a draw at the global batch's shape from the
  same-seeded generator, of which the rank keeps its rows, so that every
  rank draws what the run of one process draws for those rows.

Every function is the identity (or the plain draw) with no active group.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from sgg_torch.parallel.distributed import Group, current, host_all_reduce


def _dist():
    import torch.distributed as dist
    return dist


def replicate(module: torch.nn.Module, group: Optional[Group],
              check: bool = False) -> torch.nn.Module:
    """Broadcast ``module``'s parameters and buffers from rank 0 of
    ``group`` (none: nothing), in place. With ``check``, raise unless every
    rank then holds the same bits (a second broadcast, compared byte by
    byte, agreed over the host group)."""
    if group is None or group.group is None:
        return module
    dist = _dist()
    tensors = list(module.parameters()) + list(module.buffers())
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src=0, group=group.group)
    if check:
        differ = sum(not bits_equal_to_rank0(t, group) for t in tensors)
        bad = int(host_all_reduce([float(differ)], group=group)[0])
        if bad:
            raise RuntimeError(f"replicate: {bad} tensor(s) differ from "
                               f"rank 0's bits after the broadcast")
    return module


def bits_equal_to_rank0(t: torch.Tensor, group: Group) -> bool:
    """Whether this rank's ``t`` has rank 0's bits (a collective: every rank
    calls it with the same shapes)."""
    mine = t.detach().reshape(-1).contiguous()
    ref = mine.clone()
    _dist().broadcast(ref, src=0, group=group.group)
    return torch.equal(ref.view(torch.uint8), mine.view(torch.uint8))


class GradReducer:
    """SUMs the gradients of a fixed list of parameters over the active
    group's ranks after a backward: one flat all-reduce a dtype, through a
    buffer allocated at the first call under a group and kept by this
    object (a step keeps one for each optimizer's parameters). A parameter
    without a gradient takes a zero one first, as the optimizers give it,
    so every rank reduces the same layout. Nothing without a group."""

    def __init__(self, params: Iterable[torch.Tensor]):
        self.params = list(params)
        self._flat: Optional[List[Tuple[torch.Tensor, List[int]]]] = None

    @torch.no_grad()
    def __call__(self) -> None:
        group = current()
        if group is None or group.group is None:
            return
        if self._flat is None:
            self._flat = []
            for dtype in {p.dtype for p in self.params}:
                idx = [i for i, p in enumerate(self.params)
                       if p.dtype == dtype]
                n = sum(self.params[i].numel() for i in idx)
                self._flat.append((torch.empty(
                    n, dtype=dtype, device=self.params[idx[0]].device), idx))
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        for buf, idx in self._flat:
            grads = [self.params[i].grad.reshape(-1) for i in idx]
            torch.cat(grads, out=buf)
            _dist().all_reduce(buf, group=group.group)
            off = 0
            for g in grads:
                g.copy_(buf[off:off + g.numel()])
                off += g.numel()


class AllReduce(torch.autograd.Function):
    """SUM over the ranks forward; SUM of the gradient over the ranks
    backward (each rank's loss is its share of the global loss, so the
    global loss's gradient w.r.t. the reduced value is the sum of the
    ranks')."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        out = x.clone()
        _dist().all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        out = grad.clone()
        _dist().all_reduce(out, group=ctx.group)
        return out, None


def all_reduce(x: torch.Tensor, group: Optional[Group] = None
               ) -> torch.Tensor:
    """Differentiable SUM of ``x`` over the ranks (``x`` itself without a
    group)."""
    group = group or current()
    if group is None or group.group is None:
        return x
    return AllReduce.apply(x, group.group)


def all_reduce_scalars(*counts: torch.Tensor, group: Optional[Group] = None
                       ) -> Tuple[torch.Tensor, ...]:
    """The SUM over the ranks of each float scalar, in one all-reduce and
    without gradient (the scalars themselves without a group)."""
    group = group or current()
    if group is None or group.group is None:
        return counts
    flat = torch.stack([c.detach().float() for c in counts])
    _dist().all_reduce(flat, group=group.group)
    return tuple(flat.unbind())


def all_reduce_metrics(metrics: Dict[str, torch.Tensor],
                       keys: Sequence[str]) -> Dict[str, torch.Tensor]:
    """``metrics`` with the values of ``keys`` (each rank's share of a loss)
    summed over the ranks in one all-reduce: every rank then logs, and
    checks, the global value."""
    if current() is None or not keys:
        return metrics
    return {**metrics, **dict(zip(keys, all_reduce_scalars(
        *(metrics[k] for k in keys))))}


def global_rand(shape: Sequence[int], generator: Optional[torch.Generator],
                device) -> torch.Tensor:
    """``torch.rand(shape)`` as the rank's part of a draw at the global
    shape: the same numbers the run of one process draws for this part,
    the generator advanced as there.

    The leading axis is the batch's: the draw has ``world`` times the rows
    and the rank keeps its own."""
    group = current()
    if group is None or group.world == 1:
        return torch.rand(tuple(shape), generator=generator, device=device)
    full = list(shape)
    full[0] *= group.world
    out = torch.rand(full, generator=generator, device=device)
    return out.narrow(0, group.rank * shape[0], shape[0])


def shard_rows(batch, rank: int, world: int):
    """The rank's contiguous ``B / world`` rows of a host-replicated batch
    (a dataclass of arrays and tensors with a leading batch axis, such as
    ``GraphBatch``), or of one array."""
    if dataclasses.is_dataclass(batch):
        return dataclasses.replace(batch, **{
            f.name: shard_rows(getattr(batch, f.name), rank, world)
            for f in dataclasses.fields(batch)
            if getattr(batch, f.name) is not None})
    b = batch.shape[0]
    if b % world:
        raise ValueError(f"a batch of {b} does not split over {world} ranks")
    per = b // world
    return batch[rank * per:(rank + 1) * per]
