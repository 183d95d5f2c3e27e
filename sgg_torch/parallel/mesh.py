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

The edge-axis sharding (``sgg_tpu/parallel/mesh.py``'s ``make_mesh_2d`` and
``shard_batch_edges``, the context-parallel analogue for large graphs): the
ranks form a (data x edge) mesh. A rank holds the rows of its data
coordinate; the edge ranks of one data coordinate hold the same images,
run the trunk, the node pooling and the node head in full, and take each
a contiguous ``E / edge`` of every image's sampled edges
(``edge_slots``) for the union pooling, the union features, the edge
head and the incidence sums of message passing, whose partial sums
``edge_all_reduce`` closes over the edge group (the sum GSPMD inserts into
the JAX package's incidence einsums). The losses, the BatchNorm moments
and the gradients still reduce over the world.
"""

from __future__ import annotations

import dataclasses
import datetime
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
    so every rank reduces the same layout. Nothing without a group. The
    sum runs over the world on a (data x edge) mesh too: every rank's loss
    is its share of the global loss, whichever axis it splits."""

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
                device, edge_axis: Optional[int] = None) -> torch.Tensor:
    """``torch.rand(shape)`` as the rank's part of a draw at the global
    shape: the same numbers the run of one process draws for this part,
    the generator advanced as there.

    The leading axis is the batch's: the draw has ``data`` times the rows
    and the rank keeps those of its data coordinate, the same on every
    edge rank of it (a draw over nodes). ``edge_axis`` names the axis of a
    draw over the rank's edge slots: it has ``edge`` times the slots and
    the rank keeps those of its edge coordinate."""
    group = current()
    if group is None or group.world == 1:
        return torch.rand(tuple(shape), generator=generator, device=device)
    full = list(shape)
    full[0] *= group.data
    if edge_axis is not None:
        full[edge_axis] *= group.edge
    out = torch.rand(full, generator=generator, device=device)
    out = out.narrow(0, group.data_rank * shape[0], shape[0])
    if edge_axis is not None:
        n = shape[edge_axis]
        out = out.narrow(edge_axis, group.edge_rank * n, n)
    return out


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


# ---------------------------------------------------------------------------
# the (data x edge) mesh

def make_mesh_2d(data: int, edge: int, group: Optional[Group] = None
                 ) -> Group:
    """The (data x edge) mesh over ``group`` (default: the active one),
    whose ``world`` must be ``data * edge``: rank r at ``(r // edge, r %
    edge)``, the order of ``np.arange(world).reshape(data, edge)`` (JAX's
    ``devices.reshape(data, edge)``). Returns the group with its edge
    group (the ``edge`` ranks of this rank's data coordinate, which hold
    the same images) and its data group (the ``data`` ranks of its edge
    coordinate); activate it with ``parallel.using``.

    Every rank calls ``torch.distributed.new_group`` for every sub-group,
    in the same order (the API's rule: a rank that skips one hangs the
    job), on the world group's backend (NCCL when each rank has a card of
    its own, gloo when ranks share one), each under the group's timeout.
    """
    group = group or current()
    if group is None or group.group is None:
        raise ValueError("make_mesh_2d needs a joined group "
                         "(parallel.init_group)")
    if data < 1 or edge < 1 or data * edge != group.world:
        raise ValueError(f"a {data} x {edge} mesh does not cover "
                         f"{group.world} ranks")
    dist = _dist()
    timeout = datetime.timedelta(seconds=group.timeout_s)
    rows = ([[d * edge + k for k in range(edge)] for d in range(data)]
            + [[d * edge + k for d in range(data)] for k in range(edge)])
    subs = [dist.new_group(r, backend=group.backend, timeout=timeout)
            for r in rows]
    d, k = divmod(group.rank, edge)
    return dataclasses.replace(group, edge=edge, edge_group=subs[d],
                               data_group=subs[data + k])


def shard_batch_edges(batch, mesh: Group):
    """The rank's part of a host-replicated ``GraphBatch`` on the mesh: the
    rows of its data coordinate (``shard_rows`` over the data axis), the GT
    ``rels`` and ``rel_mask`` whole, since the sampler needs all of an
    image's relations to choose FG and BG (JAX's GSPMD gathers the same
    for its sharded sampler). The train step takes the rank's edge slots
    of the sampled pairs (``edge_slots``, by the mesh's edge coordinate).
    An edge axis that does not divide the batch's ``E`` raises."""
    if batch.max_edges % mesh.edge:
        raise ValueError(f"{batch.max_edges} edges do not split over an edge "
                         f"axis of {mesh.edge}")
    return shard_rows(batch, mesh.data_rank, mesh.data)


def edge_slots(n_edges: int) -> slice:
    """The active mesh's rank's contiguous ``n_edges / edge`` edge slots
    (all of them off an edge axis); an edge axis that does not divide
    ``n_edges`` raises."""
    group = current()
    if group is None or group.edge == 1:
        return slice(None)
    if n_edges % group.edge:
        raise ValueError(f"{n_edges} sampled edges do not split over an "
                         f"edge axis of {group.edge}")
    per = n_edges // group.edge
    return slice(group.edge_rank * per, (group.edge_rank + 1) * per)


def edge_all_reduce(x: torch.Tensor) -> torch.Tensor:
    """Differentiable SUM of ``x`` over the active mesh's edge group: a sum
    over the edges that each edge rank took a part of (``x`` itself off a
    mesh of ``make_mesh_2d``)."""
    group = current()
    if group is None or group.edge_group is None:
        return x
    return AllReduce.apply(x, group.edge_group)


def refuse_edge_axis(what: str, group: Optional[Group] = None) -> None:
    """Raise a ``ValueError`` naming ``what`` on a mesh whose edge axis is
    larger than 1 (``group``, default: the active one)."""
    group = group or current()
    if group is not None and group.edge > 1:
        raise ValueError(f"{what} does not run on an edge axis (a "
                         f"{group.data} x {group.edge} mesh); the 2-D mesh "
                         f"trains through train/step.py::make_train_step")
