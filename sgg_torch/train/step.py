"""Training and evaluation steps (``sgg_tpu/train/step.py``).

Counterpart of the reference's training inner loop
(reference ``main.py:100-122`` ``train_batch``) and of the eval
branch of ``rel_model_stanford.py:183-207``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from sgg_torch.config import Config
from sgg_torch.data.graph_batch import GraphBatch
from sgg_torch.device import resolve_device
from sgg_torch.parallel.mesh import (GradReducer, all_reduce_metrics,
                                     edge_slots)
from sgg_torch.train.assign import all_pairs, compact_pairs, sample_edges
from sgg_torch.train.losses import edge_losses, node_losses
from sgg_torch.train.state import Optimizer
from sgg_torch.utils import counters


def make_train_step(model, config: Config, optimizer: Optimizer):
    """Returns ``train_step(batch, generator, edges=None) -> metrics``.

    One step on ``config.device``: sample edges, forward in train mode
    (from the batch's cached trunk maps when it carries them)
    (dropout from ``generator``, BatchNorm statistics updated), node and
    edge losses, total, backward, clip, SGD. ``model`` and ``optimizer``
    are updated in place. ``generator`` lives on that device; the sampler
    draws from it first, then dropout.

    The per-image relation budget is ``min(padded edge bucket,
    rels_per_img)``, as in the JAX step. ``edges``, a ``(sampled, mask)``
    pair as ``sample_edges`` returns, replaces the sampler, so that two
    devices or two packages can be held against each other on the same
    edges.

    The metrics (``obj_loss``, ``rel_loss``, ``total``, ``grad_norm``) are
    device scalars: the step does not wait for the device. With W&B logging
    (``config.wandb``) they also hold ``grad/<module>``, the gradient norm
    of each top-level module (the flax top-level parameter keys; a frozen
    module's is 0), before clipping: the JAX step's counterpart of the
    reference's ``wandb.watch(model, log='all')`` (main.py:93-97). A call
    is a ``step`` span with the thread's CPU time (``utils/counters.py``).

    Under a data-parallel group (``sgg_torch.parallel``) the batch is the
    rank's rows of the global batch: the losses are the rank's shares of
    the global ones, the gradients are summed over the ranks right after
    the backward (before the norms and the clip, which read global
    gradients, as the JAX step's), and the metrics are the global values
    on every rank. On a (data x edge) mesh (``parallel.make_mesh_2d``,
    the batch from ``shard_batch_edges``) the step samples (or takes, as
    ``edges``) all ``E`` edges of its images, then keeps its edge
    coordinate's ``E / edge`` slots of them and runs the model on those.
    """
    dev = resolve_device(config.device)
    loss_weights = (config.alpha, config.beta, config.gamma)
    reduce_grads = GradReducer(optimizer.params)
    modules = {}
    if config.wandb is not None:
        for name, p in model.named_parameters():
            modules.setdefault(name.split(".")[0], []).append(p)

    def train_step(batch: GraphBatch, generator: Optional[torch.Generator],
                   edges: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                   ) -> Dict[str, torch.Tensor]:
        with counters.span("step", cpu=True):
            batch = batch.to(dev)
            model.train()
            if edges is None:
                edges = sample_edges(
                    generator, batch.rels, batch.rel_mask, batch.node_mask,
                    max_out=min(batch.max_edges, config.rels_per_img))
            sampled, pair_mask = edges[0].to(dev, torch.long), edges[1].to(dev)
            mine = edge_slots(sampled.shape[1])
            sampled, pair_mask = sampled[:, mine], pair_mask[:, mine]
            pairs, rel_labels = sampled[..., :2], sampled[..., 2]
            optimizer.zero_grad()
            out = model(batch.images, batch.boxes, batch.classes, pairs,
                        pair_mask, fmap=batch.fmaps, im_hw=batch.im_hw,
                        generator=generator)
            losses = {}
            losses.update(node_losses(out["obj_logits"], batch.classes,
                                      batch.node_mask))
            losses.update(edge_losses(out["rel_logits"], rel_labels, pair_mask,
                                      config.loss, loss_weights))
            total = sum(losses.values())
            total.backward()
            # under a group: the ranks' gradients summed, before any norm
            reduce_grads()
            metrics = {k: v.detach() for k, v in losses.items()}
            metrics["total"] = total.detach()
            metrics = all_reduce_metrics(metrics, list(metrics))
            for mod, params in modules.items():  # before the clip
                metrics[f"grad/{mod}"] = module_grad_norm(params)
            metrics["grad_norm"] = optimizer.apply_gradients()
            return metrics

    return train_step


@torch.no_grad()
def module_grad_norm(params) -> torch.Tensor:
    """The global norm of ``params``' gradients (``optax.global_norm``; a
    parameter without one counts 0), a float32 device scalar."""
    sq = [p.grad.float().square().sum() for p in params if p.grad is not None]
    if not sq:
        return torch.zeros((), device=params[0].device)
    return torch.stack(sq).sum().sqrt()


def make_eval_step(model, mode: str = None, max_pairs: int = None,
                   dedup: bool = True, device="cuda"):
    """Returns ``eval_step(batch) -> outputs`` for a host or device batch.

    Enumerates all ordered pairs (reference rel_model_base.py:148-163) and
    runs the forward in eval mode (``model.eval()``) on ``device`` (the
    card unless the caller asks for the CPU). ``mode`` overrides the
    model's regime (reference lib/eval.py:56 ``set_mode``). ``max_pairs``
    compacts the candidates to that budget, order-preserving (exact iff
    every image has <= max_pairs valid pairs, which ``val_epoch``
    guarantees). ``dedup`` enables the unordered-union dedup; the output's
    ``dedup_ok`` lets the caller check and fall back.
    """
    dev = resolve_device(device)

    @torch.inference_mode()
    def eval_step(batch: GraphBatch) -> Dict[str, torch.Tensor]:
        batch = batch.to(dev)
        model.eval()
        pairs, pair_mask = all_pairs(batch.node_mask)
        if max_pairs is not None and max_pairs < pairs.shape[1]:
            pairs, pair_mask, _ = compact_pairs(pairs, pair_mask, max_pairs)
        out = model(batch.images, batch.boxes, batch.classes, pairs,
                    pair_mask, fmap=batch.fmaps, im_hw=batch.im_hw,
                    mode=mode, dedup_unions=dedup)
        out["pairs"] = pairs
        out["pair_mask"] = pair_mask
        out["rel_dists"] = torch.softmax(out["rel_logits"], dim=-1)
        return out

    return eval_step
