"""GAN-augmented training step: the SGG (F), generator (G) and
discriminator (D) updates of one batch.

Counterpart of ``sgg_tpu/train/gan_step.py`` (reference
``main.py:100-200``):

1. **F**: the SGG losses update the relation model (clipped SGD), its
   forward also returning the real map and its RoIAlign pools.
2. **G**: the generator paints fake maps from the (perturbed) scene graph
   (with ``vis_cond``, also from the feature bank's real features of its
   classes); the relation model pools them (K1 on the f32 map, K1-bwd-fmap
   in the backward); adversarial losses against the three Ds (target
   real) and the reconstruction losses (``rec``: the SGG losses on
   predictions from the fake map) update G with Adam, and with ``rec`` the
   relation model again with its clipped SGD (``main.py:152-178``).
3. **D**: BCE real against fake on node patches, edge patches and whole
   maps updates the Ds with Adam (``main.py:181-194``); then one pass with
   the updated Ds writes their spectral-norm vectors.

What JAX expresses with ``stop_gradient`` is ``detach`` here: the SGG
predictions see a detached fake map unless ``attachG``
(``main.py:144-149``), and every D input of the D phase is detached. The D
calls inside the G and D losses run their power iteration from the stored
vectors and write nothing. The relation model's union BatchNorms advance
as in the JAX step: once on the real forward and once on the fake one; the
detached ``rec`` forward normalizes with its batch statistics but leaves
the running ones as it found them. Nothing waits for the device.

Under a data-parallel group (``sgg_torch.parallel``) each optimizer's
gradients are summed over the ranks right after the backward that makes
them, before its norm and clip; every mean over the batch is the rank's
share of the global batch's (``masked_bce``, ``train/losses.py``, the
masked BatchNorms), and the metrics are the global values on every rank.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from sgg_torch.config import Config
from sgg_torch.constants import STRIDE
from sgg_torch.data.graph_batch import GraphBatch
from sgg_torch.device import resolve_device
from sgg_torch.models.gan import GANModel
from sgg_torch.parallel import (GradReducer, all_reduce_metrics,
                                all_reduce_scalars, current,
                                refuse_edge_axis)
from sgg_torch.train.assign import sample_edges
from sgg_torch.train.losses import edge_losses, node_losses
from sgg_torch.train.state import Adam, Optimizer
from sgg_torch.utils import counters

_RUNNING = ("running_mean", "running_var", "num_batches_tracked")


def create_gan_optimizers(config: Config, gan: GANModel
                          ) -> Tuple[Adam, Adam]:
    """Adam for G (``lrG``) and for the Ds (``lrD``), each over its own
    partition (reference ``get_optim_gan``, pytorch_misc.py:98-127)."""
    return (Adam(gan.partition("G"), config.lrG, config.beta1, config.beta2),
            Adam(gan.partition("D"), config.lrD, config.beta1, config.beta2))


def masked_bce(logits: torch.Tensor, target: float,
               mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean BCE-with-logits against a constant 0/1 target over the valid
    slots (reference loss_fn, gan.py:162-171), in optax's form. Under a
    data-parallel group, the rank's share of the global batch's mean: its
    sum over the global count."""
    per = -target * F.logsigmoid(logits) - (1.0 - target) * F.logsigmoid(
        -logits)
    if mask is None:
        group = current()
        # every rank holds as many rows
        return per.mean() if group is None else per.mean() / group.world
    m = mask.to(per.dtype).reshape(*per.shape[:-1], 1)
    return (per * m).sum() / torch.clamp(all_reduce_scalars(m.sum())[0],
                                         min=1.0)


@contextlib.contextmanager
def running_stats_kept(module: torch.nn.Module):
    """Train-mode forwards inside leave ``module``'s BatchNorm running
    statistics as they were (the JAX step drops that forward's
    mutation)."""
    saved = [(b, b.clone()) for n, b in module.named_buffers()
             if n.endswith(_RUNNING)]
    try:
        yield
    finally:
        with torch.no_grad():
            for b, v in saved:
                b.copy_(v)


@contextlib.contextmanager
def no_grad_for(params):
    """``params`` take no gradient inside (the Ds' weights in the G phase:
    the JAX step's optimizer drops those gradients)."""
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


def make_gan_train_step(model, gan: GANModel, config: Config,
                        optimizer: Optimizer, g_opt: Adam, d_opt: Adam):
    """Returns ``gan_step(batch, fake_classes, generator, edges=None,
    mark=None, vis_features=None) -> metrics`` on ``config.device``.

    ``fake_classes`` (B, N): the (perturbed) object classes that G paints
    (the batch's own when not perturbing). ``vis_features`` (B, N, p, p,
    n_ch): the feature bank's samples of those classes, which a
    ``vis_cond`` G reads in both of its generate calls. ``generator``
    draws the sampled edges, then dropout; the two fake forwards draw the
    same dropout masks, as the JAX step gives both one key. ``edges``, a
    ``(sampled, mask)`` pair, replaces the sampler, as in
    ``train/step.py``. ``mark``, if given, is called with "F", "G" and "D"
    as each phase has been issued (a caller may record CUDA events there
    to time the phases). ``model``, ``gan`` and the three optimizers are
    updated in place. A call is a ``step`` span with the thread's CPU time
    (``utils/counters.py``), split at the same points into ``step.F``,
    ``step.G`` and ``step.D``.

    The metrics are device scalars with the JAX step's keys: ``obj_loss``,
    ``rel_loss``, ``grad_norm``; with ``G`` ``G_obj``, ``G_rel``,
    ``G_fmap``; with ``rec`` ``obj_loss_rec``, ``rel_loss_rec``;
    ``grad_norm_G`` (G's partition) when either runs; with ``D``
    ``D_obj``, ``D_rel``, ``D_fmap``, ``grad_norm_D``; and ``total``, the
    sum of the losses."""
    dev = resolve_device(config.device)
    loss_weights = (config.alpha, config.beta, config.gamma)
    use_D = "D" in config.ganlosses
    use_G = "G" in config.ganlosses
    use_rec = "rec" in config.ganlosses
    ganw = config.ganw
    d_params = [p for _, p in gan.partition("D")]
    reduce_f, reduce_g, reduce_d = (GradReducer(o.params)
                                    for o in (optimizer, g_opt, d_opt))

    def sgg_losses(out, classes, rel_labels, batch, pair_mask, sfx=""):
        losses = node_losses(out["obj_logits"], classes, batch.node_mask,
                             sfx=sfx)
        losses.update(edge_losses(out["rel_logits"], rel_labels, pair_mask,
                                  config.loss, loss_weights, sfx=sfx))
        return losses

    def gan_step(batch: GraphBatch, fake_classes,
                 generator: Optional[torch.Generator],
                 edges: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 mark=None, vis_features=None) -> Dict[str, torch.Tensor]:
        with counters.span("step", cpu=True):
            return issue(batch, fake_classes, generator, edges,
                         mark or (lambda phase: None), vis_features)

    def issue(batch, fake_classes, generator, edges, mark, vis_features):
        refuse_edge_axis("the GAN step")
        with counters.span("step.F"):
            batch = batch.to(dev)
            fake = torch.as_tensor(fake_classes).to(dev, torch.long)
            vis = None if vis_features is None else torch.as_tensor(
                vis_features).to(dev)
            model.train()
            gan.train()
            if edges is None:
                edges = sample_edges(
                    generator, batch.rels, batch.rel_mask, batch.node_mask,
                    max_out=min(batch.max_edges, config.rels_per_img))
            sampled, pair_mask = edges[0].to(dev, torch.long), edges[1].to(dev)
            pairs, rel_labels = sampled[..., :2], sampled[..., 2]
            metrics: Dict[str, torch.Tensor] = {}

            def relate(classes, fmap, **kw):
                return model(None if fmap is not None else batch.images,
                             batch.boxes, classes, pairs, pair_mask, fmap=fmap,
                             im_hw=batch.im_hw, generator=generator, **kw)

            # ---- F: the SGG update ---------------------------------------
            optimizer.zero_grad()
            real = relate(batch.classes, batch.fmaps, return_feats=True)
            losses = sgg_losses(real, batch.classes, rel_labels, batch,
                                pair_mask)
            sum(losses.values()).backward()
            reduce_f()
            metrics.update({k: v.detach() for k, v in losses.items()})
            metrics["grad_norm"] = optimizer.apply_gradients()
            real_nodes = real["node_pool"].detach()
            real_edges = real["edge_pool"].detach()
            real_fmap = real["fmap"].detach()
            del real
        mark("F")

        with counters.span("step.G"):
            # the layout's frame: the padded canvas (or, from cached maps,
            # their extent times the stride), as the JAX step
            # (gan_step.py:137-152); divided by a tensor, not a Python number
            canvas = (max(batch.images.shape[1], batch.images.shape[2])
                      if batch.images is not None
                      else max(batch.fmaps.shape[1], batch.fmaps.shape[2])
                      * STRIDE)
            boxes01 = batch.boxes / torch.full((), float(canvas), device=dev)
            gen = (fake, boxes01, batch.rels, batch.node_mask, batch.rel_mask,
                   vis)

            # ---- G: adversarial and reconstruction losses ----------------
            if use_G or use_rec:
                g_opt.zero_grad()
                optimizer.zero_grad()
                with no_grad_for(d_params):
                    fmaps_fake = gan.generate(*gen)
                    drop_state = None if generator is None \
                        else generator.get_state()
                    out_fake = relate(fake, fmaps_fake, return_feats=True)
                    nodes_fake = out_fake["node_pool"]
                    edges_fake = out_fake["edge_pool"]
                    g_losses = {}
                    if use_G:
                        g_losses["G_obj"] = ganw * masked_bce(
                            gan.disc_nodes(nodes_fake, fake), 1.0,
                            batch.node_mask)
                        g_losses["G_rel"] = ganw * masked_bce(
                            gan.disc_edges(edges_fake, rel_labels), 1.0,
                            pair_mask)
                        g_losses["G_fmap"] = ganw * masked_bce(
                            gan.disc_global(fmaps_fake), 1.0, None)
                    if use_rec:
                        out_rec = out_fake
                        if not config.attachG:
                            if drop_state is not None:
                                generator.set_state(drop_state)
                            with running_stats_kept(model):
                                out_rec = relate(fake, fmaps_fake.detach())
                        g_losses.update(sgg_losses(out_rec, fake, rel_labels,
                                                   batch, pair_mask, "_rec"))
                    sum(g_losses.values()).backward()
                reduce_g()
                if use_rec:
                    reduce_f()
                metrics["grad_norm_G"] = g_opt.apply_gradients()
                if use_rec:
                    # reconstruction updates the SGG model too
                    # (main.py:173-176)
                    optimizer.apply_gradients()
                metrics.update({k: v.detach() for k, v in g_losses.items()})
                fmaps_fake = fmaps_fake.detach()
                nodes_fake = nodes_fake.detach()
                edges_fake = edges_fake.detach()
                del out_fake, g_losses
            else:
                with torch.no_grad():
                    fmaps_fake = gan.generate(*gen)
                    out_fake = relate(fake, fmaps_fake, return_feats=True)
                nodes_fake, edges_fake = out_fake["node_pool"], \
                    out_fake["edge_pool"]
                del out_fake
        mark("G")

        with counters.span("step.D"):
            # ---- D: real against fake ------------------------------------
            if use_D:
                d_opt.zero_grad()
                d_losses = {
                    # nodes: the real ones under their GT classes, the fake
                    # ones under the perturbed (main.py:185-187)
                    "D_obj": ganw * (
                        masked_bce(gan.disc_nodes(real_nodes, batch.classes),
                                   1.0, batch.node_mask)
                        + masked_bce(gan.disc_nodes(nodes_fake, fake), 0.0,
                                     batch.node_mask)),
                    "D_rel": ganw * (
                        masked_bce(gan.disc_edges(real_edges, rel_labels), 1.0,
                                   pair_mask)
                        + masked_bce(gan.disc_edges(edges_fake, rel_labels),
                                     0.0, pair_mask)),
                    "D_fmap": ganw * (
                        masked_bce(gan.disc_global(real_fmap), 1.0, None)
                        + masked_bce(gan.disc_global(fmaps_fake), 0.0, None))}
                sum(d_losses.values()).backward()
                reduce_d()
                metrics.update({k: v.detach() for k, v in d_losses.items()})
                metrics["grad_norm_D"] = d_opt.apply_gradients()
                gan.update_disc_stats(real_nodes, batch.classes, real_edges,
                                      rel_labels, real_fmap)
        mark("D")
        metrics = all_reduce_metrics(metrics, [
            k for k in metrics if not k.startswith("grad_norm")])
        metrics["total"] = sum(v for k, v in metrics.items()
                               if not k.startswith("grad_norm"))
        return metrics

    return gan_step
