"""GAN for compositional augmentation (ICCV 2021) over padded batches.

Counterpart of ``sgg_tpu/models/gan/gan.py`` (reference
``augment/gan.py``): the generator embeds object and predicate classes
(200-d), runs a ``GraphTripleConvNet`` over ``[embedding, box]`` node
inputs, reshapes its node outputs to spatial (hidden / 2) x 7 x 7 features,
convolves ("spatializes") them, projects them, paints them into a layout
(``boxes_to_layout``) and refines the layout into a fake feature map with a
CRN. Three spectrally normalized discriminators judge node patches, edge
patches and whole maps.

The per-image "dummy node" that the reference appends (``gan.py:262-289``)
is a static extra node slot ``N`` with two-way edges to every node, masked
by node validity. The parameters are partitioned by name prefix, ``G`` and
``D_`` (reference ``pytorch_misc.py:100-114``), for the two optimizers.
With ``vis_cond`` the generator also takes real per-class features from
the feature bank (``augment/feature_bank.py``) ahead of its projection.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from sgg_torch.models.gan.crn import RefinementModule, RefinementNetwork
from sgg_torch.models.gan.discriminators import (CondPatchDiscriminator,
                                                 GlobalDiscriminator, SNConv,
                                                 conditioned_features)
from sgg_torch.models.gan.graphconv import GraphTripleConvNet, TripleMLP
from sgg_torch.models.gan.layout import boxes_to_layout


def add_dummy_nodes(classes, boxes01, rels, node_mask, rel_mask):
    """Append the per-image background "dummy node" and its two-way edges.

    Reference ``dummy_nodes`` (gan.py:262-289): one class-0 node with box
    [0, 0, 1, 1] an image, joined to every object both ways with predicate
    0. Here the dummy is slot ``N``; its 2N edges are masked by node
    validity. Returns (classes (B, N+1), boxes01 (B, N+1, 4), edges (B,
    E+2N, 3), node_mask (B, N+1), edge_mask (B, E+2N))."""
    B, N = classes.shape
    dev = classes.device
    classes_d = torch.cat([classes, classes.new_zeros((B, 1))], dim=1)
    # [0, 0, 1, 1] from fills (a Python number written into a slice of a
    # card tensor is copied from the host)
    dummy_box = torch.cat([boxes01.new_zeros((B, 1, 2)),
                           boxes01.new_ones((B, 1, 2))], dim=-1)
    boxes_d = torch.cat([boxes01, dummy_box], dim=1)
    node_mask_d = torch.cat(
        [node_mask, torch.ones((B, 1), dtype=torch.bool, device=dev)], dim=1)
    idx = torch.arange(N, dtype=rels.dtype, device=dev)
    dummy = torch.full((N,), N, dtype=rels.dtype, device=dev)
    zeros = torch.zeros((N,), dtype=rels.dtype, device=dev)
    # (i -> dummy) then (dummy -> i), as gan.py:277-279
    extra = torch.cat([torch.stack([idx, dummy, zeros], dim=1),
                       torch.stack([dummy, idx, zeros], dim=1)], dim=0)
    edges = torch.cat([rels, extra[None].expand(B, 2 * N, 3)], dim=1)
    edge_mask = torch.cat([rel_mask, node_mask, node_mask], dim=1)
    return classes_d, boxes_d, edges, node_mask_d, edge_mask


class Generator(nn.Module):
    """Scene graph -> fake global feature map (reference GAN.forward,
    gan.py:174-208). ``init_embed_objs``/``init_embed_rels``: optional
    (num_classes, embed_dim) / (num_predicates, embed_dim) tables to start
    the embeddings from (reference ``-init_embed``, gan.py:146-159).
    ``vis_cond``: the projection also reads ``n_ch`` channels of real
    features a node (reference ``-vis_cond``, gan.py:192-199)."""

    def __init__(self, num_classes: int, num_predicates: int,
                 embed_dim: int = 200, hidden_dim: int = 64,
                 n_ch: int = 512, pool_sz: int = 7, fmap_sz: int = 37,
                 n_layers: int = 5, batch_norm: bool = True,
                 vis_cond: bool = False,
                 init_embed_objs: Optional[np.ndarray] = None,
                 init_embed_rels: Optional[np.ndarray] = None):
        super().__init__()
        self.hidden_dim, self.pool_sz = hidden_dim, pool_sz
        self.vis_cond = vis_cond
        self.fmap_sz = fmap_sz
        self.init_embed = (init_embed_objs, init_embed_rels)
        self.obj_embed = nn.Embedding(num_classes, embed_dim)
        self.rel_embed = nn.Embedding(num_predicates, embed_dim)
        self.gcn = GraphTripleConvNet(
            embed_dim + 4, embed_dim, hidden_dim // 2 * pool_sz * pool_sz,
            num_layers=n_layers, hidden_dim=hidden_dim, pooling="avg",
            batch_norm=batch_norm)
        self.node_conv0 = nn.Conv2d(hidden_dim // 2, hidden_dim, 3,
                                    padding=1)
        self.node_conv1 = nn.Conv2d(hidden_dim, hidden_dim, 3, padding=1)
        self.proj = nn.Conv2d(hidden_dim + (n_ch if vis_cond else 0),
                              hidden_dim, 1)
        self.refine = RefinementNetwork(
            (hidden_dim, n_ch // 4, n_ch // 2, n_ch))

    def forward(self, classes, boxes01, rels, node_mask, rel_mask,
                vis_features: Optional[torch.Tensor] = None) -> torch.Tensor:
        """classes (B, N), boxes01 (B, N, 4) in [0, 1], rels (B, E, 3),
        masks, and with ``vis_cond`` ``vis_features`` (B, N, p, p, n_ch)
        -> (B, fmap_sz, fmap_sz, n_ch) float32, contiguous."""
        if self.vis_cond and vis_features is None:
            raise ValueError("a vis_cond generator needs vis_features")
        B, N = classes.shape
        p, h = self.pool_sz, self.hidden_dim
        classes_d, boxes_d, edges, node_mask_d, edge_mask = add_dummy_nodes(
            classes, boxes01.float(), rels, node_mask, rel_mask)
        obj_vecs = self.obj_embed(classes_d.long())
        pred_vecs = self.rel_embed(edges[..., 2].long())
        node_in = torch.cat([obj_vecs, boxes_d], dim=-1)
        nodes, _ = self.gcn(node_in, pred_vecs, edges[..., :2].long(),
                            node_mask_d, edge_mask)
        # drop the dummy slot; spatialize (gan.py:182-190), NCHW per node
        x = nodes[:, :N].reshape(B * N, h // 2, p, p)
        x = F.relu(self.node_conv0(x))
        x = F.relu(self.node_conv1(x))
        if self.vis_cond:
            # [vis, nodes] on the channel axis, as the JAX package's NHWC
            # concatenation
            vis = vis_features.float().reshape(B * N, p, p, -1)
            x = torch.cat([vis.permute(0, 3, 1, 2), x], dim=1)
        x = self.proj(x)
        x = x.reshape(B, N, h, p, p).permute(0, 1, 3, 4, 2)  # (B,N,p,p,h)
        layout = boxes_to_layout(x, boxes01.float(), node_mask, self.fmap_sz,
                                 self.fmap_sz, pooling="sum")
        return F.relu(self.refine(layout)).contiguous()


class GANModel(nn.Module):
    """The generator ``G`` and the three discriminators ``D_nodes``,
    ``D_edges``, ``D_global`` in one module, float32. ``generate`` runs G
    (train mode: its BatchNorms on batch statistics, their running
    statistics updated); the ``disc_*`` calls run a D from its stored
    spectral-norm vectors, which only ``update_disc_stats`` writes."""

    def __init__(self, num_classes: int, num_predicates: int,
                 embed_dim: int = 200, hidden_dim: int = 64,
                 n_ch: int = 512, pool_sz: int = 7, fmap_sz: int = 37,
                 n_layers_G: int = 5, batch_norm: bool = True,
                 vis_cond: bool = False, largeD: bool = False,
                 init_embed_objs: Optional[np.ndarray] = None,
                 init_embed_rels: Optional[np.ndarray] = None):
        super().__init__()
        self.num_classes, self.num_predicates = num_classes, num_predicates
        self.n_ch, self.pool_sz, self.fmap_sz = n_ch, pool_sz, fmap_sz
        self.G = Generator(num_classes, num_predicates, embed_dim,
                           hidden_dim, n_ch, pool_sz, fmap_sz, n_layers_G,
                           batch_norm, vis_cond, init_embed_objs,
                           init_embed_rels)
        self.D_nodes = CondPatchDiscriminator(n_ch + num_classes, n_ch)
        self.D_edges = CondPatchDiscriminator(n_ch + num_predicates, n_ch)
        self.D_global = GlobalDiscriminator(n_ch, large=largeD,
                                            fmap_sz=fmap_sz)

    def partition(self, prefix: str):
        """(name, parameter) of the ``G`` (prefix "G") or the D ("D")
        partition."""
        return [(n, p) for n, p in self.named_parameters()
                if n.startswith(prefix)]

    def generate(self, classes, boxes01, rels, node_mask, rel_mask,
                 vis_features: Optional[torch.Tensor] = None):
        return self.G(classes, boxes01, rels, node_mask, rel_mask,
                      vis_features)

    def disc_nodes(self, feats, labels, update_stats: bool = False):
        return self.D_nodes(conditioned_features(feats, labels,
                                                 self.num_classes),
                            update_stats)

    def disc_edges(self, feats, labels, update_stats: bool = False):
        return self.D_edges(conditioned_features(feats, labels,
                                                 self.num_predicates),
                            update_stats)

    def disc_global(self, fmaps, update_stats: bool = False):
        return self.D_global(fmaps, update_stats)

    @torch.no_grad()
    def update_disc_stats(self, node_feats, node_labels, edge_feats,
                          edge_labels, fmaps) -> None:
        """One pass through all three Ds that writes their spectral-norm
        vectors (``u``, ``sigma``)."""
        self.disc_nodes(node_feats, node_labels, update_stats=True)
        self.disc_edges(edge_feats, edge_labels, update_stats=True)
        self.disc_global(fmaps, update_stats=True)


def init_gan_weights(gan: GANModel, seed: int) -> GANModel:
    """Seeded random weights drawn on the CPU from one ``torch.Generator``,
    in the JAX initializers' laws (flax's truncated normals: He for the
    ``TripleMLP`` denses and the CRN's convs, LeCun for the other convs):
    embeddings normal(1.0) or the ``init_embed`` tables, zero biases,
    identity BatchNorms, the spectral-norm ``u`` normal and ``sigma`` 1."""
    g = torch.Generator().manual_seed(seed)
    he = {id(m) for r in gan.modules()
          if isinstance(r, (TripleMLP, RefinementNetwork, RefinementModule))
          for m in r.modules()}
    tables = dict(zip((gan.G.obj_embed, gan.G.rel_embed), gan.G.init_embed))

    def trunc_normal(t, std):
        # flax's variance_scaling: a [-2, 2] truncated normal rescaled to
        # the wanted std
        s = std / 0.87962566103423978
        nn.init.trunc_normal_(t, 0.0, s, -2.0 * s, 2.0 * s, generator=g)

    with torch.no_grad():
        for mod in gan.modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d)):
                gain = 2.0 if id(mod) in he else 1.0
                trunc_normal(mod.weight,
                             math.sqrt(gain / mod.weight[0].numel()))
                mod.bias.zero_()
            elif isinstance(mod, nn.Embedding):
                table = tables.get(mod)
                if table is None:
                    mod.weight.copy_(torch.randn(mod.weight.shape,
                                                 generator=g))
                else:
                    mod.weight.copy_(torch.as_tensor(
                        np.asarray(table, np.float32)))
            elif isinstance(mod, SNConv):
                mod.u.copy_(torch.randn(mod.u.shape, generator=g))
                mod.sigma.fill_(1.0)
            elif hasattr(mod, "running_var"):  # the BatchNorms
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
                mod.num_batches_tracked.zero_()
    return gan
