"""IMP relation head and the full SGG model (PredCls/SGCls/SGDet paths).

Counterpart of ``sgg_tpu/models/relhead.py``: GRU-based iterative message
passing (Xu et al. 2017; reference ``sgg_models/rel_model_stanford.py``)
over padded graph batches. Message pooling is a per-image one-hot product
over the padded ``(B, E)`` edge set, with masked edges contributing zero;
node and union features come from RoIAlign (kernel K1) over the NHWC
trunk feature map; the trunk is frozen (its parameters take no gradient
and it runs without autograd, as the JAX package's ``stop_gradient``).

The heads keep float32 weights and compute in ``compute_dtype``
(``RelModelIMP.to_compute_dtype``); ``model.train()`` is the JAX
``train=True``: dropout on, union BatchNorms on batch statistics.

In mode ``sgdet`` the model has no trunk of its own: the frozen detector's
feature map feeds it (``models/sgdet.py``), as the JAX package initializes
its SGDet relation model feature-map first.

Two backbones, as in the JAX package: ``vgg16`` (the VGG16 trunk's
stride-16, 512-channel map, obj_dim 4096) and ``resnet50`` (the
ResNet50-FPN's stride-64 ``pool`` level, 256 channels, obj_dim 1024 as the
caller sets it, both RoI heads torchvision TwoMLPHeads with no dropout:
reference ``rel_model_base.py:58-81,239``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from sgg_torch.constants import POOL_SIZE, STRIDE, VGG_OBJ_DIM
from sgg_torch.models.backbone import RoiHead, VGG16Trunk, linear_in
from sgg_torch.models.frequency_bias import FrequencyBias
from sgg_torch.models.resnet import (FPN_CHANNELS, STRIDES, ResNet50FPN,
                                     set_compute_dtype)
from sgg_torch.models.union_features import UnionBoxFeats
from sgg_torch.ops.boxes import gather_boxes, union_boxes
from sgg_torch.ops.roi_align import roi_align
from sgg_torch.train.assign import unordered_union_index

FMAP_CHANNELS = 512  # the VGG16 trunk's
# per backbone: the feature map's channels and stride
BACKBONES = {"vgg16": (FMAP_CHANNELS, STRIDE),
             "resnet50": (FPN_CHANNELS, STRIDES[-1])}  # the pool level


def _take_nodes(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-edge node values: (B, N, H)[(B, E)] -> (B, E, H)."""
    return torch.gather(x, 1, idx[..., None].expand(*idx.shape, x.shape[-1]))


class GRUCell(nn.Module):
    """GRU cell with ``torch.nn.GRUCell``'s parameterization and names.

    Gates ``[r; z; n]`` along the 3H axis; ``h' = (1 - z) * n + z * h`` with
    ``n = tanh(i_n + r * h_n)``; both bias vectors are kept, as in the
    reference's ``node_gru``/``edge_gru`` (rel_model_stanford.py:34-35).
    Works on any leading batch dims; computes in ``compute_dtype``.
    """

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        H = hidden_size
        self.hidden_size = H
        self.compute_dtype = torch.float32
        self.weight_ih = nn.Parameter(torch.empty(3 * H, input_size))
        self.weight_hh = nn.Parameter(torch.empty(3 * H, H))
        self.bias_ih = nn.Parameter(torch.empty(3 * H))
        self.bias_hh = nn.Parameter(torch.empty(3 * H))

    def forward(self, carry: torch.Tensor, inputs: torch.Tensor):
        dt = self.compute_dtype
        gi = F.linear(inputs.to(dt), self.weight_ih.to(dt),
                      self.bias_ih.to(dt))
        gh = F.linear(carry.to(dt), self.weight_hh.to(dt),
                      self.bias_hh.to(dt))
        i_r, i_z, i_n = gi.chunk(3, dim=-1)
        h_r, h_z, h_n = gh.chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        return (1.0 - z) * n + z * carry


class IMPHead(nn.Module):
    """mp_iter rounds of GRU message passing over node/edge states
    (reference ``message_pass``, rel_model_stanford.py:48-94)."""

    def __init__(self, obj_dim: int, num_classes: int, num_predicates: int,
                 hidden_dim: int = 512, mp_iter: int = 3):
        super().__init__()
        H = hidden_dim
        self.mp_iter = mp_iter
        self.compute_dtype = torch.float32
        self.obj_unary = nn.Linear(obj_dim, H)
        self.edge_unary = nn.Linear(obj_dim, H)
        self.node_gru = GRUCell(H, H)
        self.edge_gru = GRUCell(H, H)
        self.sub_vert_w_fc = nn.Linear(2 * H, 1)
        self.obj_vert_w_fc = nn.Linear(2 * H, 1)
        self.out_edge_w_fc = nn.Linear(2 * H, 1)
        self.in_edge_w_fc = nn.Linear(2 * H, 1)
        # kept in float32 whatever the compute type, as in the JAX package
        self.obj_fc = nn.Linear(H, num_classes)
        self.rel_fc = nn.Linear(H, num_predicates)

    def forward(self, node_feat, edge_feat, pairs, pair_mask):
        """node_feat (B,N,obj_dim), edge_feat (B,E,obj_dim), pairs (B,E,2).

        Returns (obj_logits (B,N,C) f32, rel_logits (B,E,R) f32).
        """
        dt = self.compute_dtype
        N = node_feat.shape[1]
        obj_rep = linear_in(self.obj_unary, node_feat, dt)
        rel_rep = F.relu(linear_in(self.edge_unary, edge_feat, dt))
        gate = lambda fc, x: torch.sigmoid(linear_in(fc, x, dt))  # noqa: E731

        vert = self.node_gru(torch.zeros_like(obj_rep), obj_rep)
        edge = self.edge_gru(torch.zeros_like(rel_rep), rel_rep)

        subj, obj = pairs[..., 0], pairs[..., 1]
        m = pair_mask.to(dt)[..., None]
        subj_inc = F.one_hot(subj, N).to(dt) * m  # (B, E, N)
        obj_inc = F.one_hot(obj, N).to(dt) * m

        for _ in range(self.mp_iter):
            sub_vert = _take_nodes(vert, subj)  # (B, E, H)
            obj_vert = _take_nodes(vert, obj)
            cat_sub = torch.cat([sub_vert, edge], dim=-1)
            cat_obj = torch.cat([obj_vert, edge], dim=-1)

            # edge update: gated sum of endpoint states (:78-83)
            msg = (gate(self.sub_vert_w_fc, cat_sub) * sub_vert
                   + gate(self.obj_vert_w_fc, cat_obj) * obj_vert)
            new_edge = self.edge_gru(edge, msg)

            # node update: incidence-pooled gated edge states (:86-92)
            pre_out = gate(self.out_edge_w_fc, cat_sub) * edge
            pre_in = gate(self.in_edge_w_fc, cat_obj) * edge
            vert_ctx = (
                torch.einsum("ben,beh->bnh", subj_inc.float(), pre_out.float())
                + torch.einsum("ben,beh->bnh", obj_inc.float(),
                               pre_in.float())).to(dt)
            new_vert = self.node_gru(vert, vert_ctx)
            vert, edge = new_vert, new_edge

        obj_logits = self.obj_fc(vert.float())
        rel_logits = self.rel_fc(edge.float())
        return obj_logits, rel_logits


class RelModelIMP(nn.Module):
    """Full SGG model: trunk -> RoI features -> IMP head (reference
    RelModelStanford.forward/predict, rel_model_stanford.py:97-207, with
    the VGG16 path of rel_model_base.py:83-117). In mode ``sgdet`` there
    is no trunk: ``forward`` takes the detector's ``fmap``.

    State-dict names follow the flax module names of the JAX package
    (``trunk.conv.{i}``, ``roi_fmap_obj``, ``roi_fmap``, ``union_feats``,
    ``imp``, ``freq_bias``); ``convert.variables_from_jax`` maps one onto
    the other.
    """

    def __init__(self, num_classes: int, num_predicates: int,
                 mode: str = "sgcls", use_bias: bool = False,
                 test_bias: bool = False, hidden_dim: int = 512,
                 obj_dim: int = VGG_OBJ_DIM, mp_iter: int = 3,
                 backbone: str = "vgg16", edge_model: str = "motifs",
                 freq_table: Optional[np.ndarray] = None):
        super().__init__()
        if backbone not in BACKBONES:
            raise ValueError(f"backbone {backbone!r} not in "
                             f"{tuple(BACKBONES)}")
        self.num_classes = num_classes
        self.num_predicates = num_predicates
        self.mode = mode
        self.use_bias = use_bias
        self.test_bias = test_bias
        self.backbone = backbone
        self.pool_size = POOL_SIZE
        channels, self.stride = BACKBONES[backbone]
        in_dim = POOL_SIZE * POOL_SIZE * channels
        trunk = VGG16Trunk if backbone == "vgg16" else ResNet50FPN
        self.trunk = (None if mode == "sgdet"
                      else trunk().requires_grad_(False))
        self.union_feats = UnionBoxFeats(dim=channels,
                                         pooling_size=POOL_SIZE,
                                         edge_model=edge_model)
        # vgg16: fc6-relu-drop-fc7-relu-drop for nodes, fc6-relu-drop-fc7
        # for edges (rel_model_base.py:310-321); resnet50: both
        # torchvision TwoMLPHeads, final ReLU and no dropout (:78-80)
        resnet = backbone == "resnet50"
        self.roi_fmap_obj = RoiHead(in_dim, obj_dim, with_final_relu=True)
        self.roi_fmap = RoiHead(in_dim, obj_dim, with_final_relu=resnet)
        if resnet:
            self.roi_fmap_obj.drop.p = self.roi_fmap.drop.p = 0.0
        self.imp = IMPHead(obj_dim, num_classes, num_predicates,
                           hidden_dim=hidden_dim, mp_iter=mp_iter)
        if use_bias:
            self.freq_bias = FrequencyBias(num_classes, num_predicates,
                                           init_table=freq_table)

    def to_compute_dtype(self, dtype: torch.dtype) -> "RelModelIMP":
        """Compute in ``dtype``: the frozen trunk is stored in it (so K2
        and K1 take their ``dtype`` routes); the trainable modules keep
        float32 weights and cast them at use. The output layers
        ``obj_fc``/``rel_fc`` and the frequency table stay float32, as in
        the JAX package."""
        if self.trunk is not None:
            set_compute_dtype(self.trunk, dtype, store=True)
        set_compute_dtype(self, dtype, store=False)
        return self

    def forward(self, images, boxes, classes, pairs, pair_mask, *,
                fmap=None, im_hw=None, mode: Optional[str] = None,
                dedup_unions: bool = False, return_feats: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """Forward pass over a padded batch; train mode (``self.training``)
        draws dropout masks from ``generator``.

        images (B, H, W, 3) or None when ``fmap`` (the backbone's map: (B,
        h, w, 512) at stride 16, or (B, h, w, 256) at stride 64) is given;
        boxes (B, N, 4) image pixels; classes (B, N); pairs (B, E, 2);
        pair_mask (B, E); ``im_hw`` (B, 2), each image's (height, width),
        which ``edge_model="raw_boxes"`` needs. ``dedup_unions`` pools union
        boxes once per
        unordered pair at half the edge budget; the output then carries
        ``dedup_ok`` (per image; False means callers must re-run without
        dedup).

        Returns obj_logits (B,N,C), rel_logits (B,E,R), obj_preds (B,N),
        obj_scores (B,N), and ``dedup_ok`` when deduplicating. With
        ``return_feats`` also ``fmap``, ``node_pool`` (B,N,P,P,C) and
        ``edge_pool`` (B,E,P,P,C): the map and its raw RoIAlign pools,
        before the rects are added, in the map's type (the features the
        GAN's discriminators judge, ``sgg_tpu/models/relhead.py:337-346``).
        """
        mode = mode or self.mode
        if fmap is None:
            if self.trunk is None:
                raise ValueError("an sgdet model has no trunk: pass the "
                                 "detector's fmap")
            with torch.no_grad():  # frozen detector (:125-131)
                fmap = (self.trunk(images) if self.backbone == "vgg16"
                        else self.trunk.pool(images))
        boxes = boxes.float().contiguous()
        scale = 1.0 / self.stride

        node_pool = roi_align(fmap, boxes, spatial_scale=scale,
                              pooled=self.pool_size)
        uboxes = union_boxes(boxes, pairs[..., 0], pairs[..., 1])
        dedup_ok = None
        gidx = None
        if dedup_unions:
            n_uni = max(pairs.shape[1] // 2, 1)
            uni_slots, gidx, dedup_ok, _ = unordered_union_index(
                pairs, pair_mask, n_uni, num_nodes=boxes.shape[1])
            uboxes = gather_boxes(uboxes, uni_slots)
        union_pool_u = roi_align(fmap, uboxes.contiguous(),
                                 spatial_scale=scale, pooled=self.pool_size)

        pair_boxes = torch.cat([gather_boxes(boxes, pairs[..., 0]),
                                gather_boxes(boxes, pairs[..., 1])], dim=-1)
        rects = self.union_feats(pair_boxes, im_hw)  # (B, E, h, w, C)
        edge_split = dedup_unions and rects.shape[2] == 1 \
            and rects.shape[3] == 1
        node_feat = self.roi_fmap_obj(node_pool, generator=generator)
        if edge_split:
            # fc6 is linear before its ReLU: run it on the deduplicated
            # pools, gather, and add the constant rects vector through the
            # spatially summed kernel
            edge_feat = self.roi_fmap(union_pool_u, gather_idx=gidx,
                                      broadcast_add=rects[:, :, 0, 0, :],
                                      generator=generator)
        else:
            union_pool = union_pool_u
            if gidx is not None:
                union_pool = torch.gather(
                    union_pool_u, 1,
                    gidx[:, :, None, None, None].expand(
                        *gidx.shape, *union_pool_u.shape[2:]))
            edge_feat = self.roi_fmap(union_pool + rects.to(union_pool.dtype),
                                      generator=generator)

        obj_logits, rel_logits = self.imp(node_feat, edge_feat, pairs,
                                          pair_mask)

        # object predictions: argmax of the non-background softmax
        probs = torch.softmax(obj_logits, dim=-1)
        obj_scores, obj_preds = probs[..., 1:].max(dim=-1)
        obj_preds = obj_preds + 1
        if mode == "predcls":
            obj_preds = classes.long()
            obj_scores = torch.ones_like(obj_scores)

        if self.use_bias:
            subj_cls = torch.gather(obj_preds, 1, pairs[..., 0])
            obj_cls = torch.gather(obj_preds, 1, pairs[..., 1])
            freq = self.freq_bias(subj_cls, obj_cls)
            rel_logits = freq if self.test_bias else rel_logits + freq

        out = {"obj_logits": obj_logits, "rel_logits": rel_logits,
               "obj_preds": obj_preds, "obj_scores": obj_scores}
        if dedup_ok is not None:
            out["dedup_ok"] = dedup_ok
        if return_feats:
            edge_pool = union_pool_u
            if gidx is not None:
                edge_pool = torch.gather(
                    union_pool_u, 1, gidx[:, :, None, None, None].expand(
                        *gidx.shape, *union_pool_u.shape[2:]))
            out.update(fmap=fmap, node_pool=node_pool, edge_pool=edge_pool)
        return out


def init_weights(model: nn.Module, seed: int) -> nn.Module:
    """Seeded random weights: lecun normal for dense layers and for the
    ResNet50-FPN's convs (the JAX package's initializer; its frozen
    BatchNorms do not rescale, and lecun keeps the residual sums in
    range), He normal for the other convs (the VGG trunk keeps its
    activations at unit scale), zero biases, torch GRU uniform, identity
    BatchNorms. Drawn on the CPU from one ``torch.Generator``, so the same
    seed gives the same weights on any device."""
    g = torch.Generator().manual_seed(seed)
    lecun = {id(m) for r in model.modules() if isinstance(r, ResNet50FPN)
             for m in r.modules()}
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d)):
                fan_in = mod.weight[0].numel()
                gain = 2.0 if isinstance(mod, nn.Conv2d) \
                    and id(mod) not in lecun else 1.0
                std = math.sqrt(gain / fan_in)
                mod.weight.copy_(torch.randn(mod.weight.shape, generator=g)
                                 * std)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, GRUCell):
                k = 1.0 / math.sqrt(mod.hidden_size)
                for p in mod.parameters():
                    p.copy_(torch.rand(p.shape, generator=g) * 2 * k - k)
            elif isinstance(mod, nn.BatchNorm2d):
                mod.reset_parameters()
    return model
