"""The relation model's training step in plain PyTorch: a VGG16 trunk, RoI
pooling by bilinear interpolation, the union-box ("rects") branch, the RoI
heads, iterative message passing (IMP, Xu et al. 2017), the node and
density-normalised edge losses (Knyazev et al. 2020) and clipped SGD.

The parameters are a dict by name. ``param_spec`` lists them with their
shapes and laws; ``make_weights`` draws them on the device from a seed in
one call, so that the benchmark hands the same weights to the program and
to this reference.

``Numerics`` says where the configuration computes in a low precision:
every product (convolution, dense layer) there takes its operands in
bfloat16, or, for the control, rounded to float8 (e4m3, one scale a
tensor) first. Sums of statistics, the losses and the output layers stay
in float32, as the configuration states.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

POOL = 7
STRIDE = 16
RECT = POOL * 4 - 1          # the rasterized pair's side
FG_FRACTION = 0.25
BN_MOMENTUM = 0.01
BN_EPS = 1e-5
VGG16 = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
         "M", 512, 512, 512)
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


# -- numerics ---------------------------------------------------------------

class Numerics:
    """The low precision of the configuration's products: ``bf16`` or the
    control's ``fp8`` (operands rounded to float8 e4m3 at one scale a
    tensor, then computed in bfloat16; the rounding passes the gradient
    straight through). The GAN's products (``g_linear``, ``g_conv``) are
    float32, and bfloat16 in the control."""

    def __init__(self, low: str = "bf16"):
        if low not in ("bf16", "fp8"):
            raise ValueError(low)
        self.low = low
        self.dtype = torch.bfloat16

    def op(self, t: torch.Tensor) -> torch.Tensor:
        t = t.to(self.dtype)
        if self.low == "fp8":
            amax = t.detach().abs().amax().float().clamp(min=1e-12)
            scale = amax / 448.0
            q = ((t.detach().float() / scale).to(torch.float8_e4m3fn)
                 .float() * scale).to(self.dtype)
            t = t + (q - t).detach()
        return t

    def linear(self, x, w, b):
        return F.linear(self.op(x), self.op(w), self.op(b))

    # the GAN's products: float32 as the configuration states, bfloat16
    # in the control
    def _f(self, t):
        return t if self.low == "bf16" else t.to(torch.bfloat16)

    def g_linear(self, x, w, b):
        return F.linear(self._f(x), self._f(w), self._f(b)).float()

    def g_conv(self, x, w, b, padding=0):
        return F.conv2d(self._f(x), self._f(w), self._f(b),
                        padding=padding).float()


# -- parameters -------------------------------------------------------------

def param_spec(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, law) of every parameter of the relation model, under
    the names of the model as the cells run it. Laws: ``he`` and ``lecun``
    normals (fan-in), ``gru`` (normal of the variance of U(-k, k), k =
    1/sqrt(hidden)), ``zeros``, ``ones``."""
    spec = []
    c_in, i = 3, 0
    for v in VGG16:
        if v == "M":
            continue
        spec += [(f"trunk.conv.{i}.weight", (v, c_in, 3, 3), "he"),
                 (f"trunk.conv.{i}.bias", (v,), "zeros")]
        c_in, i = v, i + 1
    C = cfg["fmap_channels"]
    spec += [("union_feats.conv1.weight", (C // 2, 2, 7, 7), "he"),
             ("union_feats.conv1.bias", (C // 2,), "zeros"),
             ("union_feats.bn1.weight", (C // 2,), "ones"),
             ("union_feats.bn1.bias", (C // 2,), "zeros"),
             ("union_feats.conv2.weight", (C, C // 2, 3, 3), "he"),
             ("union_feats.conv2.bias", (C,), "zeros"),
             ("union_feats.bn2.weight", (C,), "ones"),
             ("union_feats.bn2.bias", (C,), "zeros")]
    D, H = cfg["obj_dim"], cfg["hidden_dim"]
    in_dim = POOL * POOL * C
    for head in ("roi_fmap_obj", "roi_fmap"):
        spec += [(f"{head}.fc6.weight", (D, in_dim), "lecun"),
                 (f"{head}.fc6.bias", (D,), "zeros"),
                 (f"{head}.fc7.weight", (D, D), "lecun"),
                 (f"{head}.fc7.bias", (D,), "zeros")]
    spec += [("imp.obj_unary.weight", (H, D), "lecun"),
             ("imp.obj_unary.bias", (H,), "zeros"),
             ("imp.edge_unary.weight", (H, D), "lecun"),
             ("imp.edge_unary.bias", (H,), "zeros")]
    for gru in ("node_gru", "edge_gru"):
        spec += [(f"imp.{gru}.weight_ih", (3 * H, H), "gru"),
                 (f"imp.{gru}.weight_hh", (3 * H, H), "gru"),
                 (f"imp.{gru}.bias_ih", (3 * H,), "gru"),
                 (f"imp.{gru}.bias_hh", (3 * H,), "gru")]
    for fc in ("sub_vert_w_fc", "obj_vert_w_fc", "out_edge_w_fc",
               "in_edge_w_fc"):
        spec += [(f"imp.{fc}.weight", (1, 2 * H), "lecun"),
                 (f"imp.{fc}.bias", (1,), "zeros")]
    spec += [("imp.obj_fc.weight", (cfg["num_classes"], H), "lecun"),
             ("imp.obj_fc.bias", (cfg["num_classes"],), "zeros"),
             ("imp.rel_fc.weight", (cfg["num_predicates"], H), "lecun"),
             ("imp.rel_fc.bias", (cfg["num_predicates"],), "zeros")]
    return spec


def frozen(name: str) -> bool:
    """The trunk is frozen: no gradient, no update, no decay."""
    return name.startswith("trunk.")


def stored_types(cfg: dict) -> Dict[str, torch.dtype]:
    """The frozen trunk is stored in the configuration's compute type."""
    dt = torch.bfloat16 if cfg["compute_dtype"] == "bfloat16" \
        else torch.float32
    return {n: dt for n, _, _ in param_spec(cfg) if frozen(n)}


def make_weights(spec, seed: int, device, stored=None
                 ) -> Dict[str, torch.Tensor]:
    """The parameters of ``spec`` from one normal draw on ``device``
    (``torch.Generator`` seeded with ``seed``), float32 unless ``stored``
    maps a name to another type."""
    stored = stored or {}
    drawn = [(n, s, law) for n, s, law in spec
             if law in ("he", "lecun", "gru")]
    total = sum(math.prod(s) for _, s, _ in drawn)
    g = torch.Generator(device=device).manual_seed(seed % (2 ** 63))
    flat = torch.randn(total, generator=g, device=device)
    out, at = {}, 0
    for name, shape, law in spec:
        if law == "zeros":
            t = torch.zeros(shape, device=device)
        elif law == "ones":
            t = torch.ones(shape, device=device)
        else:
            n = math.prod(shape)
            fan_in = math.prod(shape[1:]) if len(shape) > 1 else shape[0]
            if law == "gru":
                std = 1.0 / math.sqrt(3.0 * (shape[0] // 3))
            else:
                std = math.sqrt((2.0 if law == "he" else 1.0) / fan_in)
            t = flat[at:at + n].view(shape) * std
            at += n
        out[name] = t.to(stored.get(name, torch.float32))
    return out


# -- layers -----------------------------------------------------------------

def trunk(P, images: torch.Tensor, num: Numerics) -> torch.Tensor:
    """uint8 (B, S, S, 3), or float canvases already normalised, -> (B,
    S/16, S/16, 512) in the low precision."""
    x = images.float()
    if images.dtype == torch.uint8:
        mean = torch.tensor(MEAN, device=images.device) * 255.0
        std = torch.tensor(STD, device=images.device) * 255.0
        x = (x - mean) / std
    x = x.permute(0, 3, 1, 2)
    i = 0
    for v in VGG16:
        if v == "M":
            x = F.max_pool2d(x, 2, 2)
            continue
        x = F.relu(F.conv2d(num.op(x), num.op(P[f"trunk.conv.{i}.weight"]),
                            num.op(P[f"trunk.conv.{i}.bias"]), padding=1))
        i += 1
    return x.permute(0, 2, 3, 1)


def interp(start, extent, dim: int, ratio: int = 2) -> torch.Tensor:
    """(..., POOL, dim) weights of RoIAlign (aligned=False, ``ratio``
    samples a bin) along one axis."""
    S = POOL * ratio
    i = torch.arange(S, dtype=torch.float32, device=start.device)
    y = start[..., None] + extent[..., None] * (i + 0.5) / torch.full_like(
        i, S)
    valid = (y >= -1.0) & (y <= dim)
    yc = y.clamp(min=0.0)
    low = torch.floor(yc).long()
    cap = low >= dim - 1
    low = torch.where(cap, torch.full_like(low, dim - 1), low)
    high = torch.where(cap, low, low + 1)
    frac = torch.where(cap, torch.zeros_like(yc), yc - low.float())
    w_low = torch.where(valid, 1.0 - frac, torch.zeros_like(yc))
    w_high = torch.where(valid, frac, torch.zeros_like(yc))
    W = (w_low[..., None] * F.one_hot(low, dim).float()
         + w_high[..., None] * F.one_hot(high, dim).float())
    return W.reshape(*W.shape[:-2], POOL, ratio, dim).mean(-2)


def roi_align(fmap: torch.Tensor, boxes: torch.Tensor,
              chunk: int = 64) -> torch.Tensor:
    """(B, h, w, C) map, (B, R, 4) pixel boxes -> (B, R, P, P, C) in the
    map's type, the interpolation in float32."""
    B, H, W, C = fmap.shape
    sb = boxes.float() / STRIDE
    x1, y1 = sb[..., 0], sb[..., 1]
    rw = torch.clamp(sb[..., 2] - x1, min=1.0)
    rh = torch.clamp(sb[..., 3] - y1, min=1.0)
    Wy, Wx = interp(y1, rh, H), interp(x1, rw, W)
    f32 = fmap.float()
    outs = []
    for s in range(0, boxes.shape[1], chunk):
        t = torch.einsum("brph,bhwc->brpwc", Wy[:, s:s + chunk], f32)
        outs.append(torch.einsum("brqw,brpwc->brpqc", Wx[:, s:s + chunk], t))
    return torch.cat(outs, 1).to(fmap.dtype)


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, ...)[(B, E)] -> (B, E, ...)."""
    shape = idx.shape + x.shape[2:]
    flat = idx.reshape(*idx.shape, *([1] * (x.dim() - 2))).expand(shape)
    return torch.gather(x, 1, flat)


def union_rects(pair_boxes: torch.Tensor) -> torch.Tensor:
    """(B, E, 8) subject and object boxes -> (B, E, 2, RECT, RECT): each
    box's coverage of the pixels of its pair's union frame."""
    b = pair_boxes.float().reshape(*pair_boxes.shape[:-1], 2, 4)
    x1u = b[..., 0].amin(-1, keepdim=True)
    y1u = b[..., 1].amin(-1, keepdim=True)
    w = b[..., 2].amax(-1, keepdim=True) - x1u
    h = b[..., 3].amax(-1, keepdim=True) - y1u
    w = torch.where(w > 0, w, torch.ones_like(w))
    h = torch.where(h > 0, h, torch.ones_like(h))
    sx = torch.full_like(w, float(RECT)) / w
    sy = torch.full_like(h, float(RECT)) / h
    x1, x2 = (b[..., 0] - x1u) * sx, (b[..., 2] - x1u) * sx
    y1, y2 = (b[..., 1] - y1u) * sy, (b[..., 3] - y1u) * sy
    g = torch.arange(RECT, dtype=torch.float32, device=b.device)

    def cover(lo, hi, along):
        lo, hi = lo[..., None, None], hi[..., None, None]
        return (along + 1 - lo).clamp(0, 1) * (hi - along).clamp(0, 1)

    return cover(y1, y2, g[:, None]) * cover(x1, x2, g[None, :])


def conv_windows(x, w, b, stride: int, pad: int, num: Numerics):
    """A convolution as one product of the input's windows by the weight
    matrix, in the low precision."""
    k = w.shape[-1]
    xp = F.pad(num.op(x), (pad, pad, pad, pad))
    win = xp.unfold(2, k, stride).unfold(3, k, stride)
    n, _, oh, ow = win.shape[:4]
    cols = win.permute(0, 2, 3, 1, 4, 5).reshape(n * oh * ow, -1)
    y = F.linear(cols, num.op(w).reshape(w.shape[0], -1), num.op(b))
    return y.reshape(n, oh, ow, -1).permute(0, 3, 1, 2)


def batch_norm(x: torch.Tensor, weight, bias) -> torch.Tensor:
    """Train-mode batch norm over (N, H, W) with the biased variance
    E[x^2] - E[x]^2, in float32, returned in the input's type."""
    xf = x.float()
    mean = xf.mean((0, 2, 3))
    var = torch.clamp((xf * xf).mean((0, 2, 3)) - mean * mean, min=0.0)
    mul = torch.rsqrt(var + BN_EPS) * weight
    y = (xf - mean[:, None, None]) * mul[:, None, None] \
        + bias[:, None, None]
    return y.to(x.dtype)


def start_norm(x: torch.Tensor, weight, bias) -> torch.Tensor:
    """Eval-mode batch norm on the running statistics that a model starts
    from (mean 0, variance 1), in float32, returned in the input's type:
    the evaluated model has not trained."""
    mul = torch.rsqrt(torch.ones_like(weight) + BN_EPS) * weight
    y = x.float() * mul[:, None, None] + bias[:, None, None]
    return y.to(x.dtype)


def rects_branch(P, pair_boxes, num: Numerics,
                 norm=batch_norm) -> torch.Tensor:
    """(B, E, 8) -> (B, E, h, w, C): conv 7x7 -> ReLU -> BN -> max pool 3/2
    -> conv 3x3 -> ReLU -> BN, both convs at the map's stride; ``norm``:
    ``batch_norm`` in training, ``start_norm`` in eval."""
    B, E = pair_boxes.shape[:2]
    x = (union_rects(pair_boxes) - 0.5).reshape(B * E, 2, RECT, RECT)
    x = F.relu(conv_windows(x, P["union_feats.conv1.weight"],
                            P["union_feats.conv1.bias"], STRIDE, 3, num))
    x = norm(x, P["union_feats.bn1.weight"], P["union_feats.bn1.bias"])
    x = F.max_pool2d(x, 3, 2, padding=1)
    x = F.relu(conv_windows(x, P["union_feats.conv2.weight"],
                            P["union_feats.conv2.bias"], STRIDE, 1, num))
    x = norm(x, P["union_feats.bn2.weight"], P["union_feats.bn2.bias"])
    return x.permute(0, 2, 3, 1).reshape(B, E, x.shape[2], x.shape[3], -1)


def dropout(x: torch.Tensor, gen, p: float = 0.5) -> torch.Tensor:
    """Keep with probability 1 - p (a uniform draw from ``gen`` under it),
    scaled by 1 / (1 - p); without ``gen`` (eval) keep everything."""
    if gen is None:
        return x
    keep = 1.0 - p
    mask = torch.rand(tuple(x.shape), generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def roi_head(P, name, x, gen, final_relu: bool, num: Numerics):
    x = num.linear(x.reshape(*x.shape[:-3], -1), P[f"{name}.fc6.weight"],
                   P[f"{name}.fc6.bias"])
    x = dropout(F.relu(x), gen)
    x = num.linear(x, P[f"{name}.fc7.weight"], P[f"{name}.fc7.bias"])
    if final_relu:
        x = dropout(F.relu(x), gen)
    return x


def gru(P, name, carry, inputs, num: Numerics):
    gi = num.linear(inputs, P[f"{name}.weight_ih"], P[f"{name}.bias_ih"])
    gh = num.linear(carry, P[f"{name}.weight_hh"], P[f"{name}.bias_hh"])
    i_r, i_z, i_n = gi.chunk(3, -1)
    h_r, h_z, h_n = gh.chunk(3, -1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1.0 - z) * n + z * carry.to(num.dtype)


def imp(P, node_feat, edge_feat, pairs, pair_mask, mp_iter: int,
        num: Numerics):
    """Message passing over the padded graph; (obj_logits, rel_logits) in
    float32."""
    N = node_feat.shape[1]
    lin = lambda n, x: num.linear(x, P[f"imp.{n}.weight"],  # noqa: E731
                                  P[f"imp.{n}.bias"])
    gate = lambda n, x: torch.sigmoid(lin(n, x))  # noqa: E731
    obj_rep = lin("obj_unary", node_feat)
    rel_rep = F.relu(lin("edge_unary", edge_feat))
    vert = gru(P, "imp.node_gru", torch.zeros_like(obj_rep), obj_rep, num)
    edge = gru(P, "imp.edge_gru", torch.zeros_like(rel_rep), rel_rep, num)
    subj, obj = pairs[..., 0], pairs[..., 1]
    m = pair_mask.float()[..., None]
    subj_inc = F.one_hot(subj, N).float() * m
    obj_inc = F.one_hot(obj, N).float() * m
    for _ in range(mp_iter):
        sub_vert, obj_vert = take(vert, subj), take(vert, obj)
        cat_sub = torch.cat([sub_vert, edge], -1)
        cat_obj = torch.cat([obj_vert, edge], -1)
        msg = (gate("sub_vert_w_fc", cat_sub) * sub_vert
               + gate("obj_vert_w_fc", cat_obj) * obj_vert)
        new_edge = gru(P, "imp.edge_gru", edge, msg, num)
        pre_out = gate("out_edge_w_fc", cat_sub) * edge
        pre_in = gate("in_edge_w_fc", cat_obj) * edge
        ctx = (torch.einsum("ben,beh->bnh", subj_inc, pre_out.float())
               + torch.einsum("ben,beh->bnh", obj_inc, pre_in.float()))
        vert = gru(P, "imp.node_gru", vert, ctx.to(num.dtype), num)
        edge = new_edge
    obj_logits = F.linear(vert.float(), P["imp.obj_fc.weight"],
                          P["imp.obj_fc.bias"])
    rel_logits = F.linear(edge.float(), P["imp.rel_fc.weight"],
                          P["imp.rel_fc.bias"])
    return obj_logits, rel_logits


def relation_model(P, batch, pairs, pair_mask, gen, cfg: dict,
                   num: Numerics, fmap: Optional[torch.Tensor] = None,
                   classes: Optional[torch.Tensor] = None,
                   return_feats: bool = False):
    """The forward of the relation model on a padded batch of tensors;
    dropout draws from ``gen``: the node head's two masks, then the edge
    head's. Without ``gen`` the eval forward: no dropout, the rects'
    norms on the starting statistics."""
    if fmap is None:
        with torch.no_grad():
            fmap = trunk(P, batch["images"], num)
    boxes = batch["boxes"].float()
    node_pool = roi_align(fmap, boxes)
    b_s, b_o = take(boxes, pairs[..., 0]), take(boxes, pairs[..., 1])
    uboxes = torch.cat([torch.minimum(b_s[..., :2], b_o[..., :2]),
                        torch.maximum(b_s[..., 2:], b_o[..., 2:])], -1)
    union_pool = roi_align(fmap, uboxes)
    rects = rects_branch(P, torch.cat([b_s, b_o], -1), num,
                         batch_norm if gen is not None else start_norm)
    node_feat = roi_head(P, "roi_fmap_obj", node_pool, gen, True, num)
    edge_feat = roi_head(P, "roi_fmap", union_pool + rects.to(
        union_pool.dtype), gen, False, num)
    obj_logits, rel_logits = imp(P, node_feat, edge_feat, pairs, pair_mask,
                                 cfg["mp_iter"], num)
    out = {"obj_logits": obj_logits, "rel_logits": rel_logits}
    if return_feats:
        out.update(fmap=fmap, node_pool=node_pool, edge_pool=union_pool)
    return out


# -- the sampler, the losses, the optimizer ---------------------------------

def sample_edges(gen, rels, rel_mask, node_mask, max_out: int):
    """Per image: the annotated pairs (at most ``max_out`` x FG_FRACTION,
    ranked by a uniform draw), then the other ordered pairs of distinct
    valid nodes by a second draw, up to ``max_out``; FG first. Draws (B, E)
    then (B, N*N) uniforms from ``gen``. Returns ((B, max_out, 3) subject,
    object, predicate; (B, max_out) mask)."""
    B, E = rel_mask.shape
    N = node_mask.shape[1]
    dev = rel_mask.device
    u_fg = torch.rand((B, E), generator=gen, device=dev)
    u_bg = torch.rand((B, N * N), generator=gen, device=dev)
    inf = float("inf")
    max_fg = int(round(max_out * FG_FRACTION))
    order = torch.argsort(torch.where(rel_mask, u_fg, inf), dim=1,
                          stable=True)
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(E, device=dev).expand(B, E))
    fg_keep = rel_mask & (rank < max_fg)
    fg_score = torch.where(fg_keep, 2.0 + u_fg, -inf)
    subj, obj = rels[..., 0].long(), rels[..., 1].long()
    valid = node_mask[:, :, None] & node_mask[:, None, :] \
        & ~torch.eye(N, dtype=torch.bool, device=dev)
    annotated = torch.zeros((B, N * N), dtype=torch.int32, device=dev) \
        .scatter_add_(1, subj * N + obj, rel_mask.int()) > 0
    bg_score = torch.where(valid.reshape(B, N * N) & ~annotated, u_bg, -inf)
    grid = torch.arange(N, device=dev)
    scores = torch.cat([fg_score, bg_score], 1)
    all_s = torch.cat([subj, grid.repeat_interleave(N).expand(B, -1)], 1)
    all_o = torch.cat([obj, grid.repeat(N).expand(B, -1)], 1)
    all_p = torch.cat([rels[..., 2].long(),
                       torch.zeros((B, N * N), dtype=torch.long,
                                   device=dev)], 1)
    top, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    top, idx = top[:, :max_out], idx[:, :max_out]
    mask = top > -inf
    out = torch.stack([torch.where(mask, torch.gather(a, 1, idx), 0)
                       for a in (all_s, all_o, all_p)], 2)
    return out, mask


def masked_ce(logits, labels, mask):
    ce = F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                         labels.long().reshape(-1), reduction="none")
    return torch.where(mask.reshape(-1), ce, 0.0).reshape(mask.shape)


def node_loss(obj_logits, classes, node_mask):
    ce = masked_ce(obj_logits, classes, node_mask)
    return ce.sum() / torch.clamp(node_mask.sum().float(), min=1.0)


def dnorm_edge_loss(rel_logits, labels, mask, alpha=1.0, beta=1.0,
                    gamma=1.0):
    """FG edges weighted alpha / M_FG, BG edges beta / M_FG (weight 1 where
    the batch has no FG edge)."""
    ce = masked_ce(rel_logits, labels, mask)
    fg = mask & (labels > 0)
    bg = mask & (labels == 0)
    m_fg, m_bg = fg.sum().float(), bg.sum().float()
    fg_w = torch.where(m_fg > 0, alpha / torch.clamp(m_fg, min=1.0), 1.0)
    bg_w = torch.where((m_bg > 0) & (m_fg > 0),
                       beta / torch.clamp(m_fg, min=1.0), 1.0)
    w = torch.where(fg, fg_w, torch.where(bg, bg_w, 0.0))
    return gamma * (ce * w).sum()


class ClippedSGD:
    """SGD with momentum 0.9 and coupled L2 over the trainable parameters,
    gradients clipped to a global norm first (``g * clip / norm`` where
    ``norm >= clip``); the parameters whose name starts with ``roi_fmap``
    take a tenth of the rate."""

    def __init__(self, P: Dict[str, torch.Tensor], lr: float, l2: float,
                 clip: float):
        self.names = [n for n in P if not frozen(n)]
        self.P, self.lr, self.l2, self.clip = P, lr, l2, clip
        self.momentum = {n: torch.zeros_like(P[n]) for n in self.names}

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        grads = {n: (self.P[n].grad if self.P[n].grad is not None
                     else torch.zeros_like(self.P[n])) for n in self.names}
        norm = torch.stack([g.square().sum() for g in grads.values()]).sum() \
            .sqrt()
        factor = torch.where(norm < self.clip, 1.0, self.clip / norm)
        for n in self.names:
            d = grads[n] * factor + self.l2 * self.P[n]
            self.momentum[n].mul_(0.9).add_(d)
            lr = self.lr * (0.1 if n.startswith("roi_fmap") else 1.0)
            self.P[n].sub_(lr * self.momentum[n])
            self.P[n].grad = None
        return norm


def sgg_losses(out, classes, rel_labels, batch, pair_mask, loss_w):
    return {"obj_loss": node_loss(out["obj_logits"], classes,
                                  batch["node_mask"]),
            "rel_loss": dnorm_edge_loss(out["rel_logits"], rel_labels,
                                        pair_mask, *loss_w)}


def train_step(P, opt: ClippedSGD, batch, gen, cfg: dict,
               num: Numerics) -> Dict[str, float]:
    """One step: sample edges, forward, losses, backward, clipped SGD."""
    max_out = min(batch["rels"].shape[1], cfg["rels_per_img"])
    sampled, pair_mask = sample_edges(gen, batch["rels"], batch["rel_mask"],
                                      batch["node_mask"], max_out)
    pairs, labels = sampled[..., :2], sampled[..., 2]
    out = relation_model(P, batch, pairs, pair_mask, gen, cfg, num)
    losses = sgg_losses(out, batch["classes"], labels, batch, pair_mask,
                        loss_weights(cfg))
    sum(losses.values()).backward()
    opt.step()
    return {k: float(v.detach()) for k, v in losses.items()}


def loss_weights(cfg: dict):
    return (cfg["alpha"], cfg["beta"], cfg["gamma"])
