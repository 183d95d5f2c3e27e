"""The GAN of compositional augmentation (Knyazev et al., ICCV 2021) and
its training step, in plain PyTorch, float32 with TF32 off.

The generator embeds the (perturbed) classes and the predicates, runs a
scene-graph triple convolution (sg2im) over [embedding, box] nodes with a
background node joined to every object both ways, turns each node's
output into a 7x7 feature, paints the features into their boxes and grows
the layout into a fake map with a cascaded refinement network. Three
spectrally normalised discriminators judge node patches, edge patches
(each with one-hot class planes) and whole maps. A step: the relation
model's update on the real map (F), the generator's adversarial and
reconstruction losses with the relation model's second update (G), the
discriminators' real-against-fake update and one power iteration of
their spectral norms (D).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmarks.reference import model as rm

EMBED, HID, POOL_SZ, N_CH, GCN_LAYERS = 200, 64, 7, 512, 5


# -- parameters -------------------------------------------------------------

def _mlp(prefix, in_dim, dims, bn_last):
    spec, n_bn = [], 0
    for i, d in enumerate(dims):
        spec += [(f"{prefix}.Dense_{i}.weight", (d, in_dim), "he"),
                 (f"{prefix}.Dense_{i}.bias", (d,), "zeros")]
        if i < len(dims) - 1 or bn_last:
            spec += [(f"{prefix}.MaskedBatchNorm_{n_bn}.weight", (d,),
                      "ones"),
                     (f"{prefix}.MaskedBatchNorm_{n_bn}.bias", (d,),
                      "zeros")]
            n_bn += 1
        in_dim = d
    return spec


def _conv(name, cin, cout, k, law):
    return [(f"{name}.weight", (cout, cin, k, k), law),
            (f"{name}.bias", (cout,), "zeros")]


def d_convs(cfg: dict):
    """(name, c_in, c_out, kernel) of the three discriminators' convs."""
    C = N_CH
    out = []
    for d, n_lab in (("D_nodes", cfg["num_classes"]),
                     ("D_edges", cfg["num_predicates"])):
        for i, (ci, co, k) in enumerate(((C + n_lab, C // 2, 3),
                                         (C // 2, C // 4, 3),
                                         (C // 4, C // 8, 1),
                                         (C // 8, 1, 3))):
            out.append((f"{d}.SNConv_{i}", ci, co, k))
    g = [(C, C // 2, 3), (C // 2, C // 2, 1), (C // 2, C // 2, 3),
         (C // 2, C // 2, 1), (C // 2, C // 4, 3), (C // 4, C // 4, 1),
         (C // 4, 1, 3)] if cfg["largeD"] else \
        [(C, C // 2, 3), (C // 2, C // 2, 3), (C // 2, C // 4, 3),
         (C // 4, 1, 3)]
    out += [(f"D_global.SNConv_{i}", ci, co, k)
            for i, (ci, co, k) in enumerate(g)]
    return out


def crn_dims():
    return (HID, N_CH // 4, N_CH // 2, N_CH)


def param_spec(cfg: dict):
    """(name, shape, law) of the GAN's parameters, under the program's
    names; laws as ``model.param_spec``'s, ``unit`` a unit normal."""
    spec = [("G.obj_embed.weight", (cfg["num_classes"], EMBED), "unit"),
            ("G.rel_embed.weight", (cfg["num_predicates"], EMBED), "unit")]
    obj_dim, pred_dim = EMBED + 4, EMBED
    out_dim = HID // 2 * POOL_SZ * POOL_SZ
    for i in range(GCN_LAYERS):
        last = i == GCN_LAYERS - 1
        o = out_dim if last else HID
        spec += _mlp(f"G.gcn.gconv_{i}.net1", 2 * obj_dim + pred_dim,
                     (HID, 2 * HID + o), not last)
        spec += _mlp(f"G.gcn.gconv_{i}.net2", HID, (HID, o), not last)
        obj_dim = pred_dim = HID
    spec += _conv("G.node_conv0", HID // 2, HID, 3, "lecun")
    spec += _conv("G.node_conv1", HID, HID, 3, "lecun")
    spec += _conv("G.proj", HID, HID, 1, "lecun")
    dims = crn_dims()
    in_dim = 1
    for i in range(len(dims) - 1):
        m = f"G.refine.mod{i}"
        spec += _conv(f"{m}.conv0", dims[0] + in_dim, dims[i + 1], 3, "he")
        spec += [(f"{m}.bn0.weight", (dims[i + 1],), "ones"),
                 (f"{m}.bn0.bias", (dims[i + 1],), "zeros")]
        spec += _conv(f"{m}.conv1", dims[i + 1], dims[i + 1], 3, "he")
        spec += [(f"{m}.bn1.weight", (dims[i + 1],), "ones"),
                 (f"{m}.bn1.bias", (dims[i + 1],), "zeros")]
        in_dim = dims[i + 1]
    spec += _conv("G.refine.output_conv", dims[-1], dims[-1], 3, "he")
    for name, ci, co, k in d_convs(cfg):
        spec += _conv(f"{name}.Conv_0", ci, co, k, "lecun")
    return spec


def sn_spec(cfg: dict):
    """(name, shape, law) of the spectral norms' starting vectors."""
    return [(f"{name}.u", (1, co), "unit")
            for name, _, co, _ in d_convs(cfg)]


def make(spec, seed: int, device) -> Dict[str, torch.Tensor]:
    """``spec``'s tensors, float32, from one normal draw on ``device``."""
    total = sum(math.prod(s) for _, s, law in spec
                if law not in ("zeros", "ones"))
    g = torch.Generator(device=device).manual_seed(seed % (2 ** 63))
    flat = torch.randn(total, generator=g, device=device)
    out, at = {}, 0
    for name, shape, law in spec:
        if law in ("zeros", "ones"):
            out[name] = (torch.zeros if law == "zeros" else torch.ones)(
                shape, device=device)
            continue
        n = math.prod(shape)
        fan_in = math.prod(shape[1:])
        std = {"unit": 1.0, "he": math.sqrt(2.0 / fan_in),
               "lecun": math.sqrt(1.0 / fan_in)}[law]
        out[name] = flat[at:at + n].view(shape) * std
        at += n
    return out


# -- the generator ----------------------------------------------------------

def masked_bn(x, mask, w, b, eps=1e-5):
    dims = tuple(range(x.dim() - 1))
    m = mask.float()[..., None]
    n = torch.clamp(m.sum(), min=1.0)
    mean = (x * m).sum(dim=dims) / n
    var = (((x - mean) ** 2) * m).sum(dim=dims) / n
    return (x - mean) / torch.sqrt(var + eps) * w + b


def mlp(P, prefix, x, mask, n_layers, bn_last, num):
    n_bn = 0
    for i in range(n_layers):
        x = num.g_linear(x, P[f"{prefix}.Dense_{i}.weight"],
                         P[f"{prefix}.Dense_{i}.bias"])
        if i < n_layers - 1 or bn_last:
            x = masked_bn(x, mask, P[f"{prefix}.MaskedBatchNorm_{n_bn}.weight"],
                          P[f"{prefix}.MaskedBatchNorm_{n_bn}.bias"])
            n_bn += 1
            x = F.relu(x)
    return x


def triple_conv(P, i, obj, pred, edges, node_mask, edge_mask, last, num):
    N = obj.shape[1]
    out = HID // 2 * POOL_SZ * POOL_SZ if last else HID
    s_idx, o_idx = edges[..., 0], edges[..., 1]
    t = torch.cat([rm.take(obj, s_idx), pred, rm.take(obj, o_idx)], -1)
    t = mlp(P, f"G.gcn.gconv_{i}.net1", t, edge_mask, 2, not last, num)
    new_s, new_p, new_o = t[..., :HID], t[..., HID:HID + out], \
        t[..., HID + out:]
    if last:
        new_s, new_o = F.relu(new_s), F.relu(new_o)
    m = edge_mask.float()[..., None]
    s_inc = F.one_hot(s_idx, N).float() * m
    o_inc = F.one_hot(o_idx, N).float() * m
    pooled = (torch.einsum("ben,beh->bnh", s_inc, new_s)
              + torch.einsum("ben,beh->bnh", o_inc, new_o))
    counts = s_inc.sum(1) + o_inc.sum(1)
    pooled = pooled / torch.clamp(counts, min=1.0)[..., None]
    return mlp(P, f"G.gcn.gconv_{i}.net2", pooled, node_mask, 2,
               not last, num), new_p


def paint_weights(start, extent, out_dim: int, in_dim: int):
    """grid_sample's bilinear taps (align_corners False, zero padding) of
    output position t in linspace(0, 1, out_dim) at ((t - start) / extent)
    * in_dim - 0.5 of the source."""
    step = float(np.float32(1.0) / np.float32(max(out_dim - 1, 1)))
    i = torch.arange(out_dim, device=start.device)
    t = (i.float() * step).masked_fill(i == max(out_dim - 1, 1), 1.0)
    xs = ((t - start[..., None]) / extent[..., None]) * in_dim - 0.5
    x0 = torch.floor(xs)
    frac = xs - x0
    d = torch.arange(in_dim, dtype=xs.dtype, device=start.device)
    return ((1.0 - frac)[..., None] * (x0[..., None] == d)
            + frac[..., None] * ((x0[..., None] + 1.0) == d))


def layout(vecs, boxes01, node_mask, H):
    """(B, N, p, p, D) node features painted into their [0, 1] boxes on an
    H x H canvas and summed over the image's nodes."""
    x0, y0 = boxes01[..., 0], boxes01[..., 1]
    ww, hh = boxes01[..., 2] - x0, boxes01[..., 3] - y0
    ww = torch.where(ww != 0, ww, torch.full_like(ww, 1e-6))
    hh = torch.where(hh != 0, hh, torch.full_like(hh, 1e-6))
    Wy = paint_weights(y0, hh, H, vecs.shape[2])
    Wx = paint_weights(x0, ww, H, vecs.shape[3]) \
        * node_mask[..., None, None].float()
    t = torch.einsum("bnyp,bnpqc->bnyqc", Wy, vecs)
    return torch.einsum("bnxq,bnyqc->byxc", Wx, t)


def pool_matrix(n_in, n_out, device):
    i = torch.arange(n_out, device=device)
    s = (i * n_in) // n_out
    e = -(-((i + 1) * n_in) // n_out)
    j = torch.arange(n_in, device=device)
    inside = (j[None] >= s[:, None]) & (j[None] < e[:, None])
    return torch.where(inside, (1.0 / (e - s).float())[:, None], 0.0)


def crn(P, lay, num):
    """(B, H, W, 64) layout -> (B, H, W, 512)."""
    B, H, W, _ = lay.shape
    dims = crn_dims()
    n = len(dims) - 1
    lay = lay.permute(0, 3, 1, 2)
    feats = lay.new_zeros((B, 1, H >> n, W >> n))
    for i in range(n):
        oh, ow = (H, W) if i == n - 1 else (feats.shape[-2] * 2,
                                            feats.shape[-1] * 2)
        ih = (torch.arange(oh, device=lay.device) * feats.shape[-2]) // oh
        iw = (torch.arange(ow, device=lay.device) * feats.shape[-1]) // ow
        feats = feats.index_select(-2, ih).index_select(-1, iw)
        pooled = lay
        if (H, W) != (oh, ow):
            ph = pool_matrix(H, oh, lay.device)
            pw = pool_matrix(W, ow, lay.device)
            pooled = torch.einsum("pw,...ow->...op", pw, torch.einsum(
                "oh,...hw->...ow", ph, lay))
        x = torch.cat([pooled, feats], 1)
        m = f"G.refine.mod{i}"
        for j in (0, 1):
            x = num.g_conv(x, P[f"{m}.conv{j}.weight"],
                           P[f"{m}.conv{j}.bias"], padding=1)
            x = F.leaky_relu(rm.batch_norm(x, P[f"{m}.bn{j}.weight"],
                                           P[f"{m}.bn{j}.bias"]), 0.2)
        feats = x
    out = num.g_conv(feats, P["G.refine.output_conv.weight"],
                     P["G.refine.output_conv.bias"], padding=1)
    return out.permute(0, 2, 3, 1)


def generate(P, classes, boxes01, rels, node_mask, rel_mask, fmap_sz, num):
    """The fake map (B, fmap_sz, fmap_sz, 512) of a (perturbed) graph."""
    B, N = classes.shape
    dev = classes.device
    cls_d = torch.cat([classes, classes.new_zeros((B, 1))], 1)
    box_d = torch.cat([boxes01, torch.cat([boxes01.new_zeros((B, 1, 2)),
                                           boxes01.new_ones((B, 1, 2))], -1)],
                      1)
    nm_d = torch.cat([node_mask, torch.ones((B, 1), dtype=torch.bool,
                                            device=dev)], 1)
    idx = torch.arange(N, dtype=rels.dtype, device=dev)
    dummy = torch.full((N,), N, dtype=rels.dtype, device=dev)
    zeros = torch.zeros((N,), dtype=rels.dtype, device=dev)
    extra = torch.cat([torch.stack([idx, dummy, zeros], 1),
                       torch.stack([dummy, idx, zeros], 1)], 0)
    edges = torch.cat([rels, extra[None].expand(B, 2 * N, 3)], 1)
    em = torch.cat([rel_mask, node_mask, node_mask], 1)
    obj = torch.cat([F.embedding(cls_d.long(), P["G.obj_embed.weight"]),
                     box_d], -1)
    pred = F.embedding(edges[..., 2].long(), P["G.rel_embed.weight"])
    pairs = edges[..., :2].long()
    for i in range(GCN_LAYERS):
        obj, pred = triple_conv(P, i, obj, pred, pairs, nm_d, em,
                                i == GCN_LAYERS - 1, num)
    x = obj[:, :N].reshape(B * N, HID // 2, POOL_SZ, POOL_SZ)
    for name, pad in (("G.node_conv0", 1), ("G.node_conv1", 1)):
        x = F.relu(num.g_conv(x, P[f"{name}.weight"], P[f"{name}.bias"],
                              padding=pad))
    x = num.g_conv(x, P["G.proj.weight"], P["G.proj.bias"])
    x = x.reshape(B, N, HID, POOL_SZ, POOL_SZ).permute(0, 1, 3, 4, 2)
    return F.relu(crn(P, layout(x, boxes01, node_mask, fmap_sz), num))


# -- the discriminators -----------------------------------------------------

def l2n(x, eps=1e-12):
    return x * torch.rsqrt((x * x).sum() + eps)


def sn_weight(P, S, name):
    """The conv's kernel over sigma from one power iteration from the stored
    vector (the gradient through the kernel alone)."""
    w = P[f"{name}.Conv_0.weight"]
    mat = w.permute(2, 3, 1, 0).reshape(-1, w.shape[0])
    with torch.no_grad():
        v0 = l2n(S[f"{name}.u"] @ mat.t())
        u0 = l2n(v0 @ mat)
    sigma = (v0 @ mat @ u0.t())[0, 0]
    return w / torch.where(sigma != 0, sigma, torch.ones_like(sigma))


@torch.no_grad()
def sn_update(P, S, cfg):
    """One power iteration of every discriminator conv, written back."""
    for name, _, _, _ in d_convs(cfg):
        w = P[f"{name}.Conv_0.weight"]
        mat = w.permute(2, 3, 1, 0).reshape(-1, w.shape[0])
        v0 = l2n(S[f"{name}.u"] @ mat.t())
        S[f"{name}.u"] = l2n(v0 @ mat)


def sn_conv(P, S, name, x, num, padding=0):
    return num.g_conv(x, sn_weight(P, S, name), P[f"{name}.Conv_0.bias"],
                      padding=padding)


def nchw(x):
    return x.reshape(-1, *x.shape[-3:]).permute(0, 3, 1, 2).float()


def d_patch(P, S, which, feats, labels, n_classes, num):
    p = feats.shape[-3]
    onehot = F.one_hot(labels.long(), n_classes).to(feats.dtype)
    planes = onehot[..., None, None, :].expand(*onehot.shape[:-1], p, p,
                                                n_classes)
    h = nchw(torch.cat([feats, planes], -1))
    lead = feats.shape[:-3]
    for i in range(4):
        h = sn_conv(P, S, f"{which}.SNConv_{i}", h, num)
        if i < 3:
            h = F.relu(h)
    return h.reshape(*lead, 1)


def avg_pool_ceil(x):
    H, W = x.shape[-2:]
    pad = (0, (-W) % 2, 0, (-H) % 2)
    summed = F.avg_pool2d(F.pad(x, pad), 2) * 4
    counts = F.avg_pool2d(F.pad(torch.ones_like(x[:1, :1]), pad), 2) * 4
    return summed / counts


def d_global(P, S, fmaps, cfg, num):
    names = iter(f"D_global.SNConv_{i}" for i in range(
        7 if cfg["largeD"] else 4))
    act = lambda h: F.leaky_relu(h, 0.2)  # noqa: E731

    def conv3(h):
        return sn_conv(P, S, next(names), h, num,
                       padding=0 if h.shape[-2] >= 3 else 1)

    def pool(h):
        return F.avg_pool2d(h, 2) if h.shape[-2] >= 6 else h

    h = act(conv3(nchw(fmaps)))
    if cfg["largeD"]:
        h = act(sn_conv(P, S, next(names), h, num))
    if fmaps.shape[1] > 24 and h.shape[-2] >= 6:
        h = avg_pool_ceil(h)
    h = act(conv3(h))
    if cfg["largeD"]:
        h = act(sn_conv(P, S, next(names), h, num))
    h = act(conv3(pool(h)))
    if cfg["largeD"]:
        h = act(sn_conv(P, S, next(names), h, num))
    return conv3(pool(h)).mean(dim=(-2, -1))


def bce(logits, target: float, mask=None):
    per = -target * F.logsigmoid(logits) - (1.0 - target) * F.logsigmoid(
        -logits)
    if mask is None:
        return per.mean()
    m = mask.to(per.dtype).reshape(*per.shape[:-1], 1)
    return (per * m).sum() / torch.clamp(m.sum(), min=1.0)


# -- the optimizer and the step ---------------------------------------------

class Adam:
    """Adam (eps 1e-8) over the named parameters; a parameter without a
    gradient takes a zero one."""

    def __init__(self, P, names: List[str], lr, b1, b2, eps=1e-8):
        self.P, self.names = P, names
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.mu = {n: torch.zeros_like(P[n]) for n in names}
        self.nu = {n: torch.zeros_like(P[n]) for n in names}
        self.t = 0

    @torch.no_grad()
    def step(self):
        self.t += 1
        for n in self.names:
            g = self.P[n].grad if self.P[n].grad is not None \
                else torch.zeros_like(self.P[n])
            self.mu[n] = (1 - self.b1) * g + self.b1 * self.mu[n]
            self.nu[n] = (1 - self.b2) * g * g + self.b2 * self.nu[n]
            mh = self.mu[n] / (1 - self.b1 ** self.t)
            vh = self.nu[n] / (1 - self.b2 ** self.t)
            self.P[n].sub_(self.lr * mh / (vh.sqrt() + self.eps))
            self.P[n].grad = None

    def zero_grad(self):
        for n in self.names:
            self.P[n].grad = None


def gan_step(P, S, opts: Tuple, batch, fake, gen, cfg,
             num: rm.Numerics) -> Dict[str, float]:
    """One step of F, G and D on a batch whose perturbed classes are
    ``fake``; ``P`` holds the relation model's and the GAN's parameters,
    ``S`` the spectral norms' vectors."""
    sgd, g_opt, d_opt = opts
    max_out = min(batch["rels"].shape[1], cfg["rels_per_img"])
    sampled, pair_mask = rm.sample_edges(gen, batch["rels"],
                                         batch["rel_mask"],
                                         batch["node_mask"], max_out)
    pairs, labels = sampled[..., :2], sampled[..., 2]
    lw = rm.loss_weights(cfg)
    w = cfg["ganw"]
    out = {}
    # F
    real = rm.relation_model(P, batch, pairs, pair_mask, gen, cfg, num,
                             return_feats=True)
    losses = rm.sgg_losses(real, batch["classes"], labels, batch, pair_mask,
                           lw)
    sum(losses.values()).backward()
    sgd.step()
    out.update(losses)
    real_nodes, real_edges = real["node_pool"].detach(), \
        real["edge_pool"].detach()
    real_fmap = real["fmap"].detach()
    del real
    # G
    canvas = max(batch["images"].shape[1], batch["images"].shape[2])
    boxes01 = batch["boxes"].float() / torch.full((), float(canvas),
                                                  device=fake.device)
    d_names = [n for n in P if n.startswith("D_")]
    for n in d_names:
        P[n].requires_grad_(False)
    fmaps_fake = generate(P, fake, boxes01, batch["rels"],
                          batch["node_mask"], batch["rel_mask"],
                          real_fmap.shape[1], num)
    state = gen.get_state()
    of = rm.relation_model(P, batch, pairs, pair_mask, gen, cfg, num,
                           fmap=fmaps_fake, return_feats=True)
    g_losses = {
        "G_obj": w * bce(d_patch(P, S, "D_nodes", of["node_pool"], fake,
                                 cfg["num_classes"], num), 1.0,
                         batch["node_mask"]),
        "G_rel": w * bce(d_patch(P, S, "D_edges", of["edge_pool"], labels,
                                 cfg["num_predicates"], num), 1.0, pair_mask),
        "G_fmap": w * bce(d_global(P, S, fmaps_fake, cfg, num), 1.0)}
    gen.set_state(state)
    rec = rm.relation_model(P, batch, pairs, pair_mask, gen, cfg, num,
                            fmap=fmaps_fake.detach())
    rec_l = rm.sgg_losses(rec, fake, labels, batch, pair_mask, lw)
    g_losses.update({k + "_rec": v for k, v in rec_l.items()})
    sum(g_losses.values()).backward()
    for n in d_names:
        P[n].requires_grad_(True)
    g_opt.step()
    sgd.step()
    out.update(g_losses)
    nodes_fake = of["node_pool"].detach()
    edges_fake = of["edge_pool"].detach()
    fmaps_fake = fmaps_fake.detach()
    del of, rec
    # D
    for n in P:
        if not n.startswith("D_"):
            P[n].grad = None
    d_losses = {
        "D_obj": w * (bce(d_patch(P, S, "D_nodes", real_nodes,
                                  batch["classes"], cfg["num_classes"], num), 1.0,
                          batch["node_mask"])
                      + bce(d_patch(P, S, "D_nodes", nodes_fake, fake,
                                    cfg["num_classes"], num), 0.0,
                            batch["node_mask"])),
        "D_rel": w * (bce(d_patch(P, S, "D_edges", real_edges, labels,
                                  cfg["num_predicates"], num), 1.0, pair_mask)
                      + bce(d_patch(P, S, "D_edges", edges_fake, labels,
                                    cfg["num_predicates"], num), 0.0, pair_mask)),
        "D_fmap": w * (bce(d_global(P, S, real_fmap, cfg, num), 1.0)
                       + bce(d_global(P, S, fmaps_fake, cfg, num), 0.0))}
    sum(d_losses.values()).backward()
    d_opt.step()
    sn_update(P, S, cfg)
    out.update(d_losses)
    return {k: float(v.detach()) for k, v in out.items()}
