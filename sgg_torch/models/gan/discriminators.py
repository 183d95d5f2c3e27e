"""GAN discriminators: class-conditional patch Ds and the global map D.

Counterpart of ``sgg_tpu/models/gan/discriminators.py`` (reference
``augment/gan.py:69-104``): every conv is spectrally normalized;
``D_nodes``/``D_edges`` are class-conditional 7x7 patch discriminators
(the reference concatenates one-hot class planes to the features; here
they enter the first conv as a per-class bias, the same sum); ``D_global``
judges whole feature maps with LeakyReLU(0.2) convs and average pools,
widened by extra 1x1 convs under ``largeD``.

NHWC at the interfaces, as the JAX modules; NCHW inside. The convs compute
in float32 whatever the input's type (flax promotes a bf16 map to the f32
layer's type).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from sgg_torch.utils import counters
from sgg_torch.utils.profiling import kernel_flops


def _l2_normalize(x: torch.Tensor, eps: float) -> torch.Tensor:
    """flax's ``_l2_normalize``: ``x * rsqrt(sum(x^2) + eps)``."""
    return x * torch.rsqrt((x * x).sum() + eps)


class SNConv(nn.Module):
    """A spectrally normalized conv with flax ``nn.SpectralNorm``'s
    arithmetic (``flax/linen/normalization.py::SpectralNorm``), not
    ``torch.nn.utils.spectral_norm``'s.

    Every call runs one power iteration from the stored ``u`` (1, out) over
    the kernel as a (kh * kw * in, out) matrix, in flax's HWIO order, each
    normalization ``x * rsqrt(sum(x^2) + 1e-12)``, and divides the kernel
    by ``sigma = v W u^T`` (1 where sigma is 0), the gradient flowing
    through W alone; eval calls too. Only a call with ``update_stats``
    writes ``u`` and ``sigma`` back. The bias is not normalized. The conv's
    parameters are ``Conv_0``'s, as the flax module's."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int,
                 padding: int = 0, eps: float = 1e-12):
        super().__init__()
        self.padding, self.eps = padding, eps
        self.Conv_0 = nn.Conv2d(in_ch, out_ch, kernel, padding=padding)
        self.register_buffer("u", torch.randn(1, out_ch))
        self.register_buffer("sigma", torch.ones(()))

    def normalized_weight(self, update_stats: bool = False) -> torch.Tensor:
        w = self.Conv_0.weight  # (out, in, kh, kw)
        mat = w.permute(2, 3, 1, 0).reshape(-1, w.shape[0])
        with torch.no_grad():
            v0 = _l2_normalize(self.u @ mat.t(), self.eps)
            u0 = _l2_normalize(v0 @ mat, self.eps)
        sigma = (v0 @ mat @ u0.t())[0, 0]
        if update_stats:
            with torch.no_grad():
                self.u.copy_(u0)
                self.sigma.copy_(sigma)
        return w / torch.where(sigma != 0, sigma, torch.ones_like(sigma))

    def forward(self, x: torch.Tensor, update_stats: bool = False,
                padding: Optional[int] = None) -> torch.Tensor:
        """NCHW float32 ``x``; ``padding`` overrides the layer's."""
        return F.conv2d(x, self.normalized_weight(update_stats),
                        self.Conv_0.bias,
                        padding=self.padding if padding is None else padding)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """(..., H, W, C) -> (prod(...), C, H, W) float32."""
    return x.reshape(-1, *x.shape[-3:]).permute(0, 3, 1, 2).float()


def avg_pool_ceil(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    """torch ``AvgPool2d(k, ceil_mode=True)`` on an NCHW map: the border
    windows average only their valid elements."""
    H, W = x.shape[-2:]
    pad = (0, (-W) % window, 0, (-H) % window)
    summed = F.avg_pool2d(F.pad(x, pad), window) * (window * window)
    counts = F.avg_pool2d(F.pad(torch.ones_like(x[:1, :1]), pad),
                          window) * (window * window)
    return summed / counts


class CondPatchDiscriminator(nn.Module):
    """Class-conditional 7x7 patch discriminator (reference gan.py:74-82):
    (..., p, p, n_ch) features and (...,) labels in ``[0, n_classes)`` ->
    (..., 1) logits.

    The reference concatenates ``n_classes`` one-hot planes to the features
    before the first conv. That conv is 3x3 with padding 0, so every output
    position reads all 9 taps of every plane, and each plane is constant
    over the patch: the planes add ``sum over taps of W[:, n_ch + label]``,
    one vector a class. So the first conv runs on the ``n_ch`` feature
    channels alone and adds that vector, gathered by label, as a bias: the
    concatenated conv's sum in another order, with its parameters, its
    power iteration over the whole (9 (n_ch + n_classes), out) matrix and,
    through autograd, its gradient in the class columns. Construction
    refuses a first conv that would read past the patch or into padding,
    where the fold would not hold."""

    def __init__(self, n_classes: int, n_ch: int = 512, patch: int = 7):
        super().__init__()
        self.n_ch, self.n_classes = n_ch, n_classes
        c = n_ch
        for i, (cin, cout, k) in enumerate(((n_ch + n_classes, c // 2, 3),
                                            (c // 2, c // 4, 3),
                                            (c // 4, c // 8, 1),
                                            (c // 8, 1, 3))):
            self.add_module(f"SNConv_{i}", SNConv(cin, cout, k))
        first = self.SNConv_0
        if first.padding != 0 or first.Conv_0.kernel_size[0] > patch:
            raise ValueError(
                f"the class planes fold into a bias only for a first conv "
                f"with padding 0 inside the {patch}x{patch} patch (padding "
                f"{first.padding}, kernel {first.Conv_0.kernel_size[0]})")

    def first_conv(self, feats: torch.Tensor, labels: torch.Tensor,
                   update_stats: bool = False) -> torch.Tensor:
        """The first conv's pre-activation (prod(...), out, p - 2, p - 2)
        over the features and their class planes, float32."""
        first = self.SNConv_0
        w = first.normalized_weight(update_stats)
        x = _nchw(feats)
        out_hw = (x.shape[-2] - w.shape[-2] + 1) * (x.shape[-1]
                                                    - w.shape[-1] + 1)
        # counted as the concatenated conv, the work the reference defines
        with kernel_flops(2 * x.shape[0] * out_hw * w[0].numel()
                          * w.shape[0]):
            h = F.conv2d(x, w[:, :self.n_ch], first.Conv_0.bias)
            class_bias = w[:, self.n_ch:].sum((2, 3)).t()  # (n_classes, out)
            # a product with the one-hot rows, not an index: the index's
            # backward adds each class's rows one after another (18.9 ms a
            # GAN step on an H100), the product's is one GEMM
            onehot = F.one_hot(labels.reshape(-1).long(),
                               self.n_classes).to(w.dtype)
            return h.add_((onehot @ class_bias)[..., None, None])

    def forward(self, feats: torch.Tensor, labels: torch.Tensor,
                update_stats: bool = False) -> torch.Tensor:
        counters.bump("gan.d_patch_fold")
        lead = feats.shape[:-3]
        h = F.relu(self.first_conv(feats, labels, update_stats))
        for i in range(1, 4):
            h = getattr(self, f"SNConv_{i}")(h, update_stats)
            if i < 3:
                h = F.relu(h)
        return h.reshape(*lead, 1)


class GlobalDiscriminator(nn.Module):
    """Whole-map discriminator (reference gan.py:87-103): (B, H, W, n_ch)
    -> (B, 1) logits. A 3x3 conv is valid where the map is at least 3 wide
    and 'same' below (the reference's sizes never go below); only the first
    pool (when ``fmap_sz > 24``) is ceil-mode, the later two floor-mode
    (reference gan.py:91,96,101); a pool is skipped below 6."""

    def __init__(self, n_ch: int = 512, large: bool = False,
                 fmap_sz: int = 37):
        super().__init__()
        self.large, self.fmap_sz = large, fmap_sz
        c = n_ch
        convs = [(n_ch, c // 2, 3)]
        if large:
            convs.append((c // 2, c // 2, 1))
        convs.append((c // 2, c // 2, 3))
        if large:
            convs.append((c // 2, c // 2, 1))
        convs.append((c // 2, c // 4, 3))
        if large:
            convs.append((c // 4, c // 4, 1))
        convs.append((c // 4, 1, 3))
        for i, (cin, cout, k) in enumerate(convs):
            self.add_module(f"SNConv_{i}", SNConv(cin, cout, k))

    def forward(self, x: torch.Tensor, update_stats: bool = False
                ) -> torch.Tensor:
        convs = iter(getattr(self, f"SNConv_{i}") for i in range(
            7 if self.large else 4))

        def conv3(h):
            return next(convs)(h, update_stats,
                               padding=0 if h.shape[-2] >= 3 else 1)

        def act(h):
            return F.leaky_relu(h, 0.2)

        def pool_floor(h):
            return F.avg_pool2d(h, 2) if h.shape[-2] >= 6 else h

        h = act(conv3(_nchw(x)))
        if self.large:
            h = act(next(convs)(h, update_stats))
        if self.fmap_sz > 24 and h.shape[-2] >= 6:
            h = avg_pool_ceil(h, 2)
        h = act(conv3(h))
        if self.large:
            h = act(next(convs)(h, update_stats))
        h = act(conv3(pool_floor(h)))
        if self.large:
            h = act(next(convs)(h, update_stats))
        h = conv3(pool_floor(h))
        # 1x1 at the reference's sizes; the mean is then the identity
        return h.mean(dim=(-2, -1))


def conditioned_features(feats: torch.Tensor, labels: torch.Tensor,
                         n_classes: int) -> torch.Tensor:
    """Concatenate one-hot class planes to (..., p, p, C) patch features
    (reference gan.py:226-242): the reference's input to a patch D, which
    ``CondPatchDiscriminator`` takes as features and labels instead."""
    p = feats.shape[-3]
    onehot = F.one_hot(labels.long(), n_classes).to(feats.dtype)
    planes = onehot[..., None, None, :].expand(*onehot.shape[:-1], p, p,
                                                n_classes)
    return torch.cat([feats, planes], dim=-1)
