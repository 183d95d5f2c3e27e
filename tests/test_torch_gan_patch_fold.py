"""The patch discriminators' class planes as a per-class bias
(``sgg_torch.models.gan.CondPatchDiscriminator``) against the reference's
form, the one-hot planes concatenated to the features
(``conditioned_features``) and convolved, on the same weights on the CPU.

Held: the logits, the feature input's gradient, every parameter's gradient
(the class columns of ``SNConv_0``'s weight included) and, after an
``update_stats`` call, the spectral-norm vectors ``u`` and ``sigma``. The
fold sums the same products in another order, so the tolerance is float32's
(1e-5 of each tensor's largest magnitude; bfloat16 features' gradient, cast
back to bfloat16, 8e-3: one rounding of that type). The vectors come from
the same arithmetic on the same weights and are held bit for bit. The whole
D needs a 7x7 patch (its four valid convs end at 1x1); on a 5x5 patch the
first conv is held alone. Also: the parameters' names and shapes, the
refusal of a first conv the fold does not fit, and the counter
``gan.d_patch_fold`` over a GAN step and an SGCls step."""

import copy
import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sgg_torch.config import Config
from sgg_torch.models.gan import (CondPatchDiscriminator, GANModel,
                                  conditioned_features)
from sgg_torch.models.gan import discriminators
from sgg_torch.models.gan.discriminators import _nchw
from sgg_torch.train.state import Optimizer
from sgg_torch.train.step import make_train_step
from sgg_torch.utils import counters
from test_torch_gan_step import _batches, _config_kw, _port_models
from test_torch_resnet_fpn import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

RTOL = 1e-5
BF16_GRAD_RTOL = 8e-3
N_CH = 32


def rel_err(got, want) -> float:
    got = got.detach().double()
    want = want.detach().double()
    return float((got - want).abs().max()
                 / max(float(want.abs().max()), 1e-12))


def concatenated(d, feats, labels, update_stats, whole):
    """The reference's form on ``d``'s weights: the one-hot planes
    concatenated to the features, then the convs (the first alone unless
    ``whole``)."""
    h = d.SNConv_0(_nchw(conditioned_features(feats, labels, d.n_classes)),
                   update_stats)
    if not whole:
        return h
    for i in range(1, 4):
        h = getattr(d, f"SNConv_{i}")(F.relu(h), update_stats)
    return h.reshape(*feats.shape[:-3], 1)


def folded(d, feats, labels, update_stats, whole):
    if whole:
        return d(feats, labels, update_stats)
    return d.first_conv(feats, labels, update_stats)


def _labels(rng, shape, n_classes):
    """Labels over ``[0, n_classes)`` with both ends present."""
    labels = rng.randint(0, n_classes, size=shape)
    labels.flat[0], labels.flat[-1] = 0, n_classes - 1
    return torch.from_numpy(labels)


@pytest.mark.parametrize("n_classes,patch,dtype,label_dtype", [
    (151, 7, torch.float32, torch.int64),   # D_nodes' class count
    (51, 7, torch.float32, torch.int32),    # D_edges'
    (9, 7, torch.bfloat16, torch.int64),    # the real pools' type
    (2, 7, torch.float32, torch.int64),
    (51, 5, torch.float32, torch.int64),
    (9, 5, torch.float32, torch.int32)],
    ids=["nodes151", "edges51", "bf16", "two", "edges51_p5", "nine_p5"])
def test_fold_matches_concatenation(n_classes, patch, dtype, label_dtype):
    torch.manual_seed(n_classes + patch)
    rng = np.random.RandomState(n_classes + patch)
    base = CondPatchDiscriminator(n_classes, N_CH, patch)
    whole = patch == 7
    feats = torch.randn(3, 5, patch, patch, N_CH).to(dtype)
    labels = _labels(rng, (3, 5), n_classes).to(label_dtype)
    results = []
    for form in (concatenated, folded):
        d = copy.deepcopy(base)
        x = feats.clone().requires_grad_(True)
        out = form(d, x, labels, True, whole)
        probe = torch.from_numpy(rng.randn(*out.shape).astype(np.float32)) \
            if not results else results[0][3]
        (out * probe).sum().backward()
        results.append((out, x.grad, d, probe))
    (want, want_gx, want_d, _), (got, got_gx, got_d, _) = results
    assert got.shape == want.shape
    assert rel_err(got, want) <= RTOL
    assert got_gx.dtype == dtype
    assert rel_err(got_gx, want_gx) <= (
        RTOL if dtype == torch.float32 else BF16_GRAD_RTOL)
    want_p = dict(want_d.named_parameters())
    checked = 0
    for name, p in got_d.named_parameters():
        if p.grad is None:  # the later convs when the first is held alone
            assert not whole and want_p[name].grad is None, name
            continue
        assert rel_err(p.grad, want_p[name].grad) <= RTOL, name
        checked += 1
    assert checked == (8 if whole else 2)
    cls_cols = got_d.SNConv_0.Conv_0.weight.grad[:, N_CH:]
    assert cls_cols.abs().max() > 0
    assert rel_err(cls_cols, want_d.SNConv_0.Conv_0.weight.grad[:, N_CH:]
                   ) <= RTOL
    for name, b in got_d.named_buffers():
        assert torch.equal(b, dict(want_d.named_buffers())[name]), name
    assert not torch.equal(got_d.SNConv_0.u, base.SNConv_0.u)


def test_parameters_keep_names_and_shapes():
    """The Ds' state at full width: the names and shapes of the
    concatenated first conv, ``(256, 512 + classes, 3, 3)``."""
    gan = GANModel(151, 51, largeD=True)
    want = {}
    for d, n in (("D_nodes", 151), ("D_edges", 51)):
        for i, (cin, cout, k) in enumerate(((512 + n, 256, 3), (256, 128, 3),
                                            (128, 64, 1), (64, 1, 3))):
            want[f"{d}.SNConv_{i}.u"] = (1, cout)
            want[f"{d}.SNConv_{i}.sigma"] = ()
            want[f"{d}.SNConv_{i}.Conv_0.weight"] = (cout, cin, k, k)
            want[f"{d}.SNConv_{i}.Conv_0.bias"] = (cout,)
    got = {k: tuple(v.shape) for k, v in gan.state_dict().items()
           if k.startswith(("D_nodes.", "D_edges."))}
    assert got == want


@pytest.mark.parametrize("fault", ["padding", "patch"])
def test_construction_refuses_what_does_not_fold(monkeypatch, fault):
    """A first conv that reads padding, or a kernel wider than the patch."""
    if fault == "padding":
        monkeypatch.setattr(discriminators, "SNConv", functools.partial(
            discriminators.SNConv, padding=1))
        make = functools.partial(CondPatchDiscriminator, 9, N_CH, 7)
    else:
        make = functools.partial(CondPatchDiscriminator, 9, N_CH, 2)
    with pytest.raises(ValueError, match="padding 0"):
        make()
    monkeypatch.undo()
    CondPatchDiscriminator(9, N_CH, 7)  # the module's own layers fold


def test_fold_counter_over_gan_and_sgcls_steps():
    """``gan.d_patch_fold``: 8 over a GAN step with G and D (G's fake
    nodes and edges, D's real and fake of each, ``update_disc_stats``' two);
    0 over an SGCls step."""
    from sgg_torch.train.gan_step import (create_gan_optimizers,
                                          make_gan_train_step)
    _, tb, fake, _, edges = _batches(1)[0]
    tm, tgan = _port_models()
    cfg = Config(device="cpu", **_config_kw("D_G_rec"))
    g_opt, d_opt = create_gan_optimizers(cfg, tgan)
    step = make_gan_train_step(tm, tgan, cfg, Optimizer(cfg, tm), g_opt,
                               d_opt)
    before = counters.get("gan.d_patch_fold")
    step(tb, torch.from_numpy(fake), None, edges=edges)
    assert counters.get("gan.d_patch_fold") - before == 8

    kw = {k: v for k, v in _config_kw("D_G_rec").items()
          if k not in ("gan", "ganlosses")}
    cfg = Config(device="cpu", **kw)
    before = counters.get("gan.d_patch_fold")
    make_train_step(tm, cfg, Optimizer(cfg, tm))(tb, None, edges=edges)
    assert counters.get("gan.d_patch_fold") - before == 0
