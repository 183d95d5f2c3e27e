"""Detector pretraining in the port against the JAX package, f32 on the
CPU: target assignment, the balanced sampler's core on JAX's own draws,
the RPN and RoI-head losses and their gradients, the GT proposals, the
learning-rate schedule against optax, one train step of the whole VGG16
detector at tiny widths (losses, the decayed gradients as the momentum
traces hold them, the updated parameters; the RoI-head losses reach the
RPN through the proposal boxes), and ``pretrain`` writing payloads that the
SGDet path loads."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pretrain_detector import make_detector_train_step as jax_train_step
from sgg_tpu.data.graph_batch import GraphBatch as JBatch
from sgg_tpu.models import detector as jdet
from sgg_tpu.train.state import TrainState
from sgg_torch import pretrain_detector as tpre
from sgg_torch.convert import variables_from_jax
from sgg_torch.data.graph_batch import GraphBatch
from sgg_torch.data.synthetic import synthetic_splits
from sgg_torch.models import detector as tdet
from test_torch_resnet_fpn import one_thread  # noqa: F401

C, IMG, B, N = 9, 96, 2, 6
TINY = dict(rpn_pre_nms_top_n=32, rpn_post_nms_top_n=16,
            detections_per_img=8, obj_dim=32)
LR = 0.005


def _t(x):
    return torch.from_numpy(np.array(x))


def _draws(key, shape):
    """The two uniforms of JAX's ``_sample_balanced`` for each image of a
    batch: ``split(key, B)``, then ``split`` into (k_p, k_n) per image."""
    keys = jax.random.split(key, shape[0])
    u = [[np.asarray(jax.random.uniform(k, shape[1:]))
          for k in jax.random.split(kb)] for kb in keys]
    return (_t(np.stack([a for a, _ in u])), _t(np.stack([b for _, b in u])))


def _gt(seed=0, n_obj=(4, 3)):
    rng = np.random.RandomState(seed)
    boxes = np.zeros((B, N, 4), np.float32)
    mask = np.zeros((B, N), bool)
    for b, n in enumerate(n_obj):
        xy = rng.rand(n, 2) * 50
        wh = rng.rand(n, 2) * 40 + 16
        boxes[b, :n] = np.concatenate([xy, np.minimum(xy + wh, 80)], 1)
        mask[b, :n] = True
    classes = np.where(mask, rng.randint(1, C, (B, N)), 0).astype(np.int32)
    return boxes, classes, mask


# -- assignment, sampling, losses on identical inputs -----------------------

@pytest.mark.parametrize("low_quality", [True, False])
def test_assign_targets_matches_jax(low_quality):
    anchors = jdet.make_anchors(6, 6, 16)
    gtb, _, gtm = _gt(1)
    gtb[1, 1] = anchors[200]  # an exact match: IoU 1 and a tie
    gtb[1, 2] = anchors[200]
    hi, lo = (0.7, 0.3) if low_quality else (0.5, 0.5)
    want = jax.vmap(lambda b, m: jdet.assign_targets(
        jnp.asarray(anchors), b, m, hi, lo, low_quality))(gtb, gtm)
    got = tdet.assign_targets(_t(anchors), _t(gtb), _t(gtm), hi, lo,
                              low_quality)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[0] == 1).any() and (got[0] == 0).any()
    assert (got[0] == -1).any() == (hi > lo)


@pytest.mark.parametrize("num,frac,p_pos", [(256, 0.5, 0.02),
                                            (512, 0.25, 0.4), (16, 0.25, 0.6)])
def test_sampler_core_on_jax_draws(num, frac, p_pos):
    rng = np.random.RandomState(num)
    K = 600
    labels = np.where(rng.rand(B, K) < p_pos, 1,
                      rng.randint(-1, 1, (B, K))).astype(np.int32)
    key = jax.random.key(num)
    want = jax.vmap(lambda k, l: jdet._sample_balanced(k, l, num, frac))(
        jax.random.split(key, B), jnp.asarray(labels))
    got = tdet.sample_balanced(*_draws(key, (B, K)), _t(labels), num, frac)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[0].sum()) > 0 and int(got[1].sum()) > 0


def test_rpn_losses_and_gradients_match_jax():
    anchors = jdet.make_anchors(6, 6, 16)
    K = anchors.shape[0]
    gtb, _, gtm = _gt(2)
    rng = np.random.RandomState(3)
    obj = rng.randn(B, K).astype(np.float32)
    deltas = (rng.randn(B, K, 4) * 0.3).astype(np.float32)
    key = jax.random.key(5)

    def jloss(o, d):
        out = jdet.rpn_losses(key, jnp.asarray(anchors), o, d, gtb, gtm)
        return out["loss_objectness"] + out["loss_rpn_box_reg"], out

    (_, want), (g_obj, g_del) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(obj),
                                             jnp.asarray(deltas))
    o, d = _t(obj).requires_grad_(), _t(deltas).requires_grad_()
    got = tdet.rpn_losses(_draws(key, (B, K)), _t(anchors), o, d, _t(gtb),
                          _t(gtm))
    print("rpn losses vs JAX: " + ", ".join(
        f"{k} {abs(float(got[k].detach()) - float(want[k])):.3g}"
        for k in want))
    for k in want:
        assert abs(float(got[k].detach()) - float(want[k])) <= 1e-6, k
    go, gd = torch.autograd.grad(got["loss_objectness"]
                                 + got["loss_rpn_box_reg"], (o, d))
    np.testing.assert_allclose(go.numpy(), np.asarray(g_obj), atol=1e-7)
    np.testing.assert_allclose(gd.numpy(), np.asarray(g_del), atol=1e-7)


def test_roi_head_losses_and_gradients_match_jax():
    """Including the gradient in the proposals, through the box targets."""
    P = 40
    gtb, gtc, gtm = _gt(4)
    rng = np.random.RandomState(6)
    props = np.concatenate([rng.rand(B, P, 2) * 60, rng.rand(B, P, 2) * 60],
                           -1).astype(np.float32)
    props[..., 2:] = props[..., :2] + 8 + np.abs(props[..., 2:])
    props[:, :N] = gtb + rng.randn(B, N, 4).astype(np.float32)  # positives
    pmask = rng.rand(B, P) < 0.9
    logits = rng.randn(B, P, C).astype(np.float32)
    deltas = (rng.randn(B, P, C * 4) * 0.3).astype(np.float32)
    key = jax.random.key(7)

    def jloss(pr, lg, dl):
        out = jdet.roi_head_losses(key, pr, pmask, lg, dl, gtb, gtc, gtm)
        return out["loss_classifier"] + out["loss_box_reg"], out

    (_, want), grads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                          has_aux=True)(
        jnp.asarray(props), jnp.asarray(logits), jnp.asarray(deltas))
    leaves = [_t(a).requires_grad_() for a in (props, logits, deltas)]
    got = tdet.roi_head_losses(_draws(key, (B, P)), leaves[0], _t(pmask),
                               leaves[1], leaves[2], _t(gtb),
                               _t(gtc).long(), _t(gtm))
    assert float(want["loss_box_reg"]) > 0
    print("roi head losses vs JAX: " + ", ".join(
        f"{k} {abs(float(got[k].detach()) - float(want[k])):.3g}"
        for k in want))
    for k in want:
        assert abs(float(got[k].detach()) - float(want[k])) <= 1e-6, k
    tgrads = torch.autograd.grad(got["loss_classifier"]
                                 + got["loss_box_reg"], leaves)
    for g, w in zip(tgrads, grads):
        w = np.asarray(w)
        assert np.abs(w).max() > 0
        np.testing.assert_allclose(g.numpy(), w,
                                   atol=1e-6 * np.abs(w).max())


def test_append_gt_proposals_matches_jax():
    gtb, _, gtm = _gt(8)
    rng = np.random.RandomState(9)
    props = (rng.rand(B, 16, 4) * 90).astype(np.float32)
    pmask = rng.rand(B, 16) < 0.7
    want = jdet.append_gt_proposals(jnp.asarray(props), jnp.asarray(pmask),
                                    jnp.asarray(gtb), jnp.asarray(gtm))
    got = tdet.append_gt_proposals(_t(props), _t(pmask), _t(gtb), _t(gtm))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_smooth_l1_matches_jax():
    x = np.linspace(-1, 1, 201).astype(np.float32)
    np.testing.assert_allclose(tdet._smooth_l1(_t(x)).numpy(),
                               np.asarray(jdet._smooth_l1(jnp.asarray(x))),
                               atol=1e-7)


# -- the learning-rate schedule ---------------------------------------------

def _optax_schedule(lr, steps_per_epoch, num_epochs):
    """The schedule as the JAX package's ``pretrain`` builds it."""
    warmup = min(1000, steps_per_epoch - 1) if steps_per_epoch > 1 else 0
    schedules = [optax.linear_schedule(lr / 1000, lr, max(warmup, 1))]
    boundaries = [max(warmup, 1)]
    cur = lr
    for e in range(3, num_epochs, 3):
        schedules.append(optax.constant_schedule(cur))
        boundaries.append(e * steps_per_epoch)
        cur *= 0.1
    schedules.append(optax.constant_schedule(cur))
    return optax.join_schedules(schedules, boundaries)


@pytest.mark.parametrize("spe,epochs", [(1, 4), (4, 4), (1500, 4),
                                        (7, 10)])
def test_lr_schedule_equals_optax_at_every_step(spe, epochs):
    """optax's arithmetic as written (evaluated op by op; a compiled
    program may contract the warmup's multiply-add and differ by an
    ulp)."""
    n = spe * max(epochs, 4)
    want = np.asarray(_optax_schedule(LR, spe, epochs)(jnp.arange(n)))
    port = tpre.detector_lr_schedule(LR, spe, epochs)
    got = np.asarray([port(c) for c in range(n)], np.float32)
    np.testing.assert_array_equal(got, want)


# -- one train step of the whole detector -----------------------------------

def _batch():
    rng = np.random.RandomState(11)
    gtb, gtc, gtm = _gt(10)
    return dict(images=rng.randn(B, IMG, IMG, 3).astype(np.float32),
                im_hw=np.asarray([[IMG, IMG], [80.0, IMG]], np.float32),
                boxes=gtb, classes=gtc, node_mask=gtm,
                rels=np.zeros((B, 1, 3), np.int32),
                rel_mask=np.zeros((B, 1), bool))


@functools.lru_cache(maxsize=None)
def _jax_step():
    """JAX's train step from seeded weights (``pretrain_detector.py``'s own
    step, SGD at a constant 0.005), and ``loss_classifier``'s own
    gradient; computed once for the module."""
    batch = _batch()
    jd = jdet.FasterRCNNVGG(num_classes=C, dtype=jnp.float32, **TINY)
    # the JAX package's own initializer, as its pretrain() draws the
    # weights (host copies: the step donates its state)
    v = jax.tree_util.tree_map(np.asarray, jd.init(
        jax.random.key(0), jnp.asarray(batch["images"]),
        jnp.asarray(batch["im_hw"]), train=False))
    tx = optax.chain(optax.add_decayed_weights(5e-4),
                     optax.sgd(LR, momentum=0.9))
    state = TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                       batch_stats=v.get("batch_stats", {}),
                       opt_state=tx.init(v["params"]), tx=tx)
    key = jax.random.key(13)
    jb = JBatch(**{k: jnp.asarray(x) for k, x in batch.items()})
    out = jax.jit(lambda v, b: jd.apply(v, b.images, b.im_hw,
                                        gt_boxes=b.boxes,
                                        gt_mask=b.node_mask))(v, jb)
    new, metrics = jax_train_step(jd)(state, jb, key)
    k_rpn, k_roi = jax.random.split(key)

    def cls_loss(params):
        o = jd.apply({"params": params}, jb.images, jb.im_hw,
                     gt_boxes=jb.boxes, gt_mask=jb.node_mask)
        return jdet.roi_head_losses(
            k_roi, o["proposals"], o["prop_mask"], o["class_logits"],
            o["box_deltas"], jb.boxes, jb.classes,
            jb.node_mask)["loss_classifier"]

    cls_grad = jax.jit(jax.grad(cls_loss))(v["params"])
    trace = new.opt_state[1][0].trace
    np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return dict(v=v, out={k: np.asarray(x) for k, x in out.items()
                          if k != "anchors"},
                metrics={k: float(x) for k, x in metrics.items()},
                params=np_(new.params), trace=np_(trace),
                cls_grad=np_(cls_grad), key=key, K=out["anchors"].shape[0],
                P=out["prop_mask"].shape[1])


def _port_detector(v):
    td = tdet.FasterRCNNVGG(C, **TINY)
    td.load_state_dict(variables_from_jax(v), strict=True)
    return td.eval()


def _port_draws(ref):
    k_rpn, k_roi = jax.random.split(ref["key"])
    return {"rpn": _draws(k_rpn, (B, ref["K"])),
            "roi": _draws(k_roi, (B, ref["P"]))}


def _sd(tree):
    return {k: v.numpy() for k, v in variables_from_jax(
        {"params": tree}).items()}


def test_forward_with_gt_boxes_matches_jax():
    ref = _jax_step()
    td = _port_detector(ref["v"])
    batch = GraphBatch(**_batch())
    with torch.no_grad():
        got = td(_t(batch.images), _t(batch.im_hw), gt_boxes=_t(batch.boxes),
                 gt_mask=_t(batch.node_mask))
    want = ref["out"]
    np.testing.assert_array_equal(got["prop_mask"].numpy(),
                                  want["prop_mask"])
    # the same slots; a corner moves by up to ~1e-2 px with the RPN's
    # last-bit differences (as in test_torch_detector.py)
    np.testing.assert_allclose(got["proposals"].numpy(), want["proposals"],
                               atol=1e-2)
    # the GT boxes hold the last slots where they exist
    np.testing.assert_array_equal(got["proposals"][:, -N:][_t(
        batch.node_mask)].numpy(), batch.boxes[batch.node_mask])
    for k in ("class_logits", "box_deltas"):
        np.testing.assert_allclose(got[k].numpy(), want[k],
                                   atol=1e-4 * np.abs(want[k]).max())


def test_train_step_matches_jax():
    """Losses within 1e-5; the momentum traces (gradient + 5e-4 * p after
    one step from zero) and the updated parameters within 1e-5 of each
    tensor's size, RPN included."""
    ref = _jax_step()
    td = _port_detector(ref["v"])
    opt = tpre.DetectorOptimizer(td, lambda count: LR)
    step = tpre.make_detector_train_step(td, opt)
    metrics = step(GraphBatch(**_batch()), None, draws=_port_draws(ref))
    print("train step losses vs JAX: " + ", ".join(
        f"{k} {abs(float(metrics[k]) - v):.3g}"
        for k, v in ref["metrics"].items()))
    for k, want in ref["metrics"].items():
        assert abs(float(metrics[k]) - want) <= 1e-5, (k, float(metrics[k]),
                                                      want)
    errs = {}
    for kind, mine, theirs in (
            ("trace", opt.state_dict(), _sd(ref["trace"])),
            ("param", dict(td.named_parameters()), _sd(ref["params"]))):
        assert set(mine) == set(theirs)
        for name, want in theirs.items():
            got = mine[name].detach().numpy()
            scale = float(np.abs(want).max())
            assert scale > 0, name
            errs[(kind, name)] = float(np.abs(got - want).max()) / scale
    worst = max(errs, key=errs.get)
    print(f"train step vs JAX: worst relative error {errs[worst]:.3g} at "
          f"{worst}")
    assert errs[worst] <= 1e-5, worst


def test_classifier_loss_reaches_the_rpn_through_the_proposals():
    """``loss_classifier`` alone puts a gradient on ``rpn.bbox_pred``
    (through RoIAlign's box gradient), as in the JAX package."""
    ref = _jax_step()
    td = _port_detector(ref["v"])
    batch = GraphBatch(**_batch())
    out = td(_t(batch.images), _t(batch.im_hw), gt_boxes=_t(batch.boxes),
             gt_mask=_t(batch.node_mask))
    loss = tdet.roi_head_losses(
        _port_draws(ref)["roi"], out["proposals"], out["prop_mask"],
        out["class_logits"], out["box_deltas"], _t(batch.boxes),
        _t(batch.classes).long(), _t(batch.node_mask))["loss_classifier"]
    params = dict(td.named_parameters())
    names = ("rpn.bbox_pred.bias", "rpn.bbox_pred.weight", "rpn.conv.bias")
    grads = torch.autograd.grad(loss, [params[n] for n in names])
    want = _sd(ref["cls_grad"])
    for n, g in zip(names, grads):
        w = want[n]
        assert np.abs(w).max() > 1e-6, n
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4 * np.abs(w).max(),
                                   err_msg=n)


# -- the loop, its payloads and its refusals --------------------------------

def _splits(n=8):
    return synthetic_splits(num_train=n, num_eval=2, num_classes=C,
                            num_predicates=5, max_objects=5, image_size=96)


def test_pretrain_writes_payloads_that_sgdet_loads(tmp_path):
    from sgg_torch.train.checkpoint import (latest_epoch, load_detector,
                                            load_detector_state)
    from sgg_torch import constants
    old = constants.IM_SCALE
    det = tdet.FasterRCNNVGG(C, **TINY)
    try:
        constants.IM_SCALE = 96
        splits = _splits()
        first = {k: v.clone() for k, v in tdet.init_detector_weights(
            tdet.FasterRCNNVGG(C, **TINY), 0).state_dict().items()}
        det, state = tpre.pretrain(splits, num_epochs=2, batch_size=4,
                                   max_nodes=8, detector=det,
                                   save_dir=str(tmp_path / "det"),
                                   steps_per_print=1, device="cpu",
                                   with_images=False)
    finally:
        constants.IM_SCALE = old
    assert state.step == 4  # 8 images / batch 4, 2 epochs
    assert len(state.history) == 4
    assert all(np.isfinite(list(h.values())).all() for h in state.history)
    assert latest_epoch(str(tmp_path / "det")) == 1
    payload, epoch = load_detector(str(tmp_path / "det"))
    assert epoch == 1 and int(payload["step"]) == 4
    fresh = tdet.FasterRCNNVGG(C, **TINY)
    load_detector_state(fresh, payload)
    moved = [n for n, p in fresh.named_parameters()
             if not torch.equal(p, first[n])]
    assert len(moved) == len(list(fresh.parameters()))


def test_pretrain_refuses_what_is_not_ported(monkeypatch, one_thread):
    """The real datasets raise; ``detector=None``, refused until the FPN
    detector was ported, now trains it (tiny heads, 64 px)."""
    from sgg_torch import constants
    monkeypatch.setattr(tdet, "FasterRCNNFPN", functools.partial(
        tdet.FasterRCNNFPN, **TINY))
    monkeypatch.setattr(constants, "IM_SCALE", 64)
    splits = synthetic_splits(num_train=2, num_eval=1, num_classes=C,
                              num_predicates=5, max_objects=4,
                              image_size=64)
    det, state = tpre.pretrain(splits, num_epochs=1, batch_size=2,
                               max_nodes=8, detector=None, device="cpu")
    assert type(det).__name__ == "FasterRCNNFPN" and state.step == 1
    for ds in ("vg", "gqa"):
        with pytest.raises(NotImplementedError, match="dataset parsers"):
            tpre.main([ds, "data", "out"])
