"""Port parity of the SGDet path on the CPU in f32: ``sgg_torch`` against
``sgg_tpu`` with the same weights (a small ``FasterRCNNVGG``: 8 classes,
96-px images, obj_dim 48, 8 detections; a trunk-free IMP relation model),
the same batches and the same random draws.

* ``detection_pairs`` (the single (0, 0) self-pair when nothing
  overlaps), exactly;
* the retry eval step with its pair-budget ladder, and
  ``sgdet_eval_with_retry`` with each escalation forced (the rounds budget
  and then the NMS candidate cap in one batch, the pair budget in
  another): discrete outputs and the cap counters exact, boxes within
  1e-2 px, scores and relation outputs within 5e-5; each escalated result
  equals the exact run (sequential NMS, a cap that covers, dense pairs);
* ``rel_assignments``: the core exactly on JAX's own draws;
* three SGDet train steps: losses and updated parameters within 1e-5
  relative, as ``tests/test_torch_train_step.py``;
* ``val_epoch`` in mode sgdet: recalls within 1e-6;
* ``python -m sgg_torch.main -m sgdet -nepoch 0 -ckpt <dir>`` in-process.

The JAX references are computed once per module (module-scoped
fixtures)."""

import functools
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sgg_torch.constants
import sgg_tpu.constants
from sgg_tpu.config import Config as JConfig
from sgg_tpu.data.synthetic import SyntheticSGGDataset as JSynth
from sgg_tpu.data.synthetic import synthetic_splits as jsplits
from sgg_tpu.eval.driver import val_epoch as jval_epoch
from sgg_tpu.models.detector import FasterRCNNVGG as JDet
from sgg_tpu.models.relhead import RelModelIMP as JModel
from sgg_tpu.models.sgdet import detection_pairs as jdetection_pairs
from sgg_tpu.models.sgdet import make_sgdet_eval_step as jmake_eval_step
from sgg_tpu.models.sgdet import make_sgdet_retry_eval_step as jmake_retry
from sgg_tpu.models.sgdet import make_sgdet_train_step as jmake_train_step
from sgg_tpu.models.sgdet import sgdet_eval_with_retry as jretry
from sgg_tpu.train.assign import all_pairs as jall_pairs
from sgg_tpu.train.rel_assign import rel_assignments as jrel_assignments
from sgg_tpu.train.state import create_train_state
from sgg_tpu.utils import counters as jcounters
from sgg_torch import main as cli
from sgg_torch.config import Config
from sgg_torch.convert import variables_from_jax
from sgg_torch.data.synthetic import SyntheticSGGDataset
from sgg_torch.data.synthetic import synthetic_splits
from sgg_torch.eval.driver import val_epoch
from sgg_torch.models import detector as detector_mod
from sgg_torch.models.backbone import Dropout
from sgg_torch.models.detector import FasterRCNNVGG
from sgg_torch.models.relhead import RelModelIMP, init_weights
from sgg_torch.models.sgdet import (detection_pairs, make_sgdet_eval_step,
                                    make_sgdet_retry_eval_step,
                                    make_sgdet_train_step,
                                    sgdet_eval_with_retry)
from sgg_torch.train import checkpoint as ckpt
from sgg_torch.train import trainer as trainer_mod
from sgg_torch.train.rel_assign import select_rel_assignments
from sgg_torch.train.state import Optimizer
from sgg_torch.utils import counters
from test_torch_models import random_variables
from test_torch_resnet_fpn import one_thread  # noqa: F401
from test_torch_train_step import _no_flax_dropout, assert_state_close

C, R, IMG, B, D = 8, 5, 96, 2, 8
DET_KW = dict(rpn_pre_nms_top_n=64, rpn_post_nms_top_n=24,
              detections_per_img=D, obj_dim=48, score_thresh=0.01)
REL_KW = dict(num_classes=C, num_predicates=R, mode="sgdet", hidden_dim=16,
              obj_dim=32)


def _data(seed=0, n=2):
    kw = dict(num_images=n, num_classes=C, num_predicates=R, max_objects=5,
              image_size=IMG, with_images=True, seed=seed)
    return JSynth(**kw), SyntheticSGGDataset(**kw)


def _batches(seed=0, idx=(0, 1)):
    js, ts = _data(seed, n=max(idx) + 1)
    return (js.batch(list(idx), max_nodes=8, max_edges=16),
            ts.batch(list(idx), max_nodes=8, max_edges=16))


@pytest.fixture(scope="module")
def models():
    jb, _ = _batches()
    jd = JDet(num_classes=C, dtype=jnp.float32, **DET_KW)
    dv = random_variables(jd, (jnp.asarray(jb.images), jnp.asarray(jb.im_hw)),
                          seed=4)
    jm = JModel(dtype=jnp.float32, **REL_KW)
    pairs, pm = jall_pairs(jnp.ones((B, D), bool))
    shim = types.SimpleNamespace(init=functools.partial(
        jm.init, fmap=jnp.zeros((B, 6, 6, 512)), mode="sgdet"))
    rv = random_variables(shim, (None, jnp.zeros((B, D, 4)),
                                 jnp.ones((B, D), jnp.int32), pairs, pm),
                          seed=5)
    td = FasterRCNNVGG(C, **DET_KW)
    td.load_state_dict(variables_from_jax(dv), strict=True)
    tm = RelModelIMP(**REL_KW)
    tm.load_state_dict(variables_from_jax(rv), strict=True)
    return jd, dv, jm, rv, td.eval(), tm.eval()


def _np(out):
    return {k: np.asarray(v) for k, v in out.items()}


# random box deltas decode boxes hundreds of pixels wide before the clip
# to the image, so the detector head's ~2e-5 relative difference between
# the packages (tests/test_torch_detector.py) moves a corner by up to ~4e-3
# px, and the relation head, pooling those boxes, moves by up to ~2e-5
BOX_ATOL = 1e-2


def assert_outputs_equal(got, want, atol=5e-5):
    """Discrete outputs exactly; boxes within ``BOX_ATOL`` px; scores,
    logits and distributions within ``atol``."""
    got = {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
           for k, v in got.items()}
    assert set(got) == set(want), set(got) ^ set(want)
    for k, w in want.items():
        if np.asarray(w).dtype.kind in "biu":
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            np.testing.assert_allclose(
                got[k], w, atol=BOX_ATOL if "boxes" in k else atol,
                err_msg=k)


def test_detection_pairs_match_jax():
    """Random boxes, and the reference's fall-back: an image whose
    detections do not overlap gets ONE (0, 0) self-pair
    (rel_model_base.py:159-161), not all pairs."""
    rng = np.random.RandomState(3)
    boxes = rng.rand(3, 6, 4).astype(np.float32) * 60
    boxes[..., 2:] += boxes[..., :2] + 4
    boxes[2] = 0.0
    boxes[2, :3] = [(0, 0, 10, 10), (50, 50, 60, 60), (20, 0, 30, 10)]
    mask = rng.rand(3, 6) > 0.2
    mask[2] = [True, True, True, False, False, False]
    for overlap in (True, False):
        want = jdetection_pairs(jnp.asarray(boxes), jnp.asarray(mask),
                                overlap)
        got = detection_pairs(torch.from_numpy(boxes),
                              torch.from_numpy(mask), overlap)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    pairs, pm = detection_pairs(torch.from_numpy(boxes),
                                torch.from_numpy(mask), True)
    assert pm[2].sum() == 1 and pairs[2][pm[2]].tolist() == [[0, 0]]


@pytest.fixture(scope="module")
def jax_steps():
    """JAX's compiled retry steps, shared by the tests of the default
    detector (``sgdet_eval_with_retry``'s ``_cache``)."""
    return {}


@pytest.fixture(scope="module")
def dense(models, jax_steps):
    """JAX's dense retry step on the standard batch (its pair counts size
    the ladders below)."""
    jd, dv, jm, rv, _, _ = models
    jb, _ = _batches()
    return jretry(jd, jm, (dv, rv), jb, max_pairs=None, _cache=jax_steps)


def test_eval_step_matches_jax(models):
    jd, dv, jm, rv, td, tm = models
    jb, tb = _batches()
    want = _np(jmake_eval_step(jd, jm, score_thresh=0.05)((dv, rv), jb))
    got = make_sgdet_eval_step(td, tm, score_thresh=0.05, device="cpu")(tb)
    assert want["det_mask"].sum() >= 4
    assert_outputs_equal(got, want)


# the ladder's small rung covers the batch (taken), or misses it by one
# (skipped for the top rung); without a ladder the pairs stay dense
@pytest.mark.parametrize("ladder", ["covers", "misses", "dense"])
def test_retry_eval_step_matches_jax(models, dense, ladder):
    jd, dv, jm, rv, td, tm = models
    jb, tb = _batches()
    need = int(dense["pair_count"].max())
    assert 2 <= need < D * (D - 1) - 1
    top = min(D * (D - 1) - 1, 2 * need)
    kw = {"covers": dict(max_pairs=top, pair_ladder=(need,)),
          "misses": dict(max_pairs=top, pair_ladder=(need - 1,)),
          "dense": dict(max_pairs=None)}[ladder]
    want = dense if ladder == "dense" else _np(
        jmake_retry(jd, jm, **kw)((dv, rv), jb))
    step = make_sgdet_retry_eval_step(td, tm, device="cpu", **kw)
    got = step(tb)
    assert_outputs_equal(got, want)
    if ladder != "dense":
        assert got["pairs"].shape[1] == top
        assert step.rung_for(need) == (need if ladder == "covers" else top)
    # valid pairs and their scores are the dense run's, in its order
    for i in range(B):
        dv_, cv = dense["pair_mask"][i], want["pair_mask"][i]
        np.testing.assert_array_equal(want["pairs"][i][cv],
                                      dense["pairs"][i][dv_])


def _retry_case(models, case, need_cand):
    """(JAX detector, port detector settings, max_pairs) of a case."""
    jd, _, _, _, _, _ = models
    if case == "nms":
        # one round does not converge; after the switch to sequential NMS
        # the candidates overflow the cap, and one doubling covers them
        cap = (need_cand + 1) // 2
        return (jd.clone(nms_candidates=cap, nms_rounds=1),
                {"nms_candidates": cap, "nms_rounds": 1}, 1024)
    return jd, {}, 4  # pairs


EXPECT = {"nms": {"sgdet_nms_unconverged": 1, "sgdet_nms_cand_overflow": 1},
          "pairs": {"sgdet_pair_overflow": 1}}


@pytest.mark.parametrize("case", ["nms", "pairs"])
def test_retry_escalations_match_jax(models, dense, jax_steps, case):
    jd, dv, jm, rv, td, tm = models
    jb, tb = _batches()
    need_cand = int(dense["n_nms_candidates"].max())
    assert need_cand > 2
    jdet, settings, mp = _retry_case(models, case, need_cand)
    before = jcounters.snapshot()
    # the step cache's key leaves nms_rounds out: a fresh one for that case
    want = jretry(jdet, jm, (dv, rv), jb, max_pairs=mp,
                  _cache={} if case == "nms" else jax_steps)
    jdelta = jcounters.delta(before)
    saved = {k: getattr(td, k) for k in settings}
    try:
        for k, v in settings.items():
            setattr(td, k, v)
        before = counters.snapshot()
        got = sgdet_eval_with_retry(td, tm, tb, max_pairs=mp, device="cpu")
        tdelta = counters.delta(before)
    finally:
        for k, v in saved.items():
            setattr(td, k, v)
    assert jdelta == tdelta == {"sgdet_batches": 1, **EXPECT[case]}
    assert_outputs_equal(got, want)
    # the exact run: sequential NMS, a cap that covers everything, dense
    exact = make_sgdet_retry_eval_step(td, tm, max_pairs=None,
                                       nms_method="sequential",
                                       nms_candidates=10_000,
                                       device="cpu")(tb)
    keys = ("det_boxes", "det_labels", "det_scores", "det_mask",
            "sel_thresh", "n_det")
    for k in keys:
        np.testing.assert_array_equal(got[k], exact[k].numpy(), err_msg=k)
    for i in range(B):
        cv, ev = got["pair_mask"][i], exact["pair_mask"][i].numpy()
        np.testing.assert_array_equal(got["pairs"][i][cv],
                                      exact["pairs"][i].numpy()[ev])
        np.testing.assert_allclose(got["rel_dists"][i][cv],
                                   exact["rel_dists"][i].numpy()[ev],
                                   atol=1e-5)


def _assign_inputs():
    rng = np.random.RandomState(0)
    N, Ng, Eg = 10, 5, 6
    det_boxes = rng.rand(B, N, 4).astype(np.float32) * 80
    det_boxes[..., 2:] += det_boxes[..., :2] + 15
    det_mask = np.ones((B, N), bool)
    det_mask[:, 8:] = False
    gt_boxes = det_boxes[:, :Ng] + rng.randn(B, Ng, 4).astype(np.float32)
    gt_boxes[..., 2:] = np.maximum(gt_boxes[..., 2:], gt_boxes[..., :2] + 2)
    gt_classes = rng.randint(1, C, (B, Ng)).astype(np.int32)
    det_labels = np.concatenate(
        [gt_classes, rng.randint(1, C, (B, N - Ng))], 1).astype(np.int32)
    gt_rels = np.zeros((B, Eg, 3), np.int32)
    gt_rel_mask = np.zeros((B, Eg), bool)
    for b in range(B):
        for e in range(4 + b):
            s, o = rng.choice(Ng, 2, replace=False)
            gt_rels[b, e] = (s, o, rng.randint(1, R))
            gt_rel_mask[b, e] = True
    return (det_boxes, det_labels, det_mask, gt_boxes, gt_classes, gt_rels,
            gt_rel_mask)


def _jax_draws(key, B, Eg, N):
    """The draws of ``sgg_tpu.train.rel_assign``: per image, split its key
    into (Gumbel, FG cap, BG) keys."""
    draws = [[], [], []]
    for k in jax.random.split(key, B):
        k_fg, k_cap, k_bg = jax.random.split(k, 3)
        draws[0].append(jax.random.gumbel(k_fg, (Eg, N, N)))
        draws[1].append(jax.random.uniform(k_cap, (Eg,)))
        draws[2].append(jax.random.uniform(k_bg, (N * N,)))
    return [torch.from_numpy(np.stack([np.asarray(x) for x in d]))
            for d in draws]


# max_out 4 caps the FG pairs at 1
@pytest.mark.parametrize("max_out,overlap", [(16, False), (4, True)])
def test_rel_assignments_core_matches_jax_on_its_draws(max_out, overlap):
    inputs = _assign_inputs()
    key = jax.random.key(max_out)
    want = jrel_assignments(key, *map(jnp.asarray, inputs), max_out=max_out,
                            filter_non_overlap=overlap)
    N, Eg = inputs[0].shape[1], inputs[5].shape[1]
    got = select_rel_assignments(
        *_jax_draws(key, B, Eg, N), *map(torch.from_numpy, inputs),
        max_out=max_out, filter_non_overlap=overlap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[0][..., 2][got[1]] > 0).any()  # FG pairs were found


def test_rel_assignments_dummy_relation_when_empty():
    inputs = [np.asarray(x) for x in (
        [[[0, 0, 10, 10], [500, 500, 510, 510]]], [[1, 2]], [[True, True]],
        [[[100, 100, 120, 120], [200, 200, 220, 220]]], [[3, 4]],
        [[[0, 1, 2]]], [[True]])]
    inputs[0] = inputs[0].astype(np.float32)
    inputs[3] = inputs[3].astype(np.float32)
    key = jax.random.key(0)
    want = jrel_assignments(key, *map(jnp.asarray, inputs), max_out=8)
    got = select_rel_assignments(*_jax_draws(key, 1, 1, 2),
                                 *map(torch.from_numpy, inputs), max_out=8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[1].sum() == 1 and got[0][0, 0].tolist() == [0, 0, 0]


def test_three_sgdet_train_steps_match_jax(models, monkeypatch):
    """On identical inputs: the port's detector hands the step JAX's
    detections (the detector's own parity is ``test_torch_detector.py``),
    and JAX's step draws the relations inside while the port's takes the
    same ones (``rels=``), drawn by JAX from the same key split."""
    _no_flax_dropout(monkeypatch)
    jd, dv, jm, rv, td, _ = models
    jdetect = jax.jit(lambda im, hw: jd.apply(dv, im, hw))
    tm = RelModelIMP(**REL_KW)
    tm.load_state_dict(variables_from_jax(rv), strict=True)
    for mod in tm.modules():
        if isinstance(mod, Dropout):
            mod.p = 0.0
    kw = dict(mode="sgdet", loss="dnorm", batch_size=B, max_nodes=8,
              max_edges=16, compute_dtype="float32", lr=5e-3, clip=0.05,
              steps=(0,), l2=1e-3)
    jcfg, cfg = JConfig(**kw), Config(device="cpu", **kw)
    state = create_train_state(jcfg, rv, steps_per_epoch=2)
    jstep = jmake_train_step(jd, jm, jcfg, dv)
    opt = Optimizer(cfg, tm, steps_per_epoch=2)
    step = make_sgdet_train_step(td, tm, cfg, opt)
    for i in range(3):
        jb, tb = _batches(seed=1, idx=(2 * i, 2 * i + 1))
        key = jax.random.key(i)
        k_rel, _ = jax.random.split(key)  # as the JAX step splits it
        det = jdetect(jb.images, jb.im_hw)
        monkeypatch.setattr(td, "forward", lambda *a, det=det, **k: {
            n: torch.from_numpy(np.array(det[n])) for n in (
                "boxes", "labels", "mask", "fmap", "nms_converged")})
        rels, rmask = jrel_assignments(
            k_rel, det["boxes"], det["labels"], det["mask"], jb.boxes,
            jb.classes, jb.rels, jb.rel_mask)
        state, want = jstep(state, jb, key)
        got = step(tb, None, rels=(torch.from_numpy(np.array(rels)),
                                   torch.from_numpy(np.array(rmask))))
        assert set(got) == set(want)
        for k in want:
            w = float(want[k])
            assert abs(float(got[k]) - w) <= 1e-5 * max(abs(w), 1e-12), (
                i, k, float(got[k]), w)
    assert opt.count == int(state.step) == 3
    assert_state_close(tm, jax.tree_util.tree_map(np.asarray, state.params),
                       jax.tree_util.tree_map(np.asarray, state.batch_stats))
    # with its own detector and sampler: finite, the detector unchanged
    monkeypatch.undo()
    det0 = {k: v.clone() for k, v in td.state_dict().items()}
    got = step(tb, torch.Generator().manual_seed(0))
    assert all(np.isfinite(float(v)) for v in got.values())
    for k, v in td.state_dict().items():
        assert torch.equal(v, det0[k]), k


SPLIT_KW = dict(num_train=8, num_eval=6, num_classes=C, num_predicates=R,
                max_objects=6, image_size=64)


@pytest.fixture
def small_canvas(monkeypatch):
    for mod in (sgg_tpu.constants, sgg_torch.constants):
        monkeypatch.setattr(mod, "IM_SCALE", 64)


def test_val_epoch_sgdet_matches_jax(models, small_canvas):
    jd, dv, jm, rv, td, tm = models
    kw = dict(mode="sgdet", compute_dtype="float32", max_nodes=16,
              max_edges=12)
    want = jval_epoch(jm, rv, jsplits(**SPLIT_KW)["test_alls"],
                      JConfig(**kw), "test_alls", detector=jd,
                      det_variables=dv, verbose=False)
    got = val_epoch(tm, synthetic_splits(**SPLIT_KW)["test_alls"],
                    Config(device="cpu", **kw), "test_alls", detector=td,
                    verbose=False, device="cpu")
    keys = {k for k in want if not k.startswith("_")}
    assert keys == {k for k in got if not k.startswith("_")}
    assert "sgdet/test_alls_R@20_GC" in keys
    for k in sorted(keys):
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])
    assert got["_counters"] == want["_counters"]
    assert got["_throughput"]["sgdet"]["images"] > 0
    assert len(got["_detections"]["n_det"]) == 6
    # validation splits skip the sgdet evaluator (eval.py:34-35)
    res = val_epoch(tm, synthetic_splits(**SPLIT_KW)["val_alls"],
                    Config(device="cpu", **kw), "val_alls", detector=td,
                    verbose=False, device="cpu")
    assert not [k for k in res if not k.startswith("_")]


def test_cli_sgdet_evaluates_a_saved_detector(tmp_path, monkeypatch,
                                              small_canvas, one_thread):
    tiny_det = functools.partial(FasterRCNNVGG, **DET_KW)
    monkeypatch.setattr(detector_mod, "FasterRCNNVGG", tiny_det)
    tiny_fpn = functools.partial(detector_mod.FasterRCNNFPN, **DET_KW)
    monkeypatch.setattr(detector_mod, "FasterRCNNFPN", tiny_fpn)

    def tiny_model(config, train_data, *, device="cuda", seed=0):
        return init_weights(RelModelIMP(
            num_classes=train_data.num_classes,
            num_predicates=train_data.num_predicates, mode="sgdet",
            hidden_dim=16, obj_dim=32, backbone=config.backbone),
            seed).to(device).eval()

    monkeypatch.setattr(trainer_mod, "build_model", tiny_model)
    det_dir = str(tmp_path / "det")
    # the CLI's synthetic splits have the VG-Stanford vocabulary
    ckpt.save_detector(det_dir, detector_mod.init_detector_weights(
        tiny_det(151), 0))
    run = str(tmp_path / "run")
    argv = ["-m", "sgdet", "-split", "synthetic", "-device", "cpu",
            "-dtype", "float32", "-val_size", "4", "-nwork", "1",
            "-save_dir", run]
    results = cli.main(argv + ["-nepoch", "0", "-ckpt", det_dir])
    with open(os.path.join(run, "test_results.json")) as f:
        written = json.load(f)
    assert "sgdet/test_alls_R@100_NOGC" in written
    assert written == {k: v for k, v in results.items()
                       if not k.startswith("_")}
    assert all(v == v for v in written.values())
    # -backbone resnet50: the FPN detector's payload, its stride-64 map
    # feeding the relation head (the classifier scaled, as chip_smoke's
    # CLS_SCALE, so that a score clears the 0.01 retry floor)
    fpn = detector_mod.init_detector_weights(tiny_fpn(151), 0)
    with torch.no_grad():
        fpn.cls_score.weight.mul_(24.0)
    fpn_dir = str(tmp_path / "fpn")
    ckpt.save_detector(fpn_dir, fpn)
    results = cli.main(argv + ["-nepoch", "0", "-ckpt", fpn_dir,
                               "-backbone", "resnet50"])
    assert "sgdet/test_alls_R@100_NOGC" in results
    assert sum(len(b) for v in results["_detections"].values()
               for b in v["boxes"]) > 0
    with pytest.raises(RuntimeError, match="Missing key"):
        cli.main(argv + ["-nepoch", "0", "-ckpt", det_dir, "-backbone",
                         "resnet50"])  # a VGG payload is no FPN's
    with pytest.raises(ValueError, match="-ckpt"):
        cli.main(argv)
    with pytest.raises(FileNotFoundError):
        cli.main(argv + ["-ckpt", str(tmp_path / "empty")])


def test_sgdet_entry_points_refuse_cpu_unless_asked(models):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present; nothing to refuse")
    _, _, _, _, td, tm = models
    _, tb = _batches()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_sgdet_retry_eval_step(td, tm)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sgdet_eval_with_retry(td, tm, tb)
    cfg = Config(mode="sgdet", compute_dtype="float32")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_sgdet_train_step(td, tm, cfg, Optimizer(cfg, tm))
