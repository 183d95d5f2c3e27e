"""Data-parallel SGDet training of the port on the CPU: 2 gloo ranks
(``parallel.spawn``: spawned processes joined within ``JOIN_S``, their
collectives under a timeout) against the same work in this process with
no group.

* ``rel_assignments``' draws (the Gumbel noise, the FG-cap and the BG
  uniforms), with a stand-in group of 2 and of 4: a rank's rows are the
  one-process rows;
* one SGDet train step (dnorm, dropout on, the sampler drawing) behind a
  frozen ``FasterRCNNVGG`` and behind a frozen ``FasterRCNNFPN``, 2 images
  a rank against one process of 4: the losses within 1e-6 relative,
  ``nms_converged_frac`` the global share, the gradients before the clip
  within 1e-5 of the largest gradient and the updated relation model
  within 1e-5 of the largest update, both ranks the same bits;
* ``Trainer.fit`` in mode sgdet (the detector trunk's feature cache, a
  checkpoint, the SGDet evaluation) on 2 ranks against one process: the
  interval losses within 1e-5 relative (the second step's starts from
  updates that differ in the last bits: the limit of
  ``tests/test_torch_distributed.py``'s ``Trainer.fit``), the test
  metrics within 1e-9;
  rank 0 alone extracts the cache and writes the test results.

Tiny models (``FasterRCNNVGG``/``FasterRCNNFPN`` with 8 detections an
image and small heads over the full trunks, a trunk-free IMP relation
model with hidden 16 and obj_dim 32, float32, 96-px synthetic images).
PyTorch runs on one thread in every process. No JAX here:
``tests/test_torch_distributed_sgdet_parity.py`` holds the 2-rank step
against the JAX package's sgdet step on its 8-device mesh."""

import os

import numpy as np
import pytest
import torch

import sgg_torch.constants
from sgg_torch import parallel
from sgg_torch.config import Config
from sgg_torch.data.synthetic import SyntheticSGGDataset, synthetic_splits
from sgg_torch.models.backbone import Dropout
from sgg_torch.models.detector import (FasterRCNNFPN, FasterRCNNVGG,
                                       init_detector_weights)
from sgg_torch.models.relhead import RelModelIMP, init_weights
from sgg_torch.models.sgdet import make_sgdet_train_step
from sgg_torch.train.rel_assign import rel_assignments
from sgg_torch.train.state import Optimizer
from sgg_torch.train.trainer import Trainer

C, R, IMG = 8, 5, 96
B, N, E = 4, 8, 16
WORLD = 2
JOIN_S = 120
LOSS_RTOL = 1e-6
FIT_RTOL = 1e-5
GRAD_LIMIT = 1e-5
UPDATE_LIMIT = 1e-5
METRIC_ATOL = 1e-9
DET_KW = dict(rpn_pre_nms_top_n=64, rpn_post_nms_top_n=24,
              detections_per_img=8, obj_dim=48, score_thresh=0.01)
DETECTORS = {"vgg": FasterRCNNVGG, "fpn": FasterRCNNFPN}
BACKBONE = {"vgg": "vgg16", "fpn": "resnet50"}
CFG_KW = dict(mode="sgdet", loss="dnorm", batch_size=B, max_nodes=N,
              max_edges=E, compute_dtype="float32", lr=5e-3, clip=0.05,
              steps=(0,), l2=1e-3)
SEED = 3


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed=1):
    return SyntheticSGGDataset(
        num_images=B, num_classes=C, num_predicates=R, max_objects=5,
        image_size=IMG, with_images=True, seed=seed).batch(
            list(range(B)), max_nodes=N, max_edges=E)


def _relmodel(kind, dropout=True):
    model = init_weights(RelModelIMP(
        num_classes=C, num_predicates=R, mode="sgdet", hidden_dim=16,
        obj_dim=32, backbone=BACKBONE[kind]), 1)
    if not dropout:
        for mod in model.modules():
            if isinstance(mod, Dropout):
                mod.p = 0.0
    return model


def _detector(kind):
    return init_detector_weights(DETECTORS[kind](C, **DET_KW), 0) \
        .requires_grad_(False).eval()


def run_sgdet_step(kind, batch=None, rels=None, det=None, state=None,
                   cfg_kw=CFG_KW):
    """One SGDet train step behind the ``kind`` detector on ``batch`` (the
    rank's rows under the active group): the metrics, the relation model's
    gradients before the clip and its state after. ``rels`` (global, as
    ``rel_assignments`` returns them) replaces the sampler; ``det``
    (global detector outputs) the detector; ``state`` the relation model's
    seeded weights (then with dropout off)."""
    group = parallel.current()
    rows = (lambda x: x) if group is None else (  # noqa: E731
        lambda x: parallel.shard_rows(x, group.rank, group.world))
    detector = _detector(kind)
    if det is not None:
        mine = {k: rows(torch.as_tensor(v)) for k, v in det.items()}
        detector.forward = lambda *a, **k: mine
    model = _relmodel(kind, dropout=state is None)
    if state is not None:
        model.load_state_dict(state, strict=True)
    cfg = Config(device="cpu", **cfg_kw)
    opt = Optimizer(cfg, model, steps_per_epoch=2)
    grads = {}
    apply = opt.apply_gradients

    def apply_recorded():
        grads.update({n: p.grad.numpy().copy()
                      for n, p in model.named_parameters()})
        return apply()

    opt.apply_gradients = apply_recorded
    step = make_sgdet_train_step(detector, model, cfg, opt)
    metrics = step(rows(_batch() if batch is None else batch),
                   torch.Generator().manual_seed(SEED),
                   rels=None if rels is None else tuple(
                       rows(torch.as_tensor(r)) for r in rels))
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": grads,
            "after": {k: v.numpy().copy()
                      for k, v in model.state_dict().items()}}


def _fit_config(workdir):
    return Config(device="cpu", batch_size=B, max_nodes=N, max_edges=E,
                  mode="sgdet", loss="dnorm", num_epochs=1,
                  print_interval=1, compute_dtype="float32", steps=(1,),
                  num_workers=1, save_dir=os.path.join(workdir, "ckpt"),
                  feature_cache=os.path.join(workdir, "fcache"))


def run_sgdet_fit(workdir, group=None):
    """``Trainer.fit`` in mode sgdet (one epoch of 2 steps, val, test): the
    interval losses, the test results, the caches, which ranks extracted
    a cache and which wrote the test results."""
    sgg_torch.constants.IM_SCALE = IMG
    splits = synthetic_splits(num_train=2 * B, num_eval=4, num_classes=C,
                              num_predicates=R, max_objects=5,
                              image_size=IMG)
    trainer = Trainer(_fit_config(workdir), splits, model=_relmodel("vgg"),
                      detector=_detector("vgg"), group=group)
    calls = {"extract": 0, "write": 0}
    extract, write = trainer._open_or_extract, trainer._write_results

    def counted_extract(*a, **kw):
        calls["extract"] += 1
        return extract(*a, **kw)

    def counted_write(*a, **kw):
        calls["write"] += 1
        return write(*a, **kw)

    trainer._open_or_extract, trainer._write_results = counted_extract, \
        counted_write
    logged = []
    trainer.log_fn = lambda d, **kw: logged.append(dict(d))
    results = trainer.fit(val_names=("val_alls",), test_names=("test_alls",))
    return {"losses": {k: [d[k] for d in logged if k in d]
                       for k in ("loss/total", "loss/nms_converged_frac")},
            "test": {k: v for k, v in results.items()
                     if not k.startswith("_")},
            "caches": sorted(trainer._feature_caches), **calls,
            "results_file": os.path.exists(os.path.join(
                workdir, "ckpt", "test_results.json")),
            "checkpoint": os.path.exists(os.path.join(
                workdir, "ckpt", "vgrel-0.pth"))}


def worker_sgdet(group, workdir):
    return {"vgg": run_sgdet_step("vgg"), "fpn": run_sgdet_step("fpn"),
            "fit": run_sgdet_fit(workdir, group)}


def worker_sgdet_given(group, kind, batch, rels, det, state, cfg_kw):
    """The step with the relations and the detections given (the JAX
    parity file's worker)."""
    return run_sgdet_step(kind, batch, rels, det, state, cfg_kw)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return parallel.spawn(worker_sgdet, WORLD,
                              (str(tmp_path_factory.mktemp("ranks")),),
                              device="cpu", timeout_s=JOIN_S)
    finally:
        torch.set_num_threads(n)


def loss_errs(got, want):
    assert set(got) == set(want)
    return {k: abs(got[k] - w) / max(abs(w), 1e-30) for k, w in want.items()}


def grad_err(got, want):
    assert set(got) == set(want)
    diff = max(float(np.abs(got[k] - w).max()) for k, w in want.items())
    return diff / max(float(np.abs(w).max()) for w in want.values())


def update_err(got, want, before):
    keys = [k for k in want if "num_batches" not in k]
    diff = max(float(np.abs(got[k] - want[k]).max()) for k in keys)
    return diff / max(float(np.abs(want[k] - before[k]).max())
                      for k in keys)


# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world,rank", [(world, rank) for world in (2, 4)
                                        for rank in range(world)])
def test_rel_assignments_rank_rows_equal_one_process_rows(world, rank):
    g = torch.Generator().manual_seed(0)
    det_boxes = torch.rand(B, N, 4, generator=g) * 60
    det_boxes[..., 2:] += det_boxes[..., :2] + 20
    det_labels = torch.randint(1, C, (B, N), generator=g)
    det_mask = torch.ones(B, N, dtype=torch.bool)
    batch = _batch()
    gt = [torch.from_numpy(x) for x in (batch.boxes, batch.classes,
                                        batch.rels, batch.rel_mask)]
    # the detections' first boxes are the GT's, so FG pairs exist
    det_boxes[:, :gt[0].shape[1]] = gt[0]
    det_labels[:, :gt[1].shape[1]] = gt[1].long()
    inputs = (det_boxes, det_labels, det_mask, *gt)
    want = rel_assignments(torch.Generator().manual_seed(4), *inputs)
    mine = [parallel.shard_rows(x, rank, world) for x in inputs]
    with parallel.using(parallel.Group(rank, world, torch.device("cpu"))):
        got = rel_assignments(torch.Generator().manual_seed(4), *mine)
    assert (want[0][..., 2][want[1]] > 0).any()  # FG pairs were drawn
    for a, b in zip(got, want):
        torch.testing.assert_close(a, parallel.shard_rows(b, rank, world),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("kind", sorted(DETECTORS))
def test_sgdet_step_on_two_ranks_matches_one(ranks, kind):
    want = run_sgdet_step(kind)
    before = {k: v.numpy() for k, v in _relmodel(kind).state_dict().items()}
    for res in ranks:
        got = res[kind]
        errs = loss_errs(got["metrics"], want["metrics"])
        assert max(errs.values()) <= LOSS_RTOL, errs
        assert got["metrics"]["nms_converged_frac"] \
            == want["metrics"]["nms_converged_frac"]
        assert grad_err(got["grads"], want["grads"]) <= GRAD_LIMIT
        assert update_err(got["after"], want["after"], before) \
            <= UPDATE_LIMIT
    for k, v in ranks[0][kind]["after"].items():
        np.testing.assert_array_equal(ranks[1][kind]["after"][k], v,
                                      err_msg=k)


def test_sgdet_trainer_fit_on_two_ranks_matches_one(ranks, tmp_path,
                                                     monkeypatch):
    monkeypatch.setattr(sgg_torch.constants, "IM_SCALE", IMG)
    want = run_sgdet_fit(str(tmp_path / "one"))
    got = [r["fit"] for r in ranks]
    assert len(want["losses"]["loss/total"]) == 2
    assert got[0]["losses"] == got[1]["losses"]
    assert got[0]["test"] == got[1]["test"]
    for k, v in want["losses"].items():
        np.testing.assert_allclose(got[0]["losses"][k], v, rtol=FIT_RTOL,
                                   err_msg=k)
    assert set(got[0]["test"]) == set(want["test"]) and want["test"]
    assert any(k.startswith("sgdet/") for k in want["test"])
    for k, v in want["test"].items():
        np.testing.assert_allclose(got[0]["test"][k], v, atol=METRIC_ATOL,
                                   err_msg=k)
    for res in got:
        assert res["caches"] == want["caches"] == ["test_alls", "train"]
        assert res["results_file"] and res["checkpoint"]
    # rank 0 alone extracted the caches and wrote the results
    assert got[0]["extract"] == want["extract"] == 2
    assert got[1]["extract"] == 0
    assert got[0]["write"] == 1 and got[1]["write"] == 0
