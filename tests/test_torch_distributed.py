"""Data-parallel training and evaluation of the port (``sgg_torch.parallel``)
on the CPU: 2 gloo ranks, spawned processes joined through a file store
(``parallel.spawn``: each group is joined within ``JOIN_S`` and runs its
collectives under a timeout), against the same work in this process with
no group.

* the loader's shards, concatenated, are the unsharded batch;
* the global-shape draws (``sample_edges``, ``Dropout``): a rank's rows are
  the one-process rows;
* the losses' global normalizers on halves of unequal density, the synced
  BatchNorm and MaskedBatchNorm (output, input gradient, parameter
  gradients, running statistics) and the flat gradient all-reduce;
* ``Trainer.fit`` (sgcls, dnorm, dropout and the edge sampler on, the
  rank-0 feature cache, checkpoints and a resume) and a ``-gan -perturb
  graphn`` epoch on 2 ranks against 1, as ``tests/test_distributed.py``
  holds the JAX package's multi-process runs: the last interval loss within
  1e-5 relative, the test metrics within 1e-9, the GAN's F, G and D losses
  within 2e-4 relative (float32 sums taken in another order);
* mode sgdet under a group trains as with none (a 1-rank stand-in;
  ``tests/test_torch_distributed_sgdet.py`` holds 2 ranks);
* the refusals: ``-ndev 2`` without a group, ``-gan`` with sgdet under a
  group, a batch the ranks do not divide; and a rank's failure failing
  the group.

Tiny models (``tests/multihost_trainer_common.py``'s: 9 classes, 5
predicates, hidden 16, obj_dim 32, float32, 80-pixel synthetic images,
batch 8). PyTorch runs on one thread in every process. No JAX here:
``tests/test_torch_distributed_parity.py`` holds a 2-rank step and eval
against the JAX package's mesh, ``tests/test_torch_distributed_cli.py`` the
CLI under ``torchrun``."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import sgg_torch.constants
from sgg_torch import parallel
from sgg_torch.config import Config
from sgg_torch.data.pipeline import BatchLoader
from sgg_torch.data.synthetic import synthetic_splits
from sgg_torch.models.backbone import Dropout
from sgg_torch.models.gan import GANModel, init_gan_weights
from sgg_torch.models.gan.graphconv import MaskedBatchNorm
from sgg_torch.models.relhead import RelModelIMP, init_weights
from sgg_torch.models.union_features import BatchNorm
from sgg_torch.train.assign import sample_edges
from sgg_torch.train.losses import edge_losses, node_losses
from sgg_torch.train.trainer import Trainer

C, R = 9, 5
B, N, E = 8, 8, 12
IMG = 96          # the canvas (multihost_trainer_common's SGG_IM_SCALE)
GAN_IMG = 128     # the CRN needs an 8x8 map at least
WORLD = 2
JOIN_S = 120      # each spawned group ends within this or fails
LOSS_RTOL = 1e-5
METRIC_ATOL = 1e-9
GAN_RTOL = 2e-4


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_ranks(fn, *args):
    return parallel.spawn(fn, WORLD, args, device="cpu", timeout_s=JOIN_S)


# ---------------------------------------------------------------------------
# the loader's shards

@pytest.mark.parametrize("world", [2, 4])
def test_loader_shards_concatenate_to_the_batch(world):
    splits = synthetic_splits(num_train=16, num_eval=4, num_classes=C,
                              num_predicates=R, max_objects=5,
                              image_size=80)
    kw = dict(batch_size=B, max_nodes=N, max_edges=E, seed=3,
              num_workers=1, im_scale=IMG)
    full = BatchLoader(splits["train"], **kw)
    parts = [BatchLoader(splits["train"], shard=(r, world), **kw)
             for r in range(world)]
    n_batches = 0
    for epoch in range(2):  # a new order and new flips each epoch
        for loader in [full] + parts:
            loader._epoch = epoch
        for whole, *shards in zip(full, *parts):
            n_batches += 1
            for f in dataclasses.fields(whole):
                want = getattr(whole, f.name)
                if want is None:
                    continue
                got = np.concatenate([getattr(s, f.name) for s in shards])
                np.testing.assert_array_equal(got, want, err_msg=f.name)
    assert n_batches == 2 * (16 // B)


def test_loader_pads_a_tail_the_ranks_do_not_divide():
    """An eval-style loader's tail of 2 images over 4 ranks: repeated to 4
    (``sgg_tpu``'s rule), one image a rank."""
    splits = synthetic_splits(num_train=10, num_eval=4, num_classes=C,
                              num_predicates=R, max_objects=5,
                              image_size=80)
    kw = dict(batch_size=B, max_nodes=N, max_edges=E, shuffle=False,
              drop_last=False, num_workers=1, im_scale=IMG)
    whole = list(BatchLoader(splits["train"], **kw))
    assert [b.batch_size for b in whole] == [8, 2]
    for rank in range(4):
        mine = list(BatchLoader(splits["train"], shard=(rank, 4), **kw))
        assert [b.batch_size for b in mine] == [2, 1]
        np.testing.assert_array_equal(mine[0].boxes,
                                      whole[0].boxes[2 * rank:2 * rank + 2])
        np.testing.assert_array_equal(mine[1].boxes,
                                      whole[1].boxes[rank % 2:rank % 2 + 1])


def test_loader_refuses_a_batch_the_ranks_do_not_divide():
    splits = synthetic_splits(num_train=8, num_eval=4, num_classes=C,
                              num_predicates=R, image_size=80)
    with pytest.raises(ValueError, match="not divisible"):
        BatchLoader(splits["train"], batch_size=6, max_nodes=N, max_edges=E,
                    shard=(0, 4))


def test_process_local_indices_raise_on_an_undivided_batch():
    with parallel.using(parallel.Group(1, 2, torch.device("cpu"))):
        np.testing.assert_array_equal(
            parallel.process_local_indices(100, 8), [4, 5, 6, 7])
        with pytest.raises(ValueError, match="not divisible"):
            parallel.process_local_indices(100, 7)
    assert parallel.initialize(world_size=1) is None
    assert parallel.current() is None


# ---------------------------------------------------------------------------
# the global-shape draws, with a stand-in group (a draw needs no collective)

def _graph(seed=0, b=B):
    splits = synthetic_splits(num_train=b, num_eval=4, num_classes=C,
                              num_predicates=R, max_objects=5,
                              image_size=80, seed=seed)
    loader = BatchLoader(splits["train"], batch_size=b, max_nodes=N,
                         max_edges=E, num_workers=1, im_scale=IMG,
                         with_images=False)
    return next(iter(loader)).to("cpu")


@pytest.mark.parametrize("rank", range(WORLD))
def test_sample_edges_rank_rows_equal_one_process_rows(rank):
    g = _graph()
    want = sample_edges(torch.Generator().manual_seed(4), g.rels,
                        g.rel_mask, g.node_mask, max_out=E)
    mine = parallel.shard_rows(g, rank, WORLD)
    with parallel.using(parallel.Group(rank, WORLD, torch.device("cpu"))):
        got = sample_edges(torch.Generator().manual_seed(4), mine.rels,
                           mine.rel_mask, mine.node_mask, max_out=E)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, parallel.shard_rows(b, rank, WORLD),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("rank", range(WORLD))
def test_dropout_rank_rows_equal_one_process_rows(rank):
    x = torch.randn(B, 5, 32, generator=torch.Generator().manual_seed(1))
    drop = Dropout(0.5).train()
    want = drop(x, torch.Generator().manual_seed(2))
    with parallel.using(parallel.Group(rank, WORLD, torch.device("cpu"))):
        got = drop(parallel.shard_rows(x, rank, WORLD),
                   torch.Generator().manual_seed(2))
    torch.testing.assert_close(got, parallel.shard_rows(want, rank, WORLD),
                               rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the collectives of a step, one spawned group for all of them

def _loss_inputs():
    """Edge and node logits over a global batch whose two halves differ
    in density: rank 0's images have many FG edges and nodes, rank 1's
    few."""
    g = torch.Generator().manual_seed(11)
    rel_logits = torch.randn(B, E, R, generator=g)
    rel_mask = torch.zeros(B, E, dtype=torch.bool)
    labels = torch.zeros(B, E, dtype=torch.long)
    for i in range(B):
        n_valid = E if i < B // 2 else 3 + i % 2
        n_fg = n_valid - 1 if i < B // 2 else i % 2
        rel_mask[i, :n_valid] = True
        labels[i, :n_fg] = torch.randint(1, R, (n_fg,), generator=g)
    obj_logits = torch.randn(B, N, C, generator=g)
    node_mask = torch.zeros(B, N, dtype=torch.bool)
    for i in range(B):
        node_mask[i, :N if i < B // 2 else 2] = True
    classes = torch.randint(1, C, (B, N), generator=g)
    return rel_logits, labels, rel_mask, obj_logits, classes, node_mask


def _weights(loss_type):
    return (1.0, 1.0, 1.0) if loss_type == "baseline" else (1.0, 0.5, 1.0)


def _losses(rank, world, loss_type):
    """The rank's loss shares (with a group active) and their logits'
    gradients, or the one-process ones (``world`` 1)."""
    rl, lab, rm, ol, cls, nm = (parallel.shard_rows(t, rank, world)
                                for t in _loss_inputs())
    rl, ol = rl.clone().requires_grad_(), ol.clone().requires_grad_()
    losses = {**edge_losses(rl, lab, rm, loss_type, _weights(loss_type)),
              **node_losses(ol, cls, nm)}
    sum(losses.values()).backward()
    metrics = parallel.all_reduce_metrics(
        {k: v.detach() for k, v in losses.items()}, list(losses))
    return ({k: float(v) for k, v in metrics.items()},
            rl.grad.numpy(), ol.grad.numpy())


def _bn_inputs():
    g = torch.Generator().manual_seed(21)
    x = torch.randn(B, 6, 3, 3, generator=g) * 2 + 1
    w = torch.randn(B, 6, 3, 3, generator=g)
    xm = torch.randn(B, 5, 7, generator=g) * 3 - 1
    wm = torch.randn(B, 5, 7, generator=g)
    mask = torch.zeros(B, 5, dtype=torch.bool)
    for i in range(B):
        mask[i, :5 if i < B // 2 else 1 + i % 2] = True
    return x, w, xm, wm, mask


def _batchnorms(rank, world):
    """Two train-mode forwards of each BatchNorm on the rank's rows: the
    outputs, the input and parameter gradients, the running statistics."""
    x, w, xm, wm, mask = (parallel.shard_rows(t, rank, world)
                          for t in _bn_inputs())
    torch.manual_seed(0)
    bn, mbn = BatchNorm(6).train(), MaskedBatchNorm(7).train()
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5), bn.bias.uniform_(-0.5, 0.5)
        mbn.weight.uniform_(0.5, 1.5), mbn.bias.uniform_(-0.5, 0.5)
    out = {}
    for it in range(2):
        x_ = x.clone().requires_grad_()
        xm_ = xm.clone().requires_grad_()
        y, ym = bn(x_), mbn(xm_, mask)
        ((y * w).sum() + (ym * wm * mask[..., None]).sum()).backward()
        params = list(bn.parameters()) + list(mbn.parameters())
        parallel.GradReducer(params)()
        out[f"y{it}"], out[f"ym{it}"] = y.detach().numpy(), \
            ym.detach().numpy()
        out[f"dx{it}"], out[f"dxm{it}"] = x_.grad.numpy(), xm_.grad.numpy()
        for name, p in list(bn.named_parameters(prefix="bn")) + list(
                mbn.named_parameters(prefix="mbn")):
            out[f"{name}.grad{it}"] = p.grad.numpy().copy()
            p.grad = None
    for name, b in list(bn.named_buffers(prefix="bn")) + list(
            mbn.named_buffers(prefix="mbn")):
        out[name] = b.numpy().copy()
    return out


LOSS_TYPES = ("baseline", "dnorm", "dnorm-fgbg")
ROW_KEYS = ("y0", "ym0", "dx0", "dxm0", "y1", "ym1", "dx1", "dxm1")


def worker_collectives(group):
    """Every collective of a step on this rank's rows: the losses, the
    BatchNorms, the draws (with the real group), ``replicate``."""
    out = {"losses": {t: _losses(group.rank, group.world, t)
                      for t in LOSS_TYPES},
           "bn": _batchnorms(group.rank, group.world)}
    g = _graph()
    mine = parallel.shard_rows(g, group.rank, group.world)
    out["edges"] = [t.numpy() for t in sample_edges(
        torch.Generator().manual_seed(4), mine.rels, mine.rel_mask,
        mine.node_mask, max_out=E)]
    torch.manual_seed(100 + group.rank)  # each rank's own init
    lin = torch.nn.Linear(4, 3)
    parallel.replicate(lin, group, check=True)
    out["replicated"] = lin.weight.detach().numpy()
    out["host_mean"] = parallel.host_mean(float(group.rank))
    return out


@pytest.fixture(scope="module")
def collectives():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return run_ranks(worker_collectives)
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("loss_type", LOSS_TYPES)
def test_loss_normalizers_are_global_on_unequal_halves(collectives,
                                                       loss_type):
    want, d_rel, d_obj = _losses(0, 1, loss_type)
    for rank, res in enumerate(collectives):
        got, g_rel, g_obj = res["losses"][loss_type]
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL,
                                       err_msg=k)
        np.testing.assert_allclose(
            g_rel, parallel.shard_rows(d_rel, rank, WORLD), rtol=0,
            atol=1e-7)
        np.testing.assert_allclose(
            g_obj, parallel.shard_rows(d_obj, rank, WORLD), rtol=0,
            atol=1e-7)
    # the per-rank mean DDP would give is not the loss: the halves differ
    local = {}
    for rank in range(WORLD):
        rl, lab, rm, ol, cls, nm = (parallel.shard_rows(t, rank, WORLD)
                                    for t in _loss_inputs())
        for k, v in edge_losses(rl, lab, rm, loss_type,
                                _weights(loss_type)).items():
            local.setdefault(k, []).append(float(v))
    if loss_type != "baseline":
        assert abs(np.mean(local["rel_loss"]) - want["rel_loss"]) \
            > 10 * LOSS_RTOL * abs(want["rel_loss"])


@pytest.mark.parametrize("key", ROW_KEYS)
def test_synced_batchnorms_match_one_process(collectives, key):
    want = _batchnorms(0, 1)
    for rank, res in enumerate(collectives):
        np.testing.assert_allclose(
            res["bn"][key], parallel.shard_rows(want[key], rank, WORLD),
            rtol=1e-5, atol=1e-6, err_msg=key)


def test_synced_batchnorm_statistics_and_grads_match(collectives):
    want = _batchnorms(0, 1)
    for res in collectives:
        for k, v in want.items():
            if k in ROW_KEYS:
                continue
            np.testing.assert_allclose(res["bn"][k], v, rtol=1e-5,
                                       atol=1e-6, err_msg=k)


def test_group_draws_replicate_and_host_mean(collectives):
    g = _graph()
    want = [t.numpy() for t in sample_edges(
        torch.Generator().manual_seed(4), g.rels, g.rel_mask, g.node_mask,
        max_out=E)]
    for rank, res in enumerate(collectives):
        for a, b in zip(res["edges"], want):
            np.testing.assert_array_equal(a, parallel.shard_rows(b, rank,
                                                                 WORLD))
        np.testing.assert_array_equal(res["replicated"],
                                      collectives[0]["replicated"])
        assert res["host_mean"] == 0.5


# ---------------------------------------------------------------------------
# the trainer

def _splits():
    return synthetic_splits(num_train=16, num_eval=4, num_classes=C,
                            num_predicates=R, max_objects=5, image_size=80)


def _model(mode="sgcls", use_bias=True):
    return init_weights(RelModelIMP(num_classes=C, num_predicates=R,
                                    mode=mode, use_bias=use_bias,
                                    hidden_dim=16, obj_dim=32), 0)


def _fit_config(workdir, **kw):
    return Config(device="cpu", batch_size=B, max_nodes=N, max_edges=E,
                  mode="sgcls", loss="dnorm", num_epochs=2,
                  print_interval=1, compute_dtype="float32", use_bias=True,
                  steps=(1,), num_workers=1,
                  save_dir=os.path.join(workdir, "ckpt"),
                  feature_cache=os.path.join(workdir, "fcache"), **kw)


def run_fit(workdir, group=None):
    """``Trainer.fit`` (2 epochs, val after the first, test), then a resume
    from the same ``save_dir``: the interval losses, the test results, the
    resumed epoch, the re-test, which ranks extracted a feature cache and
    which wrote the test results."""
    sgg_torch.constants.IM_SCALE = IMG
    splits = _splits()
    trainer = Trainer(_fit_config(workdir), splits, model=_model(),
                      with_images=False, group=group)
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
    caches = sorted(trainer._feature_caches)
    again = Trainer(_fit_config(workdir), splits, model=_model(),
                    with_images=False, group=group)
    resumed = again.start_epoch
    retest = again.fit(val_names=("val_alls",), test_names=("test_alls",))
    scalars = lambda r: {k: v for k, v in r.items()  # noqa: E731
                         if not k.startswith("_")}
    return {"losses": [d["loss/total"] for d in logged if "loss/total" in d],
            "test": scalars(results), "retest": scalars(retest),
            "resumed": resumed, "caches": caches, **calls,
            "results_file": os.path.exists(os.path.join(
                workdir, "ckpt", "test_results.json"))}


def worker_fit(group, workdir):
    return run_fit(workdir, group)


def test_trainer_fit_on_two_ranks_matches_one(tmp_path, monkeypatch):
    got = run_ranks(worker_fit, str(tmp_path / "ranks"))
    monkeypatch.setattr(sgg_torch.constants, "IM_SCALE", IMG)
    want = run_fit(str(tmp_path / "one"))
    assert len(want["losses"]) == 2 * (16 // B)
    assert got[0]["losses"] == got[1]["losses"]
    assert got[0]["test"] == got[1]["test"]
    np.testing.assert_allclose(got[0]["losses"][-1], want["losses"][-1],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(got[0]["losses"], want["losses"],
                               rtol=LOSS_RTOL)
    assert set(got[0]["test"]) == set(want["test"]) and want["test"]
    for k, v in want["test"].items():
        np.testing.assert_allclose(got[0]["test"][k], v, atol=METRIC_ATOL,
                                   err_msg=k)
    for res in got:
        assert res["resumed"] == 2
        for k, v in res["test"].items():
            np.testing.assert_allclose(res["retest"][k], v,
                                       atol=METRIC_ATOL, err_msg=k)
        assert res["caches"] == ["test_alls", "train", "val_alls"]
        assert res["results_file"]
    # rank 0 alone extracted the caches and wrote the results
    assert got[0]["extract"] == 3 and got[1]["extract"] == 0
    assert got[0]["write"] == 1 and got[1]["write"] == 0


def _gan_config(workdir):
    return Config(device="cpu", batch_size=B, max_nodes=N, max_edges=E,
                  mode="sgcls", loss="dnorm", num_epochs=1,
                  print_interval=1, val_size=0, notest=True,
                  compute_dtype="float32", gan=True,
                  ganlosses=("D", "G", "rec"), perturb="graphn", L=0.5,
                  num_workers=1, save_dir=os.path.join(workdir, "gan"))


def run_gan_epoch(workdir, group=None):
    """One ``-gan -perturb graphn`` epoch: the interval losses by key."""
    sgg_torch.constants.IM_SCALE = GAN_IMG
    splits = _splits()
    gan = init_gan_weights(GANModel(C, R, embed_dim=16, hidden_dim=8,
                                    fmap_sz=GAN_IMG // 16, n_layers_G=2),
                           1)
    trainer = Trainer(_gan_config(workdir), splits,
                      model=_model(use_bias=False), gan=gan,
                      with_images=False, group=group)
    logged = []
    trainer.log_fn = lambda d, **kw: logged.append(dict(d))
    trainer.fit()
    # the loss means: the interval's times (``time/``) differ by rank
    return {k: [d[k] for d in logged] for k in logged[0]
            if k.startswith("loss/")}


def worker_gan(group, workdir):
    return run_gan_epoch(workdir, group)


GAN_KEYS = ("obj_loss", "rel_loss", "G_obj", "G_rel", "G_fmap",
            "obj_loss_rec", "rel_loss_rec", "D_obj", "D_rel", "D_fmap")


def test_gan_epoch_on_two_ranks_matches_one(tmp_path, monkeypatch):
    got = run_ranks(worker_gan, str(tmp_path / "ranks"))
    monkeypatch.setattr(sgg_torch.constants, "IM_SCALE", GAN_IMG)
    want = run_gan_epoch(str(tmp_path / "one"))
    assert got[0] == got[1]
    for k in GAN_KEYS:
        assert len(want[f"loss/{k}"]) == 16 // B
        np.testing.assert_allclose(got[0][f"loss/{k}"], want[f"loss/{k}"],
                                   rtol=GAN_RTOL, err_msg=k)


# ---------------------------------------------------------------------------
# refusals and failures

def test_ndev_without_a_group_names_torchrun():
    cfg = Config(device="cpu", batch_size=B, max_nodes=N, max_edges=E,
                 num_devices=2, num_workers=1)
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        Trainer(cfg, _splits(), model=_model())


def test_sgdet_trains_under_a_group_and_gan_sgdet_is_refused(monkeypatch):
    """Mode sgdet under a group (a 1-rank stand-in: every collective the
    identity) trains as with none; ``-gan`` with sgdet is still refused
    under a group of 2. ``tests/test_torch_distributed_sgdet.py`` holds 2
    ranks against one process."""
    from sgg_torch.models.detector import FasterRCNNVGG, init_detector_weights
    monkeypatch.setattr(sgg_torch.constants, "IM_SCALE", IMG)
    cfg = Config(device="cpu", mode="sgdet", batch_size=B, max_nodes=N,
                 max_edges=E, num_workers=1, print_interval=1,
                 compute_dtype="float32")
    losses = []
    for group in (parallel.Group(0, 1, torch.device("cpu")), None):
        det = init_detector_weights(FasterRCNNVGG(
            C, rpn_pre_nms_top_n=64, rpn_post_nms_top_n=24,
            detections_per_img=8, obj_dim=48, score_thresh=0.01), 0)
        trainer = Trainer(cfg, _splits(), model=_model("sgdet", False),
                          detector=det, group=group)
        losses.append(trainer.train_epoch(0))
    assert losses[0] == losses[1] and np.isfinite(losses[0]["total"])
    with pytest.raises(ValueError, match="-gan trains on the GT boxes"):
        Trainer(dataclasses.replace(cfg, gan=True), _splits(),
                detector=object(),
                group=parallel.Group(0, 2, torch.device("cpu")))


def worker_fails(group):
    if group.rank == 1:
        raise RuntimeError("rank 1 fails")
    parallel.sync_processes("never", timeout_s=30)


def test_a_failing_rank_fails_the_group():
    # rank 1 raises; rank 0's barrier then fails too (its peer closed the
    # connection), and whichever exits first is reported
    with pytest.raises(RuntimeError, match="rank [01] exited with code 1"):
        run_ranks(worker_fails)


# ---------------------------------------------------------------------------
# workers of tests/test_torch_distributed_parity.py (which imports JAX; the
# ranks import only this file)

def _loaded_model(state, model_kw):
    model = RelModelIMP(**model_kw)
    model.load_state_dict(state, strict=True)
    for mod in model.modules():
        if isinstance(mod, Dropout):
            mod.p = 0.0
    return model


def worker_step(group, state, model_kw, cfg_kw, batch, edges):
    """One train step of the model of ``state`` (dropout off) on this
    rank's rows of the host ``batch`` and of the given ``edges``: the
    metrics and the updated trainable state."""
    from sgg_torch.train.state import Optimizer
    from sgg_torch.train.step import make_train_step
    model = _loaded_model(state, model_kw)
    cfg = Config(device="cpu", **cfg_kw)
    opt = Optimizer(cfg, model, steps_per_epoch=2)
    step = make_train_step(model, cfg, opt)
    rows = lambda x: parallel.shard_rows(x, group.rank,  # noqa: E731
                                         group.world)
    metrics = step(rows(batch), None,
                   edges=tuple(rows(torch.as_tensor(e)) for e in edges))
    return ({k: float(v) for k, v in metrics.items()},
            {k: v.numpy().copy() for k, v in model.state_dict().items()
             if not k.startswith("trunk.")})


def worker_val(group, state, model_kw, cfg_kw, split_kw, im_scale,
               eval_batch_size):
    """``val_epoch`` of the model of ``state`` over the synthetic
    ``test_alls`` split, the eval batches split over the ranks."""
    from sgg_torch.eval.driver import val_epoch
    sgg_torch.constants.IM_SCALE = im_scale
    model = _loaded_model(state, model_kw).eval()
    res = val_epoch(model, synthetic_splits(**split_kw)["test_alls"],
                    Config(device="cpu", **cfg_kw), "test_alls",
                    eval_batch_size=eval_batch_size, verbose=False,
                    device="cpu", group=group)
    return {k: v for k, v in res.items()
            if not k.startswith("_") or k == "_counters"}

