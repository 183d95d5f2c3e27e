"""The port's (data x edge) mesh (``parallel.make_mesh_2d``,
``shard_batch_edges``) on the CPU: spawned gloo ranks (``parallel.spawn``:
each group joined within ``JOIN_S``, its collectives under a timeout)
against the same work in this process with no group.

* the mesh's coordinates and its edge and data groups against
  ``np.arange(world).reshape(data, edge)`` (a sum over each group of a
  one-hot of the rank names its members);
* the draws, with a stand-in mesh (a draw needs no collective): a dropout
  over edges keeps the one-process draw's data rows and edge slots, a
  dropout over nodes the same data rows on every edge rank;
* one sgcls dnorm train step (dropout on, the sampler drawing, the
  frequency bias on) on 2 x 2 (4 ranks), 1 x 2 and 2 x 1 (2 ranks) against
  one process on the same batch and generator seed: the losses within
  1e-6 relative, the gradients before the clip within 1e-5 of the largest
  gradient, the updated parameters and the union BatchNorms' running
  statistics within 1e-5 of the largest update; each rank's union
  RoIAlign pools ``B / data`` x ``E / edge`` boxes;
* the same step with the edge group's all-reduce of ``vert_ctx`` removed,
  or with the dropout draws sliced by world rank (a 1-D group's rule),
  is not the one-process step;
* the refusals: a mesh that does not cover the world, an ``E`` that the
  edge axis does not divide, the union dedup, ``val_epoch``, the trainer,
  the SGDet and GAN steps on an edge axis.

Tiny model (9 classes, 5 predicates, hidden 16, obj_dim 32, float32, 64-px
synthetic images, batch 4, 12 edges). PyTorch runs on one thread in every
process. No JAX here: ``tests/test_torch_edge_mesh_parity.py`` holds the
mesh step against the JAX package's ``make_mesh_2d(2, 4)`` step."""

import numpy as np
import pytest
import torch

from sgg_torch import parallel
from sgg_torch.config import Config
from sgg_torch.data.synthetic import SyntheticSGGDataset, synthetic_splits
from sgg_torch.eval.driver import val_epoch
from sgg_torch.models import backbone as backbone_mod
from sgg_torch.models import relhead as relhead_mod
from sgg_torch.models.backbone import Dropout
from sgg_torch.models.relhead import RelModelIMP, init_weights
from sgg_torch.train.state import Optimizer
from sgg_torch.train.step import make_train_step
from sgg_torch.train.trainer import Trainer

C, R, IMG = 9, 5, 64
B, N, E = 4, 8, 12
JOIN_S = 120
LOSS_RTOL = 1e-6
GRAD_LIMIT = 1e-5
UPDATE_LIMIT = 1e-5
MODEL_KW = dict(num_classes=C, num_predicates=R, hidden_dim=16, obj_dim=32,
                use_bias=True)
CFG_KW = dict(mode="sgcls", loss="dnorm", batch_size=B, max_nodes=N,
              max_edges=E, compute_dtype="float32", lr=5e-3, clip=0.05,
              steps=(0,), l2=1e-3)
SEED = 7


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(b=B, seed=5):
    return SyntheticSGGDataset(
        num_images=b, num_classes=C, num_predicates=R, max_objects=6,
        image_size=IMG, with_images=True, seed=seed).batch(
            list(range(b)), max_nodes=N, max_edges=E)


def _model():
    return init_weights(RelModelIMP(**MODEL_KW), 0)


def world_rows_rand(shape, generator, device, edge_axis=None):
    """The draw of a 1-D group: the rank's rows by world rank."""
    group = parallel.current()
    if group is None or group.world == 1:
        return torch.rand(tuple(shape), generator=generator, device=device)
    b = shape[0]
    full = torch.rand((b * group.world, *shape[1:]), generator=generator,
                      device=device)
    return full[group.rank * b:(group.rank + 1) * b]


def run_step(batch, mesh=None, fault=None, edges=None, model_kw=MODEL_KW,
             cfg_kw=CFG_KW, state=None, dropout=True):
    """One train step of the tiny model on ``batch`` (the rank's part on
    ``mesh``, whose group is then active): the metrics, the gradients
    before the clip, the updated state (trunk left out) and the boxes
    each RoIAlign call pooled. ``fault`` names a broken copy of the step:
    ``no_edge_sum`` (the node update sums only the rank's edges) or
    ``world_rows`` (the draws sliced by world rank)."""
    model = RelModelIMP(**model_kw)
    if state is None:
        init_weights(model, 0)
    else:
        model.load_state_dict(state, strict=True)
    if not dropout:
        for mod in model.modules():
            if isinstance(mod, Dropout):
                mod.p = 0.0
    cfg = Config(device="cpu", **cfg_kw)
    opt = Optimizer(cfg, model, steps_per_epoch=2)
    step = make_train_step(model, cfg, opt)
    grads, pooled = {}, []
    apply = opt.apply_gradients

    def apply_recorded():
        grads.update({n: p.grad.numpy().copy()
                      for n, p in model.named_parameters()
                      if p.grad is not None})
        return apply()

    opt.apply_gradients = apply_recorded
    roi_align = relhead_mod.roi_align

    def recorded(fmap, boxes, **kw):
        pooled.append(tuple(boxes.shape))
        return roi_align(fmap, boxes, **kw)

    saved = (relhead_mod.roi_align, relhead_mod.edge_all_reduce,
             backbone_mod.global_rand)
    relhead_mod.roi_align = recorded
    if fault == "no_edge_sum":
        relhead_mod.edge_all_reduce = lambda x: x
    elif fault == "world_rows":
        backbone_mod.global_rand = world_rows_rand
    if edges is not None:
        edges = tuple(torch.as_tensor(e) for e in edges)
    if mesh is not None:
        batch = parallel.shard_batch_edges(batch, mesh)
        if edges is not None:  # the rank's rows, all E slots
            edges = tuple(parallel.shard_rows(e, mesh.data_rank, mesh.data)
                          for e in edges)
    try:
        with parallel.using(mesh):
            metrics = step(batch, torch.Generator().manual_seed(SEED),
                           edges=edges)
    finally:
        (relhead_mod.roi_align, relhead_mod.edge_all_reduce,
         backbone_mod.global_rand) = saved
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": grads, "pooled": pooled,
            "after": {k: v.numpy().copy()
                      for k, v in model.state_dict().items()
                      if not k.startswith("trunk.")}}


def _members(mesh, sub):
    """The ranks of the process group ``sub``, from a sum of one-hots."""
    import torch.distributed as dist
    hot = torch.zeros(mesh.world)
    hot[mesh.rank] = 1.0
    dist.all_reduce(hot, group=sub)
    return np.flatnonzero(hot.numpy()).tolist()


def worker_mesh(group, shapes, faults):
    """For each (data, edge) of ``shapes``: the mesh's coordinates and
    groups, and the train step on it (and, on the first shape, its broken
    copies named in ``faults``). A mesh that does not cover the world
    raises."""
    out = {}
    with pytest.raises(ValueError, match="does not cover"):
        parallel.make_mesh_2d(group.world + 1, 1, group)
    batch = _batch()
    for i, (data, edge) in enumerate(shapes):
        mesh = parallel.make_mesh_2d(data, edge, group)
        res = {"coords": (mesh.data_rank, mesh.edge_rank, mesh.data,
                          mesh.edge),
               "edge_members": _members(mesh, mesh.edge_group),
               "data_members": _members(mesh, mesh.data_group),
               "step": run_step(batch, mesh)}
        for fault in (faults if i == 0 else ()):
            res[fault] = run_step(batch, mesh, fault)
        out[(data, edge)] = res
    return out


def worker_mesh_given(group, shape, batch, edges, state, model_kw, cfg_kw):
    """The step on the ``shape`` mesh from ``state`` (dropout off) with the
    global sampled ``edges`` given (the JAX parity file's worker)."""
    mesh = parallel.make_mesh_2d(*shape, group)
    return run_step(batch, mesh, edges=edges, model_kw=model_kw,
                    cfg_kw=cfg_kw, state=state, dropout=False)


def run_ranks(world, shapes, faults=()):
    return parallel.spawn(worker_mesh, world, (shapes, faults), device="cpu",
                          timeout_s=JOIN_S)


SHAPES = {4: [(2, 2)], 2: [(1, 2), (2, 1)]}
FAULTS = ("no_edge_sum", "world_rows")


@pytest.fixture(scope="module")
def one():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return run_step(_batch())
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = {}
        for world, shapes in SHAPES.items():
            res = run_ranks(world, shapes, FAULTS if world == 2 else ())
            for shape in shapes:
                out[shape] = [r[shape] for r in res]
        return out
    finally:
        torch.set_num_threads(n)


def _update_err(got, want, before):
    diff = max(float(np.abs(got[k] - w).max()) for k, w in want.items()
               if "num_batches" not in k)
    upd = max(float(np.abs(w - before[k]).max()) for k, w in want.items()
              if "num_batches" not in k)
    return diff / upd


def _grad_err(got, want):
    assert set(got) == set(want)
    diff = max(float(np.abs(got[k] - w).max()) for k, w in want.items())
    return diff / max(float(np.abs(w).max()) for w in want.values())


def _loss_errs(got, want):
    assert set(got) == set(want)
    return {k: abs(got[k] - w) / max(abs(w), 1e-30) for k, w in want.items()}


ALL_SHAPES = [s for shapes in SHAPES.values() for s in shapes]


@pytest.mark.parametrize("shape", ALL_SHAPES, ids=lambda s: "x".join(
    map(str, s)))
def test_mesh_coordinates_and_groups(ranks, shape):
    data, edge = shape
    grid = np.arange(data * edge).reshape(data, edge)
    for rank, res in enumerate(ranks[shape]):
        d, k = divmod(rank, edge)
        assert res["coords"] == (d, k, data, edge)
        assert res["edge_members"] == grid[d].tolist()
        assert res["data_members"] == grid[:, k].tolist()


@pytest.mark.parametrize("shape", ALL_SHAPES, ids=lambda s: "x".join(
    map(str, s)))
def test_mesh_step_matches_one_process(ranks, one, shape):
    data, edge = shape
    before = {k: v.numpy() for k, v in _model().state_dict().items()
              if not k.startswith("trunk.")}
    for res in ranks[shape]:
        got = res["step"]
        errs = _loss_errs(got["metrics"], one["metrics"])
        assert max(errs.values()) <= LOSS_RTOL, errs
        assert _grad_err(got["grads"], one["grads"]) <= GRAD_LIMIT
        assert _update_err(got["after"], one["after"], before) \
            <= UPDATE_LIMIT
        # the union BatchNorms' running statistics moved, as one process's
        for k in ("union_feats.bn1.running_mean",
                  "union_feats.bn2.running_var"):
            assert not np.allclose(one["after"][k], before[k])
            np.testing.assert_allclose(got["after"][k], one["after"][k],
                                       rtol=1e-5, atol=1e-7, err_msg=k)
        # the nodes of B / data images, the unions of their E / edge slots
        assert got["pooled"] == [(B // data, N, 4), (B // data, E // edge, 4)]
    assert one["metrics"]["grad_norm"] > CFG_KW["clip"]  # the clip is taken
    assert one["pooled"] == [(B, N, 4), (B, E, 4)]
    # every rank of the mesh holds the same state after the step
    for res in ranks[shape][1:]:
        for k, v in ranks[shape][0]["step"]["after"].items():
            np.testing.assert_array_equal(res["step"]["after"][k], v,
                                          err_msg=k)


@pytest.mark.parametrize("fault", FAULTS)
def test_a_broken_mesh_step_differs_from_one_process(ranks, one, fault):
    for res in ranks[(1, 2)]:
        sound = max(_loss_errs(res["step"]["metrics"],
                               one["metrics"]).values())
        broken = max(_loss_errs(res[fault]["metrics"],
                                one["metrics"]).values())
        assert sound <= LOSS_RTOL and broken > 1e3 * LOSS_RTOL, (sound,
                                                                broken)


# ---------------------------------------------------------------------------
# the draws, with a stand-in mesh

def _stand_in(rank, data=2, edge=2):
    return parallel.Group(rank, data * edge, torch.device("cpu"), edge=edge)


@pytest.mark.parametrize("rank", range(4))
def test_edge_dropout_keeps_its_data_rows_and_edge_slots(rank):
    x = torch.randn(B, E, 6, generator=torch.Generator().manual_seed(1))
    drop = Dropout(0.5, edge_axis=1).train()
    want = drop(x, torch.Generator().manual_seed(2))
    mesh = _stand_in(rank)
    rows = slice(mesh.data_rank * B // 2, (mesh.data_rank + 1) * B // 2)
    with parallel.using(mesh):
        cut = parallel.edge_slots(E)
        got = drop(x[rows, cut], torch.Generator().manual_seed(2))
    assert cut == slice(mesh.edge_rank * E // 2, (mesh.edge_rank + 1) * E // 2)
    torch.testing.assert_close(got, want[rows, cut], rtol=0, atol=0)


@pytest.mark.parametrize("rank", range(4))
def test_node_dropout_is_the_same_on_every_edge_rank(rank):
    x = torch.randn(B, N, 6, generator=torch.Generator().manual_seed(1))
    drop = Dropout(0.5).train()
    want = drop(x, torch.Generator().manual_seed(2))
    mesh = _stand_in(rank)
    rows = slice(mesh.data_rank * B // 2, (mesh.data_rank + 1) * B // 2)
    with parallel.using(mesh):
        got = drop(x[rows], torch.Generator().manual_seed(2))
    torch.testing.assert_close(got, want[rows], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# refusals

def test_edges_the_edge_axis_does_not_divide_raise():
    mesh = parallel.Group(0, 10, torch.device("cpu"), edge=5)
    with pytest.raises(ValueError, match="do not split over an edge axis"):
        parallel.shard_batch_edges(_batch(), mesh)
    with parallel.using(mesh), pytest.raises(ValueError,
                                             match="sampled edges"):
        parallel.edge_slots(E)
    with pytest.raises(ValueError, match="joined group"):
        parallel.make_mesh_2d(1, 1)


def test_eval_paths_refuse_an_edge_axis():
    mesh = _stand_in(0)
    model = _model().eval()
    batch = _batch()
    pairs = torch.tensor([[0, 1], [1, 0]]).expand(B, 2, 2)
    with parallel.using(mesh), pytest.raises(ValueError,
                                             match="union dedup"):
        model(torch.from_numpy(batch.images), torch.from_numpy(batch.boxes),
              torch.from_numpy(batch.classes), pairs,
              torch.ones(B, 2, dtype=torch.bool), dedup_unions=True)
    splits = synthetic_splits(num_train=4, num_eval=4, num_classes=C,
                              num_predicates=R, image_size=IMG)
    with pytest.raises(ValueError, match="val_epoch does not run on an "
                                         "edge axis"):
        val_epoch(model, splits["test_alls"], Config(device="cpu"),
                  "test_alls", device="cpu", group=mesh)


@pytest.mark.parametrize("mode", ["sgcls", "sgdet", "gan"])
def test_trainer_and_other_steps_refuse_an_edge_axis(mode):
    mesh = _stand_in(0)
    splits = synthetic_splits(num_train=4, num_eval=4, num_classes=C,
                              num_predicates=R, image_size=IMG)
    cfg = Config(device="cpu", batch_size=B, max_nodes=N, max_edges=E,
                 num_workers=1)
    if mode == "sgcls":
        with pytest.raises(ValueError, match="Trainer does not run"):
            Trainer(cfg, splits, model=_model(), group=mesh)
        return
    # built with no group, then stepped on the mesh
    from sgg_torch.models.gan import GANModel
    from sgg_torch.models.sgdet import make_sgdet_train_step
    from sgg_torch.train.gan_step import (create_gan_optimizers,
                                          make_gan_train_step)
    model = _model()
    opt = Optimizer(cfg, model, steps_per_epoch=2)
    if mode == "sgdet":
        step = make_sgdet_train_step(None, model, cfg, opt)
    else:
        gan = GANModel(C, R, embed_dim=16, hidden_dim=8, fmap_sz=IMG // 16,
                       n_layers_G=2)
        step = make_gan_train_step(model, gan, cfg, opt,
                                   *create_gan_optimizers(cfg, gan))
    with parallel.using(mesh), pytest.raises(ValueError,
                                             match="does not run on an "
                                                   "edge axis"):
        step(_batch(), None, None) if mode == "gan" else step(_batch(), None)
