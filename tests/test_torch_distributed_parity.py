"""The port's data-parallel step and evaluation against the JAX package's:
one sgcls dnorm train step of ``sgg_torch`` on 2 gloo ranks (each on its
rows of the global batch, ``parallel.spawn``) against ``sgg_tpu``'s step
on its 8-virtual-device mesh (``replicate`` + ``shard_batch``, as
``tests/test_distributed.py`` runs it) on the same global batch and
weights, with the sampled edges given and dropout off on both sides, as
``tests/test_torch_train_step.py`` holds the one-process step: losses,
``grad_norm`` and every updated parameter and BatchNorm statistic within
1e-5 relative, per tensor, to its largest magnitude; and ``val_epoch``
with its batches split over 2 ranks against the JAX package's
one-process ``val_epoch``: every metric within 1e-9. The JAX side is
computed once per module; the ranks run the workers of
``tests/test_torch_distributed.py`` (no JAX in them)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sgg_tpu.constants
import sgg_tpu.models.backbone as jbackbone
from sgg_tpu.config import Config as JConfig
from sgg_tpu.data.synthetic import SyntheticSGGDataset as JSynth
from sgg_tpu.data.synthetic import synthetic_splits as jsplits
from sgg_tpu.eval.driver import val_epoch as jval_epoch
from sgg_tpu.models.relhead import RelModelIMP as JModel
from sgg_tpu.parallel import make_mesh, replicate, shard_batch
from sgg_tpu.train.assign import sample_edges as jsample_edges
from sgg_tpu.train.state import create_train_state
from sgg_tpu.train.step import make_train_step as jmake_train_step
from sgg_torch.convert import variables_from_jax
from sgg_torch.data.synthetic import SyntheticSGGDataset
from test_torch_distributed import run_ranks, worker_step, worker_val
from test_torch_models import random_variables

C, R, IMG = 9, 6, 64
B, N, E = 8, 8, 12   # 8: the JAX mesh's devices; 4 rows a rank
RTOL = 1e-5
METRIC_ATOL = 1e-9
MODEL_KW = dict(num_classes=C, num_predicates=R, hidden_dim=16, obj_dim=32)
CFG_KW = dict(mode="sgcls", loss="dnorm", batch_size=B, max_nodes=N,
              max_edges=E, compute_dtype="float32", lr=5e-3, clip=0.05,
              steps=(0,), l2=1e-3)
SPLIT_KW = dict(num_train=8, num_eval=6, num_classes=C, num_predicates=R,
                max_objects=6, image_size=IMG)
EVAL_CFG = dict(mode="sgcls", compute_dtype="float32", max_nodes=16,
                max_edges=12)
EVAL_BATCH = 4  # 6 images: batches of 4 and 2, both split over 2 ranks


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


@pytest.fixture(scope="module")
def jax_step():
    """The JAX step on the mesh and what the port needs to repeat it."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jbackbone.nn, "Dropout",
               lambda rate, deterministic=None: (lambda x: x))
    try:
        kw = dict(num_images=B, num_classes=C, num_predicates=R,
                  max_objects=6, image_size=IMG, with_images=True, seed=5)
        jb = JSynth(**kw).batch(list(range(B)), max_nodes=N, max_edges=E)
        tb = SyntheticSGGDataset(**kw).batch(list(range(B)), max_nodes=N,
                                             max_edges=E)
        jm = JModel(dtype=jnp.float32, **MODEL_KW)
        key = jax.random.key(3)
        k_sample, _ = jax.random.split(key)  # as the JAX step splits it
        jcfg = JConfig(**CFG_KW)
        sampled, pm = jsample_edges(k_sample, jb.rels, jb.rel_mask,
                                    jb.node_mask,
                                    max_out=min(E, jcfg.rels_per_img))
        v = random_variables(jm, tuple(map(jnp.asarray, (
            jb.images, jb.boxes, jb.classes, sampled[..., :2], pm))),
            seed=7)
        state0 = {k: t.clone() for k, t in variables_from_jax(v).items()}
        mesh = make_mesh()
        assert mesh.size == 8
        state = replicate(create_train_state(jcfg, v, steps_per_epoch=2),
                          mesh)
        state, metrics = jmake_train_step(jm, jcfg)(
            state, shard_batch(jb, mesh), key)
        after = variables_from_jax(jax.tree_util.tree_map(np.asarray, {
            "params": state.params, "batch_stats": state.batch_stats}))
        return {"state0": state0, "batch": tb,
                "edges": (np.array(sampled), np.array(pm)),
                "metrics": {k: float(x) for k, x in metrics.items()},
                "after": {k: t.numpy() for k, t in after.items()},
                "v": v, "jm": jm}
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def port_step(jax_step):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return run_ranks(worker_step, jax_step["state0"], MODEL_KW, CFG_KW,
                         jax_step["batch"], jax_step["edges"])
    finally:
        torch.set_num_threads(n)


def test_two_rank_step_losses_match_jax_mesh(jax_step, port_step):
    want = jax_step["metrics"]
    for metrics, _ in port_step:
        assert set(metrics) == set(want)
        for k in want:
            assert rel_err(metrics[k], want[k]) <= RTOL, (k, metrics[k],
                                                          want[k])
    assert want["grad_norm"] > CFG_KW["clip"]  # the clip is taken


def test_two_rank_step_update_matches_jax_mesh(jax_step, port_step):
    want = jax_step["after"]
    for _, state in port_step:
        checked = 0
        for k, got in state.items():
            if k.endswith("num_batches_tracked"):
                continue
            assert rel_err(got, want[k]) <= RTOL, k
            checked += 1
        assert checked > 10
    for k, v in port_step[0][1].items():
        np.testing.assert_array_equal(port_step[1][1][k], v, err_msg=k)


def test_two_rank_val_epoch_matches_jax(jax_step, monkeypatch):
    monkeypatch.setattr(sgg_tpu.constants, "IM_SCALE", IMG)
    want = jval_epoch(jax_step["jm"], jax_step["v"],
                      jsplits(**SPLIT_KW)["test_alls"], JConfig(**EVAL_CFG),
                      "test_alls", eval_batch_size=EVAL_BATCH,
                      verbose=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = run_ranks(worker_val, jax_step["state0"], MODEL_KW, EVAL_CFG,
                        SPLIT_KW, IMG, EVAL_BATCH)
    finally:
        torch.set_num_threads(n)
    keys = {k for k in want if not k.startswith("_")}
    for res in got:
        assert keys == {k for k in res if not k.startswith("_")}
        for k in sorted(keys):
            assert abs(res[k] - want[k]) <= METRIC_ATOL, (k, res[k], want[k])
        # each regime: one batch of 4 and one of 2, both split
        assert res["_counters"]["eval_ladder_batches"] == 4
    assert got[0] == got[1]
