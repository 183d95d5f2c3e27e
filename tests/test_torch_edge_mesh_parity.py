"""The port's (data x edge) mesh step against the JAX package's: one sgcls
dnorm train step of ``sgg_torch`` on a 2 x 2 gloo mesh (4 spawned ranks,
``parallel.make_mesh_2d`` + ``shard_batch_edges``) against ``sgg_tpu``'s
step on ``make_mesh_2d(2, 4)`` + ``shard_batch_edges`` over its 8 virtual
devices, as ``tests/test_edge_sharding.py`` builds it, on the same batch
and weights, f32, with the sampled edges given (drawn by JAX from the
step's key split) and dropout off on both sides: the losses and
``grad_norm`` within 1e-5 relative, every updated parameter and BatchNorm
statistic within 1e-5 relative to its largest magnitude. The JAX side is
computed once per module; the ranks run the worker of
``tests/test_torch_edge_mesh.py`` (no JAX in it)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgg_tpu.config import Config as JConfig
from sgg_tpu.data.synthetic import SyntheticSGGDataset as JSynth
from sgg_tpu.models.relhead import RelModelIMP as JModel
from sgg_tpu.parallel import make_mesh_2d, replicate, shard_batch_edges
from sgg_tpu.train.assign import sample_edges as jsample_edges
from sgg_tpu.train.state import create_train_state
from sgg_tpu.train.step import make_train_step as jmake_train_step
from sgg_torch import parallel
from sgg_torch.convert import variables_from_jax
from sgg_torch.data.synthetic import SyntheticSGGDataset
from test_torch_distributed_parity import rel_err
from test_torch_edge_mesh import C, IMG, JOIN_S, R, worker_mesh_given
from test_torch_models import random_variables
from test_torch_train_step import _no_flax_dropout

B, N, E = 4, 8, 16  # E / 4 edge slots a JAX device, E / 2 a port rank
RTOL = 1e-5
MODEL_KW = dict(num_classes=C, num_predicates=R, hidden_dim=16, obj_dim=32,
                use_bias=True)
CFG_KW = dict(mode="sgcls", loss="dnorm", batch_size=B, max_nodes=N,
              max_edges=E, compute_dtype="float32", lr=5e-3, clip=0.05,
              steps=(0,), l2=1e-3)


@pytest.fixture(scope="module")
def jax_step():
    mp = pytest.MonkeyPatch()
    _no_flax_dropout(mp)
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
        mesh = make_mesh_2d(2, 4)
        state = replicate(create_train_state(jcfg, v, steps_per_epoch=2),
                          mesh)
        state, metrics = jmake_train_step(jm, jcfg)(
            state, shard_batch_edges(jb, mesh), key)
        after = variables_from_jax(jax.tree_util.tree_map(np.asarray, {
            "params": state.params, "batch_stats": state.batch_stats}))
        return {"state0": state0, "batch": tb,
                "edges": (np.array(sampled), np.array(pm)),
                "metrics": {k: float(x) for k, x in metrics.items()},
                "after": {k: t.numpy() for k, t in after.items()}}
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def port_step(jax_step):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return parallel.spawn(
            worker_mesh_given, 4,
            ((2, 2), jax_step["batch"], jax_step["edges"],
             jax_step["state0"], MODEL_KW, CFG_KW), device="cpu",
            timeout_s=JOIN_S)
    finally:
        torch.set_num_threads(n)


def test_edge_mesh_step_losses_match_jax_mesh(jax_step, port_step):
    want = jax_step["metrics"]
    assert want["grad_norm"] > CFG_KW["clip"]  # the clip is taken
    assert (jax_step["edges"][0][..., 2][jax_step["edges"][1]] > 0).any()
    for res in port_step:
        got = res["metrics"]
        assert set(got) == set(want)
        for k in want:
            assert rel_err(got[k], want[k]) <= RTOL, (k, got[k], want[k])
        assert res["pooled"] == [(B // 2, N, 4), (B // 2, E // 2, 4)]


def test_edge_mesh_step_update_matches_jax_mesh(jax_step, port_step):
    want = jax_step["after"]
    for res in port_step:
        checked = 0
        for k, got in res["after"].items():
            if k.endswith("num_batches_tracked"):
                continue
            assert rel_err(got, want[k]) <= RTOL, k
            checked += 1
        assert checked > 10
