"""The port's data-parallel SGDet step against the JAX package's: one SGDet
train step of ``sgg_torch`` on 2 gloo ranks (each on its rows of the
global batch, ``parallel.spawn``) against ``sgg_tpu``'s sgdet step on its
8-virtual-device mesh (``replicate`` + ``shard_batch``) on the same 8
images and weights, f32, dropout off on both sides. As
``tests/test_torch_sgdet.py`` holds the one-process step: the port's
detector hands each rank its rows of JAX's detections (the detector's own
parity is ``tests/test_torch_detector.py``), and the ranks take their rows
of the relations JAX's step draws inside (``rel_assignments`` on the same
key split); the GT boxes stand in for the first detections, so that FG
pairs exist. The losses and ``nms_converged_frac`` within 1e-5 relative,
every updated parameter and BatchNorm statistic within 1e-5 relative to
its largest magnitude, both ranks the same bits. The JAX side is computed
once per module; the ranks run the worker of
``tests/test_torch_distributed_sgdet.py`` (no JAX in it)."""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgg_tpu.config import Config as JConfig
from sgg_tpu.data.synthetic import SyntheticSGGDataset as JSynth
from sgg_tpu.models.detector import FasterRCNNVGG as JDet
from sgg_tpu.models.relhead import RelModelIMP as JModel
from sgg_tpu.models.sgdet import make_sgdet_train_step as jmake_train_step
from sgg_tpu.parallel import make_mesh, replicate, shard_batch
from sgg_tpu.train.assign import all_pairs as jall_pairs
from sgg_tpu.train.rel_assign import rel_assignments as jrel_assignments
from sgg_tpu.train.state import create_train_state
from sgg_torch import parallel
from sgg_torch.convert import variables_from_jax
from sgg_torch.data.synthetic import SyntheticSGGDataset
from test_torch_distributed_parity import rel_err
from test_torch_distributed_sgdet import (C, DET_KW, IMG, JOIN_S, R,
                                          worker_sgdet_given)
from test_torch_models import random_variables
from test_torch_train_step import _no_flax_dropout

B, N, E = 8, 8, 16  # 8: the JAX mesh's devices; 4 rows a rank
RTOL = 1e-5
CFG_KW = dict(mode="sgdet", loss="dnorm", batch_size=B, max_nodes=N,
              max_edges=E, compute_dtype="float32", lr=5e-3, clip=0.05,
              steps=(0,), l2=1e-3)
DET_KEYS = ("boxes", "labels", "mask", "fmap", "nms_converged")


@pytest.fixture(scope="module")
def jax_step():
    mp = pytest.MonkeyPatch()
    _no_flax_dropout(mp)
    try:
        kw = dict(num_images=B, num_classes=C, num_predicates=R,
                  max_objects=5, image_size=IMG, with_images=True, seed=1)
        jb = JSynth(**kw).batch(list(range(B)), max_nodes=N, max_edges=E)
        tb = SyntheticSGGDataset(**kw).batch(list(range(B)), max_nodes=N,
                                             max_edges=E)
        jd = JDet(num_classes=C, dtype=jnp.float32, **DET_KW)
        dv = random_variables(jd, (jnp.asarray(jb.images),
                                   jnp.asarray(jb.im_hw)), seed=4)
        jm = JModel(num_classes=C, num_predicates=R, mode="sgdet",
                    hidden_dim=16, obj_dim=32, dtype=jnp.float32)
        D = DET_KW["detections_per_img"]
        pairs, pm = jall_pairs(jnp.ones((B, D), bool))
        shim = types.SimpleNamespace(init=functools.partial(
            jm.init, fmap=jnp.zeros((B, 6, 6, 512)), mode="sgdet"))
        rv = random_variables(shim, (None, jnp.zeros((B, D, 4)),
                                     jnp.ones((B, D), jnp.int32), pairs, pm),
                              seed=5)
        state0 = {k: t.clone() for k, t in variables_from_jax(rv).items()}

        def with_gt(v, im, hw, **kw):
            # a random detector matches no GT box: its first detections
            # take the GT boxes and classes, so the sampler finds FG pairs
            out = dict(jd.apply(v, im, hw, **kw))
            gt = jnp.asarray(jb.node_mask)
            out["boxes"] = jnp.where(gt[..., None], jb.boxes, out["boxes"])
            out["labels"] = jnp.where(gt, jb.classes, out["labels"])
            out["mask"] = out["mask"] | gt
            return out

        shim_det = types.SimpleNamespace(apply=with_gt)
        key = jax.random.key(2)
        k_rel, _ = jax.random.split(key)  # as the JAX step splits it
        det = jax.jit(lambda im, hw: with_gt(dv, im, hw))(jb.images,
                                                          jb.im_hw)
        rels = jrel_assignments(k_rel, det["boxes"], det["labels"],
                                det["mask"], jb.boxes, jb.classes, jb.rels,
                                jb.rel_mask)
        mesh = make_mesh()
        assert mesh.size == 8
        jcfg = JConfig(**CFG_KW)
        state = replicate(create_train_state(jcfg, rv, steps_per_epoch=2),
                          mesh)
        state, metrics = jmake_train_step(shim_det, jm, jcfg, dv)(
            state, shard_batch(jb, mesh), key)
        after = variables_from_jax(jax.tree_util.tree_map(np.asarray, {
            "params": state.params, "batch_stats": state.batch_stats}))
        return {"state0": state0, "batch": tb,
                "det": {k: np.array(det[k]) for k in DET_KEYS},
                "rels": tuple(np.array(r) for r in rels),
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
            worker_sgdet_given, 2,
            ("vgg", jax_step["batch"], jax_step["rels"], jax_step["det"],
             jax_step["state0"], CFG_KW), device="cpu", timeout_s=JOIN_S)
    finally:
        torch.set_num_threads(n)


def test_two_rank_sgdet_step_losses_match_jax_mesh(jax_step, port_step):
    want = jax_step["metrics"]
    assert 0 < want["nms_converged_frac"] <= 1
    assert (jax_step["rels"][0][..., 2][jax_step["rels"][1]] > 0).any()
    for res in port_step:
        got = res["metrics"]
        assert set(got) == set(want)
        for k in want:
            assert rel_err(got[k], want[k]) <= RTOL, (k, got[k], want[k])


def test_two_rank_sgdet_step_update_matches_jax_mesh(jax_step, port_step):
    want = jax_step["after"]
    for res in port_step:
        checked = 0
        for k, got in res["after"].items():
            if k.endswith("num_batches_tracked"):
                continue
            assert rel_err(got, want[k]) <= RTOL, k
            checked += 1
        assert checked > 10
    for k, v in port_step[0]["after"].items():
        np.testing.assert_array_equal(port_step[1]["after"][k], v,
                                      err_msg=k)
