"""Port parity of the evaluation path: ``make_eval_step`` on one batch and
``val_epoch`` (dual predcls + sgcls, pair-budget ladder, unordered-union
dedup) on a 6-image synthetic split, ``sgg_tpu`` against ``sgg_torch``,
both in f32 on the CPU. Also: entry points refuse to run on the CPU
unless asked (on the card, ``test_torch_cuda.py`` checks that a wrapper
never takes its plain version)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sgg_tpu.constants
import sgg_torch.constants
from sgg_tpu.config import Config as JConfig
from sgg_tpu.data.synthetic import synthetic_splits as jsplits
from sgg_tpu.eval.driver import val_epoch as jval_epoch
from sgg_tpu.models.relhead import RelModelIMP as JModel
from sgg_tpu.train.assign import all_pairs
from sgg_tpu.train.step import make_eval_step as jmake_eval_step
from sgg_torch.config import Config
from sgg_torch.convert import variables_from_jax
from sgg_torch.data.synthetic import synthetic_splits
from sgg_torch.eval.driver import val_epoch
from sgg_torch.models.relhead import RelModelIMP
from sgg_torch.train.step import make_eval_step
from sgg_torch.train.trainer import build_model
from test_torch_models import random_variables

C, R, IMG = 9, 6, 64
SPLIT_KW = dict(num_train=8, num_eval=6, num_classes=C, num_predicates=R,
                max_objects=6, image_size=IMG)


@pytest.fixture(scope="module")
def models():
    jm = JModel(num_classes=C, num_predicates=R, hidden_dim=16, obj_dim=32,
                dtype=jnp.float32)
    nm = jnp.ones((1, 3), bool)
    pairs, pm = all_pairs(nm)
    v = random_variables(jm, (jnp.zeros((1, IMG, IMG, 3)),
                              jnp.zeros((1, 3, 4)),
                              jnp.ones((1, 3), jnp.int32), pairs, pm), seed=3)
    tm = RelModelIMP(num_classes=C, num_predicates=R, hidden_dim=16,
                     obj_dim=32)
    tm.load_state_dict(variables_from_jax(v), strict=True)
    return jm, v, tm.eval()


@pytest.fixture
def small_canvas(monkeypatch):
    for mod in (sgg_tpu.constants, sgg_torch.constants):
        monkeypatch.setattr(mod, "IM_SCALE", IMG)


@pytest.mark.parametrize("mode", ["predcls", "sgcls"])
def test_eval_step_matches_jax(models, mode):
    jm, v, tm = models
    from sgg_tpu.data.synthetic import SyntheticSGGDataset as JSynth
    from sgg_torch.data.synthetic import SyntheticSGGDataset as TSynth
    kw = dict(num_images=3, num_classes=C, num_predicates=R, max_objects=6,
              image_size=IMG, with_images=True, seed=5)
    jb = JSynth(**kw).batch([0, 1, 2], max_nodes=8, max_edges=12)
    tb = TSynth(**kw).batch([0, 1, 2], max_nodes=8, max_edges=12)
    want = jmake_eval_step(jm, mode=mode, max_pairs=32)(v, jb)
    got = make_eval_step(tm, mode=mode, max_pairs=32, device="cpu")(tb)
    for k in ("obj_preds", "pairs", "pair_mask", "dedup_ok"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    np.testing.assert_allclose(got["rel_dists"].numpy(),
                               np.asarray(want["rel_dists"]), atol=1e-5)
    np.testing.assert_allclose(got["obj_scores"].numpy(),
                               np.asarray(want["obj_scores"]), atol=1e-5)


def test_val_epoch_matches_jax(models, small_canvas):
    jm, v, tm = models
    jcfg = JConfig(mode="sgcls", compute_dtype="float32", max_nodes=16,
                   max_edges=12)
    cfg = Config(mode="sgcls", compute_dtype="float32", max_nodes=16,
                 max_edges=12, device="cpu")
    want = jval_epoch(jm, v, jsplits(**SPLIT_KW)["test_alls"], jcfg,
                      "test_alls", eval_batch_size=3, verbose=False)
    got = val_epoch(tm, synthetic_splits(**SPLIT_KW)["test_alls"], cfg,
                    "test_alls", eval_batch_size=3, verbose=False,
                    device="cpu")
    keys = {k for k in want if not k.startswith("_")}
    assert keys == {k for k in got if not k.startswith("_")}
    for k in sorted(keys):
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])
    # both ladders took the same rungs: 2 batches x 2 regimes at rung 128
    assert got["_counters"] == {"eval_ladder_batches": 4,
                                "eval_ladder_rung_128": 4}
    assert got["_throughput"]["sgcls"]["images"] == 6


def test_entry_points_refuse_cpu_unless_asked(models):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present; nothing to refuse")
    _, _, tm = models
    splits = synthetic_splits(**SPLIT_KW)
    cfg = Config(mode="sgcls", compute_dtype="float32")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(cfg, splits["train"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_eval_step(tm)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        val_epoch(tm, splits["test_alls"], cfg, "test_alls")
