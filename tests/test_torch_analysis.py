"""The port's analysis and logging modules against ``sgg_tpu``'s on the CPU:

* ``augment/gan_eval.py``: FID to 1e-9 relative (both float64 numpy and
  scipy), the float32 distance matrices' squares within 1e-5 of their
  largest, and PRDC equal;
* ``augment/bert.py`` on a tiny local ``BertForMaskedLM`` (as
  ``tests/test_bert_scorer.py``): the same completions and scores as the
  JAX package's scorer; a ``RuntimeError`` without ``transformers``, and
  no download for a model it does not hold;
* ``eval/recall_jit.py::batch_recall``: the same per-image recalls as the
  JAX function (ties in the ranking included) and as the port's host
  evaluator (``SGGEvaluator`` in modes sgdet, sgcls and predcls);
* ``utils/logging.py::make_logger`` with a fake ``wandb`` module: the call
  sequences of ``tests/test_wandb_logging.py`` and the JAX adapter's;
* the ``grad/<module>`` norms of the train step with ``-wandb`` against
  the JAX step's (1e-5 relative), the trainer handing them to ``log_fn``;
* ``utils/misc.py``; ``utils/profiling.py``'s trace and its regions."""

import glob
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgg_tpu.augment import gan_eval as jgan_eval
from sgg_tpu.config import Config as JConfig
from sgg_tpu.eval.recall_jit import batch_recall as jbatch_recall
from sgg_tpu.train.assign import sample_edges as jsample_edges
from sgg_tpu.train.state import create_train_state
from sgg_tpu.train.step import make_train_step as jmake_train_step
from sgg_tpu.utils import misc as jmisc
from sgg_tpu.utils.logging import make_logger as jmake_logger
from sgg_torch.augment import gan_eval
from sgg_torch.config import Config
from sgg_torch.eval.recall_jit import batch_recall
from sgg_torch.eval.sgg_eval import SGGEvaluator
from sgg_torch.eval.surgery import filter_dets
from sgg_torch.train.state import Optimizer
from sgg_torch.train.step import make_train_step
from sgg_torch.utils import misc, profiling
from sgg_torch.utils.logging import make_logger
from test_torch_train_step import B, E, N, _data, _models, _no_flax_dropout

RTOL = 1e-5


# ---------------------------------------------------------------------------
def _feats(seed, n, d=16, shift=0.0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, d) + shift).astype(np.float32)


@pytest.mark.parametrize("truncate", [None, 8])
def test_fid_matches_jax(truncate):
    real, fake = _feats(0, 60), _feats(1, 50, shift=0.3)
    want = jgan_eval.compute_fid(fake, real, truncate=truncate)
    got = gan_eval.compute_fid(fake, real, truncate=truncate)
    assert want > 0 and abs(got - want) <= 1e-9 * abs(want)
    same = gan_eval.compute_fid(real, real)
    assert abs(same) < 1e-6


def test_prdc_and_distances_match_jax():
    real, fake = _feats(2, 40), _feats(3, 30, shift=0.5)
    for a, b in ((real, None), (real, fake)):
        want = jgan_eval._pairwise_distance(a, b)
        got = gan_eval._pairwise_distance(a, b, device="cpu")
        assert got.dtype == np.float32 and got.shape == want.shape
        # squared: near 0 the square root magnifies the rounding of
        # |a|^2 + |b|^2 - 2ab in either package (a self-distance reads 0
        # in one and up to 1.4e-3 in the other)
        assert np.abs(got.astype(np.float64) ** 2 - want.astype(np.float64)
                      ** 2).max() <= RTOL * float(want.max()) ** 2
    want = jgan_eval.compute_prdc(real, fake, nearest_k=5)
    got = gan_eval.compute_prdc(real, fake, nearest_k=5, device="cpu")
    assert got == want
    assert 0 < got["precision"] < 1 and 0 < got["coverage"] <= 1


# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def tiny_bert_dir(tmp_path_factory):
    pytest.importorskip("transformers")
    import test_bert_scorer
    return test_bert_scorer.tiny_bert_dir.__wrapped__(tmp_path_factory)


def test_bert_scorer_matches_jax(tiny_bert_dir):
    from sgg_torch.augment.bert import BERTScorer
    from sgg_tpu.augment.bert import BERTScorer as JBERTScorer
    got, want = BERTScorer(tiny_bert_dir), JBERTScorer(tiny_bert_dir)
    text = "the man is riding the horse"
    for classes, topk in ((["horse", "dog"], 2), (None, 3)):
        assert got.predict_token(text, 6, classes=classes, topk=topk) == \
            want.predict_token(text, 6, classes=classes, topk=topk)
    for word in ("dog", "cat", "man"):
        assert got.score_word(text, 6, word) == want.score_word(text, 6,
                                                                word)
    for args in (("man", "riding", "horse", True),
                 ("men", "riding", "cat", False), ("dog", "on", "cat", False)):
        s, p, o, subj = args
        assert got.score_triplet(s, p, o, context=", dog_on_horse",
                                 is_subject=subj) == want.score_triplet(
            s, p, o, context=", dog_on_horse", is_subject=subj)
    assert got.score_word(text, 6, "dog") == pytest.approx(6.0)


def test_bert_scorer_refusals(tiny_bert_dir, monkeypatch, tmp_path):
    from sgg_torch.augment.bert import BERTScorer
    with pytest.raises(OSError):  # nothing local: no download either
        BERTScorer(str(tmp_path / "no_such_model"))
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(RuntimeError, match="transformers"):
        BERTScorer(tiny_bert_dir)


# ---------------------------------------------------------------------------
def _scene(rng, n, n_cls=8, n_pred=5, jitter=0.0, ties=False):
    boxes = rng.rand(n, 4).astype(np.float32) * 80
    boxes[:, 2:] += boxes[:, :2] + 10
    classes = rng.randint(1, n_cls, n)
    pairs = np.asarray([(i, j) for i in range(n) for j in range(n) if i != j])
    rel_scores = rng.rand(len(pairs), n_pred).astype(np.float32)
    if ties:  # few distinct values: many pairs rank equal
        rel_scores = np.round(rel_scores * 2) / 2 + 0.1
    rel_scores /= rel_scores.sum(1, keepdims=True)
    obj_scores = rng.rand(n).astype(np.float32)
    if ties:
        obj_scores[:] = 0.5
    n_gt = rng.randint(1, 5)
    sel = rng.choice(len(pairs), n_gt, replace=False)
    gt_rels = np.asarray([(pairs[s][0], pairs[s][1], rng.randint(1, n_pred))
                          for s in sel])
    for s, (_, _, p) in zip(sel, gt_rels):  # about half predicted right
        if rng.rand() < 0.5:
            rel_scores[s, p] = rel_scores[s].max() + 0.5
    pred_boxes = boxes + rng.randn(n, 4).astype(np.float32) * jitter
    pred_classes = classes.copy()
    flip = rng.rand(n) < 0.3
    pred_classes[flip] = rng.randint(1, n_cls, flip.sum())
    return (boxes, classes, gt_rels, pairs, rel_scores, obj_scores,
            pred_boxes, pred_classes)


@pytest.mark.parametrize("mode,jitter,ties", [
    ("sgdet", 3.0, False), ("sgcls", 0.0, True), ("predcls", 0.0, False)])
def test_batch_recall_matches_jax_and_the_host_evaluator(mode, jitter, ties):
    rng = np.random.RandomState({"sgdet": 0, "sgcls": 1, "predcls": 2}[mode])
    Bn, Nn, E_GT, ks = 4, 7, 6, (20, 50, 100)
    En = Nn * (Nn - 1)
    arrays = dict(
        boxes=np.zeros((Bn, Nn, 4), np.float32),
        pred_classes=np.zeros((Bn, Nn), np.int64),
        obj_scores=np.zeros((Bn, Nn), np.float32),
        pairs=np.zeros((Bn, En, 2), np.int64),
        pair_mask=np.zeros((Bn, En), bool),
        rel_dists=np.zeros((Bn, En, 5), np.float32),
        gt_boxes=np.zeros((Bn, Nn, 4), np.float32),
        gt_classes=np.zeros((Bn, Nn), np.int64),
        gt_rels=np.zeros((Bn, E_GT, 3), np.int64),
        gt_rel_mask=np.zeros((Bn, E_GT), bool))
    host = {k: [] for k in ks}
    for b in range(Bn):
        n = rng.randint(4, Nn + 1)
        (gt_boxes, gt_classes, gt_rels, pairs, rel_scores, obj_scores,
         pred_boxes, pred_classes) = _scene(rng, n, jitter=jitter, ties=ties)
        if mode == "predcls":
            pred_classes, obj_scores = gt_classes, np.ones(n, np.float32)
        if mode != "sgdet":
            pred_boxes = gt_boxes
        ev = SGGEvaluator(mode, ks=ks)
        ev.add_image({"gt_relations": gt_rels, "gt_boxes": gt_boxes,
                      "gt_classes": gt_classes},
                     filter_dets(pred_boxes, obj_scores, pred_classes, pairs,
                                 rel_scores, np.ones(len(pairs), bool)))
        for k in ks:
            host[k].append(ev.recalls[k][0])
        e, g = len(pairs), len(gt_rels)
        for key, val, sl in (
                ("boxes", pred_boxes, np.s_[b, :n]),
                ("pred_classes", pred_classes, np.s_[b, :n]),
                ("obj_scores", obj_scores, np.s_[b, :n]),
                ("pairs", pairs, np.s_[b, :e]), ("pair_mask", True,
                                                 np.s_[b, :e]),
                ("rel_dists", rel_scores, np.s_[b, :e]),
                ("gt_boxes", gt_boxes, np.s_[b, :n]),
                ("gt_classes", gt_classes, np.s_[b, :n]),
                ("gt_rels", gt_rels, np.s_[b, :g]),
                ("gt_rel_mask", True, np.s_[b, :g])):
            arrays[key][sl] = val
    order = list(arrays)
    got = batch_recall(*(torch.from_numpy(arrays[k]) for k in order), ks=ks)
    want = jbatch_recall(*(jnp.asarray(arrays[k]) for k in order), ks=ks)
    for k in ks:
        assert got[k].shape == (Bn,) and got[k].device.type == "cpu"
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-6)
        np.testing.assert_allclose(got[k].numpy(), host[k], atol=1e-6)
    assert any(np.asarray(host[20]) > 0)
    if ties:  # in an image the top 20 cut through a run of equal scores
        score = (arrays["rel_dists"][..., 1:].max(-1)
                 * np.take_along_axis(arrays["obj_scores"],
                                      arrays["pairs"][..., 0], 1)
                 * np.take_along_axis(arrays["obj_scores"],
                                      arrays["pairs"][..., 1], 1))
        score = -np.sort(-np.where(arrays["pair_mask"], score, -np.inf), 1)
        assert (score[:, 19] == score[:, 20]).any()


# ---------------------------------------------------------------------------
class _FakeRun:
    def __init__(self, fail=False):
        self.logged, self.summary, self.fail = [], {}, fail

    def log(self, d, step=None):
        if self.fail:
            raise RuntimeError("disk full")
        self.logged.append((dict(d), step))


def _fake_wandb(monkeypatch, fail=False):
    mod = types.ModuleType("wandb")
    mod.calls, mod.runs = [], []

    def init(**kw):
        mod.calls.append(kw)
        mod.runs.append(_FakeRun(fail))
        return mod.runs[-1]

    mod.init = init
    monkeypatch.setitem(sys.modules, "wandb", mod)
    return mod


@pytest.mark.parametrize("fail", [False, True], ids=["logs", "log_fails"])
def test_make_logger_matches_jax(monkeypatch, capsys, fail):
    """Both adapters over the same calls: the same ``init`` arguments
    (hyperparameters dumped), per-step logs with prefix, summaries, the
    repeat window, and a failing ``log`` swallowed."""
    mod = _fake_wandb(monkeypatch, fail)
    kw = dict(wandb="sgg-project", name="run7", wandb_dir="/tmp")
    calls = [(({"obj_loss": 1.5, "rel_loss": 0.5},), dict(step=17,
                                                         prefix="loss/")),
             (({"R@100": 0.42},), dict(step=100, log_repeats=5,
                                       is_summary=True))]
    for make, cfg in ((jmake_logger, JConfig(**kw)),
                      (make_logger, Config(**kw))):
        log_fn = make(cfg)
        for a, k in calls:
            log_fn(*a, **k)
    (jkw, tkw), (jrun, trun) = mod.calls, mod.runs
    assert {k: v for k, v in tkw.items() if k != "config"} == \
        {k: v for k, v in jkw.items() if k != "config"} == dict(
            name="run7", dir="/tmp", project="sgg-project", resume=False)
    assert tkw["config"]["mode"] == jkw["config"]["mode"] == "sgcls"
    assert tkw["config"]["batch_size"] == jkw["config"]["batch_size"]
    assert trun.logged == jrun.logged and trun.summary == jrun.summary
    if fail:
        assert trun.logged == [] and trun.summary == {}
        assert "error logging with wandb" in capsys.readouterr().out
    else:
        assert trun.logged[:2] == [({"loss/obj_loss": 1.5}, 17),
                                   ({"loss/rel_loss": 0.5}, 17)]
        assert [s for _, s in trun.logged[2:]] == list(range(100, 105))
        assert trun.summary == {"R@100": 0.42}


def test_make_logger_fallbacks(monkeypatch, capsys):
    mod = _fake_wandb(monkeypatch)
    make_logger(Config())({"x": 1.0}, step=0)  # no -wandb: wandb untouched
    assert mod.calls == []
    monkeypatch.setitem(sys.modules, "wandb", None)  # not installed
    log_fn = make_logger(Config(wandb="p"))
    assert "disabled" in capsys.readouterr().out
    log_fn({"x": 1.0}, step=0)


# ---------------------------------------------------------------------------
def test_grad_module_norms_match_jax(monkeypatch):
    """With ``-wandb`` the train step's metrics carry ``grad/<module>`` for
    each top-level module, the frozen trunk's 0, each within 1e-5 of the
    JAX step's; without it, none."""
    _no_flax_dropout(monkeypatch)
    jm, v, tm = _models()
    kw = dict(mode="sgcls", loss="dnorm", batch_size=B, max_nodes=N,
              max_edges=E, compute_dtype="float32", clip=0.05)
    jcfg, cfg = JConfig(wandb="p", **kw), Config(device="cpu", wandb="p",
                                                 **kw)
    js, ts = _data()
    jb = js.batch([0, 1], max_nodes=N, max_edges=E)
    tb = ts.batch([0, 1], max_nodes=N, max_edges=E)
    key = jax.random.key(3)
    sampled, pm = jsample_edges(jax.random.split(key)[0], jb.rels,
                                jb.rel_mask, jb.node_mask, max_out=E)
    _, want = jmake_train_step(jm, jcfg)(create_train_state(jcfg, v), jb,
                                         key)
    edges = (torch.from_numpy(np.array(sampled)),
             torch.from_numpy(np.array(pm)))
    got = make_train_step(tm, cfg, Optimizer(cfg, tm))(tb, None, edges=edges)
    mods = {k for k in want if k.startswith("grad/")}
    assert mods == {f"grad/{m}" for m in v["params"]} and len(mods) >= 5
    assert set(got) == set(want)
    assert float(got["grad/trunk"]) == float(want["grad/trunk"]) == 0.0
    for k in mods:
        w = float(want[k])
        assert abs(float(got[k]) - w) <= RTOL * max(w, 1e-12), k
    plain = make_train_step(tm, Config(device="cpu", **kw),
                            Optimizer(cfg, tm))(tb, None, edges=edges)
    assert not any(k.startswith("grad/") for k in plain)


def test_trainer_hands_losses_and_results_to_log_fn(monkeypatch, capsys):
    """``Trainer(log_fn=)``: the interval means under ``loss/`` (the
    ``grad/`` norms among them, though not printed) and each evaluated
    split's results as summaries, repeated 5 times at test time."""
    import sgg_torch.constants
    from sgg_torch.data.synthetic import synthetic_splits
    from sgg_torch.models.relhead import RelModelIMP, init_weights
    from sgg_torch.train.trainer import Trainer
    monkeypatch.setattr(sgg_torch.constants, "IM_SCALE", 64)
    splits = synthetic_splits(num_train=4, num_eval=2, num_classes=9,
                              num_predicates=6, max_objects=5, image_size=64)
    model = init_weights(RelModelIMP(num_classes=9, num_predicates=6,
                                     hidden_dim=16, obj_dim=32), 0)
    logged = []
    t = Trainer(Config(device="cpu", wandb="p", batch_size=2, max_nodes=6,
                       max_edges=8, compute_dtype="float32", num_workers=1,
                       print_interval=1, num_epochs=1), splits, model=model,
                log_fn=lambda d, **kw: logged.append((d, kw)))
    t.train_epoch(0)
    assert len(logged) == 2 and all(kw == {"step": i + 1} for i, (_, kw)
                                    in enumerate(logged))
    assert {"loss/total", "loss/grad/imp", "loss/grad/trunk"} <= \
        set(logged[0][0])
    assert "grad/" not in capsys.readouterr().out
    logged.clear()
    t.evaluate(["test_alls"], verbose=False)
    (d, kw), = logged
    assert kw == dict(step=2, is_summary=True, log_repeats=5)
    assert any("R@" in k for k in d)


# ---------------------------------------------------------------------------
def test_misc_matches_jax(capsys):
    misc.set_seed(3)
    a = (np.random.rand(), torch.rand(2))
    misc.set_seed(3)
    assert np.random.rand() == a[0] and torch.equal(torch.rand(2), a[1])
    from sgg_torch.convert import variables_from_jax
    _, v, tm = _models()
    params = dict(tm.named_parameters())
    assert misc.param_count(params) == jmisc.param_count(v["params"])
    assert misc.param_count(variables_from_jax(v)) == misc.param_count(
        tm.state_dict())
    table = misc.print_params(params, max_rows=3)
    jtable = jmisc.print_params(v["params"], max_rows=3)
    lines, jlines = table.splitlines(), jtable.splitlines()
    assert len(lines) == len(jlines) == 6
    assert lines[-1] == jlines[-1]  # the totals
    assert lines[-2] == jlines[-2]  # "... n more"
    biggest = max(params.values(), key=lambda p: p.numel())
    assert f"{biggest.numel():,d}" in lines[1]
    assert capsys.readouterr().out.count("TOTAL") == 2


def test_profiling_matches_jax(tmp_path):
    with profiling.trace(str(tmp_path / "trace"), name="sgg_step"):
        with profiling.annotate("inner"):
            torch.ones(8).sum()
    files = glob.glob(str(tmp_path / "trace" / "*.pt.trace.json"))
    assert len(files) == 1
    text = open(files[0]).read()
    assert '"sgg_step"' in text and '"inner"' in text
    with profiling.trace(None):  # no directory: the block runs bare
        pass
