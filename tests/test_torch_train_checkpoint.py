"""The port's checkpoints, ``Trainer`` and CLI on the CPU, with a tiny
model on 64-pixel canvases: an exact save/restore round trip, the
optimistic restore's report, the last-3 rule, and ``python -m
sgg_torch.main -split synthetic`` end to end."""

import json
import os
import sys

import pytest
import torch

import sgg_torch.constants
from sgg_torch import main as cli
from sgg_torch.config import Config
from sgg_torch.data.synthetic import synthetic_splits
from sgg_torch.models.relhead import RelModelIMP, init_weights
from sgg_torch.train import checkpoint as ckpt
from sgg_torch.train import trainer as trainer_mod
from sgg_torch.train.trainer import Trainer

C, R, IMG = 9, 6, 64


@pytest.fixture
def small_canvas(monkeypatch):
    monkeypatch.setattr(sgg_torch.constants, "IM_SCALE", IMG)


def _tiny(config, train_data, *, device="cuda", seed=0, hidden=16):
    model = init_weights(RelModelIMP(
        num_classes=train_data.num_classes,
        num_predicates=train_data.num_predicates, mode=config.mode,
        hidden_dim=hidden, obj_dim=32), seed)
    dtype = torch.bfloat16 if config.compute_dtype == "bfloat16" \
        else torch.float32
    return model.to_compute_dtype(dtype).to(device).eval()


def _splits():
    return synthetic_splits(num_train=8, num_eval=4, num_classes=C,
                            num_predicates=R, max_objects=6,
                            image_size=IMG)


def _config(save_dir, **kw):
    return Config(device="cpu", mode="sgcls", loss="dnorm", batch_size=2,
                  max_nodes=8, max_edges=12, compute_dtype="float32",
                  save_dir=save_dir, num_workers=1, **kw)


def _trainer(splits, save_dir, hidden=16, seed=0):
    cfg = _config(save_dir)
    return Trainer(cfg, splits, model=_tiny(cfg, splits["train"],
                                            device="cpu", seed=seed,
                                            hidden=hidden))


def _step(trainer, i):
    """Train step ``i``: a fixed batch and a generator seeded by ``i``
    (dropout stays on)."""
    from sgg_torch.data.synthetic import SyntheticSGGDataset
    ds = SyntheticSGGDataset(num_images=2, num_classes=C, num_predicates=R,
                             max_objects=6, image_size=IMG, with_images=True,
                             seed=i)
    return trainer.train_step(ds.batch([0, 1], max_nodes=8, max_edges=12),
                              torch.Generator().manual_seed(i))


def test_save_restore_round_trip_is_exact(tmp_path):
    splits = _splits()
    straight = _trainer(splits, None)
    want = [_step(straight, i) for i in range(3)]

    first = _trainer(splits, str(tmp_path))
    for i in range(2):
        _step(first, i)
    first.save(0)
    resumed = _trainer(splits, str(tmp_path), seed=5)  # other init values
    assert resumed.start_epoch == 1 and resumed.global_iter == 2
    got = _step(resumed, 2)
    for k in want[2]:
        assert torch.equal(got[k], want[2][k]), k
    live = resumed.model.state_dict()
    for k, v in straight.model.state_dict().items():
        assert torch.equal(live[k], v), k
    for k, v in straight.optimizer.state_dict().items():
        assert torch.equal(resumed.optimizer.state_dict()[k], v), k


def test_optimistic_restore_reports_a_changed_hidden_size(tmp_path):
    splits = _splits()
    _trainer(splits, str(tmp_path)).save(3)
    wider = _trainer(splits, None, hidden=24)
    template = wider._payload(0)
    merged, epoch, keys, stats = ckpt.optimistic_restore_payload(
        str(tmp_path), template, verbose=False)
    assert epoch == 3 and keys == set(template)
    gru = "params/imp.node_gru.weight_hh"
    assert gru in stats["missing"] and gru in stats["unused"]
    assert "opt_state/imp.edge_gru.bias_ih" in stats["missing"]
    assert not any(k.startswith("params/roi_fmap") for k in stats["missing"])
    assert torch.equal(merged["params"]["imp.node_gru.weight_hh"],
                       template["params"]["imp.node_gru.weight_hh"])
    assert int(merged["epoch"]) == 3
    resumed = _trainer(splits, str(tmp_path), hidden=24)
    assert resumed.start_epoch == 4


def test_only_the_last_three_checkpoints_are_kept(tmp_path):
    for epoch in range(5):
        ckpt.save_payload(str(tmp_path), {"epoch": torch.tensor(epoch)},
                          epoch)
    assert sorted(os.listdir(tmp_path)) == [
        f"vgrel-{e}.pth" for e in (2, 3, 4)]
    assert ckpt.latest_epoch(str(tmp_path)) == 4
    assert ckpt.latest_epoch(str(tmp_path / "absent")) is None


def test_cli_trains_and_writes_test_results(tmp_path, monkeypatch,
                                            small_canvas):
    monkeypatch.setattr(trainer_mod, "build_model", _tiny)
    run = str(tmp_path / "run")
    results = cli.main(["-m", "sgcls", "-loss", "dnorm", "-split",
                        "synthetic", "-device", "cpu", "-nepoch", "1",
                        "-b", "8", "-val_size", "4", "-p", "4", "-nwork",
                        "1", "-max_nodes", "24", "-max_edges", "64",
                        "-save_dir", run])
    with open(os.path.join(run, "test_results.json")) as f:
        written = json.load(f)
    assert "sgcls/test_alls_R@100_GC" in written
    assert all(v == v and 0 <= v <= 301.001 for v in written.values())
    assert written == {k: v for k, v in results.items()
                       if not k.startswith("_")}
    assert ckpt.latest_epoch(run) == 0


def test_cli_refuses_splits_that_are_not_ported(monkeypatch, capsys):
    """Every split is ported now: ``-split stanford`` reads its tree (a
    missing one is the parser's ``FileNotFoundError``); W&B logging is
    ported too: ``-wandb`` without the ``wandb`` package logs to the
    console alone and hands the trainer its ``log_fn``."""
    with pytest.raises(FileNotFoundError):
        cli.main(["-split", "stanford", "-data", "no_such_data_dir",
                  "-device", "cpu"])
    seen = {}

    class Stop(Exception):
        pass

    def trainer(config, splits, **kw):
        seen.update(kw)
        raise Stop

    monkeypatch.setitem(sys.modules, "wandb", None)  # import wandb fails
    monkeypatch.setattr(trainer_mod, "Trainer", trainer)
    monkeypatch.setattr(cli, "load_splits", lambda config: {})
    with pytest.raises(Stop):
        cli.main(["-split", "synthetic", "-wandb", "run", "-device", "cpu"])
    assert "wandb logging disabled" in capsys.readouterr().out
    seen["log_fn"]({"x": 1.0}, step=0)  # the console fallback: a no-op
