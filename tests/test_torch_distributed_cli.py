"""The port's CLI under ``torchrun`` on the CPU: ``python -m
torch.distributed.run --standalone --nproc_per_node 2`` runs this file's
main block (the CLI at tiny widths on 64-pixel canvases) with ``-ndev 2
-device cpu``, two gloo ranks meeting on the loopback; rank 0 writes the
test results, which must be one process's within 1e-9 (the CLI run in this
process on the same argv without ``-ndev``); the same for ``-m sgdet`` on a
tiny detector's directory. The rest of the data-parallel tests:
``tests/test_torch_distributed.py``."""

import os

import numpy as np

import sgg_torch.constants
from sgg_torch.models.relhead import RelModelIMP, init_weights
from test_torch_distributed import JOIN_S, METRIC_ATOL
from test_torch_distributed import one_thread  # noqa: F401  (autouse)


# SGDet's detector at tiny heads (tests/test_torch_sgdet.py's)
DET_KW = dict(rpn_pre_nms_top_n=64, rpn_post_nms_top_n=24,
              detections_per_img=8, obj_dim=48, score_thresh=0.01)


def _tiny_cli():
    """The CLI's models at tiny widths on 64-pixel canvases."""
    import functools

    from sgg_torch.models import detector as detector_mod
    from sgg_torch.train import trainer as trainer_mod
    sgg_torch.constants.IM_SCALE = 64
    trainer_mod.build_model = lambda config, td, device="cuda", seed=0: \
        init_weights(RelModelIMP(num_classes=td.num_classes,
                                 num_predicates=td.num_predicates,
                                 mode=config.mode, hidden_dim=16,
                                 obj_dim=32), seed).to(device).eval()
    detector_mod.FasterRCNNVGG = functools.partial(
        detector_mod.FasterRCNNVGG, **DET_KW)


def _cli_argv(save_dir):
    return ["-m", "sgcls", "-loss", "dnorm", "-split", "synthetic",
            "-device", "cpu", "-nepoch", "1", "-b", "8", "-val_size", "4",
            "-p", "4", "-nwork", "1", "-max_nodes", "24", "-max_edges",
            "64", "-save_dir", save_dir]


def _torchrun_against_one(tmp_path, monkeypatch, argv):
    """The test results of ``argv`` under ``torchrun --standalone
    --nproc_per_node 2`` (``-ndev 2``; rank 0 writes them) and of one
    process, both at tiny widths."""
    import json
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = str(tmp_path / "ranks")
    env = {**os.environ, "PYTHONPATH": root, "OMP_NUM_THREADS": "1",
           "GLOO_SOCKET_IFNAME": "lo"}
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", os.path.abspath(__file__),
         *argv(run), "-ndev", "2"],
        capture_output=True, text=True, timeout=JOIN_S, env=env, cwd=root)
    assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-3000:])
    with open(os.path.join(run, "test_results.json")) as f:
        got = json.load(f)
    from sgg_torch import main as cli
    from sgg_torch.models import detector as detector_mod
    from sgg_torch.train import trainer as trainer_mod
    monkeypatch.setattr(sgg_torch.constants, "IM_SCALE", 64)
    monkeypatch.setattr(trainer_mod, "build_model", trainer_mod.build_model)
    monkeypatch.setattr(detector_mod, "FasterRCNNVGG",
                        detector_mod.FasterRCNNVGG)
    _tiny_cli()
    want = cli.main(argv(str(tmp_path / "one")))
    want = {k: v for k, v in want.items() if not k.startswith("_")}
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, atol=METRIC_ATOL, err_msg=k)
    return got


def test_torchrun_cli_on_two_ranks_matches_one_process(tmp_path,
                                                       monkeypatch):
    """``torchrun --standalone --nproc_per_node 2`` over the CLI (this
    file's main block: tiny widths) on the CPU, ``-ndev 2``: rank 0 writes
    the test results, and they are one process's."""
    got = _torchrun_against_one(tmp_path, monkeypatch, _cli_argv)
    assert "sgcls/test_alls_R@100_GC" in got


def test_torchrun_sgdet_cli_on_two_ranks_matches_one_process(tmp_path,
                                                             monkeypatch):
    """The same with ``-m sgdet -ckpt <dir>``: a tiny VGG16 detector with
    seeded weights (the synthetic split's 151 classes), its relation model
    trained on 2 ranks, then evaluated."""
    from sgg_torch.models.detector import (FasterRCNNVGG,
                                           init_detector_weights)
    from sgg_torch.train.checkpoint import save_detector
    det_dir = str(tmp_path / "det")
    save_detector(det_dir, init_detector_weights(
        FasterRCNNVGG(151, **DET_KW), 0))

    def argv(save_dir):
        return ["-m", "sgdet", "-ckpt", det_dir, "-loss", "dnorm", "-split",
                "synthetic", "-device", "cpu", "-nepoch", "1", "-b", "4",
                "-val_size", "4", "-p", "4", "-nwork", "1", "-dtype",
                "float32", "-save_dir", save_dir]

    got = _torchrun_against_one(tmp_path, monkeypatch, argv)
    assert "sgdet/test_alls_R@100_NOGC" in got


if __name__ == "__main__":
    # the CLI at tiny widths, as a launcher's rank runs it
    import sys
    _tiny_cli()
    from sgg_torch import main as cli
    cli.main(sys.argv[1:])
