"""The port's profilers (``sgg_torch/tools/profile_*.py``; the GAN's in
``tests/test_torch_tools_gan.py``), ``e2e_throughput``, ``soak`` and
``reprobe_gates`` on the CPU at a tiny size: each runs in process
(``main(argv)`` with ``-device cpu``), its last stdout line is one JSON
object, its stages map onto the JAX tool's printed stages (the tables
below; each JAX name is checked to be in the JAX tool's source), and its
FLOP counts equal the analytic count of ``tests/tools_flops.py`` at
relative 1e-6 (the sgcls train step's backward included). Stages whose
count depends on the data (the detector's NMS rounds) are held by
identities between stages. On the CPU no card time is measured: every
stage's ``card_ms`` and MFU read None, and no kernel launches."""

import math
import os

import pytest
from tools_flops import (REPO, TINY, close, head_fwd, imp_fwd, jax_names_exist,
                         k1_flops, no_card_numbers, one_thread, rects_fwd,
                         relation_fwd, run, train_step, trunk_flops)

from sgg_torch.tools import (e2e_throughput, profile_pretrain,
                             profile_relhead, profile_sgdet, profile_step,
                             profile_trunk, reprobe_gates, soak)

assert one_thread  # the module-wide fixture (tests/tools_flops.py)

# ---------------------------------------------------------------- stages

# JAX tool's printed stage -> the port's stage
STEP_NAMES = {"trunk fwd": "trunk fwd",
              "roi_align nodes (40)": "K1 nodes",
              "roi_align unions (256)": "K1 unions",
              "rects conv (256 edges)": "rects conv",
              "roi_fmap FC (256 rois)": "roi_fmap fc6/fc7",
              "full forward": "full forward",
              "full train step": "full train step"}
RELHEAD_NAMES = {"node RoIAlign (N=50)": "K1 nodes",
                 "union RoIAlign (E=1024)": "K1 unions",
                 "union RoIAlign (E=512, dedup'd)":
                     "K1 unions (dedup'd half)",
                 "rects conv branch (E=1024)": "rects conv branch",
                 "edge RoiHead fc6/fc7 (E=1024)": "edge RoiHead fc6/fc7",
                 "node RoiHead fc6/fc7 (N=50)": "node RoiHead fc6/fc7",
                 "IMP head (3 iters)": "IMP head (3 iters)"}
SGDET_NAMES = {"trunk fwd (B=8)": "trunk fwd",
               "detector full (trunk+RPN+NMS+head)":
                   "detector full (trunk+RPN+NMS+head)",
               "detector sans trunk (fmap given)":
                   "detector sans trunk (fmap given)",
               "rel head (": "rel head (pair budget)",
               "full retry eval step": "full retry eval step"}
PRETRAIN_NAMES = {n: n for n in profile_pretrain.STAGES}
# the trunk tool: XLA's operand orders become the two cuDNN layouts;
# cuDNN's conv1_1 is the port's own variant (no JAX counterpart)
TRUNK_NAMES = {"baseline trunk": "baseline",
               "B={bsz:3d}": "batch B=<n>",
               "channel_pad8": "variant channel_pad8",
               "im2col": "variant im2col",
               "im2col_manual": "variant im2col_manual",
               "fold_norm": "variant fold_norm",
               "NHWC/HWIO": "layout <conv> channels_last",
               "NCHW/OIHW": "layout <conv> nchw",
               "per_layer": "layer <name>"}



def test_profile_step():
    step_line = run(profile_step.main, TINY + [
        "--batch", "2", "--nodes", "6", "--edges", "12", "--img", "64"])[0]
    jax_names_exist("profile_step.py", STEP_NAMES)
    st = step_line["stages"]
    assert list(st) == list(STEP_NAMES.values()) == list(profile_step.STAGES)
    no_card_numbers(step_line)
    B, N, E, img, obj, H = 2, 6, 12, 64, 32, 16
    want = {"trunk fwd": trunk_flops(B, img),
            "K1 nodes": k1_flops(B * N), "K1 unions": k1_flops(B * E),
            "rects conv": rects_fwd(B * E),
            "roi_fmap fc6/fc7": head_fwd(B * E, obj),
            "full forward": trunk_flops(B, img)
            + relation_fwd(B, N, E, obj, H),
            "full train step": train_step(B, N, E, img, obj, H)}
    for name, w in want.items():
        assert close(st[name]["flops"], w), (name, st[name]["flops"], w)
    assert step_line["device"]["name"] == "cpu"


def test_profile_relhead():
    jax_names_exist("profile_relhead.py", RELHEAD_NAMES)
    B, N, E, img, obj, H = 2, 5, 8, 64, 32, 16
    line, out = run(profile_relhead.main, TINY + [
        "--batch", str(B), "--nodes", str(N), "--edges", str(E), "--img",
        str(img)])
    st = line["stages"]
    assert list(st) == list(RELHEAD_NAMES.values()) \
        == list(profile_relhead.STAGES)
    no_card_numbers(line)
    want = {"K1 nodes": k1_flops(B * N), "K1 unions": k1_flops(B * E),
            "K1 unions (dedup'd half)": k1_flops(B * E // 2),
            "rects conv branch": rects_fwd(B * E),
            "edge RoiHead fc6/fc7": head_fwd(B * E, obj),
            "node RoiHead fc6/fc7": head_fwd(B * N, obj),
            "IMP head (3 iters)": imp_fwd(B, N, E, obj, H)}
    for name, w in want.items():
        assert close(st[name]["flops"], w), (name, st[name]["flops"], w)
    parts = sum(want[p] for p in profile_relhead.PARTS)
    assert close(line["sum_of_parts"]["flops"], parts)
    assert "sum of parts" in out


def test_profile_trunk():
    jax_names_exist("profile_trunk.py", [n for n in TRUNK_NAMES
                                         if n != "per_layer"])
    B, img = 2, 32
    line, _ = run(profile_trunk.main, TINY + ["--batch", str(B), "--img",
                                              str(img)])
    st = line["stages"]
    no_card_numbers(line)
    layers = profile_trunk.layer_names()
    want_names = (["baseline"]
                  + [f"batch B={b}" for b in profile_trunk.batch_sweep(B)]
                  + [f"variant {v}" for v in profile_trunk.VARIANTS]
                  + [f"layout {c} {lay}" for c in ("conv1_1", "conv1_2")
                     for lay in profile_trunk.LAYOUTS]
                  + ["layer normalize"] + [f"layer {n}" for n in layers])
    assert list(st) == want_names
    full = trunk_flops(B, img)
    assert close(st["baseline"]["flops"], full)
    for b in profile_trunk.batch_sweep(B):
        assert close(st[f"batch B={b}"]["flops"], trunk_flops(b, img))
    stem = 2 * B * img * img * 3 * 64 * 9
    tail = full - stem
    assert close(st["variant channel_pad8"]["flops"],
                 tail + 2 * B * img * img * 8 * 64 * 9)
    for v in ("im2col", "im2col_manual", "fold_norm", "cudnn"):
        assert close(st[f"variant {v}"]["flops"], full), v
    assert all(e < 0.2 for e in line["variant_rel_err"].values()), \
        line["variant_rel_err"]
    for lay in profile_trunk.LAYOUTS:
        assert close(st[f"layout conv1_1 {lay}"]["flops"], stem)
        assert close(st[f"layout conv1_2 {lay}"]["flops"],
                     2 * B * img * img * 64 * 64 * 9)
    assert close(sum(st[f"layer {n}"]["flops"] for n in layers), full)
    assert st["layer normalize"]["flops"] == 0


def test_profile_sgdet():
    jax_names_exist("profile_sgdet.py", SGDET_NAMES)
    B, img = 2, 64
    line, out = run(profile_sgdet.main, TINY + [
        "--batch", str(B), "--nodes", "6", "--edges", "12", "--img",
        str(img)])
    st = line["stages"]
    assert list(st) == list(SGDET_NAMES.values()) \
        == list(profile_sgdet.STAGES)
    no_card_numbers(line)
    assert "CLS_SCALE" in out and line["cls_scale"] == 24.0
    assert close(st["trunk fwd"]["flops"], trunk_flops(B, img))
    # the detector on its own map is the detector less its trunk
    assert close(st["detector full (trunk+RPN+NMS+head)"]["flops"]
                 - st["detector sans trunk (fmap given)"]["flops"],
                 trunk_flops(B, img))
    assert min(line["detections"]) > 0


def test_profile_pretrain():
    jax_names_exist("profile_pretrain.py", PRETRAIN_NAMES)
    B, img = 2, 64
    line, out = run(profile_pretrain.main, TINY + [
        "--batch", str(B), "--nodes", "6", "--img", str(img)])
    st = line["stages"]
    assert list(st) == list(PRETRAIN_NAMES.values()) \
        == list(profile_pretrain.STAGES)
    no_card_numbers(line)
    trunk = trunk_flops(B, img)
    assert close(st["trunk fwd"]["flops"], trunk)
    # the backward adds at least the trunk's weight gradients
    assert st["fwd + bwd (grad)"]["flops"] \
        > st["fwd + losses (no grad)"]["flops"] + trunk - 2 * B * img \
        * img * 3 * 64 * 9
    assert st["FULL pretrain step"]["flops"] == pytest.approx(
        st["fwd + bwd (grad)"]["flops"], rel=0.05)
    assert set(line["shares"]) == {"trunk-fwd", "det-fwd", "losses", "bwd",
                                   "update+rest"}
    assert "shares" in out


# ---------------------------------------------------------------- gates

def test_gate_stage_timeout_is_recorded():
    """A stage that overruns its limit records ``timeout@<N>s`` (here the
    subprocess cannot even import torch within 0.05 s)."""
    got = reprobe_gates.run_stage("k1", "kernel", "cpu", True,
                                  timeout=0.05)
    assert got["error"] == "timeout@0.05s"
    r = {"kernel_ms": got, "plain_ms": 1.0}
    assert reprobe_gates.verdict(("kernel", "plain"), r).startswith(
        "no_determination")
    r = {"kernel_ms": {"error": "rc=1"}, "plain_ms": 1.0}
    assert reprobe_gates.verdict(("kernel", "plain"), r) == \
        "plain (others fail on this card)"


def test_gate_nms_methods_agree():
    import torch
    got = reprobe_gates.nms_indices(torch.device("cpu"))
    assert set(got) == set(reprobe_gates.STAGES["nms"])
    assert all(v == got["sequential"] for v in got.values())
    assert sum(i >= 0 for i in got["sequential"][0]) > 10


def test_gate_stage_in_process():
    """A stage's own entry (what each subprocess runs) and the n/a gates."""
    res = reprobe_gates.main(["k2", "cudnn", "--tiny", "-device", "cpu"])
    assert res["ms"] > 0 and set(res["launches"]) >= {"vgg_conv1"}
    assert set(reprobe_gates.NOT_PORTED) == {"outer_roi", "s2d_stem"}
    src = open(os.path.join(REPO, "tools", "reprobe_gates.py")).read()
    assert all(f'"{g}"' in src for g in reprobe_gates.NOT_PORTED)


# ---------------------------------------------------------------- throughput

def test_e2e_throughput():
    line, out = run(e2e_throughput.main, [
        "-device", "cpu", "--tiny", "--batch", "2", "--steps", "2",
        "--nodes", "6", "--edges", "12", "--img", "64"])
    assert list(line["stages"]) == ["epoch 0 (warm-up)", "epoch 1"]
    no_card_numbers(line)
    assert line["train_images_per_s"] == pytest.approx(
        4 / (line["stages"]["epoch 1"]["wall_ms"] / 1e3))
    assert "train images/s end to end" in out


def test_soak():
    line, out = run(soak.main, ["8", "1", "--batch", "4", "--img", "64",
                                "--tiny", "-device", "cpu"])
    no_card_numbers(line)
    assert "SOAK: 1 epochs x 8 images" in out
    assert line["results"] and all(math.isfinite(v)
                                   for v in line["results"].values())
    assert "predcls/test_alls_R@100_GC" in line["results"]


def test_soak_cache_without_h5py_raises_first(monkeypatch, tmp_path):
    """The feature cache needs h5py: without it (the card's machine) the
    soak names it before building anything."""
    import sys
    monkeypatch.setitem(sys.modules, "h5py", None)
    built = []
    monkeypatch.setattr(soak, "build_model",
                        lambda *a, **k: built.append(a))
    with pytest.raises(ImportError, match="h5py"):
        soak.main(["8", "1", str(tmp_path), "-device", "cpu"])
    assert not built
