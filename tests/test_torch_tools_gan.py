"""``python -m sgg_torch.tools.profile_gan`` on the CPU at a tiny size (a
file of its own: the GAN's runs are the profilers' longest): its stages
map onto the JAX tool's printed stages; F (the sgcls train step), G's
forward, the relation model's pass on the fake map and the Ds' forwards
equal their analytic FLOP counts at 1e-6 (``tests/tools_flops.py``); G's
and the Ds' backward depend on which inputs need gradients across three
models and are held by inequalities. ``--bf16`` (autocast) computes the
same products in bf16."""

from tools_flops import (NC, NR, TINY, close, generator_fwd, global_disc,
                         jax_names_exist, no_card_numbers, one_thread,
                         patch_disc, relation_fwd, run, train_step)

from sgg_torch.tools import profile_gan

assert one_thread  # the module-wide fixture (tests/tools_flops.py)

GAN_NAMES = {"phase F: SGG fwd+bwd+update": "phase F: SGG fwd+bwd+update",
             "G forward (GCN+layout+CRN)": "G forward (GCN+layout+CRN)",
             "G fwd+bwd (grad wrt G params)": "G fwd+bwd (grad wrt G params)",
             "SGG fwd on fake fmap (per call)":
                 "SGG fwd on fake fmap (per call)",
             "D_nodes fwd (960 rois)": "D_nodes fwd",
             "D_edges fwd (6144 unions)": "D_edges fwd",
             "D_global fwd (24 fmaps)": "D_global fwd",
             "phase D: 3xD fwd+bwd (2 passes each)":
                 "phase D: 3xD fwd+bwd (2 passes each)",
             "FULL GAN F/G/D step": "FULL GAN F/G/D step"}

def test_profile_gan():
    jax_names_exist("profile_gan.py", GAN_NAMES)
    B, N, E, img, obj, H = 2, 6, 12, 128, 32, 16
    line, out = run(profile_gan.main, TINY + [
        "--batch", str(B), "--nodes", str(N), "--edges", str(E), "--img",
        str(img)])
    st = line["stages"]
    assert list(st) == list(GAN_NAMES.values()) == list(profile_gan.STAGES)
    no_card_numbers(line)
    fm = img // 16
    want = {"phase F: SGG fwd+bwd+update": train_step(B, N, E, img, obj, H),
            "G forward (GCN+layout+CRN)": generator_fwd(B, N, E, fm, 8, 2),
            "SGG fwd on fake fmap (per call)": relation_fwd(B, N, E, obj,
                                                            H),
            "D_nodes fwd": patch_disc(B * N, 512 + NC),
            "D_edges fwd": patch_disc(B * E, 512 + NR),
            "D_global fwd": global_disc(B, fm, fm)}
    for name, w in want.items():
        assert close(st[name]["flops"], w), (name, st[name]["flops"], w)
    d_fwd = sum(want[k] for k in ("D_nodes fwd", "D_edges fwd",
                                  "D_global fwd"))
    # two passes of each D and their backward
    assert st["phase D: 3xD fwd+bwd (2 passes each)"]["flops"] > 2 * d_fwd
    assert st["G fwd+bwd (grad wrt G params)"]["flops"] \
        > st["G forward (GCN+layout+CRN)"]["flops"]
    assert set(line["phases_ms"]) == {"F", "G", "D"}
    assert all(v > 0 for v in line["phases_ms"].values())
    assert "shares of the full step" in out
    assert line["dtype"] == "float32 GAN, bfloat16 SGG"


def test_profile_gan_bf16():
    """``--bf16`` (autocast) computes the same products in bf16."""
    B, N, E, img = 2, 6, 12, 128
    line, out = run(profile_gan.main, TINY + [
        "--batch", str(B), "--nodes", str(N), "--edges", str(E), "--img",
        str(img), "--bf16"])
    st = line["stages"]
    no_card_numbers(line)
    assert line["dtype"] == "bfloat16 GAN, bfloat16 SGG"
    assert "GAN: bfloat16" in out
    fm = img // 16
    assert close(st["G forward (GCN+layout+CRN)"]["flops"],
                 generator_fwd(B, N, E, fm, 8, 2))
    assert close(st["D_global fwd"]["flops"], global_disc(B, fm, fm))
    assert all(s["peak"] == "bf16" for s in st.values())
