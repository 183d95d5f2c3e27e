"""The reference ``.pth`` importers of ``sgg_torch.train.checkpoint``
against ``sgg_tpu.train.checkpoint``'s on the same torchvision-format
state dicts (``sgg_torch.import_reference_ckpt.reference_state_dict``,
seeded):

* the port's result equals ``variables_from_jax`` of the JAX importer's,
  bitwise, key by key, for the VGG16 relation model, the VGG16 Faster
  R-CNN, the reference relation model, the ResNet50-FPN backbone (alone
  and inside a ``FasterRCNNFPN``) and the GAN (generator, spectral-norm
  discriminators with their power-iteration vectors);
* the skipped names (state entries not filled, checkpoint tensors without a
  home) are the JAX importer's under the port's names, and a damaged dict
  (names left out, a tensor of another shape, a name the model lacks)
  keeps the initial values in both packages;
* an imported VGG16 detector's f32 forward matches JAX's imported detector;
* ``python -m sgg_torch.import_reference_ckpt`` writes payloads that load
  with ``strict=True``, and ``-m sgdet -ckpt`` runs on one on the CPU."""

import copy
import functools
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sgg_tpu.train.checkpoint as jckpt
from sgg_tpu.models.detector import FasterRCNNFPN as JDetFPN
from sgg_tpu.models.detector import FasterRCNNVGG as JDet
from sgg_tpu.models.gan import GANModel as JGAN
from sgg_tpu.models.relhead import RelModelIMP as JModel
from sgg_tpu.models.resnet import ResNet50FPN as JResNet
from sgg_tpu.train.assign import all_pairs
from sgg_torch import import_reference_ckpt as tool
from sgg_torch.convert import _convert_leaf, variables_from_jax
from sgg_torch.models.detector import FasterRCNNFPN, FasterRCNNVGG
from sgg_torch.models.gan import GANModel
from sgg_torch.models.relhead import RelModelIMP
from sgg_torch.models.resnet import ResNet50FPN
from sgg_torch.train import checkpoint as ckpt
from test_torch_detector import UNCAPPED, assert_detections_match
from test_torch_models import random_variables
from test_torch_resnet_fpn import one_thread  # noqa: F401

C, P, IMG = 9, 6, 64
REL_KW = dict(num_classes=C, num_predicates=P, hidden_dim=16, obj_dim=32,
              use_bias=True)
DET_KW = dict(obj_dim=48)
FPN_DET_KW = dict(obj_dim=32, rpn_pre_nms_top_n=96, rpn_post_nms_top_n=80,
                  detections_per_img=8)
GAN_KW = dict(hidden_dim=8, n_ch=32, fmap_sz=8, n_layers_G=2, largeD=True)
GAN_SHAPE = dict(n_layers=2, largeD=True)  # the reference dict's rows


def _rel_args():
    nm = jnp.ones((1, 3), bool)
    pairs, pm = all_pairs(nm)
    return (jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, 3, 4)),
            jnp.ones((1, 3), jnp.int32), pairs, pm)


def _det_args():
    return jnp.zeros((1, IMG, IMG, 3)), jnp.full((1, 2), float(IMG))


# kind -> (JAX model, init args, port model, JAX importer on variables,
#          port importer, reference-dict kind); built once a kind
@functools.lru_cache(maxsize=None)
def _case(kind):
    if kind == "vgg":
        return (JModel(dtype=jnp.float32, **REL_KW), _rel_args(),
                RelModelIMP(**REL_KW),
                lambda v, sd: {**v, "params": jckpt.import_torch_vgg(
                    v["params"], sd)},
                ckpt.import_torch_vgg, "vgg")
    if kind == "detector":
        return (JDet(num_classes=C, dtype=jnp.float32, **DET_KW),
                _det_args(), FasterRCNNVGG(C, **DET_KW),
                lambda v, sd: {**v, "params": jckpt.import_torch_faster_rcnn(
                    v["params"], sd)},
                ckpt.import_torch_faster_rcnn, "detector")
    if kind == "relmodel":
        return (JModel(dtype=jnp.float32, **REL_KW), _rel_args(),
                RelModelIMP(**REL_KW), jckpt.import_torch_relmodel,
                ckpt.import_torch_relmodel, "relmodel")
    if kind == "resnet_fpn":
        return (JResNet(dtype=jnp.float32), (jnp.zeros((1, IMG, IMG, 3)),),
                ResNet50FPN(), jckpt.import_torch_resnet50_fpn,
                ckpt.import_torch_resnet50_fpn, "resnet_fpn")
    if kind == "gan":
        nm = jnp.ones((1, 3), bool)
        args = (jnp.ones((1, 3), jnp.int32), jnp.full((1, 3, 4), 0.5),
                jnp.zeros((1, 4, 3), jnp.int32), nm, jnp.ones((1, 4), bool))
        return (JGAN(num_classes=C, num_predicates=P, **GAN_KW), args,
                GANModel(C, P, **GAN_KW),
                functools.partial(jckpt.import_torch_gan, num_gcn_layers=2,
                                  largeD=True),
                functools.partial(ckpt.import_torch_gan, num_gcn_layers=2,
                                  largeD=True), "gan")
    assert kind == "fpn_detector"
    return (JDetFPN(num_classes=C, dtype=jnp.float32, **FPN_DET_KW),
            _det_args(), FasterRCNNFPN(C, **FPN_DET_KW),
            functools.partial(jckpt.import_torch_resnet50_fpn,
                              ours_prefix="backbone/"),
            _import_into_backbone, "resnet_fpn")


def _import_into_backbone(template, sd, return_stats):
    """The port's ResNet50-FPN import into a ``FasterRCNNFPN``'s
    ``backbone``, with the detector's other names reported as kept."""
    pre = "backbone."
    merged, stats = ckpt.import_torch_resnet50_fpn(
        {k[len(pre):]: v for k, v in template.items() if k.startswith(pre)},
        sd, return_stats=True)
    got = {k: merged[k[len(pre):]] if k.startswith(pre) else v
           for k, v in template.items()}
    missing = [k for k in template if not k.startswith(pre)
               and not k.endswith("num_batches_tracked")]
    return got, {"missing": missing + [pre + k for k in stats["missing"]],
                 "unused": [pre + k for k in stats["unused"]]}


@functools.lru_cache(maxsize=None)
def _variables(kind):
    jm, args = _case(kind)[:2]
    if kind == "gan":  # GANModel.init_all creates the Ds too
        jm = types.SimpleNamespace(init=functools.partial(
            jm.init, method=JGAN.init_all))
    return random_variables(jm, args, seed=3)


def _reference_dict(kind, port_model, damaged):
    ref_kind = _case(kind)[5]
    shape_src = _case("resnet_fpn")[2] if ref_kind == "resnet_fpn" \
        else port_model
    sd = tool.reference_state_dict(ref_kind, shape_src,
                                   torch.Generator().manual_seed(7),
                                   **(GAN_SHAPE if kind == "gan" else {}))
    if damaged:
        names = sorted(sd)
        for k in names[::5]:  # names the checkpoint lacks
            del sd[k]
        k = next(k for k in names[1::5]
                 if k.endswith("weight") and sd[k].dim() != 2)
        sd[k] = torch.ones([s + 1 for s in sd[k].shape])  # another shape
        sd["no_such_module.weight"] = torch.ones(2)  # never read
    return sd


def _port_name(collection, name, leaf):
    """A JAX importer's path ('a/b/kernel') under the port's name."""
    path = tuple(name.split("/"))
    if collection is None:
        collection, path = path[0], path[1:]
    return _convert_leaf(collection, path, np.asarray(leaf))[0]


def _jax_import(monkeypatch, importer, variables, sd_np, params_only):
    """The JAX importer's result and its skipped names, under the port's
    names (its ``optimistic_update`` computes the stats it does not
    return)."""
    seen = {}
    real = jckpt.optimistic_update

    def spy(tree, flat, verbose=False, return_stats=False):
        merged, stats = real(tree, flat, verbose=verbose, return_stats=True)
        leaves = {"/".join(str(getattr(k, "key", k)) for k in p): x
                  for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}
        coll = "params" if params_only else None
        seen["missing"] = [_port_name(coll, n, leaves[n])
                           for n in stats["missing"]]
        seen["unused"] = sorted(_port_name(coll, n, flat[n])
                                for n in stats["unused"])
        return (merged, stats) if return_stats else merged

    monkeypatch.setattr(jckpt, "optimistic_update", spy)
    return importer(variables, sd_np), seen


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("damaged", [False, True], ids=["full", "damaged"])
@pytest.mark.parametrize("kind", ["vgg", "detector", "relmodel",
                                  "resnet_fpn", "fpn_detector", "gan"])
def test_importer_matches_jax_bitwise(monkeypatch, kind, damaged):
    _, _, port_model, jimport, timport, _ = _case(kind)
    variables = _variables(kind)
    sd = _reference_dict(kind, port_model, damaged)
    sd_np = {k: v.numpy() for k, v in sd.items()}
    params_only = kind in ("vgg", "detector")
    want_vars, want_stats = _jax_import(monkeypatch, jimport, variables,
                                        sd_np, params_only)
    want = variables_from_jax(want_vars)
    template = variables_from_jax(variables)
    if params_only:  # the JAX importer leaves the BatchNorm buffers alone
        want_stats["missing"] += [
            k for k in template if k.endswith(("running_mean", "running_var"))]
    got, stats = timport(template, sd, return_stats=True)

    assert list(got) == list(template)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
    assert sorted(stats["missing"]) == sorted(want_stats["missing"])
    assert stats["unused"] == want_stats["unused"]
    # every tensor that found a home landed bitwise, after its layout change
    filled = {k for k in template if not k.endswith("num_batches_tracked")
              } - set(stats["missing"])
    changed = [k for k in filled if not torch.equal(got[k], template[k])]
    assert len(changed) == len(filled) and filled
    if damaged:
        assert stats["missing"] and stats["unused"]
        for k in stats["missing"]:
            assert torch.equal(got[k], template[k]), k
    else:  # a whole checkpoint leaves only what the reference lacks
        assert stats["unused"] == []
        copy.deepcopy(port_model).load_state_dict(got, strict=True)


def test_fc6_permutation_and_gru_gates():
    """fc6 reads the port's (P, P, C) flatten order; the GRU gates and
    both biases pass through in torch's [r; z; n] order."""
    model = _case("relmodel")[2]
    sd = tool.reference_state_dict("relmodel", model,
                                   torch.Generator().manual_seed(1))
    got = ckpt.import_torch_relmodel(model.state_dict(), sd)
    w = sd["roi_fmap.1.0.weight"]  # (out, C * 7 * 7), channel-major
    c = w.shape[1] // 49
    x = torch.randn(2, 7, 7, c)  # a pooled NHWC RoI
    torch.testing.assert_close(
        x.reshape(2, -1) @ got["roi_fmap.fc6.weight"].T,
        x.permute(0, 3, 1, 2).reshape(2, -1) @ w.T, rtol=1e-5, atol=1e-5)
    for k in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
        assert torch.equal(got[f"imp.node_gru.{k}"], sd[f"node_gru.{k}"])
    assert torch.equal(got["union_feats.bn2.running_var"],
                       sd["union_boxes.conv.6.running_var"])
    assert torch.equal(got["freq_bias.table"],
                       sd["freq_bias.obj_baseline.weight"])


def test_load_torch_state_dict_takes_the_sub_dict(tmp_path):
    sd = {"a.weight": torch.ones(2, 3), "b.bias": torch.zeros(2)}
    torch.save({"state_dict": sd, "epoch": 3}, tmp_path / "full.pth")
    torch.save(sd, tmp_path / "bare.pth")
    for name in ("full.pth", "bare.pth"):
        got = ckpt.load_torch_state_dict(str(tmp_path / name))
        assert set(got) == set(sd)
        assert all(torch.equal(got[k], sd[k]) for k in sd)


def test_imported_detector_forward_matches_jax():
    """The same reference detector through both packages' importers and
    forwards, f32 at 96 px, every cap above what it caps (the tolerances
    of ``test_torch_detector.py``)."""
    rng = np.random.RandomState(0)
    images = rng.randn(2, 96, 96, 3).astype(np.float32)
    im_hw = np.asarray([[96, 96], [80.0, 96]], np.float32)
    # a random 8-way classifier scores near 1/8: a threshold below it
    kw = dict(DET_KW, score_thresh=0.05, **UNCAPPED)
    jd = JDet(num_classes=8, dtype=jnp.float32, **kw)
    variables = random_variables(jd, (jnp.asarray(images),
                                      jnp.asarray(im_hw)), seed=2)
    td = FasterRCNNVGG(8, **kw)
    sd = tool.reference_state_dict("detector", td,
                                   torch.Generator().manual_seed(5))
    params = jckpt.import_torch_faster_rcnn(
        variables["params"], {k: v.numpy() for k, v in sd.items()})
    want = {k: np.asarray(x) for k, x in jax.jit(
        lambda v, i, h: jd.apply(v, i, h))(
            {**variables, "params": params}, images, im_hw).items()}
    td.load_state_dict(ckpt.import_torch_faster_rcnn(td.state_dict(), sd),
                       strict=True)
    with torch.no_grad():
        got = td.eval()(torch.from_numpy(images), torch.from_numpy(im_hw))
    assert want["mask"].sum() > 20
    assert_detections_match({k: x.numpy() for k, x in got.items()}, want)


@pytest.fixture
def tiny_tool(monkeypatch):
    """The tool's models at tiny widths (the ResNet50 body keeps its)."""
    from sgg_torch.models import detector as det_mod
    from sgg_torch.models import relhead as rel_mod
    monkeypatch.setattr(det_mod, "FasterRCNNVGG", functools.partial(
        FasterRCNNVGG, obj_dim=32, rpn_pre_nms_top_n=64,
        rpn_post_nms_top_n=32, detections_per_img=8))
    monkeypatch.setattr(rel_mod, "RelModelIMP", functools.partial(
        RelModelIMP, hidden_dim=16, obj_dim=32))


@pytest.mark.usefixtures("one_thread", "tiny_tool")
@pytest.mark.parametrize("kind", tool.KINDS)
def test_tool_writes_strict_payloads(tmp_path, kind):
    model = tool.build_model(kind, C, use_bias=kind == "relmodel")
    sd = tool.reference_state_dict(kind, model,
                                   torch.Generator().manual_seed(3))
    pth = tmp_path / "ref.pth"
    torch.save({"state_dict": sd} if kind == "relmodel" else sd, pth)
    out = tool.main([kind, str(pth), str(tmp_path / "out"), str(C)])
    assert out["stats"]["unused"] == []
    payload, epoch = ckpt.restore_payload(str(tmp_path / "out"))
    assert epoch == 0
    fresh = tool.build_model(kind, C, use_bias=kind == "relmodel")
    fresh.load_state_dict({**payload["params"], **payload["batch_stats"]},
                          strict=True)
    flat = ckpt.reference_flat_updates(kind, sd)
    assert flat
    for name, src in flat.items():
        assert torch.equal(fresh.state_dict()[name], src), name


@pytest.mark.usefixtures("tiny_tool")
def test_sgdet_runs_on_an_imported_detector(tmp_path, monkeypatch):
    """``-m sgdet -ckpt <imported dir> -device cpu -nepoch 0``: the test
    sweep on the frozen imported detector (64 px canvases, tiny heads)."""
    import sgg_torch.constants
    from sgg_torch import main as cli
    from sgg_torch.models.relhead import init_weights
    from sgg_torch.train import trainer as trainer_mod
    monkeypatch.setattr(sgg_torch.constants, "IM_SCALE", IMG)

    def build(config, train_data, *, device="cuda", seed=0):
        return init_weights(RelModelIMP(
            num_classes=train_data.num_classes,
            num_predicates=train_data.num_predicates, mode=config.mode,
            hidden_dim=16, obj_dim=32), seed).to(device).eval()

    monkeypatch.setattr(trainer_mod, "build_model", build)
    model = tool.build_model("detector", 151)
    sd = tool.reference_state_dict("detector", model,
                                   torch.Generator().manual_seed(4))
    torch.save(sd, tmp_path / "det.pth")
    tool.main(["detector", str(tmp_path / "det.pth"), str(tmp_path / "det")])
    res = cli.main(["-m", "sgdet", "-ckpt", str(tmp_path / "det"),
                    "-split", "synthetic", "-device", "cpu", "-nepoch", "0",
                    "-val_size", "4", "-nwork", "1", "-save_dir",
                    str(tmp_path / "run")])
    assert os.path.exists(tmp_path / "run" / "test_results.json")
    assert all(np.isfinite(v) for k, v in res.items()
               if not k.startswith("_"))
