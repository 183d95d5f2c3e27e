"""Convert reference PyTorch checkpoints into the port's payloads.

    python -m sgg_torch.import_reference_ckpt detector <ckpt.pth> <out_dir> \
        [num_classes]
    python -m sgg_torch.import_reference_ckpt vgg <vgg16.pth> <out_dir>
    python -m sgg_torch.import_reference_ckpt relmodel <vgrel.pth> <out_dir>
    python -m sgg_torch.import_reference_ckpt resnet_fpn <maskrcnn.pth> \
        <out_dir>
    python -m sgg_torch.import_reference_ckpt gan <vgrel.pth> <out_dir>

Counterpart of ``tools/import_reference_ckpt.py``. ``detector`` maps a torchvision ``FasterRCNN(vgg16)``
``state_dict`` (the reference's detector checkpoints) onto a
``FasterRCNNVGG``; ``vgg`` maps a plain torchvision VGG16 onto the relation
model's trunk and RoI heads; ``relmodel`` maps a reference
``RelModelStanford`` ``vgrel.pth`` (head, RoI heads, union-boxes convs,
frequency bias, trunk) onto a ``RelModelIMP``; ``resnet_fpn`` maps a
torchvision ``maskrcnn``/``fasterrcnn_resnet50_fpn`` backbone onto a
``ResNet50FPN``; ``gan`` maps a reference ``GAN`` state (the ``gan`` entry
of a ``vgrel.pth``, or a bare GAN state dict: the generator and the three
spectral-norm discriminators) onto a ``GANModel`` whose widths, GCN depth
and ``largeD`` are read off the checkpoint. Names the checkpoint lacks keep
seeded random values (seed 0); the skipped names are printed.

Each writes ``<out_dir>/vgrel-0.pth`` (``train/checkpoint.py``), holding
``{"step", "params", "batch_stats", "epoch"}`` keyed by ``state_dict``
name, which loads into its model with ``strict=True``: a ``detector``
directory is what ``-m sgdet -ckpt`` takes (``load_detector``), the others
restore with ``restore_payload``.
"""

from __future__ import annotations

import os
import sys
from typing import Optional, Sequence

import torch

from sgg_torch.train import checkpoint as ckpt

KINDS = ckpt.REFERENCE_KINDS


def build_model(kind: str, num_classes: int = 151, use_bias: bool = False,
                **gan_kw):
    """The port model a ``kind`` of checkpoint maps onto, with seed-0
    random weights, on the CPU (``gan_kw``: the ``GANModel``'s other
    arguments; 51 predicates unless given)."""
    from sgg_torch.models.detector import FasterRCNNVGG, init_detector_weights
    from sgg_torch.models.gan import GANModel, init_gan_weights
    from sgg_torch.models.relhead import RelModelIMP, init_weights
    from sgg_torch.models.resnet import ResNet50FPN

    if kind == "gan":
        gan_kw.setdefault("num_predicates", 51)
        return init_gan_weights(GANModel(num_classes, **gan_kw), 0)
    if kind == "detector":
        return init_detector_weights(FasterRCNNVGG(num_classes), 0)
    if kind in ("vgg", "relmodel"):
        return init_weights(RelModelIMP(num_classes=num_classes,
                                        num_predicates=51,
                                        use_bias=use_bias), 0)
    if kind == "resnet_fpn":
        return init_weights(ResNet50FPN(), 0)
    raise ValueError(f"unknown kind {kind!r}: one of {KINDS}")


def gan_shape(sd) -> dict:
    """A reference GAN state dict's ``GANModel`` arguments, read off its
    tensors as ``tools/import_reference_ckpt.py`` reads them: vocabulary,
    embedding and hidden widths, the maps' channels, the GCN's depth and
    output (hence the pool size), BatchNorms and ``largeD``."""
    n_gcn = 1 + max(int(k.split(".")[2]) for k in sd
                    if k.startswith("G_gcn.gconvs."))
    hidden = int(sd["G_proj.weight"].shape[0])
    if int(sd["G_proj.weight"].shape[1]) > hidden:
        raise NotImplementedError(
            "a GAN trained with -vis_cond: the feature bank is not ported "
            "to sgg_torch yet (ROADMAP Queue A)")
    d0 = sd.get("D_global.0.weight_orig", sd.get("D_global.0.weight"))
    net2 = f"G_gcn.gconvs.{n_gcn - 1}.net2."
    last = max(int(k.split(".")[4]) for k in sd if k.startswith(net2)
               and k.endswith(".weight") and sd[k].dim() == 2)
    gcn_out = int(sd[f"{net2}{last}.weight"].shape[0])
    return dict(num_classes=int(sd["G_obj_embed.weight"].shape[0]),
                num_predicates=int(sd["G_rel_embed.weight"].shape[0]),
                embed_dim=int(sd["G_obj_embed.weight"].shape[1]),
                hidden_dim=hidden, n_ch=int(d0.shape[1]),
                pool_sz=int(round((gcn_out / (hidden // 2)) ** 0.5)),
                n_layers_G=n_gcn,
                batch_norm="G_gcn.gconvs.0.net1.1.running_mean" in sd,
                largeD=any(k.startswith("D_global.2.") for k in sd))


def reference_state_dict(kind: str, model: torch.nn.Module,
                         generator: torch.Generator, **gan_shape
                         ) -> "dict[str, torch.Tensor]":
    """Seeded random tensors under the names a reference checkpoint of
    ``kind`` uses (the first of ``ckpt.reference_modules``' names a row),
    shaped as ``model``'s counterparts (a port model of any width): a
    stand-in for the reference's files in tests and rehearsals. Weights are
    drawn at unit activation scale, biases and BatchNorm statistics near
    their identities, the RPN head at torchvision's init; BatchNorms carry
    torchvision's ``num_batches_tracked``; VGG16's 1000-way
    ``classifier.6``, which the port has no use for, comes along. A GAN's
    spectral-norm convs carry ``weight_orig`` and unit ``weight_u`` and
    ``weight_v``, as torch's ``spectral_norm`` stores them (``gan_shape``:
    as ``checkpoint.reference_modules`` takes it)."""
    sd = model.state_dict()
    g = generator
    out: dict = {}

    def randn(shape, std):
        return torch.randn(shape, generator=g) * std

    def unit(n):
        v = torch.randn(n, generator=g)
        return v / v.norm()

    for refs, o, typ in ckpt.reference_modules(kind, **gan_shape):
        t = refs[0]
        if f"{t}.weight" in out:  # one module read into two (VGG16's fcs)
            continue
        if typ == "snconv":
            w = sd[f"{o}.Conv_0.weight"]
            out[f"{t}.weight_orig"] = randn(w.shape, w[0].numel() ** -0.5)
            out[f"{t}.bias"] = randn(w.shape[:1], 0.01)
            out[f"{t}.weight_u"] = unit(w.shape[0])
            out[f"{t}.weight_v"] = unit(w[0].numel())
            continue
        for sfx_t, sfx_o in ckpt._TENSORS[typ]:
            if f"{o}.{sfx_o}" not in sd:  # not in this model (biases, ...)
                continue
            shape, name = sd[f"{o}.{sfx_o}"].shape, f"{t}.{sfx_t}"
            if sfx_t == "running_var":
                out[name] = 0.5 + torch.rand(shape, generator=g)
            elif typ == "bn":  # scale near 1, shift and mean near 0
                out[name] = randn(shape, 0.1) + float(sfx_t == "weight")
            elif typ == "gru":
                out[name] = randn(shape, shape[-1] ** -0.5
                                  if sfx_t.startswith("w") else 0.1)
            elif typ in ("table", "embed"):
                out[name] = randn(shape, 1.0)
            elif t.startswith("rpn.head."):  # torchvision's RPNHead init
                out[name] = (randn(shape, 0.01) if sfx_t == "weight"
                             else torch.zeros(shape))
            elif sfx_t == "weight":
                gain = 2.0 if len(shape) == 4 else 1.0
                out[name] = randn(shape, (gain / shape[1:].numel()) ** 0.5)
            else:
                out[name] = randn(shape, 0.01)
        if typ == "bn" and f"{t}.weight" in out:
            out[f"{t}.num_batches_tracked"] = torch.tensor(1000)
    if kind == "vgg":
        fc7 = sd["roi_fmap_obj.fc7.weight"]
        out["classifier.6.weight"] = randn((1000, fc7.shape[0]), 0.01)
        out["classifier.6.bias"] = torch.zeros(1000)
    return out


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Returns ``{"model", "stats"}``: the imported model (on the CPU) and
    the import's skipped names (``missing``, ``unused``)."""
    args = list(sys.argv[1:] if argv is None else argv)
    if len(args) not in (3, 4) or args[0] not in KINDS:
        raise SystemExit(__doc__)
    kind, pth_path, out_dir = args[:3]
    num_classes = int(args[3]) if len(args) > 3 else 151
    sd = ckpt.load_torch_state_dict(
        pth_path, key="gan" if kind == "gan" else "state_dict")
    print(f"loaded {len(sd)} tensors from {pth_path}")
    shape: dict = {}
    if kind == "gan":
        gan_kw = gan_shape(sd)
        num_classes = gan_kw.pop("num_classes")
        model = build_model(kind, num_classes, **gan_kw)
        shape = dict(n_layers=gan_kw["n_layers_G"],
                     batch_norm=gan_kw["batch_norm"],
                     largeD=gan_kw["largeD"])
    else:
        model = build_model(kind, num_classes,
                            use_bias="freq_bias.obj_baseline.weight" in sd)
    merged, stats = ckpt.optimistic_update(
        model.state_dict(), ckpt.reference_flat_updates(kind, sd, **shape),
        verbose=True, return_stats=True)
    model.load_state_dict(merged, strict=True)
    print(f"{kind}: {len(stats['missing'])} names kept their initial "
          f"values {stats['missing'][:20]}; {len(stats['unused'])} "
          f"checkpoint tensors had no home {stats['unused'][:20]}")
    ckpt.save_payload(os.path.abspath(out_dir), {
        "step": torch.tensor(0),
        "params": {k: v.detach() for k, v in model.named_parameters()},
        "batch_stats": dict(model.named_buffers()),
        "epoch": torch.tensor(0)}, 0)
    print(f"wrote {ckpt.CKPT_NAME}-0.pth to {out_dir}")
    return {"model": model, "stats": stats}


if __name__ == "__main__":
    main()
