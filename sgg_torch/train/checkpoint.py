"""Checkpoint save and (optimistic) restore with ``torch.save``.

Counterpart of the payload half of ``sgg_tpu/train/checkpoint.py``
(reference ``lib/pytorch_misc.py:17-57,160-233``): one file per epoch,
``<save_dir>/vgrel-<epoch>.pth``, holding a nested dict of tensors (the
trainer's payload: step, parameters, buffers, optimizer state, epoch);
only the last ``MAX_TO_KEEP`` epochs are kept, as orbax's
``max_to_keep=3``. A restore copies every leaf whose path and shape match
the caller's template and reports the rest, as the reference's
``optimistic_restore``.

A detector directory (what ``-ckpt`` names in mode sgdet) has the same
layout: ``vgrel-<epoch>.pth`` holding ``{"params", "batch_stats"}`` of a
``FasterRCNNVGG`` or ``FasterRCNNFPN``, keyed by ``state_dict`` name.

The reference's own checkpoints (torchvision-format state dicts) import
through ``import_torch_vgg``, ``import_torch_faster_rcnn``,
``import_torch_relmodel``, ``import_torch_resnet50_fpn`` and
``import_torch_gan``, the JAX package's importers
(``sgg_tpu/train/checkpoint.py:176-700``) onto the port's names and
layouts; ``python -m sgg_torch.import_reference_ckpt`` writes their
payloads.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

CKPT_NAME = "vgrel"  # the reference's vgrel.pth
MAX_TO_KEEP = 3
_FILE = re.compile(rf"^{CKPT_NAME}-(\d+)\.pth$")


def _path(save_dir: str, epoch: int) -> str:
    return os.path.join(save_dir, f"{CKPT_NAME}-{epoch}.pth")


def _epochs(save_dir: str) -> List[int]:
    if not os.path.isdir(save_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_FILE.match,
                                               os.listdir(save_dir)) if m)


def save_payload(save_dir: str, payload: Mapping[str, Any],
                 epoch: int) -> None:
    """Write ``payload`` as the checkpoint of ``epoch`` (atomically: a
    temporary file renamed into place) and drop all but the newest
    ``MAX_TO_KEEP``."""
    os.makedirs(save_dir, exist_ok=True)
    path = _path(save_dir, epoch)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    for old in _epochs(save_dir)[:-MAX_TO_KEEP]:
        os.remove(_path(save_dir, old))


def latest_epoch(save_dir: str) -> Optional[int]:
    epochs = _epochs(save_dir)
    return epochs[-1] if epochs else None


def _flatten(tree: Mapping[str, Any], prefix: str = ""):
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            yield from _flatten(v, name + "/")
        else:
            yield name, v


def _merge(template: Mapping[str, Any], flat: Dict[str, torch.Tensor],
           used: set, missing: list, prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, leaf in template.items():
        name = f"{prefix}{k}"
        if isinstance(leaf, Mapping):
            out[k] = _merge(leaf, flat, used, missing, name + "/")
            continue
        got = flat.get(name)
        if isinstance(got, torch.Tensor) and got.shape == leaf.shape:
            out[k] = got.to(dtype=leaf.dtype, device=leaf.device)
            used.add(name)
        else:
            missing.append(name)
            out[k] = leaf
    return out


def optimistic_restore_payload(
        save_dir: str, template: Mapping[str, Any],
        epoch: Optional[int] = None, verbose: bool = True,
        map_location="cpu") -> Tuple[Dict[str, Any], int, set, Dict]:
    """Restore the latest (or ``epoch``'s) checkpoint into ``template``, a
    nested dict of tensors: every template leaf whose path (``a/b/c``) and
    shape match an on-disk tensor takes its value, cast to the template
    leaf's type and device; the others keep the template's value.

    The file is read with ``map_location`` (the caller's device), so a
    card checkpoint restores on the CPU. Returns (merged, epoch,
    on-disk top-level keys, stats) with ``stats["missing"]`` the template
    leaves not filled from disk and ``stats["unused"]`` the on-disk leaves
    with no home; epoch is -1, and the template comes back, when there is
    no checkpoint. A resume from a run's own ``save_dir`` should find both
    lists empty.
    """
    on_disk, epoch = restore_payload(save_dir, epoch, map_location)
    if epoch < 0:
        return dict(template), -1, set(), {"missing": [], "unused": []}
    flat = dict(_flatten(on_disk))
    used: set = set()
    missing: list = []
    merged = _merge(template, flat, used, missing)
    unused = sorted(set(flat) - used)
    if verbose:
        for name in missing:
            if name in flat:
                print(f"shape mismatch for {name}: "
                      f"{tuple(flat[name].shape)} on disk")
        if unused:
            print("unused checkpoint keys:", unused[:20])
    return merged, epoch, set(on_disk), {"missing": missing,
                                              "unused": unused}


def restore_payload(save_dir: str, epoch: Optional[int] = None,
                    map_location="cpu") -> Tuple[Dict[str, Any], int]:
    """The latest (or ``epoch``'s) payload as saved, read onto
    ``map_location``; (None, -1) when there is none."""
    if epoch is None:
        epoch = latest_epoch(save_dir)
        if epoch is None:
            return None, -1
    return torch.load(_path(save_dir, epoch), map_location=map_location,
                      weights_only=True), int(epoch)


def save_detector(save_dir: str, detector: torch.nn.Module,
                  epoch: int = 0) -> None:
    """Write ``detector``'s weights as a detector payload."""
    save_payload(save_dir, {
        "params": {k: v.detach() for k, v in detector.named_parameters()},
        "batch_stats": dict(detector.named_buffers())}, epoch)


def load_detector(save_dir: str, map_location="cpu"
                  ) -> Tuple[Dict[str, Any], int]:
    """The latest detector payload in ``save_dir`` and its epoch; raises
    ``FileNotFoundError`` when there is none."""
    payload, epoch = restore_payload(save_dir, map_location=map_location)
    if epoch < 0:
        raise FileNotFoundError(f"no detector checkpoint "
                                f"({CKPT_NAME}-<epoch>.pth) in {save_dir!r}")
    return payload, epoch


def load_detector_state(detector: torch.nn.Module,
                        payload: Mapping[str, Any]) -> None:
    """Load a detector payload into ``detector`` with ``strict=True``."""
    detector.load_state_dict({**payload["params"],
                              **payload.get("batch_stats", {})}, strict=True)


# ---------------------------------------------------------------------------
# reference ``.pth`` import (``sgg_tpu/train/checkpoint.py:176-527,688``):
# torchvision-format state dicts -> the port's flax-named ``state_dict``.
# The port keeps torch's layouts (convs OIHW, denses (out, in), GRU gates
# as ``weight_ih``/``weight_hh``), so most tensors carry over as they are;
# every fc over a flattened 7x7 RoI pool takes the CHW -> HWC permutation
# of its input axis, since the port's heads flatten NHWC pools.

def load_torch_state_dict(path: str, key: str = "state_dict"
                          ) -> Dict[str, torch.Tensor]:
    """A ``.pth`` file as ``{name: tensor}`` on the CPU: the ``key``
    sub-dict of a full training checkpoint (the reference saves the model
    under ``state_dict`` and the GAN under ``gan``, pytorch_misc.py:226-231,
    main.py:249-254), else the file as a bare state dict. Entries that are
    not tensors are left out."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    state = ckpt.get(key, ckpt) if isinstance(ckpt, dict) else ckpt
    return {k: v.detach() for k, v in state.items()
            if isinstance(v, torch.Tensor)}


def _skipped(name: str) -> bool:
    # the frozen BatchNorms never count batches: flax keeps no such leaf,
    # and the port's stays at 0 (``convert.variables_from_jax``)
    return name.endswith("num_batches_tracked")


def optimistic_update(state: Mapping[str, torch.Tensor],
                      flat_updates: Mapping[str, torch.Tensor],
                      verbose: bool = False, return_stats: bool = False):
    """Copy the same-shape tensors of ``flat_updates`` into a copy of
    ``state`` (a port ``state_dict``), cast to each entry's type and
    device; skip names missing from ``state`` or of another shape (printed
    when ``verbose``). With ``return_stats`` also returns ``{"missing":
    [state names not updated], "unused": [update names without a home]}``,
    the JAX package's lists under the port's names."""
    merged: Dict[str, torch.Tensor] = {}
    used, missing = set(), []
    for name, leaf in state.items():
        got = flat_updates.get(name)
        if got is not None and not _skipped(name) and \
                tuple(got.shape) == tuple(leaf.shape):
            merged[name] = got.to(dtype=leaf.dtype, device=leaf.device)
            used.add(name)
            continue
        if got is not None and verbose and not _skipped(name):
            print(f"shape mismatch for {name}: {tuple(got.shape)} vs "
                  f"{tuple(leaf.shape)}")
        if not _skipped(name):
            missing.append(name)
        merged[name] = leaf
    unused = sorted(set(flat_updates) - used)
    if verbose and unused:
        print("unused checkpoint keys:", unused[:20])
    if return_stats:
        return merged, {"missing": missing, "unused": unused}
    return merged


def torch_vgg_key_map() -> Dict[str, str]:
    """torchvision ``vgg16.features.{i}`` conv indices -> the port's trunk
    convs ``trunk.conv.{j}`` (convs and pools interleave in torchvision)."""
    from sgg_torch.models.backbone import VGG16_CFG
    mapping, conv_i, torch_i = {}, 0, 0
    for v in VGG16_CFG:
        if v == "M":
            torch_i += 1
        else:
            mapping[f"features.{torch_i}"] = f"trunk.conv.{conv_i}"
            torch_i += 2  # conv + relu
            conv_i += 1
    return mapping


def _fc6_chw_to_hwc(w, pool: int = 7) -> torch.Tensor:
    """A torch fc over a flattened (C, P, P) RoI pool -> the same fc over
    the port's (P, P, C) flatten order, still (out, in)."""
    w = torch.as_tensor(w)
    out_dim, in_dim = w.shape
    c = in_dim // (pool * pool)
    return (w.reshape(out_dim, c, pool, pool).permute(0, 2, 3, 1)
            .reshape(out_dim, pool * pool * c))


# the tensors of a module of each type, as (reference suffix, port suffix)
_TENSORS = {
    "wb": (("weight", "weight"), ("bias", "bias")),  # conv or dense
    "fc6": (("weight", "weight"), ("bias", "bias")),  # weight CHW -> HWC
    "bn": tuple((k, k) for k in ("weight", "bias", "running_mean",
                                 "running_var")),
    # torch's GRUCell: fused [r; z; n] gate matmuls and both bias vectors,
    # which the port's GRUCell keeps
    "gru": tuple((k, k) for k in ("weight_ih", "weight_hh", "bias_ih",
                                  "bias_hh")),
    "table": (("weight", "table"),),  # the frequency bias's (C * C, R)
    "embed": (("weight", "weight"),),
    # torch's spectral_norm(Conv2d): its weight before normalization and
    # power-iteration vectors, read by ``_snconv_updates``
    "snconv": (("weight_orig", "Conv_0.weight"), ("bias", "Conv_0.bias"),
               ("weight_u", "u")),
}
REFERENCE_KINDS = ("detector", "vgg", "relmodel", "resnet_fpn", "gan")
# the reference GAN's shape (augment/gan.py): GCN layers, BatchNorms in
# its MLPs, the CRN's stages, largeD
GAN_SHAPE = dict(n_layers=5, batch_norm=True, crn_stages=3, largeD=False)


def _vgg_trunk_rows(prefix: str):
    return [(f"{prefix}{t.split('.')[1]}", o, "wb")
            for t, o in torch_vgg_key_map().items()]


def _gan_rows(n_layers: int, batch_norm: bool, crn_stages: int,
              largeD: bool):
    """The reference ``GAN``'s modules (``sgg_tpu/train/checkpoint.py:
    528-640``): the generator's embeddings, GCN MLPs (``build_mlp``: Linear
    at 0 and 3, BatchNorm1d at 1 and 4 with ``mlp_normalization='batch'``,
    the last layer's MLPs without the trailing BatchNorm; Linear at 0 and 2
    without), spatializing convs, projection (with ``vis_cond`` its input
    holds the bank's channels first, in both layouts) and CRN
    (``refinement_modules.{i}.net``: conv 0, bn 1, conv 3, bn 4), then the
    spectral-norm convs of the Ds (patch Ds at 0/2/4/6; ``D_global`` at
    0/5/10/15, with ``largeD`` also its 1x1 convs at 2/7/12)."""
    rows = [("G_obj_embed", "G.obj_embed", "embed"),
            ("G_rel_embed", "G.rel_embed", "embed")]
    for i in range(n_layers):
        for net in ("net1", "net2"):
            t, o = f"G_gcn.gconvs.{i}.{net}", f"G.gcn.gconv_{i}.{net}"
            rows += [(f"{t}.{ti}", f"{o}.Dense_{j}", "wb") for j, ti in
                     enumerate(("0", "3") if batch_norm else ("0", "2"))]
            if batch_norm:
                rows.append((f"{t}.1", f"{o}.MaskedBatchNorm_0", "bn"))
                if i < n_layers - 1:
                    rows.append((f"{t}.4", f"{o}.MaskedBatchNorm_1", "bn"))
    rows += [("G_node.0", "G.node_conv0", "wb"),
             ("G_node.2", "G.node_conv1", "wb"), ("G_proj", "G.proj", "wb")]
    for i in range(crn_stages):
        t, o = f"G_refine.refinement_modules.{i}.net", f"G.refine.mod{i}"
        rows += [(f"{t}.0", f"{o}.conv0", "wb"), (f"{t}.1", f"{o}.bn0", "bn"),
                 (f"{t}.3", f"{o}.conv1", "wb"), (f"{t}.4", f"{o}.bn1", "bn")]
    rows.append(("G_refine.output_conv.0", "G.refine.output_conv", "wb"))
    for d in ("D_nodes", "D_edges"):
        rows += [(f"{d}.{ti}", f"{d}.SNConv_{j}", "snconv")
                 for j, ti in enumerate((0, 2, 4, 6))]
    rows += [(f"D_global.{ti}", f"D_global.SNConv_{j}", "snconv")
             for j, ti in enumerate((0, 2, 5, 7, 10, 12, 15) if largeD
                                    else (0, 5, 10, 15))]
    return rows


def reference_modules(kind: str, **gan_shape
                      ) -> List[Tuple[Tuple[str, ...], str, str]]:
    """The map from a reference checkpoint of ``kind`` onto the port, one
    row a module: (reference names, port module, type). ``_TENSORS[type]``
    lists the module's tensors. Of several reference names the first whose
    ``weight`` the checkpoint holds is read (torchvision moved the FPN's
    convs into a ``Sequential``). ``gan_shape`` overrides ``GAN_SHAPE``
    for ``kind="gan"``."""
    if kind == "gan":
        rows = _gan_rows(**{**GAN_SHAPE, **gan_shape})
    elif kind == "vgg":  # the reference copies the classifier into both heads
        rows = _vgg_trunk_rows("features.") + [
            row for head in ("roi_fmap", "roi_fmap_obj") for row in (
                ("classifier.0", f"{head}.fc6", "fc6"),
                ("classifier.3", f"{head}.fc7", "wb"))]
    elif kind == "detector":  # torchvision FasterRCNN(vgg16)
        rows = _vgg_trunk_rows("backbone.") + [
            ("rpn.head.conv", "rpn.conv", "wb"),
            ("rpn.head.cls_logits", "rpn.cls_logits", "wb"),
            ("rpn.head.bbox_pred", "rpn.bbox_pred", "wb"),
            ("roi_heads.box_head.fc6", "box_head.fc6", "fc6"),
            ("roi_heads.box_head.fc7", "box_head.fc7", "wb"),
            ("roi_heads.box_predictor.cls_score", "cls_score", "wb"),
            ("roi_heads.box_predictor.bbox_pred", "bbox_pred", "wb")]
    elif kind == "relmodel":  # the reference's RelModelStanford
        rows = _vgg_trunk_rows("detector.backbone.") + [
            (t, f"imp.{o}", "wb") for t, o in (
                ("obj_unary", "obj_unary"), ("edge_unary", "edge_unary"),
                ("obj_fc", "obj_fc"), ("rel_fc", "rel_fc"),
                ("sub_vert_w_fc.0", "sub_vert_w_fc"),
                ("obj_vert_w_fc.0", "obj_vert_w_fc"),
                ("out_edge_w_fc.0", "out_edge_w_fc"),
                ("in_edge_w_fc.0", "in_edge_w_fc"))] + [
            # roi_fmap = Sequential(Flatten, classifier); roi_fmap_obj =
            # classifier
            ("roi_fmap.1.0", "roi_fmap.fc6", "fc6"),
            ("roi_fmap.1.3", "roi_fmap.fc7", "wb"),
            ("roi_fmap_obj.0", "roi_fmap_obj.fc6", "fc6"),
            ("roi_fmap_obj.3", "roi_fmap_obj.fc7", "wb"),
            # union boxes: Sequential(conv, relu, bn, maxpool, conv, relu, bn)
            ("union_boxes.conv.0", "union_feats.conv1", "wb"),
            ("union_boxes.conv.4", "union_feats.conv2", "wb"),
            ("node_gru", "imp.node_gru", "gru"),
            ("edge_gru", "imp.edge_gru", "gru"),
            ("union_boxes.conv.2", "union_feats.bn1", "bn"),
            ("union_boxes.conv.6", "union_feats.bn2", "bn"),
            ("freq_bias.obj_baseline", "freq_bias", "table")]
    elif kind == "resnet_fpn":  # torchvision maskrcnn_resnet50_fpn backbone
        from sgg_torch.models.resnet import RESNET50_BLOCKS
        rows = [("backbone.body.conv1", "body.conv1", "wb"),
                ("backbone.body.bn1", "body.bn1", "bn")]
        for stage, n_blocks in enumerate(RESNET50_BLOCKS, start=1):
            for i in range(n_blocks):
                t = f"backbone.body.layer{stage}.{i}"
                o = f"body.layer{stage}_{i}"
                for k in ("1", "2", "3"):
                    rows += [(f"{t}.conv{k}", f"{o}.conv{k}", "wb"),
                             (f"{t}.bn{k}", f"{o}.bn{k}", "bn")]
                rows += [(f"{t}.downsample.0", f"{o}.downsample", "wb"),
                         (f"{t}.downsample.1", f"{o}.bn_down", "bn")]
        for i, lvl in enumerate(("c2", "c3", "c4", "c5")):
            for t, o in (("inner_blocks", "lateral"),
                         ("layer_blocks", "output")):
                rows.append(((f"backbone.fpn.{t}.{i}.0",
                              f"backbone.fpn.{t}.{i}"),
                             f"fpn.{o}_{lvl}", "wb"))
    else:
        raise ValueError(f"unknown kind {kind!r}: one of {REFERENCE_KINDS}")
    return [((t,) if isinstance(t, str) else t, o, typ) for t, o, typ in rows]


def _snconv_updates(t: str, ours: str, ts: Mapping
                    ) -> Dict[str, torch.Tensor]:
    """torch's ``spectral_norm(Conv2d)`` tensors -> an ``SNConv``'s
    (``sgg_tpu/train/checkpoint.py::_snconv_updates``): ``weight_orig`` and
    the bias to the conv, ``weight_u`` (out,) to ``u`` (1, out), and, with
    ``weight_v``, ``sigma = u . (W v)`` over torch's (out, in kh kw)
    flatten, in numpy float32 as the JAX importer computes it. At torch's
    converged vectors, flax's one power iteration from ``u`` then gives
    torch's eval weight. A conv saved without spectral norm (a plain
    ``weight``) maps as a conv."""
    w = ts.get(f"{t}.weight_orig")
    if w is None:
        return {f"{ours}.Conv_0.{k}": torch.as_tensor(ts[f"{t}.{k}"])
                for k in ("weight", "bias") if f"{t}.{k}" in ts}
    out = {f"{ours}.Conv_0.weight": torch.as_tensor(w)}
    if f"{t}.bias" in ts:
        out[f"{ours}.Conv_0.bias"] = torch.as_tensor(ts[f"{t}.bias"])
    u, v = ts.get(f"{t}.weight_u"), ts.get(f"{t}.weight_v")
    if u is not None:
        u = np.asarray(u)
        out[f"{ours}.u"] = torch.from_numpy(u[None, :].copy())
        if v is not None:
            wm = np.asarray(w).reshape(u.shape[0], -1)
            out[f"{ours}.sigma"] = torch.from_numpy(
                np.asarray(u @ (wm @ np.asarray(v)), np.float32))
    return out


def reference_flat_updates(kind: str, ts: Mapping, **gan_shape
                           ) -> Dict[str, torch.Tensor]:
    """The tensors of a reference checkpoint of ``kind`` that
    ``reference_modules`` maps, as ``{port name: tensor}`` in the port's
    layouts (every fc over a RoI pool permuted CHW -> HWC; spectral-norm
    convs through ``_snconv_updates``). A GAN's CRN stages are those the
    checkpoint holds from the first on, up to one whose first conv it
    lacks (``sgg_tpu/train/checkpoint.py:575-588``)."""
    if kind == "gan" and "crn_stages" not in gan_shape:
        n = 0
        while n < 8 and f"G_refine.refinement_modules.{n}.net.0.weight" in ts:
            n += 1
        gan_shape = {**gan_shape, "crn_stages": n}
    flat: Dict[str, torch.Tensor] = {}
    for refs, ours, typ in reference_modules(kind, **gan_shape):
        t = refs[0] if len(refs) == 1 else next(
            (t for t in refs if f"{t}.weight" in ts), None)
        if typ == "snconv":
            flat.update(_snconv_updates(t, ours, ts))
            continue
        for sfx_t, sfx_o in _TENSORS[typ] if t is not None else ():
            v = ts.get(f"{t}.{sfx_t}")
            if v is not None:
                v = torch.as_tensor(v)
                flat[f"{ours}.{sfx_o}"] = (_fc6_chw_to_hwc(v) if typ == "fc6"
                                           and sfx_o == "weight" else v)
    return flat


def import_torch_vgg(state, torch_state: Mapping, verbose: bool = False,
                     return_stats: bool = False):
    """A torchvision VGG16 ``state_dict`` into a ``RelModelIMP`` state: the
    trunk convs and both RoI heads."""
    return optimistic_update(state, reference_flat_updates("vgg", torch_state),
                             verbose=verbose, return_stats=return_stats)


def import_torch_faster_rcnn(state, torch_state: Mapping,
                             verbose: bool = False,
                             return_stats: bool = False):
    """A torchvision ``FasterRCNN(vgg16)`` ``state_dict`` (the reference's
    detector checkpoints) into a ``FasterRCNNVGG`` state: backbone convs,
    RPN head, box head and predictors."""
    return optimistic_update(
        state, reference_flat_updates("detector", torch_state),
        verbose=verbose, return_stats=return_stats)


def import_torch_relmodel(state, torch_state: Mapping, verbose: bool = False,
                          return_stats: bool = False):
    """The reference ``RelModelStanford.state_dict()`` into a
    ``RelModelIMP`` state: the IMP head, both RoI heads, the union-boxes
    convs with their BatchNorm statistics, the frequency bias and the
    detector's VGG trunk."""
    return optimistic_update(
        state, reference_flat_updates("relmodel", torch_state),
        verbose=verbose, return_stats=return_stats)


def import_torch_resnet50_fpn(state, torch_state: Mapping,
                              verbose: bool = False,
                              return_stats: bool = False):
    """A torchvision ResNet50-FPN ``state_dict`` (the reference's COCO
    ``maskrcnn_resnet50_fpn``; its ``backbone.*`` tensors) into a
    ``ResNet50FPN`` state: parameters and frozen BatchNorm buffers."""
    return optimistic_update(
        state, reference_flat_updates("resnet_fpn", torch_state),
        verbose=verbose, return_stats=return_stats)


def import_torch_gan(state, torch_state: Mapping, num_gcn_layers: int = 5,
                     batch_norm: bool = True, largeD: bool = False,
                     verbose: bool = False, return_stats: bool = False):
    """A reference ``GAN.state_dict()`` (the ``gan`` entry of a ``vgrel.pth``
    or a bare one: the generator and the three spectral-norm Ds) into a
    ``GANModel`` state: parameters, BatchNorm statistics and the
    power-iteration vectors."""
    return optimistic_update(
        state, reference_flat_updates("gan", torch_state,
                                      n_layers=num_gcn_layers,
                                      batch_norm=batch_norm, largeD=largeD),
        verbose=verbose, return_stats=return_stats)
