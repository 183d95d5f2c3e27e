"""Checkpoint save and (optimistic) restore with ``torch.save``.

Counterpart of the payload half of ``sgg_tpu/train/checkpoint.py``
(reference ``lib/pytorch_misc.py:17-57,160-233``): one file per epoch,
``<save_dir>/vgrel-<epoch>.pth``, holding a nested dict of tensors (the
trainer's payload: step, parameters, buffers, optimizer state, epoch);
only the last ``MAX_TO_KEEP`` epochs are kept, as orbax's
``max_to_keep=3``. A restore copies every leaf whose path and shape match
the caller's template and reports the rest, as the reference's
``optimistic_restore``.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Mapping, Optional, Tuple

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
    if epoch is None:
        epoch = latest_epoch(save_dir)
        if epoch is None:
            return dict(template), -1, set(), {"missing": [], "unused": []}
    on_disk = torch.load(_path(save_dir, epoch), map_location=map_location,
                         weights_only=True)
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
    return merged, int(epoch), set(on_disk), {"missing": missing,
                                              "unused": unused}
