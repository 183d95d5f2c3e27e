"""Weights from the JAX package: a flax variables tree (``{"params",
"batch_stats"}``, leaves as numpy) of ``RelModelIMP`` (either backbone),
``FasterRCNNVGG``, ``FasterRCNNFPN``, ``ResNet50FPN`` or ``GANModel`` -> the
port's
``state_dict``. The port's module names are the flax ones (the ResNet's
``body.layer{s}_{b}.conv1``, ``bn_down``, ``fpn.lateral_c4`` ...), so
most paths carry over as they are.

* Dense kernels ``(in, out)`` are transposed to ``(out, in)``. ``fc6``
  keeps the JAX package's HWC flatten order, which the port's ``RoiHead``
  also uses, so it too is a plain transpose.
* Conv kernels go HWIO -> OIHW; the trunk's ``Conv_{i}`` become
  ``trunk.conv.{i}``.
* ``GRUCell`` ``ih``/``hh`` dense layers become ``weight_ih``/``weight_hh``/
  ``bias_ih``/``bias_hh`` (the flax cell already has torch's
  parameterization).
* BatchNorm ``scale``/``bias``/``mean``/``var`` become ``weight``/``bias``/
  ``running_mean``/``running_var``; ``num_batches_tracked``, which flax
  does not keep, is set to 0.
* ``freq_bias/table`` carries over as it is; ``nn.Embed``'s ``embedding``
  becomes ``nn.Embedding``'s ``weight``.
* ``nn.SpectralNorm``'s ``batch_stats`` (``<SNConv>/SpectralNorm_0/
  Conv_0/kernel/u`` and ``.../sigma``) become the ``SNConv``'s ``u`` and
  ``sigma`` buffers.

The mapping is total: every flax leaf maps to exactly one entry of the same
element count, and the result loads with ``strict=True``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _prefix(path: Tuple[str, ...]) -> str:
    """The port's name of a flax module path, with its trailing dot ("" for
    the root module's own leaves)."""
    parts = list(path)
    if parts[:1] == ["trunk"] and parts[1].startswith("Conv_"):
        parts[1:2] = ["conv", parts[1][len("Conv_"):]]
    return "".join(p + "." for p in parts)


def _convert_leaf(collection: str, path: Tuple[str, ...], leaf: np.ndarray):
    """(state_dict key, array) for one flax leaf."""
    *mod, name = path
    if "SpectralNorm_0" in mod:  # flax keys its vectors 'Conv_0/kernel/u'
        owner = _prefix(tuple(mod[:mod.index("SpectralNorm_0")]))
        return owner + path[-1].split("/")[-1], leaf
    if collection == "batch_stats":
        return (_prefix(tuple(mod)) +
                {"mean": "running_mean", "var": "running_var"}[name], leaf)
    if mod and mod[-1] in ("ih", "hh"):  # GRUCell gate denses
        gate = mod[-1]
        key = _prefix(tuple(mod[:-1])) + (
            f"weight_{gate}" if name == "kernel" else f"bias_{gate}")
        return key, leaf.T if name == "kernel" else leaf
    prefix = _prefix(tuple(mod))
    if name == "kernel":
        if leaf.ndim == 4:  # conv HWIO -> OIHW
            return prefix + "weight", leaf.transpose(3, 2, 0, 1)
        return prefix + "weight", leaf.T  # dense (in, out) -> (out, in)
    if name == "scale":  # BatchNorm
        return prefix + "weight", leaf
    if name == "embedding":  # nn.Embed
        return prefix + "weight", leaf
    if name in ("bias", "table"):
        return prefix + name, leaf
    raise KeyError(f"no port counterpart for flax leaf {path}")


def variables_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """Flax variables (numpy leaves) -> port state_dict."""
    out: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in _flatten(variables.get(collection, {})):
            key, arr = _convert_leaf(collection, path, leaf)
            if key in out:
                raise KeyError(f"two flax leaves map to {key}")
            # a copy: the leaf may be a read-only view of a JAX buffer
            out[key] = torch.tensor(np.asarray(arr, dtype=np.float32))
    for key in [k for k in out if k.endswith("running_mean")]:
        out[key[:-len("running_mean")] + "num_batches_tracked"] = \
            torch.tensor(0, dtype=torch.long)
    return out
