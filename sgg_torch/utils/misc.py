"""Small shared helpers (``sgg_tpu/utils/misc.py``; the reference's
``lib/pytorch_misc.py``): seeding and the parameter table
(``print_para``, pytorch_misc.py:398-416) over a ``state_dict``."""

from __future__ import annotations

import random
from typing import Mapping

import numpy as np
import torch


def set_seed(seed: int):
    """Seed the host's RNGs and torch's default generators (reference
    set_seed, pytorch_misc.py:673-679). The port's own draws come from
    explicit ``torch.Generator``s."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def param_count(state: Mapping[str, torch.Tensor]) -> int:
    """Elements over a ``state_dict`` (or any name -> tensor mapping)."""
    return int(sum(t.numel() for t in state.values()
                   if hasattr(t, "shape")))


def print_params(state: Mapping[str, torch.Tensor],
                 max_rows: int = 100) -> str:
    """Parameter table sorted by size (reference print_para)."""
    rows = [(name, tuple(t.shape), int(t.numel()))
            for name, t in state.items() if hasattr(t, "shape")]
    rows.sort(key=lambda r: -r[2])
    total = sum(r[2] for r in rows)
    lines = [f"{'name':60s} {'shape':>20s} {'params':>12s}"]
    for name, shape, n in rows[:max_rows]:
        lines.append(f"{name[:60]:60s} {str(shape):>20s} {n:>12,d}")
    if len(rows) > max_rows:
        lines.append(f"... {len(rows) - max_rows} more")
    lines.append(f"{'TOTAL':60s} {'':>20s} {total:>12,d}")
    out = "\n".join(lines)
    print(out)
    return out
