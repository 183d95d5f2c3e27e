"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: a request
for ``cuda`` on a machine without CUDA raises instead of carrying on
quietly on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` (a string or ``torch.device``) as a checked ``torch.device``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
