"""The card a run uses, and the guard against JAX in the process."""

from __future__ import annotations

import subprocess
import sys
from typing import List

import torch

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "sgg_tpu")


class NoCard(RuntimeError):
    pass


def require_cards(n: int) -> None:
    """A measurement needs ``n`` cards; there is no fall-back."""
    if not torch.cuda.is_available():
        raise NoCard("no CUDA device: the benchmark measures the card and "
                     "has no fall-back")
    if torch.cuda.device_count() < n:
        raise NoCard(f"the cell needs {n} cards, "
                     f"{torch.cuda.device_count()} found")


def smi() -> str:
    """The card's name, power limit and clocks as ``nvidia-smi`` reads
    them (one CSV line a card), or why they could not be read."""
    q = ("name,power.limit,power.draw,clocks.sm,clocks.max.sm,clocks.mem,"
         "temperature.gpu")
    try:
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot, whole) is
    JAX's, one of its libraries', or the JAX package's."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)
