"""The frozen table of peaks: NVIDIA's data sheet for the H100 (SXM part,
dense rates without sparsity, at the full 700 W power limit). A card the
table does not know is refused: a share of an assumed peak is no
measurement.

The card's power limit and clocks are recorded beside every run
(``device.py``); a card set below 700 W reaches less than these peaks.
"""

from __future__ import annotations

PEAKS = {
    # name as torch.cuda.get_device_name gives it: rates in FLOP/s, B/s
    "NVIDIA H100 80GB HBM3": {
        "bf16": 989e12,       # tensor cores, dense
        "tf32": 495e12,
        "f32": 67e12,         # CUDA cores
        "hbm_bytes_per_s": 3.35e12,
    },
}


class UnknownCard(RuntimeError):
    pass


def peaks(card: str) -> dict:
    if card not in PEAKS:
        raise UnknownCard(f"no peaks for the card {card!r}: the table knows "
                          f"{sorted(PEAKS)}")
    return PEAKS[card]
