"""Evaluation step (``make_eval_step`` of ``sgg_tpu/train/step.py``).

``make_train_step`` comes with the training slice.
"""

from __future__ import annotations

from typing import Dict

import torch

from sgg_torch.data.graph_batch import GraphBatch
from sgg_torch.device import resolve_device
from sgg_torch.train.assign import all_pairs, compact_pairs


def make_eval_step(model, mode: str = None, max_pairs: int = None,
                   dedup: bool = True, device="cuda"):
    """Returns ``eval_step(batch) -> outputs`` for a host or device batch.

    Enumerates all ordered pairs (reference rel_model_base.py:148-163) and
    runs the forward in inference mode on ``device`` (the card unless the
    caller asks for the CPU). ``mode`` overrides the model's regime
    (reference lib/eval.py:56 ``set_mode``). ``max_pairs`` compacts the
    candidates to that budget, order-preserving (exact iff every image has
    <= max_pairs valid pairs, which ``val_epoch`` guarantees). ``dedup``
    enables the unordered-union dedup; the output's ``dedup_ok`` lets the
    caller check and fall back.
    """
    dev = resolve_device(device)

    @torch.inference_mode()
    def eval_step(batch: GraphBatch) -> Dict[str, torch.Tensor]:
        batch = batch.to(dev)
        pairs, pair_mask = all_pairs(batch.node_mask)
        if max_pairs is not None and max_pairs < pairs.shape[1]:
            pairs, pair_mask, _ = compact_pairs(pairs, pair_mask, max_pairs)
        out = model(batch.images, batch.boxes, batch.classes, pairs,
                    pair_mask, mode=mode, dedup_unions=dedup)
        out["pairs"] = pairs
        out["pair_mask"] = pair_mask
        out["rel_dists"] = torch.softmax(out["rel_logits"], dim=-1)
        return out

    return eval_step
