"""Model construction (``build_model`` of ``sgg_tpu/train/trainer.py``).

The ``Trainer`` loop, checkpoints and the CLI come with the training slice.
"""

from __future__ import annotations

import torch

from sgg_torch.config import Config
from sgg_torch.data.datasets import SGGDataset
from sgg_torch.device import resolve_device
from sgg_torch.models.frequency_bias import (count_matrices,
                                             log_predicate_distribution)
from sgg_torch.models.relhead import RelModelIMP, init_weights


def build_model(config: Config, train_data: SGGDataset, *,
                device="cuda", seed: int = 0) -> RelModelIMP:
    """Flagship IMP model from config + dataset vocabulary (main.py:54-60),
    with seeded random weights, in the config's compute type, in eval mode
    on ``device`` (the card unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    freq_table = None
    if config.use_bias:
        fg, bg = count_matrices(train_data.gt_boxes, train_data.gt_classes,
                                train_data.relationships,
                                train_data.num_classes,
                                train_data.num_predicates, must_overlap=True)
        freq_table = log_predicate_distribution(fg, bg)
    obj_dim = 1024 if config.backbone == "resnet50" else 4096
    model = RelModelIMP(
        num_classes=train_data.num_classes,
        num_predicates=train_data.num_predicates,
        mode=config.mode, use_bias=config.use_bias,
        test_bias=config.test_bias, obj_dim=obj_dim,
        backbone=config.backbone, edge_model=config.edge_model,
        freq_table=freq_table)
    init_weights(model, seed)  # the bias table keeps its counts
    dtype = torch.bfloat16 if config.compute_dtype == "bfloat16" \
        else torch.float32
    return model.to_compute_dtype(dtype).to(dev).eval()
