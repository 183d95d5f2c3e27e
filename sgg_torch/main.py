"""CLI entry point of the PyTorch port: train and evaluate SGG models.

    python -m sgg_torch.main -m sgcls -loss dnorm -b 24 -split synthetic
    python -m sgg_torch.main -m sgdet -nepoch 0 -ckpt <dir> -split synthetic

Same flags as the JAX package's ``main.py`` (``sgg_torch.config``). Runs on
the card unless ``-device cpu`` is given. Mode sgdet loads the frozen
detector from ``-ckpt`` (a ``train/checkpoint.py`` detector directory, as
``sgg_torch.pretrain_detector`` writes) and trains the relation head on its
detections; ``-nepoch 0`` only evaluates (the test sweep). ``-split
synthetic`` is the only split so far: the VG, GQA and VTransE parsers and
image decoding need libraries the card's machine lacks, and those splits
raise ``NotImplementedError``; so does ``-backbone resnet50`` (the
ResNet50-FPN slice).
"""

from __future__ import annotations

from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> dict:
    from sgg_torch import constants
    from sgg_torch.config import config_from_args
    from sgg_torch.data.synthetic import synthetic_splits
    from sgg_torch.train.checkpoint import load_detector
    from sgg_torch.train.trainer import Trainer

    config = config_from_args(argv)
    print("~~~~~~~~ Hyperparameters: ~~~~~~~")
    for k, v in sorted(vars(config).items()):
        print(f"{k} : {v}")
    if config.split != "synthetic":
        raise NotImplementedError(
            f"-split {config.split}: the dataset parsers and image decoding "
            f"are not ported to sgg_torch yet; use -split synthetic")
    if config.wandb is not None:
        raise NotImplementedError("W&B logging is not ported to sgg_torch")
    # val_size sizes the generated eval sets only when small: its default
    # of 5000 (a subsample cap for the real 26k val split) would turn the
    # run into hours of evaluation
    if not (0 < config.val_size <= 1000):
        print(f"[synthetic] -val_size {config.val_size} out of the "
              "smoke-run range (0, 1000] -> generating 16-image eval sets "
              "instead")
    splits = synthetic_splits(
        num_eval=config.val_size if 0 < config.val_size <= 1000 else 16,
        image_size=constants.IM_SCALE)
    detector = det_state = None
    if config.mode == "sgdet":
        # sgdet refuses to start without a pretrained detector (reference
        # pytorch_misc.py:210-211)
        if config.backbone != "vgg16":
            raise NotImplementedError(
                f"-backbone {config.backbone}: the ResNet50-FPN detector "
                f"comes with the ResNet50-FPN slice; use vgg16")
        if not config.ckpt:
            raise ValueError("-m sgdet needs -ckpt <pretrained detector dir>")
        from sgg_torch.models.detector import FasterRCNNVGG
        det_state, epoch = load_detector(config.ckpt)
        detector = FasterRCNNVGG(num_classes=splits["train"].num_classes)
        print(f"loaded detector checkpoint from epoch {epoch}")
    results = Trainer(config, splits, detector=detector,
                      det_state=det_state).fit()
    for k, v in sorted(results.items()):
        if not k.startswith("_"):
            print(f"{k}: {v:.4f}")
    return results


if __name__ == "__main__":
    main()
