"""CLI entry point of the PyTorch port: train and evaluate SGG models.

    python -m sgg_torch.main -m sgcls -loss dnorm -b 24 -split synthetic
    python -m sgg_torch.main -m sgdet -nepoch 0 -ckpt <dir> -split synthetic

Same flags as the JAX package's ``main.py`` (``sgg_torch.config``). Runs on
the card unless ``-device cpu`` is given. ``-backbone`` picks the VGG16 or
the ResNet50-FPN model. Mode sgdet loads the frozen detector of that
backbone (``FasterRCNNVGG`` or ``FasterRCNNFPN``) from ``-ckpt`` (a
``train/checkpoint.py`` detector directory, as
``sgg_torch.pretrain_detector`` writes) and trains the relation head on its
detections; ``-nepoch 0`` only evaluates (the test sweep).

``-gan`` trains with the GAN's compositional augmentation (the ICCV 2021
command); ``-vis_cond`` conditions its generator on a feature bank that
``python -m sgg_torch.extract_features`` writes (it needs ``h5py``)::

    python -m sgg_torch.main -m sgcls -loss dnorm -b 24 -gan -largeD \
        -perturb graphn -L 0.2 -topk 5 -graphn_a 2 -split synthetic
    python -m sgg_torch.main -m sgcls -loss dnorm -b 24 -gan -largeD \
        -vis_cond <dir>/features.hdf5 -perturb graphn -L 0.2 -topk 5 \
        -graphn_a 2

``-wandb <project>`` logs the losses and results to Weights & Biases
(``utils/logging.py``; the console alone where ``wandb`` is missing).

``-split stanford|gqa|vte`` read the datasets under ``-data``
(``data/visual_genome.py``, ``gqa.py``, ``vtranse.py``; gqa and vte need
``-backbone resnet50``) and decode their images with PIL; both ``h5py``
and PIL are imported only there, so ``-split synthetic`` also runs on a
machine without them. ``SGG_CHECK_SIZES=0`` relaxes the full-dataset
integrity checks (108,073 VG images, the eval splits' sizes) for a
miniature tree written by ``sgg_torch.data.fixtures``.
"""

from __future__ import annotations

from typing import Optional, Sequence


# the packages each split's parser and image decoding import
_NEEDS = {"stanford": ("h5py", "PIL"), "vte": ("h5py", "PIL"),
          "gqa": ("PIL",), "synthetic": ()}


def require(what: str, packages: Sequence[str]) -> None:
    """Raise ``ImportError`` naming those of ``packages`` that this Python
    lacks, before any work starts."""
    import importlib
    missing = []
    for name in packages:
        try:
            importlib.import_module(name)
        except ImportError:
            missing.append(name)
    if missing:
        raise ImportError(f"{what} needs {' and '.join(missing)}, which "
                          f"this Python lacks")


def load_splits(config) -> dict:
    """Train and eval splits of ``config.split`` (``main.py:32-70`` of the
    JAX package). A split whose packages are missing raises
    ``ImportError`` naming them before anything is read."""
    import os

    from sgg_torch import constants
    require(f"-split {config.split}", _NEEDS[config.split])
    if config.split == "synthetic":
        # val_size sizes the generated eval sets only when small: its
        # default of 5000 (a subsample cap for the real 26k val split)
        # would turn the run into hours of evaluation
        from sgg_torch.data.synthetic import synthetic_splits
        if not (0 < config.val_size <= 1000):
            print(f"[synthetic] -val_size {config.val_size} out of the "
                  "smoke-run range (0, 1000] -> generating 16-image eval "
                  "sets instead")
        return synthetic_splits(
            num_eval=config.val_size if 0 < config.val_size <= 1000 else 16,
            image_size=constants.IM_SCALE)
    check_sizes = os.environ.get("SGG_CHECK_SIZES", "1") != "0"
    sizes = dict(num_val_im=config.val_size,
                 min_graph_size=config.min_graph_size,
                 max_graph_size=config.max_graph_size)
    if config.split == "stanford":
        from sgg_torch.data import visual_genome
        # non-overlap filtering is an sgdet-only train filter (reference
        # main.py:47)
        return visual_genome.splits(config.data, check_sizes=check_sizes,
                                    filter_non_overlap=config.mode == "sgdet",
                                    **sizes)
    if config.split == "gqa":
        from sgg_torch.data import gqa
        return gqa.splits(config.data,
                          exclude_left_right=config.exclude_left_right,
                          **sizes)
    from sgg_torch.data import vtranse
    return vtranse.splits(config.data, **sizes)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    from sgg_torch.config import config_from_args
    from sgg_torch.train.checkpoint import load_detector
    from sgg_torch.train.trainer import Trainer
    from sgg_torch.utils.logging import make_logger

    config = config_from_args(argv)
    print("~~~~~~~~ Hyperparameters: ~~~~~~~")
    for k, v in sorted(vars(config).items()):
        print(f"{k} : {v}")
    if config.gan and config.vis_cond is not None:
        require("-vis_cond (the feature bank)", ("h5py",))
    splits = load_splits(config)
    log_fn = make_logger(config)
    detector = det_state = None
    if config.mode == "sgdet":
        # sgdet refuses to start without a pretrained detector (reference
        # pytorch_misc.py:210-211)
        if not config.ckpt:
            raise ValueError("-m sgdet needs -ckpt <pretrained detector dir>")
        from sgg_torch.models.detector import FasterRCNNFPN, FasterRCNNVGG
        det_state, epoch = load_detector(config.ckpt)
        cls = FasterRCNNVGG if config.backbone == "vgg16" else FasterRCNNFPN
        detector = cls(num_classes=splits["train"].num_classes)
        print(f"loaded detector checkpoint from epoch {epoch}")
    results = Trainer(config, splits, detector=detector,
                      det_state=det_state, log_fn=log_fn).fit()
    for k, v in sorted(results.items()):
        if not k.startswith("_"):
            print(f"{k}: {v:.4f}")
    return results


if __name__ == "__main__":
    main()
