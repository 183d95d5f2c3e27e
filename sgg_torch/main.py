"""CLI entry point of the PyTorch port: train and evaluate SGG models.

    python -m sgg_torch.main -m sgcls -loss dnorm -b 24 -split synthetic

Same flags as the JAX package's ``main.py`` (``sgg_torch.config``). Runs on
the card unless ``-device cpu`` is given. ``-split synthetic`` is the only
split so far: the VG, GQA and VTransE parsers and image decoding come in a
later slice, and those splits raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> dict:
    from sgg_torch import constants
    from sgg_torch.config import config_from_args
    from sgg_torch.data.synthetic import synthetic_splits
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
    results = Trainer(config, splits).fit()
    for k, v in sorted(results.items()):
        if not k.startswith("_"):
            print(f"{k}: {v:.4f}")
    return results


if __name__ == "__main__":
    main()
