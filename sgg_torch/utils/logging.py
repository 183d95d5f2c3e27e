"""Experiment logging: console + optional Weights & Biases adapter.

Counterpart of ``sgg_tpu/utils/logging.py`` (reference W&B wiring,
``config.py:107-134``): ``wandb_log(dict, step, log_repeats, is_summary,
prefix)`` with the repeat-log workaround for the final-step sync issue,
failures swallowed so that a full disk or a missing ``wandb`` never kills
training. ``wandb`` is imported only when ``config.wandb`` is set.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional


def make_logger(config) -> Callable:
    """Returns ``log_fn(dict, step=..., log_repeats=1, is_summary=False,
    prefix='')``; a no-op console fallback when wandb is unavailable."""
    run = None
    if getattr(config, "wandb", None):
        try:
            import wandb
            run = wandb.init(
                name=config.name, dir=config.wandb_dir,
                project=config.wandb,
                config={k: v for k, v in vars(config).items()
                        if not k.startswith("_")},
                resume=False)
        except Exception as e:  # wandb missing / offline — degrade quietly
            print("warning: wandb logging disabled:", e)
            run = None

    def log_fn(d: Dict[str, float], step: Optional[int] = None,
               log_repeats: int = 1, is_summary: bool = False,
               prefix: str = ""):
        if run is None:
            return
        base = step if step is not None else 0
        # repeat the last few logs to work around wandb's trailing-value
        # sync loss (reference config.py:120-128)
        for s in range(base, base + log_repeats):
            try:
                for key, value in d.items():
                    run.log({prefix + key: value}, step=s)
                    if is_summary:
                        run.summary[prefix + key] = value
            except Exception as e:
                print("error logging with wandb:", e)

    return log_fn
