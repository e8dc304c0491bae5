"""Logging: the training run's dual log files (``setup_logging``; dvgl
``commons.py:30-74``), run naming and metrics logging for sweeps (copies
of ``anyloc_tpu/utils/logging_utils.py``; the framework-free files are
copied, not imported). wandb is optional."""

from __future__ import annotations

import json
import logging
import os
import sys
import traceback
from typing import Optional


def setup_logging(output_folder: str, console: str = "info", info_filename: str = "info.log",
                  debug_filename: str = "debug.log") -> None:
    """Info and debug log files in ``output_folder``, a console handler,
    and an excepthook that also logs an uncaught exception
    (commons.py:30-74)."""
    os.makedirs(output_folder, exist_ok=True)
    base = logging.getLogger()
    base.setLevel(logging.DEBUG)
    for h in list(base.handlers):
        base.removeHandler(h)
    fmt = logging.Formatter("%(asctime)s   %(message)s", "%Y-%m-%d %H:%M:%S")
    for filename, level in ((info_filename, logging.INFO), (debug_filename, logging.DEBUG)):
        if filename:
            fh = logging.FileHandler(os.path.join(output_folder, filename))
            fh.setLevel(level)
            fh.setFormatter(fmt)
            base.addHandler(fh)
    if console:
        ch = logging.StreamHandler()
        ch.setLevel(logging.INFO if console == "info" else logging.DEBUG)
        ch.setFormatter(fmt)
        base.addHandler(ch)

    def exception_handler(type_, value, tb):
        if issubclass(type_, KeyboardInterrupt):
            sys.__excepthook__(type_, value, tb)
            return
        base.info("\n" + "".join(traceback.format_exception(type_, value, tb)))
        # keep the standard stderr traceback: with console="" the log-only
        # hook would exit with a blank terminal
        sys.__excepthook__(type_, value, tb)

    sys.excepthook = exception_handler


def run_name_for(pipeline: str, model: str, layer=None, facet=None, clusters=None,
                 dataset=None, domain=None) -> str:
    """The reference's wandb run-name convention, the keys of its exported
    ablation CSVs (configs.py:80-91, *_ablations.sh):

      vlad              DINO_V2_VLAD/l{L}_{facet}_c{C}/{dataset}/{model}
      global-vocab-vlad DINO_V2_VLAD_GLOBAL_VOCAB/l{L}_{facet}_c{C}/{domain}/{dataset}/{model}
      gem               DINO_V2_GeM/l{L}_{facet}/{dataset}/{model}
    """
    fam = "DINO_V1" if model.startswith("dino_") else "DINO_V2"
    if pipeline in ("vlad", "global-vocab-vlad"):
        model_id = f"l{layer}_{facet}_c{clusters}"
        if pipeline == "global-vocab-vlad":
            model_id = f"{model_id}/{domain}"
            return f"{fam}_VLAD_GLOBAL_VOCAB/{model_id}/{dataset}/{model}"
        return f"{fam}_VLAD/{model_id}/{dataset}/{model}"
    if pipeline == "gem":
        return f"{fam}_GeM/l{layer}_{facet}/{dataset}/{model}"
    if pipeline == "global-vpr":
        return f"{fam}_GLOBAL/{dataset}/{model}"
    return f"{pipeline}/{dataset}/{model}"


class MetricsLogger:
    """Logs to wandb when it is installed and enabled, and always keeps a
    local history (list of dicts) for CSV / JSON dumps."""

    def __init__(self, use_wandb: bool = False, project: str = "anyloc-tpu",
                 entity: Optional[str] = None, group: Optional[str] = None,
                 run_name: Optional[str] = None, config=None):
        self.history = []
        self.wandb = None
        if use_wandb:
            try:
                import wandb

                self.wandb = wandb
                wandb.init(project=project, entity=entity, group=group,
                           name=run_name, config=config)
            except Exception as e:  # wandb not installed / offline
                logging.info(f"wandb unavailable ({e}); logging locally only")

    def log(self, metrics: dict, step: Optional[int] = None):
        self.history.append(dict(metrics, _step=step))
        if self.wandb is not None:
            self.wandb.log(metrics, step=step)

    def finish(self):
        if self.wandb is not None:
            self.wandb.finish()

    def dump_json(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.history, f, indent=2, default=str)
