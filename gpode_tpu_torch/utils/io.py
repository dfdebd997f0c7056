"""Run-directory helpers: loggers and arg dumps. Counterpart of
`gpode_tpu/utils/io.py`."""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Optional


def makedirs(dirname: str):
    os.makedirs(dirname, exist_ok=True)


def save_args(args, path: str):
    """Dump a config (dataclass, argparse Namespace, or dict) to JSON."""
    if dataclasses.is_dataclass(args):
        payload = dataclasses.asdict(args)
    elif hasattr(args, "__dict__"):
        payload = vars(args)
    else:
        payload = dict(args)
    with open(path, "w") as f:
        json.dump(payload, f, sort_keys=True, indent=4, default=str)


def get_logger(logpath: Optional[str] = None, displaying: bool = True,
               saving: bool = True,
               name: str = "gpode_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    for handler in logger.handlers:
        handler.close()
    logger.handlers.clear()
    logger.propagate = False
    if saving and logpath is not None:
        fh = logging.FileHandler(logpath, mode="a")
        fh.setLevel(logging.INFO)
        logger.addHandler(fh)
    if displaying:
        sh = logging.StreamHandler()
        sh.setLevel(logging.INFO)
        logger.addHandler(sh)
    return logger
