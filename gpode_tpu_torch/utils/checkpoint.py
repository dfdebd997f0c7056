"""Checkpoints: parameters, Adam state, the train generator's state and the
step, in one `.npz` replaced atomically.

Counterpart of `gpode_tpu/utils/checkpoint.py`. The JAX format pickles a JAX
treedef, which cannot be read without JAX, so the port keys its arrays by
name instead:

  * `<dotted path>` — each parameter, under the JAX package's leaf path
    (`gp.kernel.raw_lengthscales`, `states.x0.tril_packed`, ...; the names
    `convert.py` reads);
  * `opt.mu.<dotted path>`, `opt.nu.<dotted path>`, `opt.count` — Adam;
  * `generator` — `torch.Generator.get_state()` of the train stream (uint8);
  * `step`, and `val_ll` for the best-val checkpoint.

The file is written to a temporary name and moved over the old one with
`os.replace`, so a crash mid-save never leaves a torn checkpoint.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

_OPT_PREFIXES = ("opt.mu.", "opt.nu.")
_SCALARS = ("step", "val_ll")


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def save_checkpoint(path: str, state: dict[str, Any]):
    """Write `state` to `path`. Keys: "params" (an `nn.Module` or a
    {dotted path: array} dict), optionally "opt_state" (`Adam.state()`),
    "generator" (a `torch.Generator`), "step" and "val_ll"."""
    payload = {}
    for key, value in state.items():
        if key == "params":
            items = (value.named_parameters()
                     if isinstance(value, torch.nn.Module) else value.items())
            payload.update({name: _host(p) for name, p in items})
        elif key == "opt_state":
            for moment in ("mu", "nu"):
                payload.update({f"opt.{moment}.{name}": _host(t)
                                for name, t in value[moment].items()})
            payload["opt.count"] = np.asarray(value["count"], np.int64)
        elif key == "generator":
            payload["generator"] = value.get_state().numpy()
        elif key in _SCALARS:
            payload[key] = np.asarray(value)
        else:
            raise KeyError(f"save_checkpoint: unknown entry {key!r}")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> dict[str, Any]:
    """Read a checkpoint written by :func:`save_checkpoint`: a dict with
    "params" ({dotted path: array}), "opt_state" ({"mu": {...}, "nu": {...},
    "count": int} or None), "generator_state" (a uint8 tensor or None) and
    "step" / "val_ll" where saved (0-d arrays)."""
    params, mu, nu = {}, {}, {}
    out: dict[str, Any] = {"opt_state": None, "generator_state": None}
    with np.load(path) as data:
        for key in data.files:
            if key.startswith(_OPT_PREFIXES):
                moment, name = key[len("opt."):].split(".", 1)
                (mu if moment == "mu" else nu)[name] = data[key]
            elif key == "opt.count":
                count = int(data[key])
            elif key == "generator":
                out["generator_state"] = torch.from_numpy(data[key].copy())
            elif key in _SCALARS:
                out[key] = data[key]
            else:
                params[key] = data[key]
    out["params"] = params
    if mu:
        out["opt_state"] = {"mu": mu, "nu": nu, "count": count}
    return out
