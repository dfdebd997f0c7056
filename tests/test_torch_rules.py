"""Package rules of the PyTorch port: it imports nothing of JAX or of the
JAX package, and its entry points run on CUDA unless asked for the CPU."""

import ast
import os

import jax  # noqa: F401  (the tests of the port import both packages)
import numpy as np
import pytest
import torch

from gpode_tpu_torch import resolve_device
from gpode_tpu_torch.convert import gpode_params_from_numpy, params_from_numpy
from gpode_tpu_torch.models.gpode import GPODEParams, sample_predict_noise
from gpode_tpu_torch.scripts import proto_wide_rhs
from gpode_tpu_torch.train import builders as tb
from gpode_tpu_torch.train.bench_setup import (build_bench_problem,
                                               preset_model_args)
from gpode_tpu_torch.train.evaluation import make_projected_scorer

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "gpode_tpu", "optax")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "gpode_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return files


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = _port_files()
    assert len(files) > 15 and os.path.exists(files[0])
    bad = [(os.path.relpath(p, ROOT), mod) for p in files
           for mod in _imported_modules(p)
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad, f"forbidden imports in the port: {bad}"


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _gpode_view(args, **kw):
    """Vanilla-GPODE params (the view of a shooting model) on `device`."""
    p = tb.build_shooting(torch.Generator().manual_seed(0), args,
                          np.zeros((2, 4, 3), np.float32), **kw)
    return GPODEParams(p.gp, p.states.x0, p.likelihood)


@pytest.mark.parametrize("entry", ["resolve_device", "build_bench_problem",
                                   "build_shooting", "params_from_numpy",
                                   "preset_build_bench_problem",
                                   "gpode_params_from_numpy",
                                   "sample_predict_noise",
                                   "make_projected_scorer", "build_gpode",
                                   "proto_wide_rhs"])
def test_entry_points_raise_without_a_card_unless_asked_for_the_cpu(
        monkeypatch, entry):
    _no_card(monkeypatch)
    args = tb.ModelArgs(num_inducing=4, num_features=8)
    calls = {
        "resolve_device": lambda **kw: resolve_device(**kw),
        "build_bench_problem": lambda **kw: build_bench_problem(
            initialize=False, **kw),
        "build_shooting": lambda **kw: tb.build_shooting(
            torch.Generator().manual_seed(0), args,
            np.zeros((2, 4, 3), np.float32), **kw),
        "params_from_numpy": lambda **kw: params_from_numpy({}, args, **kw),
        "preset_build_bench_problem": lambda **kw: build_bench_problem(
            preset_model_args("fast"), initialize=False, **kw),
        "gpode_params_from_numpy": lambda **kw: gpode_params_from_numpy(
            {}, **kw),
        # the generator lives on the device the params were built for
        "sample_predict_noise": lambda **kw: sample_predict_noise(
            _gpode_view(args, **kw), 8, 2, torch.Generator().manual_seed(0)),
        "make_projected_scorer": lambda **kw: make_projected_scorer(
            args.solver_config(), None, np.zeros((2, 4, 3), np.float32),
            np.linspace(0, 0.3, 4), None, **kw),
        "build_gpode": lambda **kw: tb.build_gpode(
            torch.Generator().manual_seed(0), args,
            np.zeros((2, 4, 3), np.float32), **kw),
        # the command line's --device; main returns 0 after the error lines
        "proto_wide_rhs": lambda **kw: proto_wide_rhs.main(
            ["--rows", "9", "--m", "4", "--s", "8", "--d", "2"]
            + [f"--{k}={v}" for k, v in kw.items()]) == 0,
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry](device="cuda")
    if entry in ("resolve_device", "build_shooting", "sample_predict_noise",
                 "make_projected_scorer", "build_gpode", "proto_wide_rhs"):
        assert calls[entry](device="cpu") is not None
