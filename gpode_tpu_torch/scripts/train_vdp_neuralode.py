"""NeuralODE baseline on Van der Pol.

    python -m gpode_tpu_torch.scripts.train_vdp_neuralode [flags]

Counterpart of `scripts/train_vdp_neuralode.py`: its flags, defaults, loop
and artifacts (`checkpt.npz` with the `mlp.*` weights,
`model_predictions.npz`, `train_args.json`, `logs`, and the two neural-ODE
plots unless `--no_plots`), plus `--device` (default: the CUDA card; `cpu`
runs on the CPU). The weights start from `torch.Generator().manual_seed(seed)`.
Ends with one JSON line of the train and test MSE, the wall seconds and the
Trainer's steps/s.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from gpode_tpu_torch import resolve_device
from gpode_tpu_torch.data.vanderpol import VanderPol
from gpode_tpu_torch.models import neural_ode
from gpode_tpu_torch.models.flow import SolverConfig
from gpode_tpu_torch.plots import pyplot
from gpode_tpu_torch.scripts._cli import add_vdp_flags, base_parser, run_and_report
from gpode_tpu_torch.train.metrics import compute_mse
from gpode_tpu_torch.train.trainer import TrainConfig, Trainer
from gpode_tpu_torch.utils import io as io_utils
from gpode_tpu_torch.utils.checkpoint import save_checkpoint


def parser():
    p = base_parser("NeuralODE baseline on Van der Pol")
    add_vdp_flags(p)
    p.add_argument("--num_hidden", type=int, default=128)
    p.set_defaults(save="results/vdp/neuralode", num_iter=2000)
    return p


def _tensor(a, device):
    return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)


def problem(ns):
    """(the VDP data, the solver config) of a parsed command line."""
    n_ahead = ns.data_obs_s
    data = VanderPol(s_train=ns.data_obs_s, t_train=ns.data_obs_t,
                     s_test=ns.data_obs_s + n_ahead,
                     t_test=ns.data_obs_t * (ns.data_obs_s + n_ahead - 1) / (ns.data_obs_s - 1),
                     noise_var=ns.data_obs_noise_var)
    cfg = SolverConfig(solver=ns.solver, ts_dense_scale=ns.ts_dense_scale,
                       max_steps=ns.max_steps)
    return data, cfg


def run(argv=None):
    """Parse `argv` and run: (params, the Trainer, metrics)."""
    ns = parser().parse_args(argv)
    device = resolve_device(ns.device)
    if not ns.no_plots:
        pyplot()
    io_utils.makedirs(ns.save)
    logger = io_utils.get_logger(os.path.join(ns.save, "logs"), name="vdp_node")
    io_utils.save_args(ns, os.path.join(ns.save, "train_args.json"))

    data, cfg = problem(ns)
    params = neural_ode.init_neural_ode(torch.Generator().manual_seed(ns.seed),
                                        2, ns.num_hidden, device=device)

    def loss_fn(params, noise, ys, ts):
        return neural_ode.mse_loss(params, noise, ys, ts, cfg)

    trainer = Trainer(loss_fn, TrainConfig(num_iter=ns.num_iter, lr=ns.lr,
                                           log_freq=ns.log_freq),
                      neural_ode.no_noise, logger=logger)
    params, _, _ = trainer.train(params, torch.Generator(device),
                                 _tensor(data.trn.ys, device),
                                 _tensor(data.trn.ts, device))

    def predict(split):
        return neural_ode.predict(params, _tensor(split.ys[:, 0], device),
                                  _tensor(split.ts, device), cfg).cpu().numpy()

    t_train = data.trn.ys.shape[1]
    test_pred, train_pred = predict(data.tst), predict(data.trn)
    train_mse = compute_mse(data.trn.ys, train_pred)
    test_mse = compute_mse(data.tst.ys[:, t_train:], test_pred[:, t_train:])
    logger.info(f"[TRAIN] MSE {train_mse:.3f}")
    logger.info(f"[TEST]  MSE {test_mse:.3f}")
    if not ns.no_plots:
        from gpode_tpu_torch.plots import plots_2d
        plots_2d.plot_node_longitudinal(data, test_pred, ns.save)
        plots_2d.plot_node_vectorfield(
            lambda x: neural_ode.mlp_rhs(params, x.to(device)), data,
            test_pred, ns.save)
    save_checkpoint(os.path.join(ns.save, "checkpt.npz"), {"params": params})
    np.savez(os.path.join(ns.save, "model_predictions.npz"),
             train_pred=train_pred, test_pred=test_pred,
             train_ys=data.trn.ys, test_ys=data.tst.ys)
    return params, trainer, dict(train_mse=train_mse, test_mse=test_mse)


def main(argv=None) -> int:
    return run_and_report(run, argv)


if __name__ == "__main__":
    sys.exit(main())
