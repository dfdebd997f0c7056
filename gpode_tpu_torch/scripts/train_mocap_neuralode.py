"""NeuralODE baseline on MoCap: dynamics in the PCA latent space, trained on
the latent-space MSE from the observed initial latent state, scored by the
data-space MSE after the latent-to-data projection.

    python -m gpode_tpu_torch.scripts.train_mocap_neuralode [flags]

Counterpart of `scripts/train_mocap_neuralode.py`: its flags, defaults, loop
and artifacts (`checkpt.npz` with the `mlp.*` weights,
`model_predictions.npz`, `train_args.json`, `logs`, and the two test-split
prediction grids unless `--no_plots`), plus `--device` (default: the CUDA
card; `cpu` runs on the CPU). The weights start from
`torch.Generator().manual_seed(seed)`. Ends with one JSON line of the train
and test data-space MSE, the wall seconds and the Trainer's steps/s.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from gpode_tpu_torch import resolve_device
from gpode_tpu_torch.data.mocap import MocapDataset, latent_to_data_projector
from gpode_tpu_torch.models import neural_ode
from gpode_tpu_torch.models.flow import SolverConfig
from gpode_tpu_torch.models.likelihoods import project
from gpode_tpu_torch.plots import pyplot
from gpode_tpu_torch.scripts._cli import (add_mocap_flags, base_parser,
                                          run_and_report)
from gpode_tpu_torch.train.builders import make_projector
from gpode_tpu_torch.train.metrics import compute_mse
from gpode_tpu_torch.train.trainer import TrainConfig, Trainer
from gpode_tpu_torch.utils import io as io_utils
from gpode_tpu_torch.utils.checkpoint import save_checkpoint


def parser():
    p = base_parser("NeuralODE baseline on CMU MoCap")
    add_mocap_flags(p)
    p.add_argument("--num_hidden", type=int, default=128)
    p.set_defaults(save="results/mocap/neuralode", num_iter=2000,
                   solver="rk4", ts_dense_scale=2)
    return p


def _tensor(a, device):
    return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)


def problem(ns, device):
    """(the PCA-latent data, the 50-D data, the latent-to-data `Projector`
    on `device`, the solver config) of a parsed command line."""
    data_pca = MocapDataset(data_path=ns.data_path, subject=ns.data_subject,
                            pca_components=ns.num_latents, data_normalize=False,
                            pca_normalize=True, dt=0.01, seqlen=ns.data_seqlen)
    data_full = MocapDataset(data_path=ns.data_path, subject=ns.data_subject,
                             pca_components=-1, data_normalize=False,
                             pca_normalize=False, dt=0.01, seqlen=ns.data_seqlen)
    projector = make_projector(latent_to_data_projector(data_pca), device)
    cfg = SolverConfig(solver=ns.solver, rtol=1e-6, atol=1e-6,
                       ts_dense_scale=ns.ts_dense_scale, max_steps=ns.max_steps)
    return data_pca, data_full, projector, cfg


def run(argv=None):
    """Parse `argv` and run: (params, the Trainer, metrics)."""
    ns = parser().parse_args(argv)
    device = resolve_device(ns.device)
    if not ns.no_plots:
        pyplot()
    io_utils.makedirs(ns.save)
    logger = io_utils.get_logger(os.path.join(ns.save, "logs"),
                                 name="mocap_node")
    io_utils.save_args(ns, os.path.join(ns.save, "train_args.json"))

    data_pca, data_full, projector, cfg = problem(ns, device)
    params = neural_ode.init_neural_ode(torch.Generator().manual_seed(ns.seed),
                                        ns.num_latents, ns.num_hidden,
                                        device=device)

    def loss_fn(params, noise, ys, ts):
        return neural_ode.mse_loss(params, noise, ys, ts, cfg)

    trainer = Trainer(loss_fn, TrainConfig(num_iter=ns.num_iter, lr=ns.lr,
                                           log_freq=ns.log_freq),
                      neural_ode.no_noise, logger=logger)
    params, _, _ = trainer.train(params, torch.Generator(device),
                                 _tensor(data_pca.trn.ys, device),
                                 _tensor(data_pca.trn.ts, device))
    logger.info("********** Optimization completed **********")

    def eval_split(zs_split, full_split, tag):
        pred_zs = neural_ode.predict(params, _tensor(zs_split.ys[:, 0], device),
                                     _tensor(zs_split.ts, device), cfg)
        with torch.no_grad():
            pred_ys = project(projector, pred_zs).cpu().numpy()
        mse = compute_mse(full_split.ys, pred_ys)
        logger.info(f"[{tag}] data-space MSE {mse:.3f}")
        return pred_zs.cpu().numpy(), pred_ys, mse

    train_pred_zs, train_pred_ys, train_mse = eval_split(
        data_pca.trn, data_full.trn, "TRAIN")
    test_pred_zs, test_pred_ys, test_mse = eval_split(
        data_pca.tst, data_full.tst, "TEST")

    if not ns.no_plots:
        # the deterministic prediction enters as a single-draw band
        from gpode_tpu_torch.plots import plots_mocap
        plots_mocap.plot_data_predictions(data_full.tst.ys, test_pred_ys[None],
                                          data_pca.tst.ts, ns.save,
                                          name="plt_data_test")
        plots_mocap.plot_pca_predictions(data_pca.tst.ys, test_pred_zs[None],
                                         data_pca.tst.ts, ns.save,
                                         name="plt_latents_test")
    save_checkpoint(os.path.join(ns.save, "checkpt.npz"), {"params": params})
    np.savez(os.path.join(ns.save, "model_predictions.npz"),
             train_pred_zs=train_pred_zs, train_pred_ys=train_pred_ys,
             test_pred_zs=test_pred_zs, test_pred_ys=test_pred_ys)
    return params, trainer, dict(train_mse=train_mse, test_mse=test_mse)


def main(argv=None) -> int:
    return run_and_report(run, argv)


if __name__ == "__main__":
    sys.exit(main())
