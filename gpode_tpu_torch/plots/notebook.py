"""Inline (notebook) display variants of the diagnostic plots.

Counterpart of `gpode_tpu/plots/notebook.py`: the same visuals as
`plots_2d`, shown on the active display instead of saved. Random numbers
are inputs: where the JAX package takes a key, these take a
`torch.Generator` on the parameters' device.

Data parts: `vectorfield_posterior_arrays` and
`model_initialization_arrays` (and those of `plots_2d`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from gpode_tpu_torch.plots import pyplot
from gpode_tpu_torch.plots.plots_2d import (_grid, _mean_prediction,
                                            grid_conditional,
                                            longitudinal_sequence_figure,
                                            prediction_noise,
                                            unwhiten_inducing,
                                            vectorfield_3panel_figure)


def show_longitudinal(data, pred: np.ndarray, noise_var: np.ndarray):
    """Predictive bands against the observations, one panel per state
    dim."""
    plt = pyplot()
    mean, std = pred.mean(0), pred.std(0)
    d = mean.shape[-1]
    fig, axs = plt.subplots(1, d, figsize=(6 * d, 2.8))
    for dim, ax in enumerate(np.atleast_1d(axs)):
        m, s = mean[0, :, dim], std[0, :, dim]
        sp = np.sqrt(s ** 2 + noise_var[dim % len(noise_var)])
        ax.fill_between(data.tst.ts, m - 2 * sp, m + 2 * sp, alpha=0.2)
        ax.fill_between(data.tst.ts, m - 2 * s, m + 2 * s, alpha=0.4)
        ax.plot(data.tst.ts, m)
        ax.scatter(data.trn.ts, data.trn.ys[0, :, dim], c="k", s=8)
        ax.set_title(f"State {dim + 1}")
        ax.set_xlabel("time")
    plt.show()


def vectorfield_posterior_arrays(gp_params, data) -> dict:
    """The grid conditional mean, the summed posterior std over the dims,
    and the true field."""
    xx, yy, mean, var = grid_conditional(gp_params, data)
    _, _, points = _grid(data)
    return dict(xx=xx, yy=yy, mean=mean,
                std=np.sqrt(np.maximum(var, 0.0)).sum(-1),
                true_field=np.stack([data.f(g) for g in points]))


def show_vectorfield(gp_params, data, pred: np.ndarray = None):
    """The learned mean field with posterior-std contours next to the
    truth."""
    plt = pyplot()
    a = vectorfield_posterior_arrays(gp_params, data)
    xx, yy, mean, std, true_field = (a["xx"], a["yy"], a["mean"], a["std"],
                                     a["true_field"])
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 5), sharex=True,
                                   sharey=True)
    ax1.streamplot(xx, yy, true_field[:, 0].reshape(xx.shape),
                   true_field[:, 1].reshape(xx.shape), color="grey")
    ax1.set_title("True vector field")
    cs = ax2.contourf(xx, yy, std.reshape(xx.shape), levels=12, cmap="Blues",
                      alpha=0.6)
    fig.colorbar(cs, ax=ax2)
    ax2.streamplot(xx, yy, mean[:, 0].reshape(xx.shape),
                   mean[:, 1].reshape(xx.shape), color="k")
    if pred is not None:
        for s in range(min(8, pred.shape[0])):
            ax2.plot(pred[s, 0, :, 0], pred[s, 0, :, 1], "r-", alpha=0.3, lw=0.8)
    ax2.scatter(data.trn.ys[:, :, 0], data.trn.ys[:, :, 1], c="k", s=6)
    ax2.set_title("Learned posterior mean field")
    plt.show()


def show_vectorfield_posterior(gp_params, data, pred: np.ndarray,
                               generator: Optional[torch.Generator] = None,
                               num_features: int = 256):
    """The 3-panel sampled-field diagnostic, displayed inline."""
    vectorfield_3panel_figure(gp_params, data, pred, generator=generator,
                              num_features=num_features)
    pyplot().show()


def show_longitudinal_per_sequence(data, pred: np.ndarray,
                                   noise_var: np.ndarray):
    """Per-sequence posterior/predictive band figures, displayed inline
    (the figure builder of `plots_2d.plot_longitudinal_per_sequence`)."""
    plt = pyplot()
    mean, var = pred.mean(0), pred.var(0)
    for n in range(mean.shape[0]):
        longitudinal_sequence_figure(data, mean, var, noise_var, n,
                                     "Predictive posterior")
        plt.show()


def show_inducing(gp_params, data):
    plt = pyplot()
    u, z = unwhiten_inducing(gp_params)
    fig, ax = plt.subplots(figsize=(5.5, 5.5))
    ax.scatter(data.trn.ys[:, :, 0], data.trn.ys[:, :, 1], c="k", s=6)
    ax.quiver(z[:, 0], z[:, 1], u[:, 0], u[:, 1], color="tab:blue", angles="xy")
    ax.scatter(z[:, 0], z[:, 1], c="tab:blue", s=14)
    ax.set_xlim(data.xlim); ax.set_ylim(data.ylim)
    plt.show()


def model_initialization_arrays(params, data, cfg, noise) -> dict:
    """The grid conditional mean, the mean predicted trajectory from q(x0)
    over the train grid (the draws of `noise`), the x0 posterior mean and,
    for a shooting model, the shooting-state means."""
    xx, yy, mean, _ = grid_conditional(params.gp, data)
    has_states = hasattr(params, "states")
    x0_post = params.states.x0 if has_states else params.x0
    return dict(xx=xx, yy=yy, mean=mean,
                pred=_mean_prediction(params, noise, data.trn.ts, cfg),
                x0_mean=x0_post.mean.detach().cpu().numpy(),
                states_mean=(params.states.mean.detach().cpu().numpy()
                             if has_states else None))


def show_model_initialization(generator: torch.Generator, params, data, cfg,
                              num_features: int, num_draws: int = 20,
                              ax=None):
    """Init-stage snapshot: the posterior mean field, the mean predicted
    trajectory (`num_draws` draws from `generator`), the observations and
    the state posterior means (x0 always; the shooting states when
    `params` has them)."""
    plt = pyplot()
    show = ax is None
    if ax is None:
        _, ax = plt.subplots(figsize=(5.5, 5.5))
    noise = prediction_noise(params, num_features, num_draws, generator)
    a = model_initialization_arrays(params, data, cfg, noise)
    xx, yy, mean, pred = a["xx"], a["yy"], a["mean"], a["pred"]
    ax.streamplot(xx, yy, mean[:, 0].reshape(xx.shape),
                  mean[:, 1].reshape(xx.shape), color="grey")
    ax.set_xticks([]), ax.set_yticks([])
    ax.plot(pred[0, :, 0], pred[0, :, 1], c="tab:red", lw=1.0, zorder=1)
    ax.scatter(pred[0, :, 0], pred[0, :, 1], marker="x", c="tab:red", s=18,
               zorder=2, label="predicted ys")
    ax.scatter(data.trn.ys[0, :, 0], data.trn.ys[0, :, 1], marker="x", c="k",
               s=18, zorder=2, label="observed ys")
    if a["states_mean"] is not None:
        sm = a["states_mean"]
        ax.scatter(sm[0, :, 0], sm[0, :, 1], marker="x", c="tab:blue", s=18,
                   zorder=3, label="latent xs (mean)")
    x0m = a["x0_mean"]
    ax.scatter(x0m[0, 0], x0m[0, 1], marker="o", c="tab:blue", zorder=4,
               label="latent x0 (mean)")
    ax.legend(loc="lower right", fontsize=8)
    if show:
        plt.show()


def show_trace(trainer):
    plt = pyplot()
    fig, axs = plt.subplots(1, 3, figsize=(12, 2.8))
    for (name, meter), ax in zip(
            [("loss", trainer.loss_meter),
             ("observation NLL", trainer.observ_nll_meter),
             ("inducing KL", trainer.inducing_kl_meter)], axs):
        ax.plot(meter.iters, meter.vals, lw=0.6)
        ax.set_title(name)
    plt.show()
