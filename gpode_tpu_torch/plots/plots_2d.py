"""2-D model diagnostics: longitudinal bands, vector fields, inducing
posteriors, shooting states and optimization traces.

Counterpart of `gpode_tpu/plots/plots_2d.py`: the same functions, file names
and figures. Random numbers are inputs: where the JAX package takes a key,
these take a `torch.Generator` (on the parameters' device) whose draws
become the noise tensors of the data parts.

Data parts (torch on the parameters' device, NumPy out): `_grid`,
`field_noise`, `_field_draws`, `vectorfield_arrays`, `unwhiten_inducing`,
`grid_conditional`, `shooting_initialization_arrays`, `node_field`. The
drawing parts take only NumPy arrays.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from gpode_tpu_torch.models import gp as gp_mod
from gpode_tpu_torch.models import gpode as gpode_mod
from gpode_tpu_torch.ops import math as om
from gpode_tpu_torch.ops.kernels import rbf_K
from gpode_tpu_torch.plots import pyplot
from gpode_tpu_torch.train.experiments import view

FIELD_DRAWS = 100
# draws per batched plain evaluation of the field (bounds the (S, G, F, D)
# feature tensor)
_DRAW_CHUNK = 25

# The reference's `make_plot=True` interactive display mode: every plot
# function routes through `finish_figure`, which shows instead of saving
# when the switch is on.
_DISPLAY_MODE = False


def set_display_mode(enabled: bool):
    """True -> plot functions `plt.show()` figures instead of saving them;
    False (default) -> save PNGs into `save_dir`."""
    global _DISPLAY_MODE
    _DISPLAY_MODE = bool(enabled)


def finish_figure(fig, save_dir: str, fname: str, dpi: int = 120,
                  **savefig_kwargs):
    """Show (display mode) or save-and-close a finished figure."""
    plt = pyplot()
    if _DISPLAY_MODE:
        plt.show()
        return
    fig.savefig(os.path.join(save_dir, fname), dpi=dpi, **savefig_kwargs)
    plt.close(fig)


def _device(gp_params) -> torch.device:
    return gp_params.z.device


def _tensor(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)


# ---------------------------------------------------------------------------
# data parts
# ---------------------------------------------------------------------------

def _grid(data, grid_size: int = 30):
    """(xx, yy, points (grid_size**2, 2)) over the data's phase plane."""
    xx, yy = np.meshgrid(np.linspace(*data.xlim, grid_size),
                         np.linspace(*data.ylim, grid_size))
    return xx, yy, np.stack([xx.reshape(-1), yy.reshape(-1)], axis=1)


def field_noise(gp_params, num_features: int, generator: torch.Generator,
                num_draws: int = FIELD_DRAWS) -> gpode_mod.PredictNoise:
    """The noise of `num_draws` posterior function draws (x0 None)."""
    return gpode_mod.sample_draw_noise(gp_params, num_features, num_draws,
                                       generator)


@torch.no_grad()
def _field_draws(noise: gpode_mod.PredictNoise, gp_params,
                 points: np.ndarray) -> np.ndarray:
    """Sampled vector fields at `points` (G, Din): (S, G, D), one posterior
    draw per draw of `noise`, each evaluated on the plain rhs."""
    chol = gp_mod.precompute_chol(gp_params)
    x = _tensor(points, _device(gp_params))
    out = []
    for lo in range(0, noise.inducing.shape[0], _DRAW_CHUNK):
        sl = slice(lo, lo + _DRAW_CHUNK)
        draws = gp_mod.draw_posterior(gp_params, noise.rff_weights[sl],
                                      noise.rff_freq[sl], noise.rff_phase[sl],
                                      noise.inducing[sl], chol)
        xs = x.expand(draws.weights.shape[0], *x.shape)
        out.append(gp_mod.eval_draws(gp_params, draws, xs, use_kernel=False))
    return torch.cat(out).cpu().numpy()


def vectorfield_arrays(gp_params, data, noise: gpode_mod.PredictNoise,
                       coarse_noise: gpode_mod.PredictNoise,
                       grid_size: int = 30) -> dict:
    """What the 3-panel figure draws: the draws on the fine grid (`noise`)
    and their mean and std, the draws on the 12x12 quiver grid
    (`coarse_noise`) and their pointwise std, and the true field."""
    xx, yy, points = _grid(data, grid_size)
    field = _field_draws(noise, gp_params, points)            # (S, G, 2)
    qxx, qyy, qpoints = _grid(data, 12)
    qfield = _field_draws(coarse_noise, gp_params, qpoints)   # (S, G, 2)
    return dict(xx=xx, yy=yy, field=field, mean=field.mean(0),
                std=field.std(0), qxx=qxx, qyy=qyy, qfield=qfield,
                qstd=qfield.std(0).mean(1),
                true_field=np.stack([data.f(g) for g in points]))


@torch.no_grad()
def unwhiten_inducing(gp_params) -> tuple[np.ndarray, np.ndarray]:
    """(u, z) with u = L u_whitened, L = chol(K(Z, Z) + 1e-5 I): the
    un-whitened inducing values of the arrow plots."""
    chol = om.cholesky_jittered(rbf_K(gp_params.kernel, gp_params.z), 1e-5)
    if gp_params.dimwise:
        u = torch.einsum("dnm,md->nd", chol, gp_params.u_mean)
    else:
        u = chol @ gp_params.u_mean
    return u.cpu().numpy(), gp_params.z.detach().cpu().numpy()


@torch.no_grad()
def grid_conditional(gp_params, data, grid_size: int = 30):
    """(xx, yy, mean (G, D), var (G, D)): the exact conditional of the
    field on the grid, under no_grad (where a dimwise GP's K(Z, x) comes
    from the `rbf_gram` kernel on the card)."""
    xx, yy, points = _grid(data, grid_size)
    mean, var = gp_mod.conditional(gp_params,
                                   _tensor(points, _device(gp_params)))
    return xx, yy, mean.cpu().numpy(), var.cpu().numpy()


def prediction_noise(params, num_features: int, num_draws: int,
                     generator: torch.Generator) -> gpode_mod.PredictNoise:
    """The noise of a `num_draws`-draw prediction from q(x0)."""
    return gpode_mod.sample_predict_noise(view(params), num_features,
                                          num_draws, generator)


@torch.no_grad()
def _mean_prediction(params, noise, ts, cfg) -> np.ndarray:
    """The mean over the draws of `noise` of the trajectories from q(x0)
    over `ts`: (N, T, D)."""
    pred = gpode_mod.predict(view(params), noise,
                             _tensor(ts, _device(params.gp)), cfg)
    return pred.mean(0).cpu().numpy()


def shooting_initialization_arrays(params, data, cfg,
                                   noise: gpode_mod.PredictNoise) -> dict:
    """What the shooting snapshot draws: the grid conditional mean, the mean
    predicted trajectory from q(x0) over the train grid and one
    extrapolated point (the draws of `noise`), the shooting-state and x0
    posterior means."""
    xx, yy, mean, _ = grid_conditional(params.gp, data)
    ts = np.asarray(data.trn.ts)
    ts_ext = np.concatenate([ts, [2 * ts[-1] - ts[-2]]])
    return dict(xx=xx, yy=yy, mean=mean,
                pred=_mean_prediction(params, noise, ts_ext, cfg),
                states_mean=params.states.mean.detach().cpu().numpy(),
                x0_mean=params.states.x0.mean.detach().cpu().numpy())


@torch.no_grad()
def node_field(rhs_fn, points: np.ndarray) -> np.ndarray:
    """A deterministic field `rhs_fn` ((G, 2) float32 tensor on the CPU ->
    tensor) at `points`: (G, 2)."""
    return np.asarray(rhs_fn(_tensor(points, "cpu")).detach().cpu())


# ---------------------------------------------------------------------------
# drawing parts
# ---------------------------------------------------------------------------

def plot_longitudinal(data, test_pred: np.ndarray, noise_var: np.ndarray,
                      save_dir: str, fname: str = "plt_longitudinal.png"):
    """Per-dimension predictive bands over time: mean +/- 2 std (posterior)
    and +/- 2 sqrt(std^2 + noise) (predictive), observations overlaid."""
    plt = pyplot()
    pred_mean = test_pred.mean(0)          # (N, T, D)
    pred_std = test_pred.std(0)
    ts = data.tst.ts
    n, t, d = pred_mean.shape
    fig, axs = plt.subplots(d, 1, figsize=(10, 2.5 * d), sharex=True)
    axs = np.atleast_1d(axs)
    for dim, ax in enumerate(axs):
        for seq in range(n):
            m = pred_mean[seq, :, dim]
            s = pred_std[seq, :, dim]
            sp = np.sqrt(s ** 2 + noise_var[dim % len(noise_var)])
            ax.fill_between(ts, m - 2 * sp, m + 2 * sp, alpha=0.2,
                            color="tab:blue", label="predictive" if seq == 0 else None)
            ax.fill_between(ts, m - 2 * s, m + 2 * s, alpha=0.4,
                            color="tab:blue", label="posterior" if seq == 0 else None)
            ax.plot(ts, m, color="tab:blue")
        for seq in range(data.trn.ys.shape[0]):
            ax.scatter(data.trn.ts, data.trn.ys[seq, :, dim], c="k", s=8,
                       label="observations" if seq == 0 else None)
        ax.plot(ts, data.tst.ys[0, :, dim], "r--", lw=1, label="truth")
        ax.set_ylabel(f"state {dim + 1}")
    axs[0].legend(loc="upper right", fontsize=8)
    axs[-1].set_xlabel("time")
    fig.tight_layout()
    finish_figure(fig, save_dir, fname)


def longitudinal_sequence_figure(data, pred_mean: np.ndarray,
                                 pred_var: np.ndarray, noise_var: np.ndarray,
                                 n: int, title: str):
    """One sequence's posterior/predictive band figure. Predictions beyond
    the data's sequence count omit the truth and train-obs overlays (never
    another sequence's)."""
    plt = pyplot()
    d = pred_mean.shape[-1]
    fig, axs = plt.subplots(1, d, figsize=(8 * d, 3), squeeze=False)
    for dim in range(d):
        ax = axs[0, dim]
        m, pv = pred_mean[n, :, dim], pred_var[n, :, dim]
        sv = np.sqrt(pv + noise_var[dim % len(noise_var)])
        ax.plot(data.tst.ts, m, c="r", alpha=0.7, zorder=3, label="predicted")
        ax.fill_between(data.tst.ts, m - 2 * np.sqrt(pv),
                        m + 2 * np.sqrt(pv), color="r", alpha=0.1,
                        zorder=1, label="posterior")
        ax.fill_between(data.tst.ts, m - 2 * sv, m + 2 * sv, color="b",
                        alpha=0.1, zorder=0, label="predictive")
        if n < data.tst.ys.shape[0]:
            ax.plot(data.tst.ts, data.tst.ys[n, :, dim], c="k", alpha=0.7,
                    zorder=2, label="true trajectory")
        if n < data.trn.ys.shape[0]:
            ax.scatter(data.trn.ts, data.trn.ys[n, :, dim], c="k", s=100,
                       marker=".", zorder=200, label="train obs")
        ax.set_title(f"State {dim + 1}")
        ax.set_xlabel("Time")
    axs[0, -1].legend(loc="upper right", fontsize=8)
    fig.suptitle(title)
    fig.subplots_adjust(wspace=0.2, hspace=0.2)
    return fig


def plot_longitudinal_per_sequence(data, test_pred: np.ndarray,
                                   noise_var: np.ndarray, save_dir: str):
    """One `plt_longitudinal_{n}.png` per sequence."""
    pred_mean, pred_var = test_pred.mean(0), test_pred.var(0)
    for n in range(pred_mean.shape[0]):
        fig = longitudinal_sequence_figure(data, pred_mean, pred_var,
                                           noise_var, n,
                                           "Predictive posterior for GPODE")
        finish_figure(fig, save_dir, f"plt_longitudinal_{n}.png",
                      bbox_inches="tight", pad_inches=0.2)


def _default_generator(gp_params, generator):
    if generator is not None:
        return generator
    return torch.Generator(_device(gp_params)).manual_seed(0)


def plot_vectorfield(gp_params, data, test_pred: np.ndarray, save_dir: str,
                     fname: str = "plt_vectorfield.png", grid_size: int = 30,
                     generator: Optional[torch.Generator] = None,
                     num_features: int = 256):
    """The 3-panel diagnostic; see :func:`vectorfield_3panel_figure`."""
    fig = vectorfield_3panel_figure(gp_params, data, test_pred,
                                    grid_size=grid_size, generator=generator,
                                    num_features=num_features)
    finish_figure(fig, save_dir, fname, bbox_inches="tight", pad_inches=0.01)


def vectorfield_3panel_figure(gp_params, data, test_pred: np.ndarray,
                              grid_size: int = 30,
                              generator: Optional[torch.Generator] = None,
                              num_features: int = 256):
    """The 3-panel vectorfield figure: (1) the true field with the training
    observations, (2) the draw-mean field with log draw-std contours, (3)
    10 per-draw quiver fields colored by the pointwise draw std, predictive
    sample trajectories and the true test trajectory. The 100 fine-grid
    draws and then the 100 quiver-grid draws come from `generator` (default
    seed 0)."""
    gen = _default_generator(gp_params, generator)
    noise = field_noise(gp_params, num_features, gen)
    coarse = field_noise(gp_params, num_features, gen)
    a = vectorfield_arrays(gp_params, data, noise, coarse, grid_size)
    return _vectorfield_figure(a, data, test_pred)


def _vectorfield_figure(a: dict, data, test_pred: np.ndarray):
    plt = pyplot()
    xx, yy, mean, std = a["xx"], a["yy"], a["mean"], a["std"]
    true_field = a["true_field"]
    fig, (ax1, ax2, ax3) = plt.subplots(
        1, 3, figsize=(21, 7), sharex="all", sharey="all",
        gridspec_kw={"width_ratios": [1, 1.25, 1]})

    ax1.streamplot(xx, yy, true_field[:, 0].reshape(xx.shape),
                   true_field[:, 1].reshape(xx.shape), color="grey")
    ax1.scatter(data.trn.ys[:, :, 0], data.trn.ys[:, :, 1], marker=".",
                c="k", alpha=0.8, s=200)
    ax1.scatter([], [], marker=".", c="k", s=200, label="Training obs")
    ax1.set_title("True vectorfield")
    ax1.legend(loc="lower right")

    ax2.streamplot(xx, yy, mean[:, 0].reshape(xx.shape),
                   mean[:, 1].reshape(xx.shape), color="k")
    cs2 = ax2.contourf(xx, yy, np.log(std.mean(1) + 1e-12).reshape(xx.shape),
                       levels=10, cmap="bwr", alpha=0.6)
    fig.colorbar(cs2, ax=ax2, shrink=0.9)
    ax2.locator_params(nbins=4)
    ax2.set_title("Learned vectorfield")

    qxx, qyy, qfield, qstd = a["qxx"], a["qyy"], a["qfield"], a["qstd"]
    for s in range(10):
        ax3.quiver(qxx, qyy, qfield[s, :, 0].reshape(qxx.shape),
                   qfield[s, :, 1].reshape(qxx.shape), qstd,
                   units="x", width=0.022, scale=1 / 0.15, zorder=2,
                   alpha=0.8, cmap="bwr")
    for s in range(min(test_pred.shape[0], 10)):
        for n in range(test_pred.shape[1]):
            ax3.plot(test_pred[s, n, :, 0], test_pred[s, n, :, 1],
                     color="g", alpha=0.3, lw=2.5, zorder=3)
    for n in range(data.tst.ys.shape[0]):
        ax3.plot(data.tst.ys[n, :, 0], data.tst.ys[n, :, 1], color="k",
                 lw=0.5, alpha=1.0, zorder=4)
    ax3.scatter(data.tst.ys[:, :, 0], data.tst.ys[:, :, 1], s=50, marker=".",
                c="k", alpha=0.9, zorder=4)
    ax3.plot([], [], color="g", alpha=0.7, label="predictive samples")
    ax3.plot([], [], color="k", marker=".", alpha=0.7, label="true trajectory")
    ax3.scatter([], [], c="k", marker=r"$\longrightarrow$", s=200,
                label="vectorfield samples")
    ax3.legend(loc="lower left")
    ax3.set_title("Predictive samples")

    for ax in (ax1, ax2, ax3):
        ax.set_xlim(*data.xlim)
        ax.set_ylim(*data.ylim)
    fig.subplots_adjust(wspace=0.2, hspace=0.2)
    return fig


def plot_inducing_posterior(gp_params, data, save_dir: str,
                            fname: str = "plt_inducing_posterior.png"):
    """Inducing locations and un-whitened mean arrows over the observed
    phase plane."""
    plt = pyplot()
    u, z = unwhiten_inducing(gp_params)
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.scatter(data.trn.ys[:, :, 0], data.trn.ys[:, :, 1], c="k", s=6,
               label="observations")
    ax.quiver(z[:, 0], z[:, 1], u[:, 0], u[:, 1], color="tab:blue",
              angles="xy", label="inducing mean")
    ax.scatter(z[:, 0], z[:, 1], c="tab:blue", s=14)
    ax.set_xlim(data.xlim)
    ax.set_ylim(data.ylim)
    ax.legend()
    fig.tight_layout()
    finish_figure(fig, save_dir, fname)


def plot_model_initialization(gp_params, data, save_dir: str, fname: str):
    """Field and inducing snapshot, before and after initialization: the
    grid conditional mean (`grid_conditional`) and the un-whitened inducing
    arrows."""
    plt = pyplot()
    xx, yy, mean, _ = grid_conditional(gp_params, data)
    u, z = unwhiten_inducing(gp_params)
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.streamplot(xx, yy, mean[:, 0].reshape(xx.shape),
                  mean[:, 1].reshape(xx.shape), color="grey")
    ax.quiver(z[:, 0], z[:, 1], u[:, 0], u[:, 1], color="tab:blue", angles="xy")
    ax.scatter(data.trn.ys[:, :, 0], data.trn.ys[:, :, 1], c="k", s=6)
    fig.tight_layout()
    finish_figure(fig, save_dir, fname)


def plot_shooting_initialization(generator: torch.Generator, params, data,
                                 cfg, num_features: int, save_dir: str,
                                 fname: str, num_draws: int = 20):
    """Shooting-model snapshot: the posterior mean field, the mean predicted
    trajectory from q(x0) (red; `num_draws` draws from `generator`), the
    shooting-state posterior means (blue) and the observations."""
    plt = pyplot()
    noise = prediction_noise(params, num_features, num_draws, generator)
    a = shooting_initialization_arrays(params, data, cfg, noise)
    xx, yy, mean, pred = a["xx"], a["yy"], a["mean"], a["pred"]
    states_mean, x0_mean = a["states_mean"], a["x0_mean"]

    fig, ax = plt.subplots(figsize=(6, 6))
    ax.streamplot(xx, yy, mean[:, 0].reshape(xx.shape),
                  mean[:, 1].reshape(xx.shape), color="grey")
    ax.plot(pred[0, :, 0], pred[0, :, 1], c="tab:red", lw=1.0, zorder=1)
    ax.scatter(pred[0, :, 0], pred[0, :, 1], marker="x", c="tab:red", s=18,
               zorder=2, label="ys (mean trajectory)")
    ax.scatter(states_mean[0, :, 0], states_mean[0, :, 1], marker="x",
               c="tab:blue", s=18, zorder=3, label="xs (shooting states)")
    ax.scatter(x0_mean[0, 0], x0_mean[0, 1], marker="o", c="tab:blue",
               zorder=4, label="x0")
    ax.scatter(data.trn.ys[0, :, 0], data.trn.ys[0, :, 1], marker="x", c="k",
               s=18, zorder=2, label="obs")
    ax.set_xticks([]), ax.set_yticks([])
    ax.legend(loc="upper right", fontsize=8)
    fig.tight_layout()
    finish_figure(fig, save_dir, fname)


def _long_pred_panel(ax, ts, data_seq, pred_seq, noise_var=None):
    """One (sequence, dim) band panel shared by the plot_long_pred family."""
    m, v = pred_seq.mean(0), pred_seq.var(0)
    ax.plot(ts, m, c="tab:red", alpha=0.6)
    ax.fill_between(ts, m - 2 * np.sqrt(v), m + 2 * np.sqrt(v),
                    color="tab:red", alpha=0.15, zorder=1, label="posterior")
    if noise_var is not None:
        sp = np.sqrt(v + noise_var)
        ax.fill_between(ts, m - 2 * sp, m + 2 * sp, color="tab:blue",
                        alpha=0.12, zorder=0, label="predictive")
    ax.scatter(ts, data_seq, c="k", s=6, marker=".", zorder=200)


def plot_long_pred(data_ys: np.ndarray, pred: np.ndarray, ts: np.ndarray,
                   save_dir: str, name: str, noise_var=None):
    """Long-horizon per-sequence band grid (with `noise_var`, the predictive
    band too): up to 4 sequences x D state panels.
    data_ys (N, T, D); pred (S, N, T, D) posterior draws."""
    plt = pyplot()
    nobs = min(pred.shape[1], 4)
    d = pred.shape[-1]
    fig, axs = plt.subplots(nobs, d, figsize=(6 * d, 2.6 * nobs),
                            sharex="all", squeeze=False)
    for i in range(nobs):
        for j in range(d):
            nv = None if noise_var is None else noise_var[j % len(noise_var)]
            _long_pred_panel(axs[i, j], np.asarray(ts), data_ys[i, :, j],
                             pred[:, i, :, j], nv)
            if i == 0:
                axs[i, j].set_title(f"state {j + 1}")
            if i == nobs - 1:
                axs[i, j].set_xlabel("time")
        axs[i, -1].legend(loc="lower left", fontsize=8)
    fig.tight_layout()
    finish_figure(fig, save_dir, name)


def plot_long_pred_single(data_ys: np.ndarray, pred: np.ndarray,
                          ts: np.ndarray, save_dir: str, name: str,
                          noise_var=None):
    """Single-sequence variant of :func:`plot_long_pred`."""
    plt = pyplot()
    d = pred.shape[-1]
    fig, axs = plt.subplots(1, d, figsize=(6 * d, 2.6), sharex="all",
                            squeeze=False)
    for j in range(d):
        nv = None if noise_var is None else noise_var[j % len(noise_var)]
        _long_pred_panel(axs[0, j], np.asarray(ts), data_ys[0, :, j],
                         pred[:, 0, :, j], nv)
        axs[0, j].set_title(f"state {j + 1}")
        axs[0, j].set_xlabel("time")
    axs[0, -1].legend(loc="lower left", fontsize=8)
    fig.tight_layout()
    finish_figure(fig, save_dir, name)


def plot_node_longitudinal(data, test_pred: np.ndarray, save_dir: str,
                           fname: str = "plt_longitudinal.png"):
    """Deterministic neural-ODE trajectories against the truth.
    test_pred: (N, T, D)."""
    plt = pyplot()
    d = test_pred.shape[-1]
    fig, axs = plt.subplots(1, d, figsize=(6 * d, 3), squeeze=False)
    for dim in range(d):
        ax = axs[0, dim]
        ax.plot(data.tst.ts, test_pred[0, :, dim], c="tab:red", alpha=0.8,
                zorder=3, label="predictive trajectory")
        ax.plot(data.tst.ts, data.tst.ys[0, :, dim], c="k", alpha=0.7,
                zorder=2, label="true trajectory")
        ax.scatter(data.trn.ts, data.trn.ys[0, :, dim], c="k", s=20,
                   marker=".", zorder=200, label="train obs")
        ax.set_title(f"State {dim + 1}")
        ax.set_xlabel("Time")
    axs[0, -1].legend(loc="upper right", fontsize=8)
    fig.suptitle("Predictive plot for NeuralODE")
    fig.tight_layout()
    finish_figure(fig, save_dir, fname)


def plot_node_vectorfield(rhs_fn, data, test_pred: np.ndarray, save_dir: str,
                          fname: str = "plt_vectorfield.png"):
    """True against learned deterministic field with trajectories overlaid.
    rhs_fn: (G, 2) float32 tensor on the CPU -> (G, 2) tensor."""
    plt = pyplot()
    xx, yy, points = _grid(data)
    true_field = np.stack([data.f(g) for g in points])
    learned = node_field(rhs_fn, points)

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 5), sharex=True,
                                   sharey=True)
    ax1.streamplot(xx, yy, true_field[:, 0].reshape(xx.shape),
                   true_field[:, 1].reshape(xx.shape), color="grey")
    ax1.scatter(data.trn.ys[:, :, 0], data.trn.ys[:, :, 1], c="k", s=12,
                marker=".", label="training obs")
    ax1.set_title("True vectorfield")
    ax1.legend(loc="lower right", fontsize=8)
    ax2.streamplot(xx, yy, learned[:, 0].reshape(xx.shape),
                   learned[:, 1].reshape(xx.shape), color="k")
    for n in range(test_pred.shape[0]):
        ax2.plot(test_pred[n, :, 0], test_pred[n, :, 1], c="tab:green",
                 alpha=0.5, lw=2.0, zorder=3,
                 label="predicted trajectory" if n == 0 else None)
        ax2.plot(data.tst.ys[n, :, 0], data.tst.ys[n, :, 1], c="k", lw=0.6,
                 alpha=0.9, zorder=4,
                 label="true trajectory" if n == 0 else None)
    ax2.set_title("Learned vectorfield")
    ax2.legend(loc="lower left", fontsize=8)
    for ax in (ax1, ax2):
        ax.set_xlim(data.xlim), ax.set_ylim(data.ylim)
    fig.tight_layout()
    finish_figure(fig, save_dir, fname)


def plot_trace(trainer, save_dir: str,
               fname: str = "plt_optimization_trace.png"):
    """Loss / NLL / KL traces from the trainer meters."""
    plt = pyplot()
    meters = [("loss", trainer.loss_meter),
              ("observation NLL", trainer.observ_nll_meter),
              ("inducing KL", trainer.inducing_kl_meter)]
    if trainer.state_kl_meter.vals:
        meters.append(("state KL", trainer.state_kl_meter))
    fig, axs = plt.subplots(1, len(meters), figsize=(4 * len(meters), 3))
    for (name, meter), ax in zip(meters, np.atleast_1d(axs)):
        ax.plot(meter.iters, meter.vals, lw=0.6)
        ax.set_title(name)
        ax.set_xlabel("iteration")
    fig.tight_layout()
    finish_figure(fig, save_dir, fname)


@torch.no_grad()
def shooting_state_bands(states) -> tuple[np.ndarray, ...]:
    """(mean (N, T-1, D), std (N, T-1, D), x0 mean (N, D), x0 std (N, D)):
    the posterior means and the row norms of the scale Choleskys."""
    std = torch.linalg.norm(torch.tril(states.tril()), dim=-1)
    x0_std = torch.linalg.norm(torch.tril(states.x0.tril()), dim=-1)
    return (states.mean.cpu().numpy(), std.cpu().numpy(),
            states.x0.mean.cpu().numpy(), x0_std.cpu().numpy())


def plot_shooting_states(states, data, save_dir: str,
                         fname: str = "plt_shooting_states.png"):
    """Shooting-state posterior bands over time: mean +/- 2 std of every
    q(s_t), with q(x0) at the shifted t=0 slot."""
    plt = pyplot()
    mean, std, x0_mean, x0_std = shooting_state_bands(states)
    n, tm1, d = mean.shape
    ts = data.trn.ts
    fig, axs = plt.subplots(d, 1, figsize=(10, 2.5 * d), sharex=True)
    for dim, ax in enumerate(np.atleast_1d(axs)):
        for seq in range(n):
            m = np.concatenate([[x0_mean[seq, dim]], mean[seq, :, dim]])
            s = np.concatenate([[x0_std[seq, dim]], std[seq, :, dim]])
            g = np.concatenate([[ts[0] - (ts[1] - ts[0])], ts[:tm1]])
            ax.errorbar(g, m, yerr=2 * s, fmt=".", ms=3, lw=0.7,
                        color="tab:blue",
                        label="q(s_t) mean ± 2σ" if seq == 0 else None)
            ax.scatter(ts, data.trn.ys[seq, :, dim], c="k", s=8,
                       label="observations" if seq == 0 else None)
        ax.set_ylabel(f"state {dim + 1}")
    np.atleast_1d(axs)[0].legend(fontsize=8)
    np.atleast_1d(axs)[-1].set_xlabel("time")
    fig.tight_layout()
    finish_figure(fig, save_dir, fname)
