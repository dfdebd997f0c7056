"""MoCap diagnostics: per-latent and per-sensor prediction grids, 3-D latent
trajectories and inducing posteriors, optimization traces.

Counterpart of `gpode_tpu/plots/plots_mocap.py`: the same functions, file
names and figures. They draw NumPy predictions; the one data part is
`plots_2d.unwhiten_inducing`.
"""

from __future__ import annotations

import numpy as np

from gpode_tpu_torch.plots import pyplot
from gpode_tpu_torch.plots.plots_2d import finish_figure
from gpode_tpu_torch.plots.plots_2d import plot_trace as _plot_trace
from gpode_tpu_torch.plots.plots_2d import unwhiten_inducing


def plot_pca_predictions(actual: np.ndarray, predicted: np.ndarray,
                         ts: np.ndarray, save_dir: str, num_obs: int = 5,
                         name: str = "plt_latents"):
    """Per-PCA-dim predictive bands for the first `num_obs` sequences.
    predicted: (S, N, T, L)."""
    plt = pyplot()
    mean = predicted.mean(0)
    std = predicted.std(0)
    n = min(num_obs, actual.shape[0])
    latents = actual.shape[-1]
    fig, axs = plt.subplots(n, latents, figsize=(2.2 * latents, 1.8 * n),
                            sharex=True, squeeze=False)
    for i in range(n):
        for l in range(latents):
            ax = axs[i][l]
            ax.fill_between(ts, mean[i, :, l] - 2 * std[i, :, l],
                            mean[i, :, l] + 2 * std[i, :, l],
                            alpha=0.3, color="tab:blue")
            ax.plot(ts, mean[i, :, l], color="tab:blue", lw=0.8)
            ax.plot(ts, actual[i, :, l], "k.", ms=2)
            if i == 0:
                ax.set_title(f"PCA {l + 1}", fontsize=8)
    fig.tight_layout()
    finish_figure(fig, save_dir, f"{name}.png", dpi=110)


def plot_data_predictions(actual: np.ndarray, predicted: np.ndarray,
                          ts: np.ndarray, save_dir: str, num_obs: int = 5,
                          name: str = "plt_data", max_panels: int = 50):
    """Data-space grid: one panel per sensor channel for the first sequence.
    predicted: (S, N, T, D_full)."""
    plt = pyplot()
    mean = predicted.mean(0)
    std = predicted.std(0)
    d = min(actual.shape[-1], max_panels)
    cols = 5
    rows = int(np.ceil(d / cols))
    fig, axs = plt.subplots(rows, cols, figsize=(2.2 * cols, 1.4 * rows),
                            sharex=True, squeeze=False)
    for ch in range(rows * cols):
        ax = axs[ch // cols][ch % cols]
        if ch >= d:
            ax.axis("off")
            continue
        ax.fill_between(ts, mean[0, :, ch] - 2 * std[0, :, ch],
                        mean[0, :, ch] + 2 * std[0, :, ch],
                        alpha=0.3, color="tab:blue")
        ax.plot(ts, mean[0, :, ch], color="tab:blue", lw=0.7)
        ax.plot(ts, actual[0, :, ch], "k.", ms=1.5)
        ax.set_title(f"ch {ch}", fontsize=6)
        ax.tick_params(labelsize=5)
    fig.tight_layout()
    finish_figure(fig, save_dir, f"{name}.png", dpi=110)


def plot_latents_3d(sampled_zs: np.ndarray, ts: np.ndarray, save_dir: str,
                    num_obs: int = 10, name: str = "plt_latents_3d",
                    rng=None):
    """Time-colored 3-D latent trajectories with a colorbar: every draw's
    trajectory is a Line3DCollection whose segments are colored by
    observation time (gist_rainbow), with the sampled points as black dots.

    sampled_zs: (S, N, T, L>=3). The sequence axis is shuffled before
    truncating to `num_obs`; pass `rng` (a `RandomState`) for a
    deterministic shuffle."""
    plt = pyplot()
    from matplotlib import colors
    from mpl_toolkits.mplot3d.art3d import Line3DCollection

    ts = np.asarray(ts)
    sampled_zs = np.asarray(sampled_zs)
    num_obs = min(sampled_zs.shape[1], num_obs)
    rng = np.random if rng is None else rng
    idx = rng.permutation(sampled_zs.shape[1])
    sampled_zs = sampled_zs[:, idx]

    fig = plt.figure(figsize=(6, 5))
    ax = fig.add_subplot(111, projection="3d")
    norm = colors.Normalize(vmin=ts.min(), vmax=ts.max())
    lc = None
    for n in range(num_obs):
        for s in range(sampled_zs.shape[0]):
            points = sampled_zs[s, n, :, :3].reshape(-1, 1, 3)
            segments = np.concatenate([points[:-1], points[1:]], axis=1)
            lc = Line3DCollection(segments, cmap="gist_rainbow", alpha=0.4,
                                  norm=norm)
            lc.set_array(ts[:-1])
            lc.set_linewidth(2)
            ax.add_collection(lc)
            ax.scatter(sampled_zs[s, n, :, 0], sampled_zs[s, n, :, 1],
                       sampled_zs[s, n, :, 2], c="k", marker=".", s=20,
                       zorder=3)
    ax.set_xlabel("Comp 1")
    ax.set_ylabel("Comp 2")
    ax.set_zlabel("Comp 3")
    if lc is not None:
        fig.colorbar(lc, ax=ax, shrink=0.6, pad=0.1, label="t")
    # autoscale to the collections (add_collection alone does not)
    flat = sampled_zs[:, :num_obs, :, :3].reshape(-1, 3)
    ax.auto_scale_xyz(flat[:, 0], flat[:, 1], flat[:, 2])
    finish_figure(fig, save_dir, f"{name}.png", dpi=110)


def plot_inducing_posterior_3d(gp_params, pred_zs: np.ndarray, save_dir: str,
                               name: str = "inducing_posterior",
                               dims=(0, 1, 2)):
    """3-D mean latent trajectories and un-whitened inducing arrows on three
    latent dims."""
    plt = pyplot()
    u, z = unwhiten_inducing(gp_params)
    i, j, k = dims
    fig = plt.figure(figsize=(7, 6))
    ax = fig.add_subplot(111, projection="3d")
    mean = pred_zs.mean(0)  # (N, T, L)
    for seq in range(mean.shape[0]):
        ax.plot(mean[seq, :, i], mean[seq, :, j], mean[seq, :, k],
                lw=0.8, alpha=0.8)
    scale = 0.15
    ax.quiver(z[:, i], z[:, j], z[:, k],
              scale * u[:, i], scale * u[:, j], scale * u[:, k],
              color="tab:red", lw=0.6, alpha=0.7)
    ax.set_xlabel(f"latent {i + 1}")
    ax.set_ylabel(f"latent {j + 1}")
    ax.set_zlabel(f"latent {k + 1}")
    fig.tight_layout()
    finish_figure(fig, save_dir, f"{name}.png", dpi=110)


def plot_trace(trainer, save_dir: str,
               fname: str = "plt_optimization_trace.png"):
    _plot_trace(trainer, save_dir, fname)
