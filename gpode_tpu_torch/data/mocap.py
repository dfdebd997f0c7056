"""CMU MoCap dataset: 50-D sensor sequences with a host-side PCA pipeline.

Counterpart of `gpode_tpu/data/mocap.py`, numpy only: zeroed sensor columns
clamped, optional data normalization, PCA to `pca_components` latents fit on
the train split (with sklearn's sign convention), optional PCA-space
normalization, and the latent-to-data projector's arrays.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np

from gpode_tpu_torch.data.common import Split

_ZEROED_SENSORS = (24, 25, 31, 32)  # always-zero columns


class Normalize:
    """Standardization with stored moments."""

    def __init__(self, mean: np.ndarray, std: np.ndarray):
        self.mean = mean
        self.std = std

    def __call__(self, x):
        return (x - self.mean) / self.std


class PCA:
    """Minimal PCA via SVD; `transform(x) = (x - mean) @ components.T`."""

    def __init__(self, n_components: int):
        self.n_components = n_components
        self.mean_: Optional[np.ndarray] = None
        self.components_: Optional[np.ndarray] = None

    def fit_transform(self, x: np.ndarray) -> np.ndarray:
        self.mean_ = x.mean(axis=0)
        xc = x - self.mean_
        _, _, vt = np.linalg.svd(xc, full_matrices=False)
        # sklearn's svd_flip(u_based_decision=False): the largest-|value|
        # entry of each row of Vt decides its sign.
        max_idx = np.argmax(np.abs(vt), axis=1)
        signs = np.sign(vt[np.arange(vt.shape[0]), max_idx])
        vt = vt * signs[:, None]
        self.components_ = vt[: self.n_components]
        return xc @ self.components_.T

    def transform(self, x: np.ndarray) -> np.ndarray:
        return (x - self.mean_) @ self.components_.T


class MocapDataset:
    """MoCap splits in data space (pca_components=-1) or PCA latent space."""

    def __init__(self, data_path: str = "data/mocap", subject: str = "09",
                 dt: float = 0.01, pca_components: int = -1, seqlen: int = 50,
                 data_normalize: bool = False, pca_normalize: bool = True):
        if subject not in ("09", "35", "39"):
            raise ValueError("Wrong subject passed")
        with np.load(os.path.join(data_path, f"mocap{subject}.npz")) as d:
            xs_train = np.array(d["train"])
            xs_valid = np.array(d["validation"])
            xs_test = np.array(d["test"])

        ts_train = dt * np.arange(xs_train.shape[1])
        ts_valid = dt * np.arange(xs_valid.shape[1])
        ts_test = dt * np.arange(xs_test.shape[1])

        for xs in (xs_train, xs_valid, xs_test):
            xs[:, :, _ZEROED_SENSORS] = 1e-6

        if data_normalize:
            mean = xs_train.mean((0, 1), keepdims=True)
            std = xs_train.std((0, 1), keepdims=True) + 1e-5
            self.data_normalize = Normalize(mean, std)
            xs_train, xs_valid, xs_test = map(self.data_normalize,
                                              (xs_train, xs_valid, xs_test))
        else:
            self.data_normalize = None

        self.pca: Optional[PCA] = None
        if pca_components > 0:
            self.pca = PCA(pca_components)
            xs_train = self._apply_pca(xs_train, train=True)
            xs_valid = self._apply_pca(xs_valid, train=False)
            xs_test = self._apply_pca(xs_test, train=False)

        if pca_normalize:
            pca_m = xs_train.mean((0, 1), keepdims=True)
            pca_s = xs_train.std((0, 1), keepdims=True) + 1e-5
            self.pca_normalize = Normalize(pca_m, pca_s)
            xs_train, xs_valid, xs_test = map(self.pca_normalize,
                                              (xs_train, xs_valid, xs_test))
        else:
            self.pca_normalize = None

        self.trn = Split(ys=xs_train[:, :seqlen], ts=ts_train[:seqlen])
        self.val = Split(ys=xs_valid, ts=ts_valid)
        self.tst = Split(ys=xs_test, ts=ts_test)

    def _apply_pca(self, x: np.ndarray, train: bool) -> np.ndarray:
        n, t, _ = x.shape
        flat = x.reshape(n * t, -1)
        out = self.pca.fit_transform(flat) if train else self.pca.transform(flat)
        return out.reshape(n, t, -1)


class ProjectorArrays(NamedTuple):
    """The latent->data projector's constants: components (L, D_full),
    norm_mean / norm_std (1, 1, L) or None."""

    components: np.ndarray
    norm_mean: Optional[np.ndarray]
    norm_std: Optional[np.ndarray]


def latent_to_data_projector(dataset: MocapDataset) -> ProjectorArrays:
    """The projector's arrays from a PCA-space dataset."""
    if dataset.pca is None:
        raise ValueError("projector requires a PCA-space dataset (pca_components > 0)")
    if dataset.pca_normalize is not None:
        norm_mean = np.asarray(dataset.pca_normalize.mean, dtype=np.float32)
        norm_std = np.asarray(dataset.pca_normalize.std, dtype=np.float32)
    else:
        norm_mean = norm_std = None
    return ProjectorArrays(
        components=np.asarray(dataset.pca.components_, dtype=np.float32),
        norm_mean=norm_mean, norm_std=norm_std)
