"""A CMU MoCap subject (a copy of its sequences in `benchmark/data/`): the
always-zero sensor columns clamped, PCA to the configured latents fitted on
the train split (the sign of each component fixed by its largest entry),
the latents normalised by the train split's moments, and the projector's
arrays that map latents back to the data space."""

from __future__ import annotations

import os

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(spec: dict, seed: int) -> dict:
    """Train, validation and test splits in latent and data space, their
    time grids, and the projector's arrays (`seed` is not used)."""
    with np.load(os.path.join(HERE, spec["file"])) as f:
        splits = {k: np.array(f[k], dtype=np.float64)
                  for k in ("train", "validation", "test")}
    for xs in splits.values():
        xs[:, :, spec["zeroed_sensors"]] = 1e-6
    flat = splits["train"].reshape(-1, splits["train"].shape[-1])
    mean = flat.mean(0)
    _, _, vt = np.linalg.svd(flat - mean, full_matrices=False)
    signs = np.sign(vt[np.arange(vt.shape[0]), np.argmax(np.abs(vt), 1)])
    comps = (vt * signs[:, None])[: spec["pca_components"]]
    lat = {k: (v - mean) @ comps.T for k, v in splits.items()}
    lmean = lat["train"].mean((0, 1), keepdims=True)
    lstd = lat["train"].std((0, 1), keepdims=True) + 1e-5
    lat = {k: (v - lmean) / lstd for k, v in lat.items()}
    t = spec["seqlen"]
    f32 = np.float32
    out = {"train_latent": lat["train"][:, :t].astype(f32),
           "train_full": splits["train"][:, :t].astype(f32),
           "train_ts": (spec["dt"] * np.arange(t)).astype(f32),
           "projector": {"components": comps.astype(f32),
                         "norm_mean": lmean.astype(f32),
                         "norm_std": lstd.astype(f32)}}
    for split in ("validation", "test"):
        out[f"{split}_latent"] = lat[split].astype(f32)
        out[f"{split}_full"] = splits[split].astype(f32)
        out[f"{split}_ts"] = (spec["dt"] * np.arange(splits[split].shape[1])
                              ).astype(f32)
    return out
