"""What a run hands to the program and to the reference alike, made here
and in the modules that these name, never by the program: the data (a data
set module per `data.kind`, `benchmark/datasets/`), the initial parameter
values (the parts every model shares here, the rest in its model module,
`benchmark/models/`) and the noise of every step or request. The data and
initial values come from the configuration file and its `init_seed`, the
same for every run; the noise from `--seed`.

* Initial values: the kernel's constant hyperparameters; inducing
  locations at k-means centres of the observed states (Lloyd's algorithm
  from seeded distinct points); whitened inducing means from a kernel ridge
  regression on finite-difference gradients; the rest at the model's
  stated initial scales.
* Noise: standard normals and uniforms from a `torch.Generator` on the run's
  device, in the shapes of one train step or one prediction request.
"""

from __future__ import annotations

import importlib
import math

import numpy as np
import torch


def rng(seed: int, *stream: int) -> np.random.Generator:
    """A host generator for one use of a run's seed (any whole number)."""
    return np.random.default_rng(np.random.SeedSequence([int(seed), *stream]))


def device_seed(seed: int, *stream: int) -> int:
    return int(np.random.SeedSequence([int(seed), *stream]).generate_state(1,
               np.uint64)[0] >> 1)


def invsoftplus(y: float) -> float:
    return float(y + math.log(-math.expm1(-y)))


def pack_eye(n: int, scale: float) -> np.ndarray:
    rows, cols = np.tril_indices(n)
    return (scale * np.eye(n))[rows, cols].astype(np.float32)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def load_data(config: dict) -> dict:
    """The configuration's data, by the data set module its `data.kind`
    names (`benchmark/datasets/<kind>.py`), drawn from its `init_seed`."""
    spec = config["data"]
    module = importlib.import_module(f"benchmark.datasets.{spec['kind']}")
    return module.load(spec, config["init_seed"])


# ---------------------------------------------------------------------------
# initial values
# ---------------------------------------------------------------------------

def kmeans(xs: np.ndarray, k: int, gen: np.random.Generator,
           iters: int) -> np.ndarray:
    """Lloyd's algorithm from k distinct data points; an empty cluster
    keeps its centre."""
    centres = xs[gen.choice(xs.shape[0], k, replace=False)].copy()
    for _ in range(iters):
        dist = ((xs[:, None, :] - centres[None]) ** 2).sum(-1)
        label = dist.argmin(1)
        for j in range(k):
            members = xs[label == j]
            if len(members):
                centres[j] = members.mean(0)
    return centres


def _rbf(a, b, ls, var):
    """Dimwise RBF Gram (D, len(a), len(b)) in float64."""
    scale = ls[:, None, None, :]
    diff = a[None, :, None, :] / scale - b[None, None, :, :] / scale
    return var[:, None, None] * np.exp(-0.5 * (diff ** 2).sum(-1))


def inducing_init(ys: np.ndarray, ts: np.ndarray, m: int, ls: float,
                  var: float, ridge: float, gen: np.random.Generator,
                  iters: int, max_obs: int = 1000):
    """(Z, whitened inducing mean): Z at k-means centres of the observed
    states; the mean by kernel ridge regression of the finite-difference
    gradients onto Z, whitened by the Cholesky factor of K(Z, Z) + 1e-6 I."""
    n, t, d = ys.shape
    xs = ys[:, :-1].reshape(-1, d).astype(np.float64)
    grads = (ys[:, 1:] - ys[:, :-1]).reshape(-1, d).astype(np.float64) * (
        t / float(ts.max()))
    z = kmeans(xs, m, gen, iters)
    keep = gen.choice(xs.shape[0], min(max_obs, xs.shape[0]), replace=False)
    xk, gk = xs[keep], grads[keep]
    lsv = np.full((d, d), ls)
    varv = np.full(d, var)
    kxx = _rbf(xk, xk, lsv, varv) + ridge * np.eye(len(keep))
    alpha = np.stack([np.linalg.solve(kxx[j], gk[:, j]) for j in range(d)])
    kzx = _rbf(z, xk, lsv, varv)                                   # (D, M, n)
    lzz = np.linalg.cholesky(_rbf(z, z, lsv, varv) + 1e-6 * np.eye(m))
    f_update = np.einsum("dmn,dn->dm", kzx, alpha)
    u_mean = np.stack([np.linalg.solve(lzz[j], f_update[j]) for j in range(d)], 1)
    return z.astype(np.float32), u_mean.astype(np.float32)


def gp_values(config: dict, data: dict, seed: int) -> dict:
    """The initial value of every leaf of the GP field, by the program's
    leaf name, as float32 arrays: the kernel's constant hyperparameters,
    Z and the whitened inducing mean from `inducing_init` over the train
    latents, and the inducing factor at its stated scale."""
    init, margs = config["init"], config["model_args"]
    ys, ts = data["train_latent"], data["train_ts"]
    d = ys.shape[-1]
    m = margs["num_inducing"]
    z, u_mean = inducing_init(ys, ts, m, init["lengthscale"], init["variance"],
                              init["ridge"], rng(seed, 2), init["kmeans_iters"])
    f32 = np.float32
    return {
        "gp.z": z, "gp.u_mean": u_mean,
        "gp.u_tril": np.tile(pack_eye(m, init["u_scale"]), (d, 1)),
        "gp.kernel.raw_lengthscales": np.full(
            (d, d), invsoftplus(init["lengthscale"]), f32),
        "gp.kernel.raw_variance": np.full(d, invsoftplus(init["variance"]), f32),
    }


def x0_values(data: dict, scale: float) -> tuple:
    """q(x0): its mean one interval before the first observation, by linear
    extrapolation, and its packed factor at `scale`."""
    ys = data["train_latent"]
    n, _, d = ys.shape
    mean = (2.0 * ys[:, 0] - ys[:, 1]).astype(np.float32)
    return mean, np.tile(pack_eye(d, scale), (n, 1))


# ---------------------------------------------------------------------------
# noise
# ---------------------------------------------------------------------------

def draw_noise(gen: torch.Generator, device, draws: tuple, din: int,
               features: int, d: int, m: int) -> dict:
    """The field draw's noise, with leading axes `draws`."""
    kw = dict(generator=gen, device=device)
    return {"rff_weights": torch.randn(*draws, features, d, **kw),
            "rff_freq": torch.randn(*draws, din, features, d, **kw),
            "rff_phase": torch.rand(*draws, 1, features, d, **kw),
            "inducing": torch.randn(*draws, m, d, **kw)}


def predict_noise(config: dict, draws: int, d: int, gen: torch.Generator,
                  device) -> dict:
    """Every random number of one prediction request of `draws` draws from
    given start states."""
    margs = config["model_args"]
    return draw_noise(gen, device, (draws,), d, margs["num_features"], d,
                      margs["num_inducing"])
