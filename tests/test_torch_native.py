"""The port's native host library (`gpode_tpu_torch/utils/native.py`) against
the JAX package's (`gpode_tpu/utils/native.py`), on the CPU: k-means centres,
the `n < k` refusal, the built-in and callback integrators, and the callers
that take the library's branch where it loads (the inducing init, the VDP
and FHN simulators) on both branches.

The port builds `native/host_lib.cpp` with the flags of `native/Makefile`
into `gpode_tpu_torch/_build/`; the JAX package builds the same source with
`make` into `native/`. On one host the two libraries compute the same bits,
so k-means centres and integrated trajectories are held equal; the ridge
init after the k-means, computed by each package's float32 linear algebra,
rtol 1e-4 with atol 1e-4 * max|ref| (the whitening solve with
chol(K(Z,Z) + 1e-6 I) at the centres amplifies float32 rounding, as in
tests/test_torch_eval.py); the data rtol 1e-6.

`load_jax_native` and `same_branch` are the helpers the port's other test
files import to put both packages on one branch.
"""

import fcntl
import os
import subprocess
import time

import jax
import numpy as np
import pytest
import torch

from gpode_tpu.data.fhn import FHN as JFHN
from gpode_tpu.data.mocap import MocapDataset as JMocapDataset
from gpode_tpu.data.vanderpol import VanderPol as JVanderPol
from gpode_tpu.data.vanderpol import VanderPolNonUniform as JVanderPolNonUniform
from gpode_tpu.models import init as jinit
from gpode_tpu.train import builders as jb
from gpode_tpu.utils import native as jnative

from gpode_tpu_torch.convert import gpode_params_from_numpy
from gpode_tpu_torch.data.fhn import FHN
from gpode_tpu_torch.data.vanderpol import VanderPol, VanderPolNonUniform
from gpode_tpu_torch.models import init as tinit
from gpode_tpu_torch.utils import native as tnative

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA_DIR = os.path.join(REPO, "data", "mocap")


def load_jax_native():
    """Load the JAX package's native host library in this process, whatever
    another process did to it.

    `gpode_tpu.utils.native` builds the library with an unlocked `make` the
    first time a process asks, and a process whose load failed (say, on a
    file another worker was still writing) keeps `native._load_failed` for
    good and takes scipy's branches. Here the flags are reset and the load
    retried under an exclusive lock on a file beside the library; the
    library is built into a temporary file and renamed into place when it
    is missing, or when it still fails to load after two retries."""
    lock_path = os.path.join(jnative._NATIVE_DIR, "libgpode_host.lock")
    with open(lock_path, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        for attempt in range(6):
            if attempt > 0:
                time.sleep(1.0)  # an unlocked build may still be writing it
            if not os.path.exists(jnative._LIB_PATH) or attempt >= 3:
                tmp = f"libgpode_host.{os.getpid()}.tmp"
                subprocess.run(["make", "-C", jnative._NATIVE_DIR,
                                f"TARGET={tmp}"],
                               check=True, capture_output=True, timeout=300)
                os.replace(os.path.join(jnative._NATIVE_DIR, tmp),
                           jnative._LIB_PATH)
            jnative._lib, jnative._load_failed = None, False
            if jnative._load() is not None:
                return
    raise AssertionError(f"cannot load {jnative._LIB_PATH}")


def same_branch(mp: pytest.MonkeyPatch, native: bool):
    """Put both packages on one branch for the rest of `mp`'s context: the
    native library (loaded in both, race-free) or scipy (both libraries
    reported unavailable, as in a process whose load failed)."""
    if native:
        load_jax_native()
        assert jnative.available() and tnative.available()
    else:
        mp.setattr(jnative, "available", lambda: False)
        mp.setattr(tnative, "available", lambda: False)


@pytest.fixture(scope="module")
def mocap_states():
    """MoCap-09's 594 latent states (6 x 99, 5 PCA latents), as the inducing
    init clusters them."""
    ys = JMocapDataset(data_path=DATA_DIR, subject="09", pca_components=5,
                       data_normalize=False, pca_normalize=True,
                       seqlen=100).trn.ys
    return ys


def test_the_library_builds_into_the_ports_build_directory():
    info = tnative.info()
    assert info["branch"] == "native"
    path = info["path"]
    assert os.path.dirname(path) == str(tnative.BUILD_DIR)
    assert os.path.basename(path).startswith("libgpode_host-")
    assert tnative.CXX_FLAGS == ("-O3", "-march=native", "-fPIC",
                                 "-std=c++17", "-Wall", "-shared")
    with open(os.path.join(REPO, "native", "Makefile")) as f:
        makefile = f.read()
    assert "CXXFLAGS ?= " + " ".join(tnative.CXX_FLAGS[:-1]) in makefile


@pytest.mark.parametrize("case", ["mocap09_seed121", "mocap09_seed122",
                                  "random"])
def test_kmeans_centres_equal_the_jax_librarys(case, mocap_states):
    load_jax_native()
    if case == "random":
        data = np.random.default_rng(4).normal(size=(57, 3)).astype(np.float32)
        k, seed = 7, 11
    else:
        seed_rng = np.random.RandomState(int(case[-3:]))
        data = mocap_states[:, :-1].reshape(-1, 5)
        assert data.shape == (594, 5)
        k, seed = 100, int(seed_rng.randint(2 ** 31))
    got = tnative.kmeans(data, k, seed=seed)
    want = jnative.kmeans(data, k, seed=seed)
    assert got.dtype == want.dtype == np.float32 and got.shape == (k, data.shape[1])
    np.testing.assert_array_equal(got, want)


def test_kmeans_refuses_fewer_points_than_centres():
    with pytest.raises(ValueError, match="need n >= k"):
        tnative.kmeans(np.zeros((3, 2), np.float32), 4)


@pytest.mark.parametrize("system,x0,params", [
    ("vdp", [-1.5, 2.5], (0.5,)), ("fhn", [-1.0, -1.0], ())])
def test_integrate_equals_the_jax_librarys(system, x0, params):
    load_jax_native()
    ts = np.linspace(0.0, 7.0, 26)
    got = tnative.integrate(system, np.array(x0), ts, params)
    want = jnative.integrate(system, np.array(x0), ts, params)
    assert got.dtype == np.float64 and got.shape == (26, 2)
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_integrate_callback_equals_the_jax_librarys():
    load_jax_native()

    def f(t, y):
        return [y[1], -y[0] - 0.1 * y[1] + 0.2 * np.sin(t)]

    ts = np.linspace(0.0, 5.0, 11)
    got = tnative.integrate_callback(f, np.array([1.0, 0.0]), ts)
    want = jnative.integrate_callback(f, np.array([1.0, 0.0]), ts)
    assert got.shape == (11, 2)
    np.testing.assert_allclose(got, want, rtol=1e-10)


def _flat(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(k.name for k in path): np.asarray(leaf)
            for path, leaf in leaves}


@pytest.mark.parametrize("native", [True, False], ids=["native", "scipy"])
def test_initialize_inducing_equals_jax_on_the_same_branch(native,
                                                           mocap_states):
    """MoCap-09 at M=100, as the time-to-LL init calls it: both packages
    from `RandomState(121)` on one branch give the same centres and the
    same ridge-initialised inducing posterior."""
    args = jb.ModelArgs(num_inducing=100, num_features=16)
    jparams = jb.build_gpode(jax.random.PRNGKey(0), args, mocap_states)
    jgp = jinit.initialize_kernel_parameters(jparams.gp, 1.25, 0.5)
    tparams = gpode_params_from_numpy(_flat(jparams._replace(gp=jgp)),
                                      device="cpu")
    ts_max = 0.99
    with pytest.MonkeyPatch.context() as mp:
        same_branch(mp, native)
        want = jinit.initialize_inducing(jgp, mocap_states, ts_max, 1e0,
                                         rng=np.random.RandomState(121))
        tinit.initialize_inducing(tparams.gp, mocap_states, ts_max, 1e0,
                                  rng=np.random.RandomState(121))
    np.testing.assert_array_equal(tparams.gp.z.detach().numpy(),
                                  np.asarray(want.z))
    u, u_want = tparams.gp.u_mean.detach().numpy(), np.asarray(want.u_mean)
    np.testing.assert_allclose(u, u_want, rtol=1e-4,
                               atol=1e-4 * np.abs(u_want).max())


@pytest.mark.parametrize("native", [True, False], ids=["native", "scipy"])
@pytest.mark.parametrize("kind", ["vdp", "vdp_nonuniform", "fhn"])
def test_simulated_data_equals_jax_on_the_same_branch(kind, native):
    builds = {"vdp": (VanderPol, JVanderPol,
                      dict(s_train=25, t_train=7.0, s_test=50, t_test=14.0,
                           noise_var=0.05)),
              "vdp_nonuniform": (VanderPolNonUniform, JVanderPolNonUniform,
                                 dict(s_train=25, t_train=7.0, s_test=25,
                                      t_test=14.0, noise_var=0.05)),
              "fhn": (FHN, JFHN, dict(s_train=30, t_train=6.0,
                                      noise_var=0.025))}
    port, ref, kw = builds[kind]
    with pytest.MonkeyPatch.context() as mp:
        same_branch(mp, native)
        got, want = port(**kw), ref(**kw)
    for name in ("trn", "tst"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.ys.dtype == np.float32 and a.ys.shape == b.ys.shape
        np.testing.assert_allclose(a.ys, b.ys, rtol=1e-6, err_msg=name)
        np.testing.assert_allclose(a.ts, b.ts, rtol=1e-6, err_msg=name)
