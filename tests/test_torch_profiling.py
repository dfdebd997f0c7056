"""The rest of the JAX package in the port, on the CPU: the profiling hooks
(`utils/profiling.py`) and the profiling scripts' twins (`capture_trace`,
`analyze_trace` with its roll-up of the program's spans), the state
posteriors' log densities, and the MoCap `CombinedDataset`.

Tolerances: the log densities against JAX rtol 1e-5 (atol 1e-5); the
`CombinedDataset` items equal to JAX's; a synthetic CUDA trace's groups
exact.
"""

from __future__ import annotations

import gzip
import json
import os

import numpy as np
import pytest
import torch

from gpode_tpu.data.mocap import CombinedDataset as JCombined
from gpode_tpu.data.mocap import MocapDataset as JMocap
from gpode_tpu.models import states as jstates

from gpode_tpu_torch.data.mocap import CombinedDataset, MocapDataset
from gpode_tpu_torch.models import states as tstates
from gpode_tpu_torch.scripts import analyze_trace, capture_trace
from gpode_tpu_torch.utils import profiling

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA_DIR = os.path.join(REPO, "data", "mocap")


def _posterior(n=3, t1=4, d=3, seed=0):
    """A JAX shooting posterior with non-trivial factors, and the port's
    with the same arrays."""
    rng = np.random.default_rng(seed)
    packed = d * (d + 1) // 2
    x0_mean = rng.normal(size=(n, d)).astype(np.float32)
    x0_tril = (0.3 * rng.normal(size=(n, packed))).astype(np.float32)
    mean = rng.normal(size=(n, t1, d)).astype(np.float32)
    tril = (0.3 * rng.normal(size=(n, t1, packed))).astype(np.float32)
    diag = np.cumsum(np.arange(1, d + 1)) - 1   # the packed diagonal
    x0_tril[:, diag] += 1.0
    tril[:, :, diag] += 1.0
    jp = jstates.ShootingStatePosterior(
        jstates.InitialStatePosterior(x0_mean, x0_tril), mean, tril)
    tp = tstates.ShootingStatePosterior(
        tstates.InitialStatePosterior(torch.tensor(x0_mean),
                                      torch.tensor(x0_tril)),
        torch.tensor(mean), torch.tensor(tril))
    return jp, tp, rng


@pytest.mark.parametrize("batch", [(), (2,)], ids=["unbatched", "batched"])
def test_state_log_probs_match_jax(batch):
    jp, tp, rng = _posterior()
    n, t1, d = jp.mean.shape
    x0 = rng.normal(size=batch + (n, d)).astype(np.float32)
    xs = rng.normal(size=batch + (n, t1, d)).astype(np.float32)
    with torch.no_grad():
        got0 = tstates.initial_state_log_prob(tp.x0, torch.tensor(x0))
        got = tstates.shooting_log_prob(tp, torch.tensor(xs))
    # the JAX functions take one (N, ...) point set per call
    want0 = np.asarray([jstates.initial_state_log_prob(jp.x0, x)
                        for x in x0.reshape((-1, n, d))]).reshape(batch + (n,))
    want = np.asarray([jstates.shooting_log_prob(jp, x)
                       for x in xs.reshape((-1, n, t1, d))]
                      ).reshape(batch + (n, t1))
    assert got0.shape == want0.shape == batch + (n,)
    assert got.shape == want.shape == batch + (n, t1)
    np.testing.assert_allclose(got0.numpy(), want0, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_combined_dataset_items_match_jax():
    kw = dict(data_path=DATA_DIR, subject="09", data_normalize=False,
              seqlen=20)
    ours = CombinedDataset(MocapDataset(pca_components=5, pca_normalize=True,
                                        **kw),
                           MocapDataset(pca_components=-1,
                                        pca_normalize=False, **kw))
    theirs = JCombined(JMocap(pca_components=5, pca_normalize=True, **kw),
                       JMocap(pca_components=-1, pca_normalize=False, **kw))
    assert len(ours) == len(theirs) == 6
    for i in (0, 5):
        for got, want in zip(ours[i], theirs[i]):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_nan_debugging_switches_anomaly_mode():
    try:
        profiling.enable_nan_debugging(True)
        assert torch.is_anomaly_enabled()
        x = torch.tensor([-1.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x).sum().backward()
    finally:
        profiling.enable_nan_debugging(False)
    assert not torch.is_anomaly_enabled()


def test_trace_writes_a_trace_that_analyze_trace_reads(tmp_path, capsys):
    """On the CPU the trace holds the CPU operators only: the default
    (CUDA stream) filter finds no track, a thread filter reads them."""
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path)) as prof:
        (x @ x).sum()
    assert prof.trace_path.endswith(".trace.json.gz")
    assert analyze_trace.main([str(tmp_path)]) == 1
    out = analyze_trace.report(str(tmp_path), track_filter="thread")
    assert out["path"] == prof.trace_path
    assert out["per_op"]["aten::mm"][1] == 1
    assert out["total_us"] > 0
    assert "aten::mm" in capsys.readouterr().out


def _synthetic_cuda_trace(path):
    """A Kineto-shaped trace: a CPU thread and two CUDA streams."""
    meta = [
        {"ph": "M", "name": "process_name", "pid": 7, "args": {"name": "python3"}},
        {"ph": "M", "name": "thread_name", "pid": 7, "tid": 7,
         "args": {"name": "thread 7 (python3)"}},
        {"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "GPU 0"}},
        {"ph": "M", "name": "thread_name", "pid": 0, "tid": 7,
         "args": {"name": "stream 7 "}},
        {"ph": "M", "name": "thread_name", "pid": 0, "tid": 13,
         "args": {"name": "stream 13 "}}]

    def ev(name, dur, cat="kernel", pid=0, tid=7, ts=0):
        return {"ph": "X", "name": name, "dur": dur, "cat": cat, "pid": pid,
                "tid": tid, "ts": ts}

    def span(name, ts, dur, tid=7):
        return ev(name, dur, cat="user_annotation", pid=7, tid=tid, ts=ts)

    events = meta + [
        ev("void dp_attempt_fwd_kernel<5, 2, 128>(float const*)", 10.0),
        ev("void dp_attempt_bwd_kernel<5, 2, 128>(float const*)", 20.0),
        ev("void rk4_fwd_kernel<5>(float const*)", 4.0),
        ev("void rhs_bwd_kernel<5>(float const*)", 3.0),
        ev("void wide_fwd_kernel<8>(float const*)", 2.0),
        ev("void sum_slabs_kernel(float const*, float*, int)", 1.0),
        ev("void rbf_gram_kernel<5>(float const*)", 1.5),
        ev("sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize", 6.0),
        ev("void trsm_left_kernel<float, 256, 32>(int)", 5.0),
        ev("potrf_alg2_kernel", 2.0),
        ev("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevComm*)", 8.0,
           tid=13),
        ev("Memcpy DtoH (Device -> Pinned)", 0.5, cat="gpu_memcpy"),
        ev("Memset (Device)", 0.25, cat="gpu_memset"),
        ev("void at::native::vectorized_elementwise_kernel<4>(int)", 3.0),
        ev("gpode.segment_solve", 40.0, cat="gpu_user_annotation"),
        ev("aten::mm", 100.0, cat="cpu_op", pid=7, tid=7),
        # two steps on thread 7 (the second's replay holds a copy_in, as
        # no step does: nesting alone decides), a backward on thread 9
        span("gpode.step", 1000.0, 100.0),
        span("gpode.step.replay", 1010.0, 30.0),
        span("gpode.step", 1200.0, 100.0),
        span("gpode.step.replay", 1210.0, 50.0),
        span("gpode.step.copy_in", 1220.0, 5.0),
        span("gpode.backward", 1215.0, 60.0, tid=9),
        ev("gpode.step", 100.0, cat="gpu_user_annotation", ts=1000.0)]
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events}, f)


def test_analyze_trace_groups_a_cuda_trace(tmp_path):
    path = str(tmp_path / "synthetic.trace.json.gz")
    _synthetic_cuda_trace(path)
    out = analyze_trace.report(path, top=3, steps=2)
    assert out["tracks"] == ["GPU 0/stream 13 ", "GPU 0/stream 7 "]
    assert out["groups"] == {
        "port kernels: fused_dopri5.cu": 30.0,
        "port kernels: fused_rk4.cu": 4.0,
        "port kernels: fused_rhs.cu": 3.0,
        "port kernels: fused_rhs_wide.cu": 2.0,
        "port kernels: rhs_tile.cuh": 1.0,
        "port kernels: rbf_gram.cu": 1.5,
        "cuBLAS/cuSOLVER": 13.0,
        "collectives": 8.0,
        "memcpy/memset": 0.75,
        "other kernels": 3.0}
    assert out["total_us"] == sum(out["groups"].values())


def test_capture_trace_twin_on_the_cpu(tmp_path):
    """The entry points' step (`make_step`: eager on the CPU), one step of
    the `fast` preset after the warm-up, read back by `analyze_trace`
    with the eager step's phases among its spans."""
    out = str(tmp_path / "trace")
    assert capture_trace.main(["--device", "cpu", "--steps", "1",
                               "--preset", "fast", "--kernels", "auto",
                               "--out", out]) == 0
    summary = analyze_trace.report(out, track_filter="thread")
    assert any("cholesky" in name for name in summary["per_op"])
    assert {name: n for name, (n, _, _) in summary["spans"].items()} == {
        name: 1 for name in ("gpode.states", "gpode.draw",
                             "gpode.segment_solve", "gpode.elbo",
                             "gpode.backward", "gpode.adam")}


def test_analyze_trace_rolls_up_the_spans(tmp_path, capsys):
    """Count, total and self time (less the spans directly inside, on the
    same thread) of every `gpode.*` host range; device-track annotations
    and other threads' ranges are not children."""
    path = str(tmp_path / "synthetic.trace.json.gz")
    _synthetic_cuda_trace(path)
    out = analyze_trace.report(path, steps=2)
    assert out["spans"] == {
        "gpode.step": (2, 200.0, 200.0 - 30.0 - 50.0),
        "gpode.step.replay": (2, 30.0 + 50.0, 80.0 - 5.0),
        "gpode.step.copy_in": (1, 5.0, 5.0),
        "gpode.backward": (1, 60.0, 60.0)}
    assert "== program spans" in capsys.readouterr().out


def test_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        capture_trace.main(["--out", str(tmp_path)])
