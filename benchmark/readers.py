"""Readings shared by several per-layer metric files (each metric is a file
of its own under `metrics/`, which picks its reading from here)."""

from __future__ import annotations

import re

from benchmark import opcounts

SEGMENT_KERNELS = re.compile(r"\bdp_attempt_(fwd|bwd)_kernel|\bsum_slabs_kernel")
ATTEMPT_FWD = re.compile(r"\bdp_attempt_fwd_kernel")
ATTEMPT_BWD = re.compile(r"\bdp_attempt_bwd_kernel")


def device_events_per_unit(ctx):
    """Kernels, copies and sets on the device per traced unit."""
    if ctx.trace is None:
        return None
    return len(ctx.trace.device) / ctx.trace.units


def device_idle_pct(ctx):
    """100 * (1 - the device's busy share of the traced window)."""
    if ctx.trace is None:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def host_syncs_per_unit(ctx):
    return ctx.syncs_per_unit


def attempt_roofline_pct(ctx):
    """The dopri5 attempt launches' least time on the card (the larger of
    their operations over the float32 peak and their bytes over the HBM
    peak, per launch at the step's segment rows) over their device time,
    the backward's reduction pass included."""
    if ctx.trace is None:
        return None
    seconds, _ = ctx.trace.device_time_s(SEGMENT_KERNELS)
    if seconds <= 0.0:
        return None
    _, n_fwd = ctx.trace.device_time_s(ATTEMPT_FWD)
    _, n_bwd = ctx.trace.device_time_s(ATTEMPT_BWD)
    margs = ctx.config["model_args"]
    n_seq, t, d = ctx.shapes["ys"]
    dims = (margs["num_samples"] * n_seq * t, d, d, margs["num_inducing"],
            margs["num_features"])
    least = (n_fwd * opcounts.bound_s(*opcounts.dp_attempt_fwd(*dims))[0]
             + n_bwd * opcounts.bound_s(*opcounts.dp_attempt_bwd(*dims))[0])
    return 100.0 * least / seconds


def step_mfu_pct(ctx):
    """Model operations per step (`opcounts.<model>_step_ops`) over the
    untraced window's wall seconds per step, as a share of the float32
    peak; nothing for a model whose step has no frozen count."""
    count = getattr(opcounts, f"{ctx.config['model']}_step_ops", None)
    if not ctx.on_device or ctx.nfe_per_unit is None or count is None:
        return None
    ops = count(ctx.config, ctx.shapes, ctx.nfe_per_unit)
    return 100.0 * ops / (ctx.wall_s_per_unit * opcounts.PEAK_F32_FLOPS)
