"""The share of the adaptive solves' dense output that the device formed:
100 x the points an attempt committed on the device over all points, on the
program's counter (`gpode_tpu_torch/ops/ode.py` `DENSE_POINTS`: "device",
the points of the captured attempt's commit kernel; "host", those of
`_hermite`). None off the card, where the program keeps no such counter (a
commit before the device commit) or formed no point."""

from __future__ import annotations


def read(ctx):
    if not ctx.on_device:
        return None
    from gpode_tpu_torch.ops import ode
    points = getattr(ode, "DENSE_POINTS", None)
    if not points:
        return None
    total = points["device"] + points["host"]
    if total == 0:
        return None
    return 100.0 * points["device"] / total
