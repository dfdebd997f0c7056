"""The dopri5 attempt kernels' roofline share: their least time on the card
over their device time."""

from benchmark.readers import attempt_roofline_pct as read  # noqa: F401
