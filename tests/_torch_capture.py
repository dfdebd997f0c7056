"""The batched solve's capture decision (`models/flow._capture_route`) on
the CPU: `rehearse_captures` lets it take a CPU state as a card's, so that
a CPU test runs the captured attempt's control flow (its eager stand-in,
`CapturedAttempt.rehearse`) where the program's own decision captures."""

import torch

from gpode_tpu_torch.models import flow

_ROUTE = flow._capture_route


class OnCard:
    """A state's shape and dtype, on the card."""

    is_cuda = True

    def __init__(self, x):
        self.shape, self.dtype = x.shape, x.dtype


def rehearse_captures(monkeypatch, on: bool = True):
    """Decide the batched solve's attempt as on a card, outside any capture
    (`on`), or as on the CPU (never captured)."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(flow, "_capture_route", (
        lambda cfg, g, d, x0: _ROUTE(cfg, g, d, OnCard(x0))) if on else _ROUTE)
