"""What the port's two kinds of captured CUDA graph share, the train
step's (`train/graph_step.CapturedStep`) and the prediction solve's attempt
(`models/flow.CapturedAttempt`): `WARMUP` eager calls, then the capture, on
one side stream per card; and the launch count under capture
(`cuda_kernels.LAUNCHES` counts wrapper calls and a replay makes none, so a
capture's counted calls are taken back out and each replay adds them).
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable

import torch

from gpode_tpu_torch.ops.cuda_kernels import LAUNCHES

# eager calls on the capture stream before a capture (they build the
# kernels and set up the libraries' per-stream state)
WARMUP = 2


@functools.lru_cache(maxsize=None)
def capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The card's one capture stream: the libraries keep per-stream state
    for the life of the process (cuBLAS a workspace of tens of MiB per
    stream), so a stream per graph would grow with every graph built."""
    return torch.cuda.Stream(device)


@contextlib.contextmanager
def on_capture_stream(device: torch.device):
    """Run the block on the card's capture stream, after the work queued on
    the current stream and before the work queued there later; yields the
    stream."""
    stream = capture_stream(device)
    current = torch.cuda.current_stream(device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        yield stream
    current.wait_stream(stream)


def launch_counter() -> Callable[[], dict]:
    """Start counting a capture's launches. Returns `take`: the launches
    counted since the start, by wrapper, taken back out of `LAUNCHES` (a
    capture launches nothing), so that each call counts from the same start
    (one call per graph of a split capture)."""
    before = dict(LAUNCHES)

    def take() -> dict:
        delta = {k: LAUNCHES[k] - n for k, n in before.items()
                 if LAUNCHES[k] != n}
        for name, n in delta.items():
            LAUNCHES[name] -= n
        return delta

    return take


def replay_launches(delta: dict):
    """Count a replay's launches: a graph's `take`."""
    for name, n in delta.items():
        LAUNCHES[name] += n
