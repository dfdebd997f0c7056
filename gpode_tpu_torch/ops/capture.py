"""What the port's two kinds of captured CUDA graph share, the train
step's (`train/graph_step.CapturedStep`) and the prediction solve's attempt
(`models/flow.CapturedAttempt`): `WARMUP` eager calls, then the capture, on
one side stream per card; and the counts under capture
(`cuda_kernels.LAUNCHES` counts wrapper calls, `DRAW_SOLVES` posterior
draws and `STATE_ENTROPIES` entropy calls, and a replay makes none, so a
capture's counted calls are taken back out and each replay adds them).
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable

import torch

from gpode_tpu_torch.ops.cuda_kernels import (DRAW_SOLVES, LAUNCHES,
                                             STATE_ENTROPIES)

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


# The counters a capture's calls add to and a replay does not, with disjoint
# keys: the kernel launches by wrapper, the draws by solve route, the state
# entropies by route.
_COUNTERS = (LAUNCHES, DRAW_SOLVES, STATE_ENTROPIES)


def launch_counter() -> Callable[[], dict]:
    """Start counting a capture's launches. Returns `take`: the launches
    counted since the start, by wrapper (and the draws and the state
    entropies, by route), taken back out of their counters (a capture
    launches nothing), so that each call counts from the same start (one
    call per graph of a split capture)."""
    before = [dict(counter) for counter in _COUNTERS]

    def take() -> dict:
        delta = {}
        for counter, start in zip(_COUNTERS, before):
            for k, n in start.items():
                if counter[k] != n:
                    delta[k] = counter[k] - n
                    counter[k] = n
        return delta

    return take


def replay_launches(delta: dict):
    """Count a replay's launches: a graph's `take`, each key in the counter
    that holds it."""
    for k, n in delta.items():
        for counter in _COUNTERS:
            if k in counter:
                counter[k] += n
                break
