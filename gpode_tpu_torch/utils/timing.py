"""Device-time measurement with CUDA events."""

from __future__ import annotations

import torch

# above any card's clock, so this many cycles last at least a second
_CYCLES_PER_SECOND = 2e9
_MAX_SPIN_SECONDS = 2.0


def device_ms(enqueue, count: int, host_seconds: float) -> float:
    """Device milliseconds per evaluation of the work `enqueue(count)` puts
    on the current stream (`count` evaluations), free of the host's launch
    overhead.

    The work is queued behind a spin kernel that lasts a multiple of
    `host_seconds * count` (`host_seconds`: an estimate of how long the host
    takes to enqueue one evaluation), between two events: when the spin
    ends the card finds everything queued and runs it back to back. If the
    spin ended before the host was done — the estimate was short, or CUDA's
    launch queue filled up and stalled the host — the first event
    has already fired; the measurement is then repeated with half the
    evaluations and twice the spin per evaluation, down to one evaluation.
    A reading is returned only from an attempt that was queued in time: when
    even one evaluation cannot be queued behind a spin of `_MAX_SPIN_SECONDS`
    the function raises.
    """
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    factor = 2.0
    while True:
        torch.cuda.synchronize()
        spin = min(factor * host_seconds * count + 5e-4, _MAX_SPIN_SECONDS)
        torch.cuda._sleep(int(spin * _CYCLES_PER_SECOND))
        start.record()
        enqueue(count)
        queued_in_time = not start.query()
        end.record()
        end.synchronize()
        if queued_in_time:
            return start.elapsed_time(end) / count
        if count == 1 and spin >= _MAX_SPIN_SECONDS:
            raise RuntimeError(
                f"device_ms: one evaluation was not queued within a "
                f"{_MAX_SPIN_SECONDS:g} s spin, so its device time cannot be "
                f"read apart from the host's")
        count, factor = max(1, count // 2), 2.0 * factor
