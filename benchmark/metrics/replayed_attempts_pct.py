"""The share of the untraced adaptive dopri5 attempts that replayed a
captured graph: 100 x `gpode.solve.replay` calls over `gpode.solve.attempt`
calls on the program's untraced host clock. None off the card, and where
the program keeps no replay clock (a commit before the captured attempt) or
made no attempt."""

from __future__ import annotations

from benchmark.spans import ATTEMPT, untraced

REPLAY = "gpode.solve.replay"


def read(ctx):
    attempts = untraced(ctx, ATTEMPT)
    if attempts is None:
        return None
    from gpode_tpu_torch.utils import profiling
    replays = profiling.UNTRACED.get(REPLAY)
    if replays is None:
        return None
    return 100.0 * replays[0] / attempts[0]
