"""Collective audit: no collective inside a segment solve. Counterpart of
`gpode_tpu/parallel/hlo_audit.py`.

The JAX module parses the partitioned HLO of a sharded step and walks every
`while` loop for collective instructions. The port's steps are eager
PyTorch, so the audit reads a profiler trace instead: it runs steps under
`torch.profiler`, where each rank's segment solve sits inside the range
`shooting.SOLVE_RANGE`, lists the collectives the process group ran (the
`c10d::` operators: all-reduce, all-gather, broadcast, ...) and fails if one
lies inside a solve range of its thread, or if a step ran another number of
collectives than its design states (`parallel.train.COLLECTIVES_PER_STEP`).
"""

from __future__ import annotations

import re
from typing import Callable

from torch.profiler import ProfilerActivity, profile

from gpode_tpu_torch.models.shooting import SOLVE_RANGE

_COLLECTIVE_RE = re.compile(
    r"^c10d::(allreduce|allgather|all_gather|broadcast|reduce_scatter|"
    r"_reduce_scatter|alltoall|gather|scatter|reduce|barrier)")


def audit(run: Callable[[], object], steps: int = 1) -> dict:
    """Profile `steps` calls of `run` (one train step each) and report:
    {"solves": the solve ranges seen, "collectives": names of every
    collective, "inside": "<collective> in <range>" for each one inside a
    solve range, "per_step": collectives / steps}."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(steps):
            run()
    events = prof.events()
    solves = [(e.thread, e.time_range.start, e.time_range.end)
              for e in events if e.name == SOLVE_RANGE]
    colls = [e for e in events if _COLLECTIVE_RE.match(e.name)]
    inside = [f"{c.name} in {SOLVE_RANGE}" for c in colls
              if any(th == c.thread and lo <= c.time_range.start <= hi
                     for th, lo, hi in solves)]
    return {"solves": len(solves), "collectives": [c.name for c in colls],
            "inside": inside, "per_step": len(colls) / steps}


def assert_solves_collective_free(report: dict, per_step: int) -> dict:
    """Raise AssertionError unless no collective lies inside a solve and
    each step ran `per_step` collectives; the audit must have seen a solve
    (else it is vacuous)."""
    if report["solves"] == 0:
        raise AssertionError(f"no {SOLVE_RANGE} range in the trace: the "
                             "audit saw no solve")
    if report["inside"]:
        raise AssertionError("collectives INSIDE a segment solve: "
                             + ", ".join(report["inside"]))
    if report["per_step"] != per_step:
        raise AssertionError(
            f"{report['per_step']} collectives per step, the design states "
            f"{per_step}: {report['collectives']}")
    return report
