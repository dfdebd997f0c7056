"""The host's time per train step in the launches of the captured step's
graphs, over the untraced steps (`gpode.step`, `gpode.step.replay` on the
program's untraced host clock)."""

from benchmark.spans import graph_launch_ms_per_step as read  # noqa: F401
