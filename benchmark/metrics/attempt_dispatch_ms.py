"""The host's mean time to issue one adaptive dopri5 attempt: the attempt
less its error read (`gpode.solve.attempt`, `gpode.solve.error_read` on the
program's untraced host clock)."""

from benchmark.spans import attempt_dispatch_ms as read  # noqa: F401
