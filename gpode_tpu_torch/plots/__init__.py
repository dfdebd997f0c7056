"""Host-side matplotlib diagnostics. Counterpart of `gpode_tpu/plots/`.

Each function that computes something has a data part (torch on the
parameters' device, returning NumPy arrays) and a drawing part (matplotlib
on the Agg backend, NumPy arrays only). matplotlib is imported by the
drawing parts alone (`pyplot()`), so the data parts run where it is not
installed.
"""

from __future__ import annotations

_PYPLOT = None


def pyplot():
    """matplotlib's pyplot on the Agg backend; raises naming `--no_plots`
    where matplotlib does not import."""
    global _PYPLOT
    if _PYPLOT is None:
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError as exc:
            raise RuntimeError(f"the plots need matplotlib ({exc}); pass "
                               "--no_plots to run without them") from exc
        _PYPLOT = plt
    return _PYPLOT
