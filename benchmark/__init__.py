"""The benchmark of `gpode_tpu_torch` on one NVIDIA H100: run a cell with
`python3 benchmark/run.py`; `benchmark/harness.py` says what a cell is made
of."""
