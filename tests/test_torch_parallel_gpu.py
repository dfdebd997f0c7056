"""The sharded train steps on the card: two ranks over gloo on one GPU (NCCL
refuses two ranks on one card), `dp=2`, the official and `fast` bench
problems at full width, through `gpode_tpu_torch.scripts.mesh_check` in two
spawned processes (its docstring holds the checks: loss rtol 1e-5 against
the single-process step, gradients atol 1e-4 * max|g| per leaf, an
accepted whole-span attempt and the segment kernels once per step on each
rank, parameters bit-equal after 5 steps, two collectives per step and
none inside a solve).

Needs an NVIDIA GPU with nvcc: `pytest -m gpu tests/test_torch_parallel_gpu.py`.
Without a card every test here skips (the check runs inside a fixture).
"""

import json

import pytest
import torch

from gpode_tpu_torch.scripts import mesh_check

pytestmark = pytest.mark.gpu

TIMEOUT_S = 420


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("preset,kernel", [
    ("official", "fused_dopri5_attempt_fwd"),
    ("fast", "fused_rk4_segment_fwd")])
def test_two_ranks_on_one_card_match_the_single_process_step(
        cuda, preset, kernel, tmp_path):
    codes, outs = mesh_check.run_local(2, preset, str(tmp_path), TIMEOUT_S)
    for rank, (code, out) in enumerate(zip(codes, outs)):
        assert code == 0, f"rank {rank}:\n{out[-4000:]}"
    verdict = json.loads(outs[0].strip().splitlines()[-1])
    assert verdict["backend"] == "gloo" and verdict["failures"] == []
    res = verdict["presets"][preset]
    assert res["rows_per_rank"] == 1500
    for style in ("gspmd", "shard_map"):
        assert [lau[kernel] for lau in res[style]["launches"]] == [1, 1]
        assert res[f"{style}_train"]["params_bit_equal"]
    assert [a["per_step"] for a in res["audit"]] == [2, 2]
