"""The harness's comparison catches a broken timed path: each fault that a
cell can have is planted in the program underneath a whole CPU run (the
look for a card skipped), and `correct` comes out false.

Train cells: a step that leaves its state unchanged (Adam's update does
nothing); half of the batch left out, the likelihood's mean taken over the
rest (half the sequences; VDP: half the observation times). A captured
step, rehearsed on the CPU as the card would replay it (its inputs copied
into static buffers, the accept read at the seam): its replays' noise not
copied in, so every replay reuses the first one's; Adam's update count not
advancing after the first replays. Prediction requests: half of the draws
left out of the mixture; an answer altered where it is produced (one
draw's trajectory a step late). One chip only, so there is no exchange
between chips to leave out."""

import json

import pytest
import torch

from gpode_tpu_torch.models import gpode, shooting
from gpode_tpu_torch.train import evaluation, graph_step, trainer

from benchmark import harness
from conftest import with_unlisted


def _unchanged(monkeypatch):
    monkeypatch.setattr(trainer.Adam, "step", lambda self: None)


def _half_sequences(monkeypatch):
    orig = shooting.likelihood_log_prob
    monkeypatch.setattr(shooting, "likelihood_log_prob",
                        lambda p, f, y: orig(p, f, y)[:, : f.shape[1] // 2])


def _half_times(monkeypatch):
    orig = gpode.likelihood_log_prob
    monkeypatch.setattr(gpode, "likelihood_log_prob",
                        lambda p, f, y: orig(p, f, y)[:, : f.shape[1] // 2])


def _captured(monkeypatch):
    """The entry points' step as the captured step's CPU rehearsal, which
    a card would replay: `make_step` on the CPU runs the step eagerly."""
    monkeypatch.setattr(graph_step, "make_step",
                        lambda loss_fn, params, opt, margs:
                        graph_step.make_captured_train_step(loss_fn, params, opt))


def _stale_noise(monkeypatch):
    _captured(monkeypatch)
    orig = graph_step._copy_static

    def copy(static, value, what):
        if not what.startswith("noise."):
            orig(static, value, what)

    monkeypatch.setattr(graph_step, "_copy_static", copy)


def _stuck_count(monkeypatch):
    _captured(monkeypatch)
    orig = trainer.Adam.step

    def step(self):
        orig(self)
        if self.count > 3:
            self.count = 3

    monkeypatch.setattr(trainer.Adam, "step", step)


def _half_draws(monkeypatch):
    orig = evaluation.mixture_summary_device
    monkeypatch.setattr(evaluation, "mixture_summary_device",
                        lambda a, p, v: orig(a, p[: p.shape[0] // 2], v))


def _late_answer(monkeypatch):
    orig = evaluation.mixture_summary_device

    def late(a, p, v):
        first = torch.cat([p[:1, :, :1], p[:1, :, :-1]], dim=2)
        return orig(a, torch.cat([first, p[1:]]), v)

    monkeypatch.setattr(evaluation, "mixture_summary_device", late)


FAULTS = [("vdp-vanilla.train", _unchanged),
          ("vdp-vanilla.train", _half_times),
          ("mocap09-shooting.train", _unchanged),
          ("mocap09-shooting.train", _half_sequences),
          ("mocap09-shooting.train", _stale_noise),
          ("mocap09-shooting.train", _stuck_count),
          ("mocap09-shooting.predict", _half_draws),
          ("mocap09-shooting.predict", _late_answer)]


@pytest.mark.parametrize("cell,plant", FAULTS,
                         ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_fault_is_not_correct(cell, plant, monkeypatch, capsys):
    spec = with_unlisted(harness.load_spec())
    monkeypatch.setattr(harness, "load_spec", lambda: spec)
    plant(monkeypatch)
    rc = harness.main(["--workload", cell, "--seed", "424242424242",
                       "--seconds", "1", "--trace", "0", "--device", "cpu"])
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is False, line["checks"]
