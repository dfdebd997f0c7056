"""The control fails each cell's limits: the reference in float32 with
TF32 matrix products, put in the program's place, against the float64
reference, at the cell's own sizes on the CPU (the control's rounding is
emulated, so it reads the same here as on the card)."""

import time

import torch

from benchmark import compare, harness
from benchmark.reference.common import Arith, round_tf32
from benchmark.traffic import predict, train

CONTROL = Arith(torch.float32, tf32=True)


def _cell(name, seed):
    return harness.Cell(name, seed, 0.0, False, torch.device("cpu"),
                        time.perf_counter())


def test_round_tf32():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, -3.0 - 2.0 ** -12])
    assert round_tf32(x).tolist() == [1.0, 1.0, 1.0 + 4 * 2.0 ** -11, -3.0]


def test_train_control_fails():
    cell = _cell("mocap09-shooting.train", 77)
    setup = train.Setup(cell)
    setup.free_program()
    ref = setup.reference(Arith())
    readings = compare.train_readings(setup.reference(CONTROL), ref)
    assert not compare.verdict(readings, cell.workload["limits"]), readings


def test_predict_control_fails():
    cell = _cell("mocap09-shooting.predict", 78)
    setup = predict.Setup(cell)
    setup.free_program()
    ref = setup.reference([0, 1], Arith())
    readings = compare.predict_readings(setup.reference([0, 1], CONTROL), ref)
    assert not compare.verdict(readings, cell.workload["limits"]), readings
