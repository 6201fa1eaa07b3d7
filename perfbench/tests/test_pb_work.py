"""The benchmark's operation and byte counts against values worked out
from ``chip_smoke.py``'s formulas at one rejection round a draw, at the
cells' launches."""

import pytest

from perfbench import work

K4 = [((1024, 64, 64, 81, 100), (150921216, 3650917432320)),
      ((1024, 32, 32, 81, 100), (88006656, 912730291200)),
      ((1024, 8, 8, 256, 8), (20201472, 17456431104)),
      ((8192, 8, 8, 256, 8), (161611776, 139651448832))]
K3 = [((1024, 16, 16, 8100), (70549504, 896060620800)),
      ((1024, 4, 4, 2048), (17039360, 14159970304)),
      ((8192, 4, 4, 2048), (136314880, 113279762432))]


@pytest.mark.parametrize("shape,want", K4)
def test_work_k4(shape, want):
    assert work.work_k4(*shape) == want


@pytest.mark.parametrize("shape,want", K3)
def test_work_k3(shape, want):
    assert work.work_k3(*shape) == want


def test_one_round_a_draw():
    assert work.ROUNDS == 1
    assert work.sweep_ops(2048, 1024) == 432128


def test_bound_by_operations():
    nbytes, nops = work.work_k4(1024, 64, 64, 81, 100)
    assert work.bound_s(nbytes, nops) == nops / 67e12
    assert work.bound_s(3.35e12, 1.0) == 1.0
