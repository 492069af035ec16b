"""The controls at a tiny size on the CPU: the reference in the precision
below the configuration's (int4 weights for the int8 serving trees) reads
worse than the program.  At the cells' own sizes they run on the card:
``perfbench/control.py``."""

import pytest

from perfbench import control
from perfbench.tests import tiny


@pytest.mark.parametrize("moe", [False, True])
def test_serving_control_reads_worse(moe):
    with tiny.kernels_forced():
        out = control.readings("tiny", 21, device="cpu", cell=tiny.cell(moe))
    key = out["compare"]
    assert out["control"][key] > 3 * max(out["program"][key], 1e-3)
    assert out["control"][key] > out["limit"]
