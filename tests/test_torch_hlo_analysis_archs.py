"""The last five of the ten smoke configs' train, prefill and decode steps
on one device: the port's dot FLOPs against the reference's compiled HLO
(the first five, the toys and the SSD formula are in
`test_torch_hlo_analysis.py`)."""
import pytest

from repro.configs import ARCH_IDS
from test_torch_hlo_analysis import check_smoke_steps


@pytest.mark.parametrize("arch", ARCH_IDS[5:])
def test_smoke_steps_dot_flops_equal_the_reference(arch):
    check_smoke_steps(arch)
