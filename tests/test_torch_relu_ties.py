"""The fp32 train-step check's ReLU tie rule (``chip_smoke.relu_ties`` and
``chip_smoke.relu_branch``; ROADMAP C.8), on the CPU.

Where the card and the CPU put a ReLU pre-activation on either side of
zero, the check takes the differences for ties only when there are at
most ``RELU_TIES_MAX`` of them in the step and each lies within
``RELU_TIE x max(|layer|, 1)`` of zero on both devices; it then retakes
the CPU step with just those units on the other branch.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)


def _layer(seed: int) -> torch.Tensor:
    """One call's pre-activations, (4, 64), none within 1e-3 of zero."""
    u = np.random.default_rng(seed).standard_normal((4, 64)) * 3.0
    u = np.where(np.abs(u) < 1e-3, 1.0, u)
    return torch.from_numpy(u.astype(np.float32))


# per case: (call, flat index, CPU value, card value, both x max(|layer|,
# 1)) of each unit the card flips, and whether the step's differences
# are ties.  The ties seen on an H100 lie within 2.8e-7 of zero; the
# fp32 kernels' error against float64 is about 1e-6, so a unit 5e-6 from
# zero on either device is no tie
CASES = {
    "none": ([], True),
    "one_tie": ([(0, 5, -2.8e-7, 4e-8)], True),
    "two_ties_one_call": ([(0, 5, -2.8e-7, 4e-8), (0, 77, 1.5e-7, -4e-8)],
                          True),
    "two_ties_two_calls": ([(0, 5, -2.8e-7, 4e-8), (1, 9, 1.4e-7, -1.8e-7)],
                           True),
    "three_ties": ([(0, 5, -2.8e-7, 4e-8), (0, 77, 1.5e-7, -4e-8),
                    (1, 9, 1.4e-7, -1.8e-7)], False),
    "cpu_side_wide": ([(0, 5, -5e-6, 4e-8)], False),
    "card_side_wide": ([(1, 9, 1.4e-7, -5e-6)], False),
    "one_tie_one_wide": ([(0, 5, -2.8e-7, 4e-8), (1, 9, 1.4e-7, -3e-5)],
                         False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_relu_ties_takes_only_few_narrow_flips_for_ties(case):
    units, tie = CASES[case]
    u_cpu = [_layer(0), _layer(1)]
    u_dev = [u.clone() for u in u_cpu]
    for call, i, cpu, dev in units:
        scale = max(float(u_cpu[call].abs().max()), 1.0)
        u_cpu[call].view(-1)[i] = cpu * scale
        u_dev[call].view(-1)[i] = dev * scale
    got = cs.relu_ties(u_dev, u_cpu)
    assert got["differences"] == len(units)
    assert got["all_ties"] is tie
    # the retaken step's branches: the CPU's own, just the flipped units
    # on the card's side
    for call, (a, b, m) in enumerate(zip(u_dev, u_cpu, got["masks"])):
        flipped = {i for c, i, _, _ in units if c == call}
        want = b > 0
        for i in flipped:
            want.view(-1)[i] = bool(a.view(-1)[i] > 0)
        assert torch.equal(m, want)
        assert torch.equal(m, a > 0)
    assert (got["units"] == "none") is (not units)


def test_relu_branch_records_and_forces_the_branch_then_restores_relu():
    from repro_torch.kernels import ref

    relu = ref.ACTS["relu"]
    u = _layer(2)
    seen = []
    with cs.relu_branch(record=seen):
        assert torch.equal(ref.ACTS["relu"](u), torch.relu(u))
    assert len(seen) == 1 and torch.equal(seen[0], u)
    mask = torch.from_numpy(np.random.default_rng(3).random((4, 64)) < 0.5)
    with cs.relu_branch(masks=[mask]):
        assert torch.equal(ref.ACTS["relu"](u), u * mask.float())
    assert ref.ACTS["relu"] is relu
