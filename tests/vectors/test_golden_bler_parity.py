"""CI smoke of the BLER parity surface: two reference-measured operating
points replayed through this chain at reduced slot counts; agreement
within generous Monte-Carlo bounds.  The full 300-slot table lives in
BLER_PARITY.md (benchmarks/bler_parity.py)."""

import json
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from conftest import load_suite  # noqa: E402

pytestmark = pytest.mark.vectortest


@pytest.mark.parametrize("case_idx,slots", [(0, 60), (7, 30)])
def test_bler_parity_smoke(case_idx, slots):
    from benchmarks.bler_parity import run_case

    cases = load_suite("bler_parity")
    case = cases[case_idx]
    ours = run_case(case, slots, parity_kernels=True)
    ref = case["crc_bler"]
    # 3-sigma binomial bound at the smaller sample size.
    sigma = np.sqrt(max(ref * (1 - ref), 0.02) / slots)
    assert abs(ours["crc_bler"] - ref) <= 3 * sigma + 0.02, (
        case["profile"], case["sinr_db"], ours["crc_bler"], ref)
