"""The control: the plain reference in the precision below the
configuration's, put in the program's place, fails the cell's check. The
chip runs it at the cells' own sizes (``--control``); this keeps it at a
tiny size."""

import pytest

from conftest import run_tiny


@pytest.mark.parametrize("cell,control", [
    ("serve_t4_hostwarp", "tf32"), ("eval_t4f2_b2", "tf32"),
    ("train_t4f2_b2", "fp8"), ("train_t4f2_b8", "fp8")])
def test_control_is_not_correct(cell, control):
    r = run_tiny(cell, control=control)
    assert r["control"] == control
    assert not r["correct"], r["checks"]
