"""The controls on the card, at each cell's own size: on three seeds the
program's numbers stay inside their limits and the control (the plain
reference in fp8, the next precision below the configuration's bf16, in the
program's place) fails at least one of them.

    python3 -m pytest benchmark/tests/test_bench_controls.py -q -m cuda

Needs a CUDA card (skipped without one); a few minutes a cell.
"""

from __future__ import annotations

import pytest

import tiny  # noqa: F401 (puts the benchmark on sys.path)

CELLS = ["msvd-serve", "msvd-train", "msvd-eval-beam4"]
SEEDS = [2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_where_the_program_passes(name, card):
    import controls
    from benchlib.cells import load_cell

    cell = load_cell(name)
    for seed in SEEDS:
        r = controls.readings(cell, seed, 2.0, card)
        limits = r["limits"]
        assert all(v <= limits[k] for k, v in r["program"].items()), (seed, r)
        assert any(v > limits[k] for k, v in r["control"].items()), (seed, r)

