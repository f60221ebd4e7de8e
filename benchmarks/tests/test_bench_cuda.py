"""On the card: a cell cut small runs through the kernels and comes out
correct. Marked ``cuda``; the fixture skips without a card. Run on the
card with ``python -m pytest --noconftest benchmarks/tests -m cuda``."""

import pytest

import tiny


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("regions,pairs", [(0, 1), (2, 1), (0, 3)])
def test_a_small_cell_is_correct_on_the_card(card, regions, pairs):
    import contextlib
    import io
    import json

    import run

    c = tiny.cell(regions=regions, pairs=pairs, dtype="bfloat16")
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(["--workload", c.name, "--seed", "77", "--seconds",
                       "2", "--trace", "0"], device=card, cell=c)
    assert rc == 0, err.getvalue()
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert line["device"]["platform"] == "gpu"
    assert line["correct"] is True, line["compared"]
