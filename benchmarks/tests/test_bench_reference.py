"""The frozen reference against the program's plain path on the CPU, at a
tiny size, so that drift on either side shows; and the control, the
reference in the next lower precision, failing the cell's limits."""

import pytest

import tiny


def _numbers(c, control=False, seed=5):

    import torch

    import run
    from harness import check

    torch.manual_seed(0)
    program, traffic, weights, rec, _ = run.setup(c, seed, torch.device(
        "cpu"))
    job = traffic.job()
    out, scales = program.call(job)
    return check.stylization_numbers(c.config["strotss"], weights, job,
                                     out, scales, run.FOLLOW,
                                     control=control)


def test_reference_follows_the_float32_program():
    """Float32 on the CPU: the same mathematics in another order."""
    n = _numbers(tiny.cell(levels=2, max_iter=2))
    assert n["seed_gap"] == 0.0 and n["image_gap"] == 0.0
    assert n["loss_gap"] < 1e-5
    assert n["grad_gap"] < 1e-5
    assert n["change_gap"] < 1e-3, n


@pytest.mark.parametrize("regions,pairs", [(2, 1), (0, 3)])
def test_reference_follows_masked_and_batched_calls(regions, pairs):
    n = _numbers(tiny.cell(regions=regions, pairs=pairs, levels=1,
                           max_iter=2))
    assert n["loss_gap"] < 1e-5 and n["grad_gap"] < 1e-5


def test_reference_follows_the_bf16_policy():
    """The fused block1 route's plain version and bfloat16 blocks 2-5."""
    c = tiny.cell(dtype="bfloat16", levels=1, max_iter=2)
    c.config["strotss"]["block1_impl"] = "pallas"
    n = _numbers(c)
    assert n["loss_gap"] < 1e-2 and n["grad_gap"] < 5e-2


def test_the_control_fails_the_limits():
    """fp8 VGG and TF32 losses in the program's place."""
    c = tiny.cell(dtype="bfloat16", levels=1, max_iter=2)
    c.config["strotss"]["block1_impl"] = "pallas"
    limits = tiny.resolve("strotss512.single").limits
    from harness import check

    n = _numbers(c, control=True)
    assert not check.judge(n, limits), n
