"""The per-layer metric of kernel set K6, ``moments_roofline_pct``."""

import tiny  # noqa: F401  (puts the benchmark on the path)
from harness import work
from harness.layers import reader

from test_bench_work import _metric


def test_moments_bound_counts_the_products_at_the_bf16_peak():
    """A step's moment loss and gradient at n = 1024, C = 2179: 4 n C^2
    products, 19.67 us at 989 TFLOP/s; a style target's statistics half
    that. Both are bound by their products, not their bytes."""
    k6 = _metric("moments_roofline_pct")
    rates = work.PEAKS["SXM"]
    n, c = 1024, 2179
    assert k6.step_bound(n, c, rates) == 4 * n * c * c / rates["bf16"]
    assert abs(k6.step_bound(n, c, rates) * 1e6 - 19.67) < 0.01
    assert k6.target_bound(n, c, rates) == 2 * n * c * c / rates["bf16"]


def _ctx(cell, kernels):
    shapes = work.call_shapes(cell.config["strotss"], cell.traffic)
    return {"calls": [shapes, shapes], "rates": work.PEAKS["SXM"],
            "kernels": kernels}, shapes


def test_moments_roofline_reads_its_launches():
    """strotss512.batch8's shapes: 8 pairs x 4 scales x 10 steps a call,
    two calls; a prep and a covariance launch a step and a style target,
    a finish and a backward launch a step. One launch missing: the shapes
    are not the profile's, and the share reads nothing."""
    cell = tiny.resolve("strotss512.batch8")
    ctx, shapes = _ctx(cell, {})
    steps = 2 * sum(s["pairs"] * s["regions"] * s["steps"] for s in shapes)
    targets = 2 * sum(s["pairs"] * s["regions"] for s in shapes)
    assert (steps, targets) == (640, 64)
    ctx["kernels"] = {
        "moments_prep_kernel(float const*)": (0.002, steps + targets),
        "void moments_cov_kernel<false>(CUtensorMap_st)": (0.03, steps),
        "void moments_cov_kernel<true>(CUtensorMap_st)": (0.002, targets),
        "moments_finish_kernel(float const*)": (0.001, steps),
        "moments_bwd_kernel(CUtensorMap_st)": (0.03, steps)}
    v = reader("moments_roofline_pct")(ctx)
    n, c, r = 1024, 2179, work.PEAKS["SXM"]
    want = 100 * (steps * 4 + targets * 2) * n * c * c / r["bf16"] / 0.065
    assert abs(v - want) < 1e-9 * want
    ctx["kernels"]["moments_bwd_kernel(CUtensorMap_st)"] = (0.03, steps - 1)
    assert reader("moments_roofline_pct")(ctx) is None


def test_moments_roofline_reads_nothing_without_k6():
    """The parent commit has no K6: its profile holds none of the
    kernels."""
    ctx, _ = _ctx(tiny.resolve("strotss512.single"),
                  {"gather_fwd_kernel(Table)": (0.01, 10)})
    assert reader("moments_roofline_pct")(ctx) is None
