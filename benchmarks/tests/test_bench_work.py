"""The work the per-layer metrics count from shapes."""

import importlib.util
import os

import tiny  # noqa: F401  (puts the benchmark on the path)
from harness import work
from harness.layers import reader

BENCH = tiny.BENCH


def _metric(name):
    path = os.path.join(BENCH, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_vgg16_forward_flops():
    mfu = _metric("mfu_pct")
    assert mfu.vgg_flops(224, 224) == 611712 * 224 * 224
    assert abs(mfu.vgg_flops(224, 224) / 1e9 - 30.69) < 0.01
    # pooling floors odd sizes: never more than the per-pixel count
    assert mfu.vgg_flops(341, 512) <= 611712 * 341 * 512


def test_remd_call_counts_2nmc_at_the_bf16_peak():
    remd = _metric("remd_roofline_pct")
    rates = work.PEAKS["SXM"]
    n, c = 1024, 2179
    t = remd.call_bound(n, n, c, False, rates)
    assert t == max(2 * n * n * c / rates["bf16"],
                    (4 * 2 * n * c + 16 * n) / rates["bytes"])


def test_block1_bytes_match_the_kernel_table():
    """PERF.md's kernel table bounds K3a at 0.0308 ms and K3b at 0.0608 ms
    (bytes) on a 384x512 image."""
    b1 = _metric("block1_roofline_pct")
    rates = work.PEAKS["SXM"]
    assert abs(b1.fwd(384, 512, 1, rates) * 1e3 - 0.0308) < 0.0005
    assert abs(b1.bwd(384, 512, 1, rates) * 1e3 - 0.0608) < 0.0005


def test_call_shapes_of_the_cells():
    cfg = tiny.resolve("strotss512.single").config["strotss"]
    traffic = tiny.resolve("strotss512.single").traffic
    shapes = work.call_shapes(cfg, traffic)
    assert [s["chw"] for s in shapes] == [(42, 64), (85, 128), (170, 256),
                                          (341, 512)]
    assert shapes[0]["c"] == 2179 and not shapes[0]["sinkhorn"]
    # Sinkhorn above the memory gate N * M = 2^30 streams through K4
    sk = dict(cfg, use_sinkhorn=True, levels=5, sample_size=32769,
              max_iter=1)
    shapes = work.call_shapes(sk, dict(traffic, content_hw=[768, 1024]))
    assert len(shapes) == 5 and all(s["streamed"] for s in shapes)


def test_a_roofline_with_no_device_time_reads_nothing():
    ctx = {"calls": [work.call_shapes(
        tiny.resolve("strotss512.single").config["strotss"],
        tiny.resolve("strotss512.single").traffic)],
        "kernels": {}, "rates": work.PEAKS["SXM"]}
    for name in ("block1_roofline_pct", "remd_roofline_pct",
                 "selfsim_roofline_pct", "gather_roofline_pct"):
        assert reader(name)(ctx) is None


def test_a_roofline_reads_its_kernels_and_checks_their_launches():
    cell = tiny.resolve("strotss512.single")
    shapes = work.call_shapes(cell.config["strotss"], cell.traffic)
    calls = sum(s["steps"] for s in shapes)
    ctx = {"calls": [shapes], "rates": work.PEAKS["SXM"],
           "kernels": {"void remd_tc_kernel(float*)": (0.01, calls),
                       "remd_reduce_kernel": (0.001, 2 * calls)}}
    v = reader("remd_roofline_pct")(ctx)
    assert v is not None and 0 < v < 100
    ctx["kernels"]["remd_reduce_kernel"] = (0.001, calls)
    assert reader("remd_roofline_pct")(ctx) is None


def test_gather_bytes_match_the_kernel_table():
    """PERF.md's kernel table bounds K5 at 0.0130 ms (forward) and 0.0477
    ms (backward) by bytes: the 512 px scale's 10 maps on a 384x512 image,
    n = 1024, VGG16's taps in the bf16 policy."""
    k5 = _metric("gather_roofline_pct")
    rates = work.PEAKS["SXM"]
    taps = list(work.TAP_CHANNELS)
    args = (384, 512, 1024, taps, "bfloat16", rates)
    assert abs(k5.paired_fwd(*args) * 1e3 - 0.0130) < 0.0005
    assert abs(k5.bwd(*args) * 1e3 - 0.0477) < 0.0005
    # float32 taps hold twice the bytes of blocks 2-5
    assert k5.bwd(384, 512, 1024, taps, "float32", rates) > k5.bwd(*args)


def test_a_gather_roofline_checks_its_launches():
    cell = tiny.resolve("strotss512.masked2")
    shapes = work.call_shapes(cell.config["strotss"], cell.traffic)
    k = sum(s["pairs"] * s["regions"] for s in shapes)
    steps = sum(s["steps"] * s["pairs"] * s["regions"] for s in shapes)
    ctx = {"calls": [shapes], "rates": work.PEAKS["SXM"],
           "kernels": {"gather_fwd_kernel(Table)": (0.01, steps + k),
                       "gather_sort_kernel(Table)": (0.002, steps),
                       "gather_acc_kernel(Table)": (0.02, steps)}}
    v = reader("gather_roofline_pct")(ctx)
    assert v is not None and 0 < v < 100
    # a style forward a region a scale missing: the shapes are not the
    # profile's, so the share reads nothing
    ctx["kernels"]["gather_fwd_kernel(Table)"] = (0.01, steps)
    assert reader("gather_roofline_pct")(ctx) is None
