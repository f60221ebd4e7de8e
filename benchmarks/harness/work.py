"""What one call of the entry computes, from the configuration's and the
traffic's shapes, and the chip's published peaks.

A call is a list of scale records, one a scale, for the per-layer
metrics (``benchmarks/metrics/``) to count operations and bytes from:

- ``chw``, ``shw``: the content's (and the stylized image's) and the
  style's height and width at that scale;
- ``pairs``: images a VGG pass takes (the batch);
- ``regions``: loss stacks a pair runs a step (1 without masks);
- ``steps``: optimization steps; ``n``: samples (rows) of each loss;
  ``c``: hypercolumn channels (2179 for VGG16's 9 STROTSS taps);
  ``taps``: the VGG taps, in the hypercolumn's order after the image;
  ``dtype``: the compute dtype, in which blocks 2-5 keep their taps
  (the image and block1's taps stay float32);
- ``sinkhorn``: the transport term is Sinkhorn (else REMD);
  ``streamed``: above the memory gate, through K4 with the Danskin
  gradient; ``iters``: Sinkhorn iterations.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

#: published dense peaks (NVIDIA's data sheets; SXM at 700 W):
#: bf16 matrix products, float32 outside the tensor cores, HBM bytes/s;
#: ``sfu`` is the transcendental rate the kernel table uses (1/16 of fp32)
PEAKS = {
    "SXM": {"bf16": 989e12, "fp32": 67e12, "bytes": 3.35e12},
    "NVL": {"bf16": 835e12, "fp32": 60e12, "bytes": 3.9e12},
    "PCIE": {"bf16": 756e12, "fp32": 51e12, "bytes": 2.0e12},
}
for _r in PEAKS.values():
    _r["sfu"] = _r["fp32"] / 16

TAP_CHANNELS = {"block1_conv1": 64, "block1_conv2": 64, "block2_conv1": 128,
                "block2_conv2": 128, "block3_conv1": 256, "block3_conv2": 256,
                "block3_conv3": 256, "block4_conv3": 512, "block5_conv3": 512}
GATE = 2 ** 30


def peaks(device_name: str) -> Tuple[str, Dict[str, float]]:
    """(form factor, rates) of an H100 by its name; SXM when none
    matches."""
    up = device_name.upper().replace(" ", "")
    for key, rates in PEAKS.items():
        if key in up:
            return key, rates
    return "SXM", PEAKS["SXM"]


def bound_s(rates: Dict[str, float], flops: float = 0.0, nbytes: float = 0.0,
            trans: float = 0.0) -> float:
    """The least seconds of a launch: the largest of its matrix-product
    operations at the bf16 peak, its bytes (each input read once, each
    output written once) at the memory rate, and its transcendental
    operations at the ``sfu`` rate."""
    return max(flops / rates["bf16"], nbytes / rates["bytes"],
               trans / rates["sfu"])


def resize_max_hw(h: int, w: int, size: int) -> Tuple[int, int]:
    f = max(h / size, w / size)
    return int(h / f), int(w / f)


def call_shapes(cfg: Dict, traffic: Dict) -> List[Dict]:
    """The scale records of one call of the cell's entry."""
    taps = cfg.get("taps") or list(TAP_CHANNELS)
    c = 3 + sum(TAP_CHANNELS[t] for t in taps)
    pairs = int(traffic.get("pairs", 1))
    regions = int(traffic.get("regions", 0)) or 1
    n = int(cfg["sample_size"])
    sinkhorn = bool(cfg.get("use_sinkhorn", False))
    plain = regions > 1 or pairs > 1  # masked and batched stay materialized
    out = []
    for i in range(cfg["levels"]):
        size = 2 << (5 + i)
        out.append({
            "chw": resize_max_hw(*traffic["content_hw"], size),
            "shw": resize_max_hw(*traffic["style_hw"], size),
            "pairs": pairs, "regions": regions, "steps": cfg["max_iter"],
            "n": n, "c": c, "taps": list(taps),
            "dtype": cfg["compute_dtype"], "sinkhorn": sinkhorn,
            "streamed": sinkhorn and not plain and n * n > GATE,
            "iters": int(cfg.get("sinkhorn_iters", 30)),
        })
    return out
