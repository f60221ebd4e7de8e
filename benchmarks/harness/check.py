"""The comparison that decides ``correct``.

The reference (:mod:`reference.strotss_ref`) follows the program step by
step from the program's own state: a whole stylization is chaotic (a
bfloat16 rounding moves a 10-step run by about 2%), so two free runs
never agree. Each scale of each compared stylization, and each pair of a
batch, is judged on five numbers:

- ``seed_gap``: the pyramid the program's scale starts from against the
  reference's, made from the images at the first scale and from the
  program's previous scale's final pyramid after it (the hand-off that the
  step-by-step comparison skips), max |diff| over max |reference|;
- ``loss_gap``: the program's loss, content loss and style loss of the
  scale's first step against the reference's from the same start (the
  reference draws its own coordinates, makes its own features and
  targets), the largest relative gap. Later steps are not compared: from
  the second step on the two trajectories part (RMSprop's first steps
  move every pixel by about 10 lr sign(g), and a rounding flips the sign
  where g is near 0), and their gaps measure that parting;
- ``grad_gap``: the norm of the first step's gradient as RMSprop took it,
  worked out from its slots after one step (g^2 = nu / (1 - rho)), by the
  worst pyramid level: |norm_program - norm_reference| over the larger of
  the reference's norm of that level and of the median level;
- ``change_gap``: the same for the pyramid's change after the ``follow``
  steps, over the levels whose reference gradient is at least a
  thousandth of the median level's;
- ``image_gap``: the program's uint8 image against the reference's
  clip-renormalize-quantize of the fold of the program's final pyramid,
  the largest difference in levels (exact: limit 0).
"""

from __future__ import annotations

import statistics
from typing import Dict, List

import torch

from reference import strotss_ref as R

RHO = R.RHO


def _norms(leaves, sq: bool = False) -> List[float]:
    """Each level's norm; of sqrt(v / (1 - rho)) for RMSprop slots."""
    if sq:
        return [float(torch.sqrt(torch.sum(v.double()) / (1 - RHO)))
                for v in leaves]
    return [float(torch.linalg.vector_norm(v.double())) for v in leaves]


def _worst(prog: List[float], ref: List[float], keep=None) -> float:
    med = statistics.median(ref)
    gaps = [abs(p - r) / max(r, med, 1e-30)
            for i, (p, r) in enumerate(zip(prog, ref))
            if keep is None or keep[i]]
    return max(gaps) if gaps else 0.0


def _rel(p: torch.Tensor, r: torch.Tensor) -> float:
    return float(torch.max(torch.abs(p.double() - r.double())
                           / torch.clamp(torch.abs(r.double()), min=1e-30)))


def _pair(leaves, b: int, batched: bool):
    return [t[b:b + 1] for t in leaves] if batched else list(leaves)


def scale_numbers(cfg, prec, weights, content, style, scale: int, seed: int,
                  alpha, masks, cap: Dict, b: int, batched: bool,
                  follow: int, other=None, detail=None) -> Dict[str, float]:
    """loss_gap, grad_gap and change_gap of one scale of one pair: the
    program's capture ``cap`` (pair ``b`` of a batch) against the
    reference, or, with ``other`` (a :class:`reference.strotss_ref.
    Precision`), the reference in that precision in the program's place."""
    start = _pair(cap["start"], b, batched)
    f = min(follow, cap["steps"])
    sc = R.prepare_scale(cfg, prec, weights, content, style, scale, seed,
                         *(masks or (None, None)), alpha=alpha)
    rows_r, nu1_r, after_r = R.follow(cfg, prec, weights, sc, start, f)
    if other is None:
        rows_p = torch.cat(cap["rows"])[:f]
        rows_p = rows_p[:, b] if batched else rows_p
        nu1_p = _pair(cap["nu1"], b, batched)
        after_p = _pair(cap["after"], b, batched)
    else:
        sc2 = R.prepare_scale(cfg, other, weights, content, style, scale,
                              seed, *(masks or (None, None)), alpha=alpha)
        rows_p, nu1_p, after_p = R.follow(cfg, other, weights, sc2, start, f)
    g_r, g_p = _norms(nu1_r, sq=True), _norms(nu1_p, sq=True)
    med = statistics.median(g_r)
    moved = [g >= 1e-3 * med for g in g_r]
    d_r = _norms([a - s for a, s in zip(after_r, start)])
    d_p = _norms([a - s for a, s in zip(after_p, start)])
    if detail is not None:
        detail.append({"scale": scale, "pair": b,
                       "rows_p": rows_p.tolist(), "rows_r": rows_r.tolist(),
                       "grad_p": g_p, "grad_r": g_r,
                       "change_p": d_p, "change_r": d_r})
    return {
        "loss_gap": _rel(rows_p[0].float(), rows_r[0].float()),
        "grad_gap": _worst(g_p, g_r),
        "change_gap": _worst(d_p, d_r, moved),
    }


def stylization_numbers(cfg, weights, job, out_u8, scales: List[Dict],
                        follow: int, control: bool = False, detail=None
                        ) -> Dict[str, float]:
    """The five numbers of one finished call (every scale, every pair),
    each the largest over them. ``control``: the reference in the next
    lower precision stands in for the program in the step numbers."""
    prec = R.Precision(cfg["compute_dtype"])
    other = R.Precision(cfg["compute_dtype"], control=True) \
        if control else None
    batched = len(job.seeds) > 1
    worst = {"seed_gap": 0.0, "loss_gap": 0.0, "grad_gap": 0.0,
             "change_gap": 0.0, "image_gap": 0.0}
    masks = (None if job.content_masks is None
             else (job.content_masks, job.style_masks))
    with R.exact(), torch.no_grad():
        for b, seed in enumerate(job.seeds):
            content, style = job.content[b:b + 1], job.style[b:b + 1]
            alpha = None if job.alphas is None else job.alphas[b]
            prev = None
            for i, cap in enumerate(scales):
                ref0 = R.seed_pyramid(cfg, content, style, i, prev)
                start = _pair(cap["start"], b, batched)
                top = max(float(t.abs().max()) for t in ref0)
                worst["seed_gap"] = max(worst["seed_gap"], max(
                    float((s - r).abs().max()) for s, r in zip(start, ref0))
                    / max(top, 1e-30))
                with torch.enable_grad():
                    nums = scale_numbers(cfg, prec, weights, content, style,
                                         i, seed, alpha, masks, cap, b,
                                         batched, follow, other, detail)
                for k, v in nums.items():
                    worst[k] = max(worst[k], v)
                prev = R.fold(_pair(cap["final"], b, batched))
            mine = R.to_uint8(prev)
            worst["image_gap"] = max(worst["image_gap"], float(
                (mine.int() - out_u8[b].int()).abs().max()))
    return worst


def judge(numbers: Dict[str, float], limits: Dict) -> bool:
    return all(numbers[k] <= limits[k]["limit"] for k in limits) and all(
        v == v for v in numbers.values())
