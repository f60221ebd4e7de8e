"""Batched pairs (``strotss_tpu/parallel`` without its device mesh, which
is ROADMAP.md Queue 1 item 13)."""

from strotss_torch.parallel.batch import stylize_batch

__all__ = ["stylize_batch"]
