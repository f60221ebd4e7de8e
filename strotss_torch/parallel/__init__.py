"""Batched pairs and device meshes (``strotss_tpu/parallel``): B pairs in
one run, split over a mesh's 'data' axis of ranks, and the transport
losses' style samples split over its 'sample' axis. The 'spatial' axis
is ROADMAP.md Queue 1 item 16."""

from strotss_torch.parallel.batch import stylize_batch
from strotss_torch.parallel.mesh import make_mesh

__all__ = ["make_mesh", "stylize_batch"]
