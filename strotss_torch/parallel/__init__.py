"""Batched pairs and device meshes (``strotss_tpu/parallel``): B pairs in
one run, split over a mesh's 'data' axis of ranks, the transport losses'
style samples split over its 'sample' axis, and one image's VGG stack
split by height over its 'spatial' axis."""

from strotss_torch.parallel.batch import stylize_batch
from strotss_torch.parallel.mesh import make_mesh

__all__ = ["make_mesh", "stylize_batch"]
