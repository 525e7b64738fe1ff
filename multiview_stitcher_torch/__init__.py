"""multiview_stitcher_torch: the PyTorch/CUDA port of multiview_stitcher_tpu.

The JAX package ``multiview_stitcher_tpu`` is the reference; this package
computes the same results with PyTorch on the host and hand-written CUDA C++
kernels for NVIDIA Hopper (sm_90a) on the device. It imports neither JAX nor
the JAX package: the host helpers it needs are copied here under the same
module names.

This slice covers ``fusion.fuse`` of translation-placed 2D and 3D tile grids
with the default weighted-average blending. Entry points run on the CUDA
device unless the caller passes ``device="cpu"``, which takes the plain
PyTorch version of every kernel.

- ``si_utils`` / ``msi_utils`` / ``param_utils`` — data model
- ``fusion`` — ``fuse``
- ``ops.translation_fusion`` — the two translation-fusion kernels
- ``convert`` — builds this package's sims from the JAX package's fields
"""

__version__ = "0.1.0"
