"""multiview_stitcher_torch: the PyTorch/CUDA port of multiview_stitcher_tpu.

The JAX package ``multiview_stitcher_tpu`` is the reference; this package
computes the same results with PyTorch on the host and hand-written CUDA C++
kernels for NVIDIA Hopper (sm_90a) on the device. It imports neither JAX nor
the JAX package: the host helpers it needs are copied here under the same
module names.

Ported so far: ``fusion.fuse`` of sims and of multiscale msims (any fusion
and weights function, in memory or into OME-Zarr; lazy views larger than the
card through host slabs), ``registration.register``
(the view graph, batched phase correlation, groupwise resolution; over
pyramid levels and over ``t``; any other pairwise function pair by pair,
marker-based registration of bead point sets, the linear two-pass
resolution), ``detection.detect_beads``, ``stitch.stitch``,
``transformation.transform_sim`` with linear interpolation, multi-view
deconvolution (``fusion.mv_deconv``) and registration-quality metrics
(``metrics.tile_pair_image_metrics``), block-wise fusion into a shared zarr
array (``fusion.prepare_block_fusion``), the readers of TIFF, CZI (mosaics
and multi-view), Imaris and the everyday image formats
(``io.read_mosaic_into_sims``), fusion and registration over a device mesh
and across processes (``parallel``), the serving path (virtual OME-Zarr
stores, neuroglancer state, the figures, and the service runtime's sessions,
workers and bridges), and the public names of the JAX package's modules
listed below, with the JAX package's parameters. Entry points run on the
CUDA device unless the caller passes ``device="cpu"``, which takes the plain
PyTorch version of every kernel.

- ``si_utils`` / ``msi_utils`` / ``param_utils`` / ``zarr_utils`` — data model
- ``fusion`` — ``fuse``; ``registration`` — ``register``; ``stitch`` — ``stitch``
- ``detection`` — ``detect_beads``; ``registration_plugins`` — ANTsPy, ITK-Elastix
- ``fusion.mv_deconv`` — ``multi_view_deconvolution``, a fusion function
- ``metrics`` — ``tile_pair_image_metrics``, NCC and SSIM of view overlaps
- ``io.zarr_backend`` / ``io.ngff_utils`` — zarr v2 and v3 (sharded or not,
  read over HTTP too), OME-Zarr (NGFF 0.4 and 0.5)
- ``io.virtual_ngff`` — virtual OME-Zarr stores of sims and their server
- ``vis_utils`` / ``neuroglancer`` — figures (matplotlib, imported at first
  use) and viewer state
- ``service`` — ``Session``, ``WorkerRuntime``, ``LocalBridge``,
  ``ProcessPoolBridge`` and the JSON specs
- ``io`` — ``read_mosaic_into_sims``; ``io.tif_utils``, ``io.czi_utils``
  (with ``io.jpeg``), ``io.imaris_utils``, ``io.fallback``; ``io.codecs`` —
  the TIFF decoders, native C built at first use
- ``transformation`` — ``transform_sim``, ``transform_pts``
- ``ops.translation_fusion`` — the two translation-fusion kernels
- ``ops.exact_affine`` — the three exact-affine resampling kernels
- ``ops.shear`` — the shear tier's plans and passes (``MVS_TPU_SHEAR=1``)
- ``parallel`` — ``mesh`` (``Mesh``, ``get_mesh``: ``mesh=`` of ``fuse``,
  ``register`` and ``stitch``), ``pipeline`` (sharded pair and chunk
  batches), ``executors`` (JSON work specs, block partitions) and
  ``multihost`` (``multihost_fuse`` over ``torch.distributed``)
- ``utils.profiling`` — stage timers and ``torch.profiler`` traces
- ``sample_data`` — synthetic tile grids with known shifts
- ``convert`` — builds this package's sims from the JAX package's fields

The reference's module names ``spatial_image_utils``, ``ngff_utils``,
``misc_utils``, ``tif_utils``, ``czi_utils`` and ``imaris_utils`` are
aliases of ``si_utils``, ``io.ngff_utils``, ``utils.misc`` and the three
readers under ``io``.
"""

import importlib

__version__ = "0.1.0"

# the JAX package's __all__
__all__ = [
    "si_utils",
    "msi_utils",
    "param_utils",
    "transforms",
    "transformation",
    "mv_graph",
    "registration",
    "param_resolution",
    "fusion",
    "weights",
    "detection",
    "metrics",
    "sample_data",
    "io",
    "zarr_utils",
    "vis_utils",
    "neuroglancer",
    "parallel",
    "stitch",
    "ops",
]

_ALIASES = {
    "spatial_image_utils": "multiview_stitcher_torch.si_utils",
    "ngff_utils": "multiview_stitcher_torch.io.ngff_utils",
    "misc_utils": "multiview_stitcher_torch.utils.misc",
    "tif_utils": "multiview_stitcher_torch.io.tif_utils",
    "czi_utils": "multiview_stitcher_torch.io.czi_utils",
    "imaris_utils": "multiview_stitcher_torch.io.imaris_utils",
}


def __getattr__(name):
    """The reference-layout aliases, and ``metrics``, imported at first
    use."""
    if name in _ALIASES:
        return importlib.import_module(_ALIASES[name])
    if name == "metrics":
        return importlib.import_module(f"{__name__}.metrics")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
