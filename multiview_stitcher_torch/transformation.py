"""Physical-space image resampling.

The port of ``multiview_stitcher_tpu.transformation``: ``transform_sim``
resamples a sim onto an output grid. Linear interpolation of data that is
not float64 and holds no NaN runs through the exact-affine kernels
(``ops.exact_affine``); nearest-neighbour interpolation (order 0), float64
data (kept in float64) and float data that holds NaN (which spreads through
the interpolation stencil) take the gather resample
(``ops.resample.affine_resample``), as the reference routes them
(``_try_exact_affine``). Other orders raise ``NotImplementedError``, as in
the reference, and a kernel that fails to build or launch raises. The
physical -> pixel conversion and the no-op detection follow the reference,
so output grids are comparable value for value.
"""

from __future__ import annotations

import numpy as np
import torch

from multiview_stitcher_torch import param_utils, si_utils
from multiview_stitcher_torch.ops import exact_affine
from multiview_stitcher_torch.ops import resample as resample_ops
from multiview_stitcher_torch.si_utils import Sim
from multiview_stitcher_torch.utils import misc as misc_utils


def transform_sim(
    sim: Sim,
    p=None,
    output_stack_properties=None,
    input_spacing=None,
    order: int = 1,
    cval=np.nan,
    mode: str = "constant",
    keep_transform_keys: bool = False,
    device=None,
):
    """Resample a (purely spatial) sim onto ``output_stack_properties``.

    ``p`` maps output physical coordinates -> input physical coordinates
    (fusion passes ``inv(view_param)``). Outside the input the output is
    ``cval``. Integer input gives float32 output; float input keeps its
    dtype. ``order`` is 0 (nearest) or 1 (linear). The resampling runs on
    ``device``: the CUDA device by default (raising if
    there is none), or the CPU with ``device="cpu"``, which takes the
    kernels' plain PyTorch versions. The result holds a numpy array.
    """
    device = misc_utils.resolve_device(device)
    if mode != "constant":
        raise ValueError(f"only mode='constant' is supported, got {mode!r}")
    resample_ops._check_order(order)
    ndim = len(sim.spatial_dims)
    sdims = si_utils.get_spatial_dims_from_sim(sim)
    if tuple(sim.dims) != tuple(sdims):
        raise ValueError(f"transform_sim takes a purely spatial sim, got dims {sim.dims}")

    if p is None:
        p = np.eye(ndim + 1)
    p = np.asarray(param_utils.to_xaffine(p).squeeze(), dtype=float)

    if input_spacing is None:
        input_spacing_arr = si_utils.get_spacing_from_sim(sim, asarray=True)
    else:
        input_spacing_arr = np.array([input_spacing[d] for d in sdims])
    out_shape = tuple(int(output_stack_properties["shape"][d]) for d in sdims)
    matrix, offset = resample_ops.physical_to_pixel_params(
        p,
        input_spacing=input_spacing_arr,
        input_origin=si_utils.get_origin_from_sim(sim, asarray=True),
        output_spacing=np.array([output_stack_properties["spacing"][d] for d in sdims]),
        output_origin=np.array([output_stack_properties["origin"][d] for d in sdims]),
    )

    data = np.asarray(sim.data)
    is_noop = (
        out_shape == tuple(data.shape)
        and np.allclose(matrix, np.eye(ndim), rtol=0, atol=1e-10)
        and np.allclose(offset, 0, rtol=0, atol=1e-10)
    )
    if is_noop:
        out_data = data
    elif order == 1 and _takes_exact_kernels(data):
        out_data = _exact_affine(data, matrix, offset, out_shape, cval, device)
    else:
        out_data = resample_ops.affine_resample(
            torch.from_numpy(np.ascontiguousarray(data)).to(device),
            np.asarray(matrix, np.float32), np.asarray(offset, np.float32), out_shape,
            order=order, cval=cval,
        ).cpu().numpy()

    out = si_utils.to_spatial_image(
        out_data,
        dims=sim.dims,
        scale=output_stack_properties["spacing"],
        translation=output_stack_properties["origin"],
    )
    if keep_transform_keys:
        out.transforms = {k: v.copy() for k, v in sim.transforms.items()}
    return out


def _takes_exact_kernels(data: np.ndarray) -> bool:
    """Whether an order-1 resample of ``data`` runs on the exact kernels:
    not for float64 (the gather keeps its float64 compute) nor for float
    data that holds NaN (the kernels read NaN as 0)."""
    if data.dtype == np.float64:
        return False
    return not (np.issubdtype(data.dtype, np.floating) and bool(np.isnan(data).any()))


def _exact_affine(data, matrix, offset, out_shape, cval, device) -> np.ndarray:
    """One order-1 resample through the exact-affine kernel its map takes:
    the 2D one, or in 3D the y-decoupled one where the map allows it, else
    the general one."""
    ndim = len(out_shape)
    if ndim not in (2, 3):
        raise ValueError(f"only 2D and 3D sims are supported, got {ndim}D")
    m = np.asarray(matrix, dtype=np.float64)
    resample = exact_affine.wrapper_for(ndim, ndim == 3 and exact_affine.is_y_decoupled(m[None]))
    out = resample(
        torch.from_numpy(np.ascontiguousarray(data)).to(device)[None],
        m[None].astype(np.float32),
        np.asarray(offset, np.float32)[None],
        np.asarray([data.shape], np.float32),
        out_shape,
        cval=cval,
    )[0]
    return out.cpu().numpy()


def transform_pts(pts, affine):
    """Apply homogeneous ``affine`` to an (M, N) point array (host numpy)."""
    return param_utils.transform_pts(pts, affine)
