"""Image filters on torch tensors: the box filter that SSIM takes.

The port of ``uniform_filter`` from ``multiview_stitcher_tpu.ops.filters``
(scipy.ndimage's ``uniform_filter`` with ``mode="reflect"``), on the last
``ndim`` axes of a tensor with any leading batch axes. The reference writes
it as a separable correlation with taps ``1/size``; here each axis is one
average pool over a reflect-padded copy, which sums the window and divides
by its size (the two agree to a rounding of the last bit). Other filters of
the reference (gaussian, LoG, min/max, DCT entropy) are not ported yet
(ROADMAP.md, queue 1: item 7).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_POOLS = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


def _reflect_index(n: int, r: int, device) -> torch.Tensor:
    """Indices of an axis of length ``n`` padded by ``r`` on each side in
    scipy's "reflect" mode (the edge sample repeats: d c b a | a b c d)."""
    i = torch.arange(-r, n + r, device=device) % (2 * n)
    return torch.where(i >= n, 2 * n - 1 - i, i)


def uniform_filter(data: torch.Tensor, size: int, ndim: int = None) -> torch.Tensor:
    """Box filter of odd ``size`` over the last ``ndim`` axes (all axes by
    default), reflecting at the borders."""
    if size % 2 != 1:
        raise ValueError(f"uniform_filter takes odd sizes, got {size}")
    ndim = data.dim() if ndim is None else ndim
    if ndim not in _POOLS:
        raise ValueError(f"uniform_filter takes 1 to 3 axes, got {ndim}")
    r = (size - 1) // 2
    lead = data.shape[: data.dim() - ndim]
    out = data.reshape((-1, 1) + tuple(data.shape[data.dim() - ndim:]))
    for ax in range(ndim):
        axis = 2 + ax
        out = out.index_select(axis, _reflect_index(out.shape[axis], r, out.device))
        kernel = [1] * ndim
        kernel[ax] = size
        out = _POOLS[ndim](out, kernel_size=tuple(kernel), stride=1)
    return out.reshape(lead + tuple(out.shape[2:]))
