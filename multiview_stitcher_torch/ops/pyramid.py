"""Block means of an OME-Zarr pyramid level on the card.

``coarsen_mean(x, factors)`` is ``msi_utils._coarsen_mean`` for unsigned
integer data: the mean of each block of ``factors`` (one a dim of ``x``; at
most the last three may differ from 1), the trailing rows that fill no block
dropped, cut back to the dtype by truncation. For ``uint8`` and ``uint16`` it
is computed as the exact integer sum floor-divided by the block's size,
which equals the truncated float64 mean bit for bit (``csrc/pyramid.cu``
says why).

For a CUDA tensor the wrapper launches the hand-written CUDA C++ kernel of
``csrc/pyramid.cu`` (built for sm_90a at first use) or raises; it takes the
plain PyTorch version :func:`coarsen_mean_plain` only for a tensor on the
CPU. It counts its launches in ``coarsen_mean.launches``. The kernel
replaces no Pallas kernel: the JAX package coarsens on the host with numpy.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Sequence, Tuple

import torch

from multiview_stitcher_torch.ops import _build

# dtype codes of csrc/pyramid.cu
_DTYPE_CODES = {torch.uint16: 1, torch.uint8: 2}


class _Shape(NamedTuple):
    batch: int                  # the leading dims (factor 1), merged
    spatial: Tuple[int, ...]    # (Z, Y, X), padded in front with 1s
    factors: Tuple[int, ...]    # (fz, fy, fx)
    out_shape: Tuple[int, ...]  # the output's shape, every dim of x


def _check(x: torch.Tensor, factors: Sequence[int]) -> _Shape:
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"coarsen_mean takes uint8 or uint16 data, got {x.dtype}")
    factors = tuple(int(f) for f in factors)
    if len(factors) != x.dim() or x.dim() == 0:
        raise ValueError(f"one factor a dim of the {x.dim()}D data, got {factors}")
    if min(factors) < 1:
        raise ValueError(f"factors must be positive, got {factors}")
    lead = max(0, x.dim() - 3)
    if any(f != 1 for f in factors[:lead]):
        raise ValueError(f"only the last three dims may have a factor above 1, got {factors}")
    n = math.prod(factors)
    if torch.iinfo(x.dtype).max * n >= 2**32:
        raise ValueError(f"a block of {n} voxels could overflow the kernel's 32-bit sums")
    pad = (1,) * (3 - (x.dim() - lead))
    return _Shape(
        batch=math.prod(x.shape[:lead]),
        spatial=pad + tuple(x.shape[lead:]),
        factors=pad + factors[lead:],
        out_shape=tuple(s // f for s, f in zip(x.shape, factors)),
    )


def coarsen_mean_plain(x: torch.Tensor, factors: Sequence[int]) -> torch.Tensor:
    """Plain PyTorch version of :func:`coarsen_mean`, on any device: the
    integer sum over reshaped factor axes, floor-divided by the block size."""
    shape = _check(x, factors)
    factors = tuple(int(f) for f in factors)
    trimmed = x[tuple(slice(0, o * f) for o, f in zip(shape.out_shape, factors))]
    blocked = []
    for o, f in zip(shape.out_shape, factors):
        blocked += [o, f]
    sums = trimmed.to(torch.int64).reshape(blocked).sum(dim=tuple(range(1, 2 * x.dim(), 2)))
    return (sums // math.prod(factors)).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("pyramid")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.mvs_coarsen_mean.argtypes = [P, I, ctypes.c_longlong, I, I, I, I, I, I, P, P]
    lib.mvs_coarsen_mean.restype = I
    return lib


def coarsen_mean(x: torch.Tensor, factors: Sequence[int]) -> torch.Tensor:
    """Block means of ``x`` (``uint8`` or ``uint16``) over ``factors``, one a
    dim, in ``x``'s dtype: ``floor(sum / prod(factors))`` of each block, the
    trailing remainder of each dim dropped. A CPU tensor takes
    :func:`coarsen_mean_plain`; a CUDA tensor the kernel."""
    shape = _check(x, factors)
    if x.device.type == "cpu":
        return coarsen_mean_plain(x, factors)
    if x.device.type != "cuda":
        raise ValueError(f"x must lie on the CPU or a CUDA device, got {x.device}")
    x = x.contiguous()
    out = torch.empty(shape.out_shape, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(x.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        rc = lib.mvs_coarsen_mean(x.data_ptr(), _DTYPE_CODES[x.dtype], shape.batch,
                                  *shape.spatial, *shape.factors, out.data_ptr(), stream)
    _build.check(lib, rc, "coarsen_mean")
    coarsen_mean.launches += 1
    return out


coarsen_mean.launches = 0
