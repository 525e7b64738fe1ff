"""Plain translation fusion: the weighted average of translated tiles under
cosine-tapered blending weights, in plain PyTorch.

Written from the semantics, not from the port: each tile is placed at its
world origin on the output grid of the union of all tiles (the output
spacing is the tiles' spacing); an output pixel takes from a tile the linear
interpolation of the tile at its position, where that position lies inside
the tile; the tile's blending weight there is the multilinear interpolation
(zero outside) of a 5^ndim grid that holds, at node ``i``, the anisotropic
distance to the grid's border ``min_d(min(i_d, 4 - i_d) * s_d)``, with the
grid spanning the tile widened by one pixel on each side and ``s_d`` its node
spacing over the blending width; a weight below 1 is shaped by
``(cos((1 - w) * pi) + 1) / 2``. The fused value is the weight-normalised sum,
or the plain mean of the tiles that hold the pixel where every weight is 0,
cut to the output dtype (truncated toward 0, saturated).

Everything runs in ``dtype``: float32 for the reference, a lower precision
for the control.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SPATIAL = ("z", "y", "x")
# the blending width on each axis, in physical units
BLENDING_WIDTHS = {"z": 3.0, "y": 10.0, "x": 10.0}


def output_geometry(origins: np.ndarray, tile_shape, spacing: float):
    """(origin, shape) of the union of tiles at world ``origins`` (V, ndim,
    physical units) on a grid of ``spacing``: the lowest origin, and the
    pixels up to the highest last pixel centre."""
    origins = np.asarray(origins, dtype=np.float64)
    lo = origins.min(axis=0)
    hi = (origins + (np.asarray(tile_shape) - 1) * spacing).max(axis=0)
    shape = np.floor((hi - lo) / spacing + 1e-9).astype(np.int64) + 1
    return lo, tuple(int(s) for s in shape)


def _support_grid(tile_shape, spacing, sdims, device, dtype) -> torch.Tensor:
    """The 5^ndim border-distance grid of a tile of ``tile_shape``."""
    axes = []
    for n, d in zip(tile_shape, sdims):
        node = (n + 1) / 4 * spacing  # the grid spans the tile and one pixel more a side
        s = node / BLENDING_WIDTHS[d]
        axes.append(torch.tensor([min(i, 4 - i) * s for i in range(5)], dtype=torch.float64))
    grid = axes[0].reshape((5,) + (1,) * (len(axes) - 1))
    for k, a in enumerate(axes[1:], start=1):
        shape = [1] * len(axes)
        shape[k] = 5
        grid = torch.minimum(grid, a.reshape(shape))
    return grid.to(device=device, dtype=dtype)


def _hats(coord: torch.Tensor) -> torch.Tensor:
    """(len(coord), 5) linear-interpolation weights of grid nodes 0..4 at
    ``coord`` (zero beyond one node outside the grid)."""
    nodes = torch.arange(5, device=coord.device, dtype=coord.dtype)
    return torch.clamp(1 - torch.abs(coord[:, None] - nodes[None, :]), min=0)


def _taper(w: torch.Tensor) -> torch.Tensor:
    shaped = (torch.cos((1 - w) * math.pi) + 1) / 2
    return torch.clamp(torch.where(w < 1, shaped, w), 0, 1)


def _weight(tile_shape, coords, grid) -> torch.Tensor:
    """The tapered blending weight of a tile at pixel coordinates ``coords``
    (one 1-D tensor an axis, in the tile's pixels)."""
    hats = [_hats((c + 1) * (4.0 / (n + 1))) for c, n in zip(coords, tile_shape)]
    if len(hats) == 2:
        raw = torch.einsum("ai,ij,bj->ab", hats[0], grid, hats[1])
    else:
        raw = torch.einsum("ai,bj,ck,ijk->abc", hats[0], hats[1], hats[2], grid)
    return _taper(raw)


def _lerp_axis(block: torch.Tensor, axis: int, n: int, frac: float) -> torch.Tensor:
    """``n`` samples along ``axis`` at ``i + frac`` for i = 0..n-1."""
    lo = block.narrow(axis, 0, n)
    if frac == 0.0:
        return lo
    return lo * (1 - frac) + block.narrow(axis, 1, n) * frac


def _to_dtype_out(res: torch.Tensor, out_dtype) -> torch.Tensor:
    res = torch.nan_to_num(res.to(torch.float32))
    info = torch.iinfo(out_dtype)
    return res.clamp(info.min, info.max).to(torch.int32).to(out_dtype)


def fuse(tiles: torch.Tensor, origins, spacing: float, dtype=torch.float32,
         out_dtype=torch.uint16):
    """Fuse ``tiles`` ((V, *tile) or (V, C, *tile), on their device) placed
    at world ``origins`` ((V, ndim), physical units). Returns the fused
    ([C,] *shape) tensor in ``out_dtype`` on the tiles' device, with the
    output's origin and shape."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # the weights' einsum stays in dtype
    try:
        return _fuse(tiles, origins, spacing, dtype, out_dtype)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _fuse(tiles, origins, spacing, dtype, out_dtype):
    origins = np.asarray(origins, dtype=np.float64)
    ndim = origins.shape[1]
    channels = tiles.dim() - 1 > ndim
    if not channels:
        tiles = tiles[:, None]
    tile_shape = tuple(int(s) for s in tiles.shape[2:])
    sdims = SPATIAL[-ndim:]
    device = tiles.device
    out_origin, out_shape = output_geometry(origins, tile_shape, spacing)
    grid = _support_grid(tile_shape, spacing, sdims, device, dtype)
    outs = []
    for c in range(tiles.shape[1]):
        acc = torch.zeros(out_shape, device=device, dtype=dtype)
        wsum = torch.zeros_like(acc)
        vacc = torch.zeros_like(acc)
        vcnt = torch.zeros_like(acc)
        weights = {}
        for v in range(tiles.shape[0]):
            # tile pixel of output pixel o: o + base, base = (out_origin - origin) / spacing
            base = (out_origin - origins[v]) / spacing
            region, src, fracs = [], [], []
            for d in range(ndim):
                n0 = math.floor(base[d])
                f = float(base[d] - n0)
                if f < 1e-9:
                    f = 0.0
                last = tile_shape[d] - 1 - (1 if f > 0 else 0)  # last tile index sampled
                o_lo, o_hi = max(0, -n0), min(out_shape[d] - 1, last - n0)
                if o_hi < o_lo:
                    break
                region.append(slice(o_lo, o_hi + 1))
                src.append((o_lo + n0, o_hi - o_lo + 1))
                fracs.append(f)
            else:
                block = tiles[v, c][tuple(slice(i0, i0 + n + (1 if f > 0 else 0))
                                          for (i0, n), f in zip(src, fracs))].to(dtype)
                for d in range(ndim):
                    block = _lerp_axis(block, d, src[d][1], fracs[d])
                key = tuple(src) + tuple(fracs)
                if key not in weights:
                    if len(weights) >= 8:  # fractional offsets give every tile its own
                        weights.clear()
                    coords = [torch.arange(i0, i0 + n, device=device, dtype=torch.float64) + f
                              for (i0, n), f in zip(src, fracs)]
                    weights[key] = _weight(tile_shape, [x.to(dtype) for x in coords], grid)
                w = weights[key]
                r = tuple(region)
                acc[r] += w * block
                wsum[r] += w
                vacc[r] += block
                vcnt[r] += 1
        res = torch.where(wsum > 0, acc / torch.clamp(wsum, min=1e-12),
                          vacc / torch.clamp(vcnt, min=1.0))
        del acc, wsum, vacc, vcnt
        outs.append(_to_dtype_out(res, out_dtype))
        del res
    out = torch.stack(outs) if channels else outs[0]
    return out, out_origin, out_shape
