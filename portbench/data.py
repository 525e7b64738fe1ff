"""Inputs of the benchmark, made from ``--seed``.

A configuration describes a grid of tiles sampled from one band-limited
field: white noise under a gaussian of the configuration's ``psf_sigma_px``,
scaled to [0, 1000] counts. A
tile's true position is its grid position plus a sub-pixel jitter, and its
pixels are the field at those (fractional) positions, computed exactly as
the noise under a gaussian centred there, so neighbouring tiles agree in
their overlap to the rounding of the counts. Each tile's stage position
(its metadata origin) is the true one plus a stage error; jitter and error
are drawn uniformly, not in whole pixels, from the seed. The noise and the
tiles are made on the device in a few large calls; the tiles reach the port
as host arrays, as a user holds them (or as zarr arrays, which the zarr job
writes from them).

Every seed gives the same sizes: the seed changes the field, the jitter and
the stage errors, never the number or the shape of the tiles.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

SPATIAL = ("z", "y", "x")


@dataclass
class Grid:
    """A tile grid as the port receives it, with the truth beside it.

    ``tiles``: (V, [C,] *tile) host array in the configured dtype; ``truth``
    and ``meta``: (V, ndim) true and metadata origins in pixels, fractional
    (z first in 3D); ``spacing``: the pixel size, the same on every spatial axis; ``dims``:
    the dims of one tile, channel first."""

    tiles: np.ndarray
    truth: np.ndarray
    meta: np.ndarray
    spacing: float
    dims: tuple

    @property
    def sdims(self) -> tuple:
        return tuple(d for d in self.dims if d in SPATIAL)


def _seed64(seed: int) -> int:
    """``seed`` as an unsigned 64-bit number (any whole number is a seed)."""
    return int(seed) & ((1 << 64) - 1)


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(_seed64(seed))


def grid_extent(config: dict) -> list:
    """The (z,) y, x extent in pixels spanned by the tiles at their grid
    positions."""
    tile, n, overlap = config["tile"], config["grid"], config["overlap"]
    step = [t - overlap[i] for i, t in enumerate(tile)]
    return [(n[i] - 1) * step[i] + tile[i] for i in range(len(tile))]


def radius(sigma: float) -> int:
    """The gaussian's radius in pixels: four widths."""
    return max(1, math.ceil(4 * sigma))


def _taps(frac: np.ndarray, sigma: float, device) -> torch.Tensor:
    """(V, 2 * r + 2) gaussian taps that sample, at offset ``frac`` (V,) in
    [0, 1), the noise crop that starts r = radius(sigma) pixels before the
    sample: tap q weighs crop pixel n + q for sample n, at distance
    frac + r - q."""
    r = radius(sigma)
    q = np.arange(2 * r + 2, dtype=np.float64)
    dist = frac[:, None] + r - q[None, :]
    taps = np.exp(-dist * dist / (2 * sigma**2))
    return torch.from_numpy(taps / taps.sum(axis=1, keepdims=True)).to(device, torch.float32)


def sample_tiles(noise: torch.Tensor, starts: np.ndarray, fracs: np.ndarray, tile,
                 sigma: float) -> torch.Tensor:
    """(V, C, *tile) float32: ``noise`` (C, *extent) under a gaussian of
    ``sigma`` pixels, sampled on a tile's pixel grid whose first pixel lies at
    ``starts + fracs`` (V, ndim; integer and fractional parts) in noise
    pixels."""
    ndim = len(tile)
    r = radius(sigma)
    span = [t + 2 * r + 1 for t in tile]
    crops = torch.stack([
        noise[(slice(None),) + tuple(slice(int(s[d]) - r, int(s[d]) - r + span[d])
                                     for d in range(ndim))]
        for s in starts])
    for d in range(ndim):
        axis = 2 + d
        taps = _taps(fracs[:, d], sigma, noise.device)
        shape = [len(starts)] + [1] * (crops.dim() - 1)
        out = crops.narrow(axis, 0, tile[d]) * taps[:, 0].reshape(shape)
        for q in range(1, taps.shape[1]):
            out.add_(crops.narrow(axis, q, tile[d]) * taps[:, q].reshape(shape))
        crops = out
    return crops


def make_grid(config: dict, seed: int, device) -> Grid:
    """The configuration's tiles for ``seed``.

    ``config`` keys: ``tile`` (spatial shape of a tile), ``grid`` (tiles
    along each spatial axis, 1 where the axis is not tiled), ``overlap``
    (pixels shared by neighbours at their grid positions along each axis),
    ``position_jitter_px`` (the largest distance of a true position from its
    grid position along each axis), ``stage_error_px`` (the largest error of
    a stage position along each axis), ``channels``, ``spacing`` and
    ``dtype`` (uint16)."""
    tile = [int(t) for t in config["tile"]]
    n = [int(g) for g in config["grid"]]
    overlap = [int(o) for o in config["overlap"]]
    ndim = len(tile)
    channels = int(config.get("channels", 1))
    if config.get("dtype", "uint16") != "uint16":
        raise ValueError("the generator makes uint16 tiles")
    step = np.array([t - o for t, o in zip(tile, overlap)], dtype=np.float64)
    jitter = np.array(config.get("position_jitter_px", [0.0] * ndim), dtype=np.float64)
    errors = np.array(config["stage_error_px"], dtype=np.float64)
    sigma = float(config["psf_sigma_px"])
    rng = _rng(seed)
    V = math.prod(n)
    grid_pos = np.array(list(np.ndindex(*n)), dtype=np.float64) * step
    truth = grid_pos + rng.uniform(-1, 1, size=(V, ndim)) * jitter
    meta = truth + rng.uniform(-1, 1, size=(V, ndim)) * errors
    # noise pixel k lies at position k - margin; a tile's crop starts a radius before it
    margin = np.ceil(jitter).astype(np.int64) + radius(sigma) + 1
    extent = [e + 2 * int(m) + 1 for e, m in zip(grid_extent(config), margin)]
    gen = torch.Generator(device=device)
    gen.manual_seed(_seed64(seed))
    noise = torch.rand([channels] + extent, generator=gen, device=device)
    at = truth + margin
    starts = np.floor(at)
    stack = sample_tiles(noise, starts.astype(np.int64), at - starts, tile, sigma)
    del noise
    lo, hi = stack.min(), stack.max()
    stack = ((stack - lo) * (1000.0 / (hi - lo))).to(torch.int32).to(torch.uint16)
    if channels == 1:
        stack = stack[:, 0]
    tiles = stack.cpu().numpy()
    del stack
    sdims = SPATIAL[-ndim:]
    dims = (("c",) if channels > 1 else ()) + sdims
    return Grid(tiles=tiles, truth=truth, meta=meta,
                spacing=float(config.get("spacing", 1.0)), dims=dims)


def channel_names(grid: Grid) -> list:
    return [f"ch{c}" for c in range(grid.tiles.shape[1])] if "c" in grid.dims else None


def to_sims(grid: Grid, transform_key: str, arrays=None) -> list:
    """The tiles as the port's sims, each at its metadata origin (physical
    units) under ``transform_key``; ``arrays`` replaces the host tiles (the
    zarr job's lazy arrays)."""
    from multiview_stitcher_torch import si_utils

    arrays = grid.tiles if arrays is None else arrays
    sp = grid.spacing
    return [
        si_utils.get_sim_from_array(
            arrays[v], dims=list(grid.dims), scale={d: sp for d in grid.sdims},
            translation={d: float(grid.meta[v][i] * sp) for i, d in enumerate(grid.sdims)},
            transform_key=transform_key, c_coords=channel_names(grid),
        )
        for v in range(len(grid.tiles))
    ]
