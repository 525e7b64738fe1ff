"""Judges resolved tile positions against the generator's truth, and a
plain registration of whole pixels for the control.

The generator samples every tile from one field at a known position, so the
right registration is known exactly: tile ``v``'s world origin, after its
resolved affine, must be its true origin plus one offset shared by all
tiles (registration fixes positions only up to that offset).

The plain registration correlates the overlap of each pair of grid
neighbours at whole-pixel precision and composes the pairwise offsets along
the fewest links from the centre tile: the program's registration (phase
correlation refined to a tenth of a pixel, shortest-paths resolution) with
the refinement left out, the step a later change that wants faster pairwise
registration would be tempted to take."""

from __future__ import annotations

import numpy as np


def placed_origins(affines, meta_px, spacing: float) -> np.ndarray:
    """World origins in pixels of tiles whose metadata origins are
    ``meta_px`` (V, ndim), after their resolved ``affines`` (V, ndim+1,
    ndim+1; physical units)."""
    affines = np.asarray(affines, dtype=np.float64)
    ndim = affines.shape[-1] - 1
    meta = np.asarray(meta_px, dtype=np.float64) * spacing
    placed = np.einsum("vij,vj->vi", affines[:, :ndim, :ndim], meta) + affines[:, :ndim, ndim]
    return placed / spacing


def link_error_px(affines, meta_px, truth_px, spacing: float, pairs) -> float:
    """The median over the links between grid neighbours of how far, in
    pixels along the worst axis, the resolved position of one tile relative
    to the other lies from the truth (an offset shared by all tiles does not
    count)."""
    placed = placed_origins(affines, meta_px, spacing)
    truth = np.asarray(truth_px, dtype=np.float64)
    a, b = np.asarray(pairs).T
    err = (placed[b] - placed[a]) - (truth[b] - truth[a])
    return float(np.median(np.abs(err).max(axis=1)))


def grid_pairs(grid) -> list:
    """(a, b) tile indices of neighbours along each tiled axis of a grid of
    ``grid`` tiles (C order, as the generator numbers them)."""
    idx = np.arange(int(np.prod(grid))).reshape(grid)
    pairs = []
    for d in range(len(grid)):
        if grid[d] < 2:
            continue
        a = idx.take(range(grid[d] - 1), axis=d).ravel()
        b = idx.take(range(1, grid[d]), axis=d).ravel()
        pairs += list(zip(a.tolist(), b.tolist()))
    return pairs


def cross_correlation_shift_px(fixed: np.ndarray, moving: np.ndarray) -> np.ndarray:
    """The whole-pixel shift ``s`` with ``moving[x] ~ fixed[x - s]``: the
    peak of the (circular) cross-correlation of the two mean-free crops, in
    float64 through the FFT."""
    f = np.fft.fftn(fixed.astype(np.float64) - fixed.mean())
    m = np.fft.fftn(moving.astype(np.float64) - moving.mean())
    corr = np.abs(np.fft.ifftn(f * np.conj(m)))
    peak = np.array(np.unravel_index(int(corr.argmax()), corr.shape), dtype=np.float64)
    shape = np.array(corr.shape, dtype=np.float64)
    return np.where(peak > shape / 2, peak - shape, peak)


def pairwise_offsets(tiles: np.ndarray, meta_px, pairs) -> np.ndarray:
    """(P, ndim) estimates of ``truth[b] - truth[a]`` for each pair: the
    metadata offset rounded to whole pixels, plus the whole-pixel
    cross-correlation shift of the two tiles' overlap there."""
    meta = np.asarray(meta_px, dtype=np.float64)
    shape = np.array(tiles.shape[1:])
    out = []
    for a, b in pairs:
        di = np.round(meta[b] - meta[a]).astype(np.int64)
        lo_a, lo_b = np.maximum(0, di), np.maximum(0, -di)
        n = shape - np.abs(di)
        ca = tiles[a][tuple(slice(int(o), int(o + k)) for o, k in zip(lo_a, n))]
        cb = tiles[b][tuple(slice(int(o), int(o + k)) for o, k in zip(lo_b, n))]
        out.append(di + cross_correlation_shift_px(ca, cb))
    return np.asarray(out)


def shortest_path_positions(n_tiles: int, pairs, offsets, root: int = 0) -> np.ndarray:
    """(V, ndim) positions that compose the pairwise ``offsets`` along the
    fewest links from tile ``root`` (breadth first, links in the given
    order), as shortest-paths resolution does from its reference tile."""
    links: dict = {v: [] for v in range(n_tiles)}
    for (a, b), off in zip(pairs, np.asarray(offsets, dtype=np.float64)):
        links[a].append((b, off))
        links[b].append((a, -off))
    pos = {root: np.zeros(np.asarray(offsets).shape[1])}
    queue = [root]
    for v in queue:
        for w, off in links[v]:
            if w not in pos:
                pos[w] = pos[v] + off
                queue.append(w)
    if len(pos) != n_tiles:
        raise ValueError("the tiles do not form one connected grid")
    return np.stack([pos[v] for v in range(n_tiles)])


def translation_affines(positions_px, meta_px, spacing: float) -> np.ndarray:
    """(V, ndim+1, ndim+1) translations (physical units) that move each tile
    from its metadata origin to ``positions_px``."""
    pos = np.asarray(positions_px, dtype=np.float64)
    ndim = pos.shape[1]
    affines = np.repeat(np.eye(ndim + 1)[None], len(pos), axis=0)
    affines[:, :ndim, ndim] = (pos - np.asarray(meta_px, dtype=np.float64)) * spacing
    return affines
