"""Plain resolution pyramid of an OME-Zarr: each level halves every spatial
axis whose half would still exceed 100 pixels (the others keep their size),
and holds the means of the level before over those blocks (the trailing
rows that fill no block dropped), cut back to the input dtype by truncation.
Means are taken in ``dtype`` (float64 for the reference)."""

from __future__ import annotations

import torch

MIN_SHAPE = 100


def level_factors(shape) -> list:
    """Per level after level 0, its factor on each axis relative to the level
    before."""
    factors = []
    shape = list(shape)
    while True:
        rel = [2 if s // 2 > MIN_SHAPE else 1 for s in shape]
        if max(rel) == 1:
            return factors
        factors.append(rel)
        shape = [s // f for s, f in zip(shape, rel)]


def coarsen(level: torch.Tensor, factors, dtype=torch.float64) -> torch.Tensor:
    """Block means of ``level`` (spatial axes last) over ``factors``."""
    lead = level.dim() - len(factors)
    trimmed = level[(slice(None),) * lead
                    + tuple(slice(0, (s // f) * f) for s, f in zip(level.shape[lead:], factors))]
    shape = list(trimmed.shape[:lead])
    axes = []
    for i, (s, f) in enumerate(zip(trimmed.shape[lead:], factors)):
        shape += [s // f, f]
        axes.append(lead + 2 * i + 1)
    mean = trimmed.to(dtype).reshape(shape).mean(dim=tuple(axes))
    info = torch.iinfo(level.dtype)
    return mean.to(torch.float64).clamp(info.min, info.max).to(torch.int64).to(level.dtype)


def pyramid(level0: torch.Tensor, ndim: int, dtype=torch.float64) -> list:
    """Levels 1 and up of ``level0`` (its last ``ndim`` axes spatial)."""
    levels = []
    prev = level0
    for rel in level_factors(level0.shape[-ndim:]):
        prev = coarsen(prev, rel, dtype)
        levels.append(prev)
    return levels
