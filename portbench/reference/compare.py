"""The numbers that compare an output image with its reference."""

from __future__ import annotations

import torch

# rows compared at a time, so that the comparison fits beside the reference
_ROWS = 1 << 24


def image_numbers(got: torch.Tensor, ref: torch.Tensor) -> dict:
    """``max_counts``: the largest absolute difference in counts;
    ``mean_counts``: the mean absolute difference. Shapes must agree (a
    mismatch is reported as an infinite difference)."""
    if tuple(got.shape) != tuple(ref.shape):
        return {"max_counts": float("inf"), "mean_counts": float("inf")}
    g = got.reshape(-1)
    r = ref.to(g.device).reshape(-1)
    worst, total = 0, 0.0
    for i in range(0, g.numel(), _ROWS):
        d = (g[i:i + _ROWS].to(torch.int32) - r[i:i + _ROWS].to(torch.int32)).abs()
        worst = max(worst, int(d.max()))
        total += float(d.sum(dtype=torch.float64))
    return {"max_counts": float(worst), "mean_counts": total / max(1, g.numel())}
