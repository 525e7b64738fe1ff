"""The frozen arithmetic of roofline shares.

A fusion job's kernel bytes are its tiles read once and its output written
once, from the job's shapes alone, whatever the kernel reads again and
whatever implements it. The least time those bytes take is their count over
the H100's published HBM bandwidth (NVIDIA's data sheet, SXM part), which
assumes the card's full power limit of 700 W; the harness prints the card's
own limit beside every run."""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12


def fusion_bytes(n_tiles: int, tile_shape, out_shape, channels: int = 1,
                 itemsize: int = 2, out_itemsize: int = 2) -> int:
    """Bytes of a translation fusion: every channel of every tile read once,
    every channel of the output written once."""
    return channels * (n_tiles * math.prod(tile_shape) * itemsize
                       + math.prod(out_shape) * out_itemsize)


def share_pct(nbytes: float, seconds: float) -> float | None:
    """Share of the bandwidth bound that ``nbytes`` moved in ``seconds`` of
    kernel time reach, in percent; None without kernel time."""
    if not seconds or seconds <= 0:
        return None
    return 100.0 * nbytes / HBM_BYTES_PER_S / seconds
