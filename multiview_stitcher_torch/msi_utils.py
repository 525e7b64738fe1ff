"""Multiscale images: only the test that recognises one.

This package has no multiscale image type yet (ROADMAP.md, queue 1: msims).
An msim is any non-:class:`~.si_utils.Sim` object with the multiscale
interface of ``multiview_stitcher_tpu.msi_utils.Msim`` (a ``sims`` list of
scales and ``get_scale``), so that ``fuse`` can refuse one with a clear error.
"""

from __future__ import annotations

from multiview_stitcher_torch.si_utils import Sim


def is_msim(image) -> bool:
    return (
        not isinstance(image, Sim)
        and hasattr(image, "sims")
        and hasattr(image, "get_scale")
    )
