"""Halo and shrinkage declarations of fusion and weights functions.

Copy of the decorators and readers of ``multiview_stitcher_tpu.utils.misc``:
a fusion or weights function declares the chunk halo or the source shrinkage
it needs, and the fusion planner reads the declaration.
"""

from __future__ import annotations


def requires_overlap(overlap_spec):
    """Declare that a fusion/weights func needs chunk halo context.

    ``overlap_spec`` is a value or callable(kwargs)->value giving the required
    overlap (int or dict per dim); the fusion planner reads
    ``func.required_overlap``.
    """

    def deco(func):
        func.required_overlap = (
            overlap_spec if callable(overlap_spec) else (lambda kwargs: overlap_spec)
        )
        return func

    return deco


def get_required_overlap(func, kwargs) -> object:
    spec = getattr(func, "required_overlap", None)
    return spec(kwargs) if spec is not None else 0


def get_required_source_shrinkage(func, kwargs) -> object:
    spec = getattr(func, "required_source_shrinkage", None)
    return spec(kwargs) if spec is not None else 0
