"""Halo and shrinkage declarations of fusion and weights functions, and
the device an entry point runs on.

Copy of the decorators and readers of ``multiview_stitcher_tpu.utils.misc``:
a fusion or weights function declares the chunk halo or the source shrinkage
it needs, and the fusion planner reads the declaration. Also the context in
which matmuls and convolutions run at full float32 precision.
"""

from __future__ import annotations

import contextlib
import inspect

import torch


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


def has_keyword(func, keyword: str) -> bool:
    """Whether ``func`` names ``keyword`` among its parameters. Only named
    parameters count: a ``**kwargs`` catch-all does not signal that a func
    wants a given input."""
    if func is None:
        return False
    try:
        sig = inspect.signature(func)
    except (TypeError, ValueError):
        return False
    return keyword in sig.parameters


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: the CUDA device unless the caller
    names another. Raises where CUDA is asked for and there is none."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "this runs on the CUDA device by default and this machine has "
            "none; pass device='cpu' for the plain PyTorch path"
        )
    return device


@contextlib.contextmanager
def full_f32():
    """Run float32 matmuls and cuDNN convolutions without TF32 inside the
    block (the reference computes them in float32), restoring the caller's
    settings after it."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
