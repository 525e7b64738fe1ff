"""The multi-view cell at a tiny size on the CPU: the faults of
``test_portbench_runs.py`` planted where this cell fuses, in the port's
exact-affine batches (it runs no translation kernel), and the traced run's
readings of the batched tier."""

from __future__ import annotations

import numpy as np
import pytest
import torch

CELL = "lightsheet4v.fuse_views"


def _wrap_batches(monkeypatch, change):
    """Put ``change(orig, args, kwargs)`` behind the port's exact-affine batch."""
    from multiview_stitcher_torch.fusion import _core

    orig = _core._fuse_chunk_batch_kernel_exact
    monkeypatch.setattr(_core, "_fuse_chunk_batch_kernel_exact",
                        lambda *a, **k: change(orig, list(a), k))


def _altered(orig, a, k):
    out = orig(*a, **k)
    flat = out.reshape(-1).to(torch.int32)
    flat[flat.numel() // 2] += 100
    return flat.to(out.dtype).reshape(out.shape)


def _half_left_out(orig, a, k):
    a[7] = np.asarray(a[7]) & (np.asarray(k["tile_idx"]) % 2 == 0)  # view_valid
    return orig(*a, **k)


def _unchanged(orig, a, k):
    return torch.zeros_like(orig(*a, **k))


@pytest.mark.parametrize("fault", [_altered, _half_left_out, _unchanged],
                         ids=["answer_altered", "half_left_out", "output_unchanged"])
def test_a_fault_in_the_exact_tier_is_not_correct(tiny_root, run_tiny, monkeypatch, fault):
    _wrap_batches(monkeypatch, fault)
    rc, line, err = run_tiny(tiny_root, CELL)
    assert rc == 0, err
    assert line["correct"] is False


def test_a_traced_run_reads_the_batched_tier(tiny_root, run_tiny):
    rc, line, err = run_tiny(tiny_root, CELL, trace=1)
    assert rc == 0, err
    assert line["correct"], line["checks"]
    # the host spans of the port's batched tier; the CPU has no device trace
    for name in ("tables_ms.views", "resample_ms.views", "blend_ms.views"):
        assert line["metrics"][name]["value"] > 0
    assert "exact3d_general_roofline" not in line["metrics"]
