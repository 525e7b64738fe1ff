"""The port's image filters (``multiview_stitcher_torch.ops.filters``)
against the JAX package's on the CPU.

Inputs are made from a seed with numpy; both sides get the same float32
arrays. Tolerances: rtol 1e-4, atol 1e-3 on data in [0, 100) (the two sides
sum the same float32 products in another order); the min/max filters and the
DCT matrix agree exactly. Each filter runs in every scipy boundary mode and
on an axis shorter than its radius, where the padding reflects or wraps more
than once.
"""

import numpy as np
import pytest
import torch

from multiview_stitcher_torch.ops import filters as tfilters
from multiview_stitcher_torch.utils import misc as tmisc
from multiview_stitcher_tpu.ops import filters as jfilters

MODES = ["reflect", "mirror", "nearest", "wrap", "constant"]
TOL = dict(rtol=1e-4, atol=1e-3)


def _data(shape, seed, nan=False):
    rng = np.random.default_rng(seed)
    x = (rng.random(shape) * 100).astype(np.float32)
    if nan:
        x[tuple(slice(1, 3) for _ in shape)] = np.nan
        x[(-2,) * len(shape)] = np.nan
    return x


# 3D with a z axis of 5 (the radius at sigma 3 is 12) and 2D
SHAPES = [(5, 14, 17), (23, 31)]


def test_gaussian_kernels_match_jax():
    for sigma in (0.7, 1.5, 5, 11):
        for order in (0, 2):
            np.testing.assert_allclose(
                tfilters.gaussian_kernel_1d(sigma, order=order),
                jfilters.gaussian_kernel_1d(sigma, order=order), rtol=1e-12, atol=1e-15,
            )
    with pytest.raises(NotImplementedError):
        tfilters.gaussian_kernel_1d(2.0, order=1)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", SHAPES)
def test_gaussian_filter_matches_jax(mode, shape):
    x = _data(shape, 1)
    for sigma in (1.0, 3.0, [2.0, 0.0, 1.5][-len(shape):]):
        ref = np.asarray(jfilters.gaussian_filter(x, sigma, mode=mode))
        got = tfilters.gaussian_filter(torch.from_numpy(x), sigma, mode=mode).numpy()
        np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", SHAPES)
def test_gaussian_laplace_matches_jax(mode, shape):
    x = _data(shape, 2)
    for sigma in (1.0, 3.0):
        ref = np.asarray(jfilters.gaussian_laplace(x, sigma, mode=mode))
        got = tfilters.gaussian_laplace(torch.from_numpy(x), sigma, mode=mode).numpy()
        np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", SHAPES)
def test_nan_gaussian_filter_matches_jax(mode, shape):
    x = _data(shape, 3, nan=True)
    for sigma in (1.0, 4.0):
        ref = np.asarray(jfilters.nan_gaussian_filter(x, sigma, mode=mode))
        got = tfilters.nan_gaussian_filter(torch.from_numpy(x), sigma, mode=mode).numpy()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
        np.testing.assert_allclose(got[~np.isnan(ref)], ref[~np.isnan(ref)], **TOL)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", SHAPES)
def test_extremum_filters_match_jax(mode, shape):
    x = _data(shape, 4)
    sizes = (3, 4, (2, 7, 3)[-len(shape):], 9)
    for size in sizes:
        for name in ("maximum_filter", "minimum_filter"):
            for cval in (None, 50.0) if mode == "constant" else (None,):
                ref = np.asarray(getattr(jfilters, name)(x, size, mode=mode, cval=cval))
                got = getattr(tfilters, name)(torch.from_numpy(x), size, mode=mode,
                                              cval=cval).numpy()
                np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", SHAPES)
def test_uniform_filter_modes_match_jax(mode, shape):
    """``mode=``, the JAX default "reflect" included, on axes shorter than
    the window (z of 5 at size 7)."""
    x = _data(shape, 4)
    for size in (3, 7):
        ref = np.asarray(jfilters.uniform_filter(x, size, mode=mode))
        got = tfilters.uniform_filter(torch.from_numpy(x), size, mode=mode).numpy()
        np.testing.assert_allclose(got, ref, **TOL)
    batch = np.stack([x, x * 2])
    got = tfilters.uniform_filter(torch.from_numpy(batch), 5, len(shape), mode=mode)
    np.testing.assert_allclose(
        got[1].numpy(), np.asarray(jfilters.uniform_filter(batch[1], 5, mode=mode)), **TOL)


def test_filters_take_leading_batch_axes():
    """``ndim`` filters the trailing axes of each item, as the reference's
    vmap over views does."""
    x = _data((3, 9, 11), 5, nan=True)
    ref = np.stack([np.asarray(jfilters.nan_gaussian_filter(v, 2.0)) for v in x])
    got = tfilters.nan_gaussian_filter(torch.from_numpy(x), 2.0, ndim=2).numpy()
    np.testing.assert_allclose(got[~np.isnan(ref)], ref[~np.isnan(ref)], **TOL)
    clean = np.nan_to_num(x)
    for name, args in (("gaussian_filter", (1.5,)), ("gaussian_laplace", (1.5,)),
                       ("maximum_filter", (3,)), ("minimum_filter", (4,))):
        ref = np.stack([np.asarray(getattr(jfilters, name)(v, *args)) for v in clean])
        got = getattr(tfilters, name)(torch.from_numpy(clean), *args, ndim=2).numpy()
        np.testing.assert_allclose(got, ref, **TOL)


def test_dct_matrix_matches_jax():
    for n in (1, 5, 8, 32):
        np.testing.assert_array_equal(tfilters.dct_matrix(n), jfilters.dct_matrix(n))


@pytest.mark.parametrize("otf", [None, 0.5])
@pytest.mark.parametrize("shape,sizes", [((2, 20, 27), (8, 8)), ((3, 10, 13, 9), (4, 6, 4))])
def test_dct_entropy_quality_matches_jax(otf, shape, sizes):
    """Blocks that do not divide the axes, so that the last block of each
    axis is truncated, NaN samples (filled with the block minimum) and a
    block of NaN alone (under 20 % valid: quality 0)."""
    views = _data(shape, 6)
    views[0, :3, :4] = np.nan
    views[1][tuple(slice(0, s) for s in sizes)] = np.nan
    ref = np.asarray(jfilters.dct_entropy_quality(views, sizes, otf_support_fraction=otf))
    got = tfilters.dct_entropy_quality(
        torch.from_numpy(views), sizes, otf_support_fraction=otf
    ).numpy()
    assert got.shape == ref.shape
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6 * scale)
    assert (got[1][(0,) * len(sizes)] == 0) and (ref[1][(0,) * len(sizes)] == 0)


def test_full_f32_turns_tf32_off_and_restores():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        with tmisc.full_f32():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def test_correlations_and_dcts_run_with_tf32_off(monkeypatch):
    """Every convolution and DCT matmul of the filters runs with TF32 off
    (the reference computes them in float32), whatever the caller set."""
    seen = []
    conv2d = tfilters.F.conv2d

    def spy(*a, **k):
        seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
        return conv2d(*a, **k)

    monkeypatch.setattr(tfilters.F, "conv2d", spy)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    x = torch.from_numpy(_data((6, 9, 10), 7))
    tfilters.nan_gaussian_filter(x, 1.5)
    tfilters.gaussian_laplace(x, 1.0)
    assert seen and not any(a or b for a, b in seen)
    matmul_flags = []
    dct = tfilters.dct_matrix

    def dct_spy(n):
        matmul_flags.append(torch.backends.cuda.matmul.allow_tf32)
        return dct(n)

    monkeypatch.setattr(tfilters, "dct_matrix", dct_spy)
    tfilters.dct_entropy_quality(x[None], (4, 4, 4))
    assert matmul_flags and not any(matmul_flags)
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
