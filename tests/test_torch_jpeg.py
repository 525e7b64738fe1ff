"""The port's baseline JPEG decoder (``io/jpeg.py``) against the JAX
package's and PIL / libjpeg.

Both packages decode the same PIL-encoded streams; their outputs must be
equal bit for bit, and within the JAX package's own tolerances of PIL's
(1 count for grayscale, 2-4 for subsampled colour).
"""

import io

import numpy as np
import pytest
from PIL import Image

from multiview_stitcher_torch.io import czi_utils as tczi
from multiview_stitcher_torch.io import jpeg as tjpeg
from multiview_stitcher_tpu.io import czi_utils as jczi
from multiview_stitcher_tpu.io import jpeg as jjpeg


def _smooth(shape, seed=0):
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(seed)
    return gaussian_filter(rng.random(shape) * 255, 2).astype(np.uint8)


def _encode(arr, mode, **kw):
    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def _pil_decode(data):
    return np.asarray(Image.open(io.BytesIO(data)))


def _check(data, tol, shape=None):
    ours = tjpeg.decode_jpeg(data)
    ref = jjpeg.decode_jpeg(data)
    assert ours.dtype == ref.dtype == np.uint8
    np.testing.assert_array_equal(ours, ref)
    if shape is not None:
        assert ours.shape == shape
    assert np.abs(ours.astype(int) - _pil_decode(data).astype(int)).max() <= tol
    return ours


@pytest.mark.parametrize("quality", [95, 75, 30])
def test_grayscale_matches_jax_and_pil(quality):
    img = _smooth((96, 120))
    _check(_encode(img, "L", quality=quality), 1, img.shape)


@pytest.mark.parametrize("subsampling,tol", [(0, 2), (1, 4), (2, 4)], ids=["444", "422", "420"])
def test_rgb_subsampling_matches_jax_and_pil(subsampling, tol):
    img = _smooth((96, 120))
    rgb = np.stack([img, img[::-1], np.roll(img, 13, axis=1)], -1)
    _check(_encode(rgb, "RGB", quality=85, subsampling=subsampling), tol, rgb.shape)


@pytest.mark.parametrize("blocks", [1, 4, 7])
def test_restart_markers(blocks):
    img = _smooth((96, 120), seed=3)
    _check(_encode(img, "L", quality=85, restart_marker_blocks=blocks), 1, img.shape)


@pytest.mark.parametrize("shape", [(93, 101), (8, 8), (17, 5)])
def test_odd_dimensions(shape):
    img = _smooth(shape, seed=5)
    _check(_encode(img, "L", quality=90), 1, shape)


def test_progressive_raises():
    data = _encode(_smooth((32, 32)), "L", quality=85, progressive=True)
    for dec in (tjpeg.decode_jpeg, jjpeg.decode_jpeg):
        with pytest.raises(NotImplementedError, match="baseline"):
            dec(data)


def test_not_a_jpeg_raises():
    with pytest.raises(ValueError, match="SOI"):
        tjpeg.decode_jpeg(b"\x00\x01\x02\x03")
    with pytest.raises(ValueError, match="no scan"):
        tjpeg.decode_jpeg(b"\xff\xd8\xff\xd9")


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_czi_subblock_dispatch_decodes_jpeg(dtype):
    """Compression id 1 goes through the built-in JPEG decoder, cast to the
    subblock's pixel type."""
    img = _smooth((64, 80), seed=7)
    data = _encode(img, "L", quality=92)
    out = tczi._decompress_subblock(data, 1, dtype)
    assert out == jczi._decompress_subblock(data, 1, dtype)
    got = np.frombuffer(out, dtype).reshape(64, 80)
    assert np.abs(got.astype(int) - _pil_decode(data).astype(int)).max() <= 1


def test_huffman_tables_and_extend_match_jax():
    counts = [0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]
    symbols = bytes(range(12))
    t, j = tjpeg._Huff(counts, symbols), jjpeg._Huff(counts, symbols)
    assert t.lookup == j.lookup and t.max_len == j.max_len
    for v in range(0, 64):
        for n in range(0, 7):
            assert tjpeg._extend(v, n) == jjpeg._extend(v, n)
