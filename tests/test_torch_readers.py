"""The port's readers against the JAX package's, on files the tests write.

Every reader of ``multiview_stitcher_torch.io`` is held to its counterpart
in ``multiview_stitcher_tpu.io`` on the same file, written here from a
seeded numpy generator: TIFF (every compression, ImageJ hyperstacks, the
virtual zarr-v3 store), CZI (ZISRAW files written by :func:`write_czi`: a
mosaic with channels and z in raw, ZSTD0, ZSTD1, ZSTD1 hi/lo and JPEG
subblocks, two scenes, and a multi-view file with ``View`` and
``CenterPosition`` metadata), Imaris, PNG / GIF / BMP and the aicsimageio
seam. Arrays and sims must be equal bit for bit (dims, spacing, origin,
coords, affines); the multi-view affines of both initialisation modes within
1e-12. The native TIFF decoders are held to the Python ones and to the JAX
package's. The lazy arrays of the readers go through the port's tiers that
read lazy views (streaming, host slabs, ``register(device_tiles=True)``) on
the CPU, and a small CZI mosaic through ``stitch(device="cpu")``, held to
the JAX ``register`` within 1e-3 and its ``fuse`` within 1 count.
"""

from __future__ import annotations

import importlib.util
import json
import struct
import subprocess
import sys
import threading
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

import multiview_stitcher_torch as tpkg
from multiview_stitcher_torch import io as tio
from multiview_stitcher_torch import msi_utils as tmsi
from multiview_stitcher_torch import registration as treg
from multiview_stitcher_torch import si_utils as tsi
from multiview_stitcher_torch.fusion import _core as tcore
from multiview_stitcher_torch.fusion import fuse as tfuse
from multiview_stitcher_torch.io import codecs as tcodecs
from multiview_stitcher_torch.io import czi_utils as tczi
from multiview_stitcher_torch.io import tif_utils as ttif
from multiview_stitcher_torch.stitch import stitch as tstitch
from multiview_stitcher_tpu import io as jio
from multiview_stitcher_tpu import msi_utils as jmsi
from multiview_stitcher_tpu import registration as jreg
from multiview_stitcher_tpu.fusion import fuse as jfuse
from multiview_stitcher_tpu.io import codecs as jcodecs
from multiview_stitcher_tpu.io import czi_utils as jczi
from multiview_stitcher_tpu.io import tif_utils as jtif

REPO = Path(__file__).resolve().parent.parent
KEY = tczi.METADATA_TRANSFORM_KEY
UINT_COUNTS = 1


# ---------------------------------------------------------------------------
# the ZISRAW writer of chip_smoke.py, whose readers: phase writes its CZI
# files with it too
# ---------------------------------------------------------------------------

_spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
czi_xml = chip_smoke.czi_metadata_xml
PIXEL_TYPES = {np.dtype(np.uint8): 0, np.dtype(np.uint16): 1, np.dtype(np.float32): 2}


def write_czi(path, planes, xml: str) -> None:
    """Write a ZISRAW (CZI) file with ``chip_smoke.write_czi``. ``planes``
    holds (dims, dtype, compression, payload): ``dims`` maps each dimension
    letter to (start, size), the payload is the (compressed) pixel bytes."""
    chip_smoke.write_czi(path, xml, [(dims, PIXEL_TYPES[np.dtype(dtype)], comp, payload)
                                     for dims, dtype, comp, payload in planes])


def _zstd(raw: bytes) -> bytes:
    import zstandard

    return zstandard.ZstdCompressor().compress(raw)


def _jpeg(plane: np.ndarray) -> bytes:
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(plane, "L").save(buf, format="JPEG", quality=90)
    return buf.getvalue()


def encode_subblock(plane: np.ndarray, mode: str):
    """(compression id, payload) of a plane in one of the CZI encodings."""
    raw = np.ascontiguousarray(plane).tobytes()
    if mode == "raw":
        return 0, raw
    if mode == "zstd0":
        return 5, _zstd(raw)
    if mode == "zstd1":
        return 6, bytes([1]) + _zstd(raw)
    if mode == "zstd1_hilo":
        packed = raw[0::2] + raw[1::2]
        return 6, bytes([3, 1, 1]) + _zstd(packed)
    if mode == "jpeg":
        return 1, _jpeg(plane)
    raise ValueError(mode)


def smooth_image(rng, shape, sigma=2.0, scale=4000.0, dtype=np.uint16):
    from scipy.ndimage import gaussian_filter

    d = gaussian_filter(rng.random(shape), sigma)
    d -= d.min()
    return (d * (scale / max(d.max(), 1e-12))).astype(dtype)


MOSAIC_TILE = (3, 24, 32)  # z, y, x
MOSAIC_SPACING = {"X": 0.5, "Y": 0.5, "Z": 2.0}


def write_mosaic(path, mode="raw", scenes=1, seed=0, has_z=True):
    """2 x 2 tiles of 2 channels (and z), cut from one smooth volume at
    their stage positions; returns the tiles as (scene, m) -> (c, z, y, x)."""
    rng = np.random.default_rng(seed)
    dtype = np.uint8 if mode == "jpeg" else np.uint16
    nz, ny, nx = MOSAIC_TILE if has_z else (1,) + MOSAIC_TILE[1:]
    planes, tiles = [], {}
    for s in range(scenes):
        vol = smooth_image(rng, (2, nz, 2 * ny, 2 * nx), scale=250 if dtype == np.uint8 else 4000,
                           dtype=dtype)
        for m, (iy, ix) in enumerate([(0, 0), (0, 1), (1, 0), (1, 1)]):
            y0, x0 = iy * (ny - 6), ix * (nx - 8)
            tile = np.ascontiguousarray(vol[:, :, y0:y0 + ny, x0:x0 + nx])
            tiles[(s, m)] = tile
            for c in range(2):
                for z in range(nz):
                    comp, payload = encode_subblock(tile[c, z], mode)
                    dims = {"X": (x0 + 100, nx), "Y": (y0 - 50, ny), "C": (c, 1), "Z": (z, 1),
                            "M": (m, 1), "S": (s, 1)}
                    planes.append((dims, dtype, comp, payload))
    xml = czi_xml(MOSAIC_SPACING, ["DAPI", "GFP"])
    write_czi(path, planes, xml)
    return tiles


MV_SHAPE = (6, 20, 16)
MV_VIEWS = [(10.0, 5.0, 3.0, 0.0), (10.5, 5.2, 3.1, 90.0), (9.0, 14.0, 2.0, 180.0),
            (11.0, 14.4, 4.0, 270.0)]


def write_multiview(path, seed=1):
    """Four views of (c=1, z, y, x) uint16 with View positions and angles,
    two y groups, and a CenterPosition; returns the views."""
    rng = np.random.default_rng(seed)
    views = []
    planes = []
    for v in range(len(MV_VIEWS)):
        data = smooth_image(rng, MV_SHAPE)
        views.append(data[None])
        for z in range(MV_SHAPE[0]):
            dims = {"X": (0, MV_SHAPE[2]), "Y": (0, MV_SHAPE[1]), "C": (0, 1), "Z": (z, 1),
                    "M": (0, 1), "S": (0, 1), "V": (v, 1)}
            planes.append((dims, np.uint16, 0, data[z].tobytes()))
    xml = czi_xml({"X": 1.0, "Y": 1.0, "Z": 2.5}, ["Ch0"], views=MV_VIEWS,
                  center=(8.0, 9.0, 4.0))
    write_czi(path, planes, xml)
    return views


# ---------------------------------------------------------------------------
# comparing the packages' outputs
# ---------------------------------------------------------------------------


def assert_sims_equal(t, j, affine_atol=0.0):
    assert tuple(t.dims) == tuple(j.dims)
    assert t.spacing == j.spacing
    assert t.origin == j.origin
    assert set(t.coords) == set(j.coords)
    for d in j.coords:
        np.testing.assert_array_equal(np.asarray(t.coords[d]), np.asarray(j.coords[d]))
    assert set(t.transforms) == set(j.transforms)
    for k in j.transforms:
        np.testing.assert_allclose(np.asarray(t.transforms[k].data),
                                   np.asarray(j.transforms[k].data), rtol=0, atol=affine_atol)
    assert type(t.data).__name__ == type(j.data).__name__
    assert tuple(t.data.shape) == tuple(j.data.shape)
    assert np.dtype(t.data.dtype) == np.dtype(j.data.dtype)
    tv, jv = np.asarray(t.data), np.asarray(j.data)
    assert tv.dtype == jv.dtype
    np.testing.assert_array_equal(tv, jv)


def assert_lists_equal(ts, js, affine_atol=0.0):
    assert len(ts) == len(js)
    for t, j in zip(ts, js):
        assert_sims_equal(t, j, affine_atol)


# ---------------------------------------------------------------------------
# TIFF
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32, np.int16])
def test_tiff_roundtrip_matches_jax(tmp_path, dtype):
    data = (np.random.default_rng(0).random((3, 20, 30)) * 100).astype(dtype)
    tpath, jpath = tmp_path / "t.tif", tmp_path / "j.tif"
    ttif.write_tiff(tpath, data)
    jtif.write_tiff(jpath, data)
    assert tpath.read_bytes() == jpath.read_bytes()
    back = ttif.TiffFile(jpath).asarray()
    assert back.dtype == data.dtype
    np.testing.assert_array_equal(back, data)
    np.testing.assert_array_equal(back, jtif.TiffFile(tpath).asarray())


def test_lazy_pages_match_jax(tmp_path):
    path = tmp_path / "lazy.tif"
    data = np.random.default_rng(1).integers(0, 1000, (5, 16, 16), dtype=np.uint16)
    ttif.write_tiff(path, data)
    t, j = ttif.LazyTiffPages(path), jtif.LazyTiffPages(path)
    assert t.shape == j.shape == (5, 16, 16) and t.dtype == j.dtype and t.ndim == 3
    for key in (2, (slice(1, 3), slice(4, 8), slice(None)), (Ellipsis, 3), (slice(None, None, 2),)):
        np.testing.assert_array_equal(t[key], j[key])
        np.testing.assert_array_equal(t[key], data[key])
    np.testing.assert_array_equal(np.asarray(t, dtype=np.float32), np.asarray(j, dtype=np.float32))


def test_sim_roundtrip_matches_jax(tmp_path):
    data = np.random.default_rng(2).integers(0, 1000, (2, 4, 12, 14), dtype=np.uint16)
    scale = {"z": 2.0, "y": 0.5, "x": 0.5}
    tsim = tsi.get_sim_from_array(data, dims=("c", "z", "y", "x"), scale=scale)
    from multiview_stitcher_tpu import si_utils as jsi

    jsim = jsi.get_sim_from_array(data, dims=("c", "z", "y", "x"), scale=scale)
    ttif.save_sim_as_tif(tmp_path / "t.tif", tsim)
    tio.save_sim_as_tif(tmp_path / "u.tif", tsim)
    jtif.save_sim_as_tif(tmp_path / "j.tif", jsim)
    assert (tmp_path / "t.tif").read_bytes() == (tmp_path / "j.tif").read_bytes()
    assert (tmp_path / "u.tif").read_bytes() == (tmp_path / "j.tif").read_bytes()
    kw = dict(scale=scale, translation={"z": 1.0, "y": -2.0, "x": 3.5})
    for lazy in (True, False):
        t = ttif.read_tiff_into_sim(tmp_path / "j.tif", lazy=lazy, **kw)
        j = jtif.read_tiff_into_sim(tmp_path / "j.tif", lazy=lazy, **kw)
        assert_sims_equal(t, j)
        assert t.dims == ("z", "y", "x")
        np.testing.assert_array_equal(t.to_numpy(), data.reshape(8, 12, 14))


def test_read_tif_into_msim_and_dispatch_match_jax(tmp_path):
    data = np.random.default_rng(3).integers(0, 1000, (4, 12, 14), dtype=np.uint16)
    path = tmp_path / "s.tiff"
    ttif.write_tiff(path, data, compression="deflate")
    kw = dict(scale={"z": 2.0, "y": 0.5, "x": 0.5})
    for tfn, jfn in ((tio.read_tif_into_msim, jio.read_tif_into_msim),
                     (ttif.read_tif_into_msim, jtif.read_tif_into_msim)):
        tm, jm = tfn(path, **kw), jfn(path, **kw)
        assert len(tm.sims) == len(jm.sims)
        assert_lists_equal(tm.sims, jm.sims)
    assert_lists_equal(tio.read_mosaic_into_sims(path), jio.read_mosaic_into_sims(path))


# ---------------------------------------------------------------------------
# TIFF codecs
# ---------------------------------------------------------------------------


def _codec_data(dtype=np.uint8):
    rng = np.random.default_rng(7)
    a = np.repeat(rng.integers(0, 200, (20, 8)), 5, axis=1)
    return (a + np.arange(40)[None, :]).astype(dtype)


@pytest.mark.parametrize("pil_comp", ["tiff_lzw", "packbits", "tiff_adobe_deflate"])
def test_read_pil_written_matches_jax(tmp_path, pil_comp):
    from PIL import Image

    data = _codec_data()
    path = tmp_path / f"{pil_comp}.tif"
    Image.fromarray(data).save(path, compression=pil_comp)
    got = ttif.TiffFile(path).read_page(0)
    np.testing.assert_array_equal(got, data)
    np.testing.assert_array_equal(got, jtif.TiffFile(path).read_page(0))


def test_read_pil_lzw_16bit_with_predictor(tmp_path):
    from PIL import Image

    data = _codec_data(np.uint16) * 37
    path = tmp_path / "lzw16.tif"
    Image.fromarray(data).save(path, compression="tiff_lzw")
    np.testing.assert_array_equal(ttif.TiffFile(path).read_page(0), data)
    # predictor 2 on the same bytes, written by hand: differences along rows
    diff = np.diff(data.astype(np.int64), axis=-1, prepend=0).astype(np.uint16)
    ttif.write_tiff(tmp_path / "p.tif", diff, compression="deflate")
    raw = bytearray((tmp_path / "p.tif").read_bytes())
    entries = struct.unpack_from("<H", raw, 8)[0]
    # the PHOTOMETRIC entry (tag 262) rewritten as PREDICTOR (317) = 2
    for i in range(entries):
        off = 10 + 12 * i
        if struct.unpack_from("<H", raw, off)[0] == 262:
            struct.pack_into("<HHII", raw, off, 317, 3, 1, 2)
    (tmp_path / "p.tif").write_bytes(bytes(sorted_ifd(raw)))
    t = ttif.TiffFile(tmp_path / "p.tif").read_page(0)
    np.testing.assert_array_equal(t, data)
    np.testing.assert_array_equal(t, jtif.TiffFile(tmp_path / "p.tif").read_page(0))


def sorted_ifd(raw: bytearray) -> bytearray:
    """The first IFD's entries sorted by tag, as TIFF requires."""
    n = struct.unpack_from("<H", raw, 8)[0]
    entries = sorted((bytes(raw[10 + 12 * i:22 + 12 * i]) for i in range(n)),
                     key=lambda e: struct.unpack_from("<H", e)[0])
    raw[10:10 + 12 * n] = b"".join(entries)
    return raw


@pytest.mark.parametrize("comp", ["lzw", "packbits", "deflate", "zlib"])
def test_write_read_roundtrip_matches_jax(tmp_path, comp):
    data = np.stack([_codec_data(np.uint16) * 3, _codec_data(np.uint16)])
    tpath, jpath = tmp_path / "t.tif", tmp_path / "j.tif"
    ttif.write_tiff(tpath, data, compression=comp)
    jtif.write_tiff(jpath, data, compression=comp)
    assert tpath.read_bytes() == jpath.read_bytes()
    np.testing.assert_array_equal(np.asarray(ttif.LazyTiffPages(tpath)), data)


@pytest.mark.parametrize("comp", ["tiff_lzw", "packbits"])
def test_our_encoding_readable_by_pil(tmp_path, comp):
    from PIL import Image

    data = _codec_data()
    path = tmp_path / f"ours_{comp}.tif"
    ttif.write_tiff(path, data, compression={"tiff_lzw": "lzw", "packbits": "packbits"}[comp])
    np.testing.assert_array_equal(np.asarray(Image.open(path)), data)


def test_unknown_compression_raises(tmp_path):
    with pytest.raises(ValueError, match="Unknown compression"):
        ttif.write_tiff(tmp_path / "x.tif", np.zeros((2, 2), np.uint8), compression="jpeg")
    with pytest.raises(NotImplementedError, match="compression 7"):
        tcodecs.decode_tiff_data(b"", 7, 0)
    with pytest.raises(NotImplementedError, match="compression 7"):
        tcodecs.encode_tiff_data(b"", 7)


@pytest.mark.parametrize("codec", ["lzw", "packbits"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_decoders_match_python_and_jax(codec, seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1000, 40000))
    payload = (rng.integers(0, 4 + 60 * seed, n).astype(np.uint8)).tobytes()
    enc = {"lzw": tcodecs.lzw_encode, "packbits": tcodecs.packbits_encode}[codec](payload)
    assert enc == {"lzw": jcodecs.lzw_encode, "packbits": jcodecs.packbits_encode}[codec](payload)
    assert tcodecs.native_route() == "native"
    native = {"lzw": tcodecs.lzw_decode, "packbits": tcodecs.packbits_decode}[codec](enc, n)
    plain = {"lzw": tcodecs._lzw_decode_py, "packbits": tcodecs._packbits_decode_py}[codec](enc, n)
    ref = {"lzw": jcodecs.lzw_decode, "packbits": jcodecs.packbits_decode}[codec](enc, n)
    assert native == plain == ref == payload


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int16, np.uint32, np.float32])
def test_native_predictor_matches_python_and_jax(dtype):
    rng = np.random.default_rng(4)
    if np.dtype(dtype).kind == "f":
        arr = rng.random((17, 33)).astype(dtype)
    else:
        info = np.iinfo(dtype)
        arr = rng.integers(info.min, info.max, (17, 33), dtype=np.int64).astype(dtype)
    got = tcodecs.undo_predictor2(arr)
    assert got.dtype == arr.dtype
    np.testing.assert_array_equal(got, tcodecs._undo_predictor2_py(arr))
    np.testing.assert_array_equal(got, jcodecs.undo_predictor2(arr))


def test_native_library_is_built_into_the_package(tmp_path):
    lib = tcodecs.library_path()
    assert tcodecs.native_route() == "native"
    assert lib.exists() and lib.parent == REPO / "multiview_stitcher_torch" / "_build"
    assert lib.name.startswith("libcodecs_") and tcodecs.compiler() is not None
    # the JAX package's library is not the one loaded
    assert "multiview_stitcher_tpu" not in str(tcodecs._load_native()._name)


def test_python_route_when_no_compiler_builds(monkeypatch, tmp_path, caplog):
    monkeypatch.setattr(tcodecs, "_lib", None)
    monkeypatch.setattr(tcodecs, "_lib_tried", False)
    monkeypatch.setattr(tcodecs, "BUILD_DIR", tmp_path / "empty_build")
    monkeypatch.setattr(tcodecs, "compiler", lambda: None)
    with caplog.at_level("WARNING", logger=tcodecs.__name__):
        assert tcodecs.native_route() == "python"
    assert any("decoding in Python" in r.getMessage() for r in caplog.records)
    payload = bytes(range(256)) * 20
    assert tcodecs.lzw_decode(tcodecs.lzw_encode(payload), len(payload)) == payload
    assert tcodecs.packbits_decode(tcodecs.packbits_encode(payload), len(payload)) == payload
    arr = _codec_data(np.uint16)
    np.testing.assert_array_equal(tcodecs.undo_predictor2(arr), jcodecs.undo_predictor2(arr))


def test_malformed_streams_raise():
    with pytest.raises(ValueError, match="LZW"):
        tcodecs.lzw_decode(bytes([0x80, 0x7F, 0xFF, 0xFF]), 100)
    with pytest.raises(ValueError, match="PackBits"):
        tcodecs.packbits_decode(bytes([5, 1]), 100)


# ---------------------------------------------------------------------------
# ImageJ hyperstacks and the virtual zarr-v3 store
# ---------------------------------------------------------------------------


def _write_hyperstack(path, t=2, z=3, c=2, h=8, w=10, compression="none"):
    data = np.random.default_rng(7).integers(0, 4000, (t, z, c, h, w), dtype=np.uint16)
    ttif.write_tiff(
        path, data.reshape(-1, h, w), compression=compression,
        description=(f"ImageJ=1.54f\nimages={t * z * c}\nchannels={c}\n"
                     f"slices={z}\nframes={t}\nhyperstack=true\n"),
    )
    return data


def test_hyperstack_layout_matches_jax(tmp_path):
    path = tmp_path / "hs.tif"
    data = _write_hyperstack(path, compression="packbits")
    t, j = ttif.TiffFile(path), jtif.TiffFile(path)
    assert t.description == j.description
    assert ttif.get_tiff_layout(t) == jtif.get_tiff_layout(j) == ((2, 3, 2), (8, 10),
                                                                  np.dtype(np.uint16), 12)
    assert ttif.get_tiff_axes(t) == jtif.get_tiff_axes(j) == ("t", "z", "c")
    np.testing.assert_array_equal(t.asarray().reshape(data.shape), data)
    assert ttif._parse_imagej_description(t.description) == \
        jtif._parse_imagej_description(j.description)


def test_layout_plain_stack_and_single_page(tmp_path):
    ttif.write_tiff(tmp_path / "plain.tif", np.zeros((4, 6, 6), dtype=np.uint8))
    ttif.write_tiff(tmp_path / "single.tif", np.zeros((6, 6), dtype=np.uint8))
    for name in ("plain.tif", "single.tif"):
        t, j = ttif.TiffFile(tmp_path / name), jtif.TiffFile(tmp_path / name)
        assert ttif.get_tiff_layout(t) == jtif.get_tiff_layout(j)
        assert ttif.get_tiff_axes(t) == jtif.get_tiff_axes(j)
        assert_sims_equal(ttif.read_tiff_into_sim(tmp_path / name),
                          jtif.read_tiff_into_sim(tmp_path / name))


def test_layout_inconsistent_page_count_raises(tmp_path):
    ttif.write_tiff(tmp_path / "bad.tif", np.zeros((4, 6, 6), dtype=np.uint8),
                    description="ImageJ=1.54f\nimages=6\nchannels=2\nslices=3\n")
    with pytest.raises(ValueError, match="inconsistent"):
        ttif.get_tiff_layout(ttif.TiffFile(tmp_path / "bad.tif"))


def test_lazy_nd_indexing_matches_jax(tmp_path):
    path = tmp_path / "hs.tif"
    data = _write_hyperstack(path)
    t, j = ttif.tif_to_dask_plane_chunks(path), jtif.tif_to_dask_plane_chunks(path)
    assert t.shape == j.shape == data.shape
    for key in (1, (1, 2), (slice(0, 1), slice(1, 3), 1, slice(2, 6), slice(None)),
                (-1, -1, -1), (Ellipsis, 1, slice(None, None, 3)), slice(1, 1)):
        np.testing.assert_array_equal(t[key], j[key])
        np.testing.assert_array_equal(t[key], data[key])
    with pytest.raises(IndexError):
        t[5]
    with pytest.raises(TypeError):
        t[[0, 1]]
    t.close()


def test_read_into_sim_exposes_hyperstack_dims(tmp_path):
    path = tmp_path / "hs.tif"
    data = _write_hyperstack(path)
    t, j = ttif.read_tiff_into_sim(path), jtif.read_tiff_into_sim(path)
    assert tuple(t.dims) == ("t", "z", "c", "y", "x")
    assert_sims_equal(t, j)
    np.testing.assert_array_equal(t.to_numpy(), data)


def test_virtual_zarr_v3_store_bytes_match_jax(tmp_path):
    path = tmp_path / "hs.tif"
    data = _write_hyperstack(path, compression="lzw")
    t = ttif.tif_to_virtual_zarr_v3_plane_chunks(path)
    j = jtif.tif_to_virtual_zarr_v3_plane_chunks(path)
    assert t.shape == j.shape and t.chunks == j.chunks and t.dtype == j.dtype
    assert json.loads(t.get("zarr.json")) == json.loads(j.get("zarr.json"))
    assert t.get("zarr.json") == j.get("zarr.json")
    keys = ["/".join(["c", *map(str, idx)]) for idx in np.ndindex(2, 3, 2, 1, 1)]
    keys += ["c/2/0/0/0/0", "c/0/0/0/1/0", "c/0/0/0/0", "c/x/0/0/0/0", "nonsense", "c",
             "/c/1/2/1/0/0/"]
    for key in keys:
        assert t.get(key) == j.get(key), key
    got = np.frombuffer(t.get("c/1/2/0/0/0"), dtype="<u2").reshape(8, 10)
    np.testing.assert_array_equal(got, data[1, 2, 0])
    t.close()
    j.close()


def test_page_reads_threadsafe_and_close_releases(tmp_path):
    path = tmp_path / "hs.tif"
    data = _write_hyperstack(path, compression="deflate")
    tif = ttif.TiffFile(path)
    results = {}

    def read(i):
        results[i] = tif.read_page(i)

    threads = [threading.Thread(target=read, args=(i % 12,)) for i in range(48)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    flat = data.reshape(-1, 8, 10)
    for i in range(12):
        np.testing.assert_array_equal(results[i], flat[i])
    assert len(tif._handles) >= 1
    tif.close()
    assert tif._handles == []
    np.testing.assert_array_equal(tif.read_page(0), flat[0])
    tif.close()


def test_lazy_tiff_windows_are_thread_safe(tmp_path):
    path = tmp_path / "hs.tif"
    data = _write_hyperstack(path, compression="lzw")
    sim = ttif.read_tiff_into_sim(path)

    def window(args):
        a, y, x = args
        return args, np.asarray(sim.data[a, :, :, y:y + 5, x:x + 4])

    jobs = [(a, y, x) for a in range(2) for y in (0, 2, 3) for x in (0, 5, 6)]
    with ThreadPoolExecutor(8) as ex:
        for (a, y, x), got in ex.map(window, jobs * 6):
            np.testing.assert_array_equal(got, data[a, :, :, y:y + 5, x:x + 4])


# ---------------------------------------------------------------------------
# CZI
# ---------------------------------------------------------------------------

CZI_MODES = ["raw", "zstd0", "zstd1", "zstd1_hilo", "jpeg"]


@pytest.mark.parametrize("mode", CZI_MODES)
def test_mosaic_czi_matches_jax(tmp_path, mode):
    path = tmp_path / f"mosaic_{mode}.czi"
    tiles = write_mosaic(path, mode)
    for lazy in (True, False):
        t = tczi.read_mosaic_into_sims_czifile(path, lazy=lazy)
        j = jczi.read_mosaic_into_sims_czifile(path, lazy=lazy)
        assert_lists_equal(t, j)
        assert all(isinstance(s.data, tczi.LazyCziTile) == lazy for s in t)
    t = tio.read_mosaic_into_sims(path)
    assert_lists_equal(t, jio.read_mosaic_into_sims(path))
    assert [s.dims for s in t] == [("c", "z", "y", "x")] * 4
    assert list(t[0].coords["c"]) == ["DAPI", "GFP"]
    np.testing.assert_allclose([s.origin["x"] for s in t], [50.0, 62.0, 50.0, 62.0])
    np.testing.assert_allclose([s.origin["y"] for s in t], [-25.0, -25.0, -16.0, -16.0])
    if mode != "jpeg":
        for m, s in enumerate(t):
            np.testing.assert_array_equal(np.asarray(s.data), tiles[(0, m)])
    else:  # lossy: within the JPEG decoder's tolerance of the source
        diff = np.abs(np.asarray(t[0].data).astype(int) - tiles[(0, 0)].astype(int))
        assert diff.max() <= 8


def test_mosaic_czi_2d_and_metadata_helpers_match_jax(tmp_path):
    path = tmp_path / "mosaic2d.czi"
    tiles = write_mosaic(path, "zstd1_hilo", scenes=2, has_z=False)
    tczi.close_czi_files()
    jczi.close_czi_files()
    t, j = tczi.CziFile(path), jczi.CziFile(path)
    assert t.metadata_xml == j.metadata_xml
    assert len(t.subblocks) == len(j.subblocks) == 16
    for a, b in zip(t.subblocks, j.subblocks):
        assert vars(a) == vars(b)
    assert tczi.get_czi_shape(t) == jczi.get_czi_shape(j)
    assert tczi.get_czi_spacing(path) == jczi.get_czi_spacing(path) == {"x": 0.5, "y": 0.5,
                                                                        "z": 2.0}
    assert tczi.get_spacing_from_czi(path) == jczi.get_spacing_from_czi(path)
    assert tczi.get_czi_channel_names(t) == jczi.get_czi_channel_names(j) == ["DAPI", "GFP"]
    for scene in (0, 1):
        assert tczi.get_czi_mosaic_intervals(path, scene) == \
            jczi.get_czi_mosaic_intervals(path, scene)
        for reader in ("read_czi_into_sims", "read_czi_into_xims"):
            ts = getattr(tczi, reader)(path, scene_index=scene)
            assert_lists_equal(ts, getattr(jczi, reader)(path, scene_index=scene))
        ts = tio.read_mosaic_into_sims_czifile(path, scene_index=scene, lazy=False)
        assert_lists_equal(ts, jio.read_mosaic_into_sims_czifile(path, scene_index=scene,
                                                                 lazy=False))
        assert ts[0].dims == ("c", "y", "x")
        np.testing.assert_array_equal(ts[3].data, tiles[(scene, 3)][:, 0])
    assert tio.get_number_of_scenes_in_mosaic(path) == jio.get_number_of_scenes_in_mosaic(path) == 2
    assert tczi.is_multiview_czi(path) is jczi.is_multiview_czi(path) is False
    for ide in (0, 7, 15):
        np.testing.assert_array_equal(tczi.read_czi_plane(path, ide),
                                      jczi.read_czi_plane(path, ide))
    sl = (slice(2, 9), slice(None, None, 3))
    np.testing.assert_array_equal(tczi.read_czi_plane(path, 3, sl), jczi.read_czi_plane(path, 3, sl))
    with pytest.raises(IndexError):
        tczi.read_czi_plane(path, 16)
    assert tczi.open_czi(path) is tczi.open_czi(str(path))
    tczi.close_czi_files()
    assert tczi._OPEN_CZI_CACHE == {}


def test_lazy_czi_windows_match_eager(tmp_path):
    path = tmp_path / "mosaic.czi"
    write_mosaic(path, "zstd0")
    lazy = tczi.read_mosaic_into_sims_czifile(path)
    eager = jczi.read_mosaic_into_sims_czifile(path, lazy=False)
    for sl, se in zip(lazy, eager):
        for key in (Ellipsis, (0, 1, slice(10, 20), slice(5, 40)), (-1, slice(None), Ellipsis),
                    (slice(None), -1, slice(None), slice(None, None, 2)), 1, (1, 2, 3, 4)):
            np.testing.assert_array_equal(sl.data[key], se.data[key])
        out = sl.data[0:0]
        assert out.shape == se.data[0:0].shape and out.dtype == se.data.dtype
        np.testing.assert_array_equal(sl.data[0:0, 1:1, 5:10], se.data[0:0, 1:1, 5:10])
        with pytest.raises(IndexError):
            sl.data[2]
        with pytest.raises(TypeError):
            sl.data[[0, 1]]
        np.testing.assert_array_equal(np.asarray(sl.data, dtype=np.float32),
                                      se.data.astype(np.float32))


def test_lazy_czi_reads_are_thread_safe(tmp_path):
    """Parallel window reads from many threads return the same planes as
    serial reads (each subblock read opens its own handle)."""
    path = tmp_path / "mosaic.czi"
    write_mosaic(path, "raw")
    sims = tczi.read_mosaic_into_sims_czifile(path, lazy=True)
    eager = [np.asarray(s.data) for s in sims]

    def window(args):
        i, y, x = args
        return i, y, x, np.asarray(sims[i].data[..., y:y + 7, x:x + 9])

    jobs = [(i, y, x) for i in range(len(sims)) for y in (0, 3, 11) for x in (0, 5, 17)]
    with ThreadPoolExecutor(8) as ex:
        for i, y, x, got in ex.map(window, jobs * 4):
            np.testing.assert_array_equal(got, eager[i][..., y:y + 7, x:x + 9])


@pytest.mark.parametrize("mode", ["rotate_around_y_positions",
                                  "rotation_around_czi_center_position"])
@pytest.mark.parametrize("invert_angles", [False, True])
def test_multiview_czi_matches_jax(tmp_path, mode, invert_angles):
    path = tmp_path / "mv.czi"
    views = write_multiview(path)
    kw = dict(transform_initialization_mode=mode, eps=1.0, invert_angles=invert_angles)
    t = tczi.read_multiview_czi_into_sims(path, **kw)
    j = jczi.read_multiview_czi_into_sims(path, **kw)
    assert_lists_equal(t, j, affine_atol=1e-12)
    for s, v in zip(t, views):
        np.testing.assert_array_equal(s.data, v)
        assert s.spacing == {"z": 2.5, "y": 1.0, "x": 1.0}
    ta = tczi.get_affines_from_multiview_czi(path, **kw)
    ja = jczi.get_affines_from_multiview_czi(path, **kw)
    for a, b in zip(ta, ja):
        np.testing.assert_allclose(a.data, b.data, rtol=0, atol=1e-12)
    assert_sims_equal(tczi.read_czi_view_into_sim(path, 2, **kw),
                      jczi.read_view_from_multiview_czi(path, 2, **kw), affine_atol=1e-12)


def test_multiview_info_and_errors_match_jax(tmp_path):
    path = tmp_path / "mv.czi"
    write_multiview(path)
    ti, ji = tczi.get_info_from_multiview_czi(path), jczi.get_info_from_multiview_czi(path)
    assert ti.keys() == ji.keys()
    for k in ti:
        np.testing.assert_array_equal(ti[k], ji[k])
    assert tczi.is_multiview_czi(path) and jczi.is_multiview_czi(path)
    with pytest.raises(ValueError, match="Invalid transform_initialization_mode"):
        tczi.get_affines_from_multiview_czi(path, transform_initialization_mode="nope")
    with pytest.raises(IndexError):
        tczi.read_czi_view_into_sim(path, 4)
    # the rotate-around-y mode grouped the two y levels apart
    assert list(tczi.dbscan_1d(ti["positions"][:, 1], eps=1.0)) == [0, 0, 1, 1]


@pytest.mark.parametrize("eps", [0.0, 0.5, 3.0])
def test_dbscan_1d_matches_jax(eps):
    x = np.random.default_rng(5).normal(0, 3, 40)
    np.testing.assert_array_equal(tczi.dbscan_1d(x, eps), jczi.dbscan_1d(x, eps))


def _zstd_case(case):
    if case == "zstd0":
        data = np.arange(200, dtype=np.uint16).tobytes()
        return data, 5, _zstd(data), np.uint16
    if case == "zstd1_plain":
        data = np.arange(100, dtype=np.uint8).tobytes()
        return data, 6, bytes([1]) + _zstd(data), np.uint8
    if case == "zstd1_hilo":
        data = np.arange(300, 556, dtype="<u2").tobytes()
        return data, 6, bytes([3, 1, 1]) + _zstd(data[0::2] + data[1::2]), np.uint16
    if case == "zstd1_no_header":
        data = np.arange(64, dtype=np.uint16).tobytes()
        return data, 6, _zstd(data), np.uint16
    raise ValueError(case)


@pytest.mark.parametrize("case", ["zstd0", "zstd1_plain", "zstd1_hilo", "zstd1_no_header"])
def test_zstd_subblocks_match_jax(case):
    data, comp, payload, dtype = _zstd_case(case)
    out = tczi._decompress_subblock(payload, comp, dtype)
    assert out == data == jczi._decompress_subblock(payload, comp, dtype)


def test_unsupported_compression_raises():
    try:
        import imagecodecs  # noqa: F401
    except ImportError:
        with pytest.raises(NotImplementedError, match="JPEG XR"):
            tczi._decompress_subblock(b"xx", 4, np.uint16)
    else:
        with pytest.raises(ValueError, match="JPEG XR"):
            tczi._decompress_subblock(b"xx", 4, np.uint16)
    with pytest.raises(NotImplementedError, match="LZW"):
        tczi._decompress_subblock(b"xx", 2, np.uint16)


def test_jpegxr_routes_through_optional_imagecodecs(monkeypatch):
    import types

    img = np.arange(24, dtype=np.uint16).reshape(4, 6)
    calls = {}
    fake = types.ModuleType("imagecodecs")

    def jpegxr_decode(raw):
        calls["raw"] = raw
        return img

    fake.jpegxr_decode = jpegxr_decode
    monkeypatch.setitem(sys.modules, "imagecodecs", fake)
    out = tczi._decompress_subblock(b"\x01\x02jxr", 4, np.uint16)
    assert calls["raw"] == b"\x01\x02jxr"
    assert out == jczi._decompress_subblock(b"\x01\x02jxr", 4, np.uint16)
    np.testing.assert_array_equal(np.frombuffer(out, np.uint16).reshape(4, 6), img)

    def broken(raw):
        raise RuntimeError("corrupt")

    fake.jpegxr_decode = broken
    with pytest.raises(ValueError, match="JPEG XR subblock decode failed"):
        tczi._decompress_subblock(b"xx", 4, np.uint16)


def test_register_subblock_decompressor_custom_id():
    payload = np.arange(10, dtype=np.uint8).tobytes()
    tczi.register_subblock_decompressor(2, lambda raw, dtype: raw[::-1])
    try:
        assert tczi._decompress_subblock(payload, 2, np.uint8) == payload[::-1]
        assert 2 not in jczi._SUBBLOCK_DECOMPRESSORS
    finally:
        del tczi._SUBBLOCK_DECOMPRESSORS[2]
    with pytest.raises(NotImplementedError, match="register"):
        tczi._decompress_subblock(payload, 2, np.uint8)


# ---------------------------------------------------------------------------
# Imaris
# ---------------------------------------------------------------------------


def _make_ims(path, levels, spacing=(2.0, 0.5, 0.5), pad=0):
    """An Imaris file: ``levels`` is a list over resolution levels of lists
    over channels of (z, y, x) arrays (stored with ``pad`` voxels of
    padding on each axis, as Imaris stores chunk-padded datasets)."""
    import h5py

    nz, ny, nx = levels[0][0].shape
    with h5py.File(path, "w") as f:
        for r, chans in enumerate(levels):
            for c, data in enumerate(chans):
                g = f.create_group(f"DataSet/ResolutionLevel {r}/TimePoint 0/Channel {c}")
                g.create_dataset("Data", data=np.pad(data, ((0, pad),) * 3))
                for d, n in zip("ZYX", data.shape):
                    g.attrs[f"ImageSize{d}"] = np.bytes_(str(n))
        info = f.create_group("DataSetInfo/Image")
        for d, n in zip("XYZ", (nx, ny, nz)):
            info.attrs[d] = np.bytes_(str(n))
        for i, n in enumerate((nx, ny, nz)):
            sp = spacing[2 - i]
            info.attrs[f"ExtMin{i}"] = np.bytes_(str(1.5 * i))
            info.attrs[f"ExtMax{i}"] = np.array(list(str(1.5 * i + n * sp)), dtype="S1")


@pytest.mark.parametrize("n_channels,n_levels", [(1, 1), (2, 2)])
def test_imaris_matches_jax(tmp_path, n_channels, n_levels):
    from multiview_stitcher_torch.io import imaris_utils as tims
    from multiview_stitcher_tpu.io import imaris_utils as jims

    rng = np.random.default_rng(6)
    base = [rng.integers(0, 1000, (4, 16, 20), dtype=np.uint16) for _ in range(n_channels)]
    levels = [base] + [[b[:, ::2, ::2] for b in base] for _ in range(n_levels - 1)]
    path = tmp_path / "t.ims"
    _make_ims(path, levels, pad=3)
    tm, jm = tims.read_imaris_into_msim(path), jims.read_imaris_into_msim(path)
    assert len(tm.sims) == len(jm.sims) == n_levels
    for t, j in zip(tm.sims, jm.sims):
        assert_sims_equal(t, j)
    sim = tmsi.get_sim_from_msim(tm)
    np.testing.assert_array_equal(np.asarray(sim.data), base[0] if n_channels == 1
                                  else np.stack(base))
    assert tims.get_spacing_from_ims(path) == jims.get_spacing_from_ims(path)
    assert tims.get_origin_from_ims(path) == jims.get_origin_from_ims(path)
    if n_channels == 1:
        assert_lists_equal(tio.read_mosaic_into_sims(path), jio.read_mosaic_into_sims(path))
        for key in ((1, slice(2, 9)), Ellipsis, (slice(1, 3),), (slice(None), 4, slice(3, 11))):
            np.testing.assert_array_equal(sim.data[key], base[0][key])
            np.testing.assert_array_equal(sim.data[key], jmsi.get_sim_from_msim(jm).data[key])
    with pytest.raises(ValueError, match="at least one channel"):
        tims.read_imaris_into_msim(path, channels=[])


def test_imaris_windows_index_as_numpy(tmp_path):
    """F4: the JAX package's cropped Imaris view drops a slice's step and
    reads a negative index before the crop, in the dataset's padding; the
    port indexes the cropped array as numpy does."""
    from multiview_stitcher_torch.io import imaris_utils as tims
    from multiview_stitcher_tpu.io import imaris_utils as jims

    data = np.random.default_rng(12).integers(1, 1000, (4, 16, 20), dtype=np.uint16)
    path = tmp_path / "f4.ims"
    _make_ims(path, [[data]], pad=3)
    t = tmsi.get_sim_from_msim(tims.read_imaris_into_msim(path)).data
    j = jmsi.get_sim_from_msim(jims.read_imaris_into_msim(path)).data
    for key in ((1, slice(2, 9), slice(None, None, 3)), (-1,), (slice(None, None, -1), -2),
                (slice(3, 0, -2), slice(None, 2, -1)), (Ellipsis, slice(19, None, -5))):
        np.testing.assert_array_equal(t[key], data[key])
    with pytest.raises(IndexError):
        t[4]
    # the reference's reads differ: no step, and the padding's zeros
    assert j[1, 2:9, ::3].shape == (7, 20)
    assert not np.asarray(j[-1]).any()
    with pytest.raises(ValueError, match="at least one channel"):
        tims.read_imaris_into_msim(path, channels=[])


# ---------------------------------------------------------------------------
# the dispatcher, the everyday formats and the aicsimageio seam
# ---------------------------------------------------------------------------


def test_unknown_suffix_routes_to_aicsimageio_seam(tmp_path):
    p = tmp_path / "mystery.nd2"
    p.write_bytes(b"\x00" * 16)
    for path in (tmp_path / "nonexistent.lif", p):
        with pytest.raises(ImportError, match="aicsimageio"):
            tio.read_mosaic_into_sims(path)
    with pytest.raises(ImportError, match="aicsimageio"):
        tio.read_mosaic_into_sims_aicsimageio(p)


def test_aicsimageio_fallback_with_fake_backend_matches_jax(monkeypatch):
    import types

    tiles = [
        np.arange(2 * 1 * 1 * 8 * 10, dtype=np.uint16).reshape(2, 1, 1, 8, 10),
        (np.arange(2 * 1 * 3 * 8 * 10, dtype=np.uint16) * 2).reshape(2, 1, 3, 8, 10),
    ]

    class FakeAICSImage:
        physical_pixel_sizes = types.SimpleNamespace(X=0.5, Y=0.25, Z=None)
        channel_names = ["DAPI"]

        def __init__(self, path, reconstruct_mosaic=False):
            assert reconstruct_mosaic is False

        def set_scene(self, idx):
            assert idx == 0

        def get_image_data(self, *a, **k):
            return tiles[k["M"]] if "M" in k else tiles[1]

        def get_mosaic_tile_positions(self):
            return [(0, 0), (4, 8)]

    monkeypatch.setitem(sys.modules, "aicsimageio", types.SimpleNamespace(AICSImage=FakeAICSImage))
    t = tio.read_mosaic_into_sims("/nonexistent/fake.lif")
    assert_lists_equal(t, jio.read_mosaic_into_sims("/nonexistent/fake.lif"))
    assert tuple(t[0].dims) == ("t", "c", "y", "x") and tuple(t[1].dims) == ("t", "c", "z", "y", "x")
    np.testing.assert_allclose(t[1].origin["x"], 8 * 0.5)
    assert list(np.asarray(t[0].coords["c"])) == ["DAPI"]


def test_fallback_png_grayscale_with_physical_resolution(tmp_path):
    from PIL import Image

    arr = np.arange(24 * 17, dtype=np.uint8).reshape(24, 17)
    p = tmp_path / "gray.png"
    Image.fromarray(arr).save(p, dpi=(2000 * 0.0254, 2000 * 0.0254))
    (t,) = tio.read_mosaic_into_sims(p)
    assert_sims_equal(t, jio.read_mosaic_into_sims(p)[0])
    np.testing.assert_array_equal(np.asarray(t.data), arr)
    assert abs(tsi.get_spacing_from_sim(t)["x"] - 500.0) < 1.0


def test_fallback_rgb_png_as_channel_dim(tmp_path):
    from PIL import Image

    rgb = np.random.default_rng(0).integers(0, 255, (10, 12, 3)).astype(np.uint8)
    p = tmp_path / "color.png"
    Image.fromarray(rgb).save(p)
    (t,) = tio.read_mosaic_into_sims(p)
    assert_sims_equal(t, jio.read_mosaic_into_sims(p)[0])
    assert t.dims == ("c", "y", "x") and list(t.coords["c"]) == ["R", "G", "B"]


def test_fallback_multiframe_gif_as_time(tmp_path):
    from PIL import Image

    from multiview_stitcher_torch.io import fallback as tfb
    from multiview_stitcher_tpu.io import fallback as jfb

    frames = [Image.fromarray(np.full((8, 9), v, np.uint8)) for v in (0, 120, 250)]
    p = tmp_path / "anim.gif"
    frames[0].save(p, save_all=True, append_images=frames[1:])
    t = tfb.read_image_into_sim(p)
    assert_sims_equal(t, jfb.read_image_into_sim(p))
    assert t.dims[0] == "t" and t.shape[0] == 3


def test_fallback_bmp_unit_spacing_scene_guard_and_metadata(tmp_path):
    from PIL import Image

    from multiview_stitcher_torch.io import fallback as tfb
    from multiview_stitcher_tpu.io import fallback as jfb

    p = tmp_path / "plain.bmp"
    Image.fromarray(np.zeros((5, 6), np.uint8)).save(p)
    (t,) = tfb.read_image_into_sims(p)
    assert_sims_equal(t, jfb.read_image_into_sims(p)[0])
    assert tsi.get_spacing_from_sim(t) == {"y": 1.0, "x": 1.0}
    with pytest.raises(ValueError, match="single scene"):
        tfb.read_image_into_sims(p, scene_index=2)
    for name in ("a.PNG", "b.webp", "c.tif", "d.czi", "e.jpeg"):
        assert tfb.can_read(name) == jfb.can_read(name)
    for meta in ({}, {"dpi": (72, 72)}, {"dpi": (300, 300)}, {"resolution": (2000, 1000),
                                                               "unit": "meter"},
                 {"resolution": (1, 1)}, {"resolution": ("x",)}, {"resolution": (5, 4)}):
        assert tfb._physical_pixel_sizes(meta) == jfb._physical_pixel_sizes(meta)


def test_dispatch_of_ome_zarr_matches_jax(tmp_path):
    from multiview_stitcher_torch.io import ngff_utils as tngff

    data = np.random.default_rng(8).integers(0, 1000, (2, 10, 12), dtype=np.uint16)
    sim = tsi.get_sim_from_array(data, dims=("c", "y", "x"), scale={"y": 0.5, "x": 0.25},
                                 translation={"y": 1.0, "x": -2.0})
    path = tmp_path / "img.ome.zarr"
    tngff.write_sim_to_ome_zarr(sim, str(path))
    (t,) = tio.read_mosaic_into_sims(path)
    (j,) = jio.read_mosaic_into_sims(path)
    assert t.dims == j.dims and t.spacing == j.spacing and t.origin == j.origin
    np.testing.assert_array_equal(np.asarray(t.data), np.asarray(j.data))
    np.testing.assert_array_equal(np.asarray(t.data), data)


def test_deprecated_aliases_warn_and_match_jax(tmp_path):
    path = tmp_path / "mosaic.czi"
    write_mosaic(path, "raw")
    with pytest.warns(DeprecationWarning, match="read_mosaic_into_sims"):
        t = tio.read_mosaic_image_into_list_of_spatial_xarrays(path)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        assert_lists_equal(t, jio.read_mosaic_image_into_list_of_spatial_xarrays(path))
    tif = tmp_path / "s.tif"
    ttif.write_tiff(tif, np.arange(60, dtype=np.uint16).reshape(3, 4, 5))
    with pytest.warns(DeprecationWarning, match="read_tiff_into_sim"):
        t = tio.read_tiff_into_spatial_xarray(tif, scale={"z": 3.0, "y": 1.0, "x": 1.0})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        assert_sims_equal(t, jio.read_tiff_into_spatial_xarray(tif,
                                                               scale={"z": 3.0, "y": 1.0,
                                                                      "x": 1.0}))


def test_package_aliases_are_the_readers():
    assert tpkg.tif_utils is ttif and tpkg.czi_utils is tczi
    from multiview_stitcher_torch.io import imaris_utils

    assert tpkg.imaris_utils is imaris_utils
    assert tio.METADATA_TRANSFORM_KEY == jio.METADATA_TRANSFORM_KEY


FORBIDDEN = ("jax", "multiview_stitcher_tpu", "tifffile", "tensorstore", "networkx", "pandas")


@pytest.mark.parametrize("module", ["io", "io.codecs", "io.tif_utils", "io.czi_utils", "io.jpeg",
                                    "io.imaris_utils", "io.fallback"])
def test_reader_modules_import_no_jax(module):
    code = (
        "import importlib, sys\n"
        f"m = importlib.import_module('multiview_stitcher_torch.{module}')\n"
        "import multiview_stitcher_torch as p\n"
        "p.czi_utils, p.tif_utils, p.imaris_utils\n"
        f"print([n for n in {FORBIDDEN!r} if n in sys.modules])\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


# ---------------------------------------------------------------------------
# the readers' lazy arrays in the tiers that read lazy views
# ---------------------------------------------------------------------------


@pytest.fixture
def _empty_cache():
    tcore.clear_device_tile_cache()
    yield
    tcore.clear_device_tile_cache()


def _tiff_grid(tmp_path, n=2, tile=(8, 24, 24), overlap=6, seed=9):
    rng = np.random.default_rng(seed)
    step = tile[1] - overlap
    vol = smooth_image(rng, (tile[0], step * n + overlap, step * n + overlap), sigma=1.5)
    paths, trans, arrays = [], [], []
    for iy in range(n):
        for ix in range(n):
            data = np.ascontiguousarray(vol[:, iy * step:iy * step + tile[1],
                                            ix * step:ix * step + tile[2]])
            path = tmp_path / f"tile_{iy}_{ix}.tif"
            ttif.write_tiff(path, data, compression="deflate")
            paths.append(path)
            trans.append({"z": 0.0, "y": float(iy * step), "x": float(ix * step)})
            arrays.append(data)
    return paths, trans, arrays


def test_lazy_tiff_tiles_stream_like_memory(tmp_path, monkeypatch, _empty_cache):
    paths, trans, arrays = _tiff_grid(tmp_path, n=4, tile=(8, 32, 32), overlap=8)
    lazy = [ttif.read_tiff_into_sim(p, translation=t) for p, t in zip(paths, trans)]
    assert all(isinstance(s.data, ttif.LazyTiffPagesND) for s in lazy)
    mem = [tsi.get_sim_from_array(a, dims=("z", "y", "x"), translation=t)
           for a, t in zip(arrays, trans)]
    monkeypatch.setattr(tcore, "STREAM_BYTES", 0)
    from multiview_stitcher_torch.fusion import _streaming as tstream

    ran = []
    run = tstream.execute_streaming

    def spy(*a, **k):
        res = run(*a, **k)
        ran.append(res is not None)
        return res

    monkeypatch.setattr(tstream, "execute_streaming", spy)
    key = tsi.DEFAULT_TRANSFORM_KEY
    got = tfuse(lazy, transform_key=key, device="cpu", output_chunksize=16)
    want = tfuse(mem, transform_key=key, device="cpu", output_chunksize=16)
    assert ran == [True, True]
    np.testing.assert_array_equal(np.asarray(got.data), np.asarray(want.data))
    jsims = [jtif.read_tiff_into_sim(p, translation=t) for p, t in zip(paths, trans)]
    ref = np.asarray(jfuse(jsims, transform_key=key, output_chunksize=16).data)
    assert np.abs(np.asarray(got.data).astype(int) - ref.astype(int)).max() <= UINT_COUNTS


def test_lazy_tiff_views_take_host_slabs(tmp_path, monkeypatch, _empty_cache):
    paths, trans, arrays = _tiff_grid(tmp_path, seed=10)
    theta = 0.3
    rot = np.eye(4)
    rot[1:3, 1:3] = [[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]]
    lazy, mem = [], []
    for p, t, a in zip(paths, trans, arrays):
        for sims, data in ((lazy, ttif.read_tiff_into_sim(p, translation=t).data), (mem, a)):
            s = tsi.get_sim_from_array(data, dims=("z", "y", "x"), translation=t)
            tsi.set_sim_affine(s, rot, transform_key="affine")
            sims.append(s)
    monkeypatch.setattr(tcore, "TILES_MAX_BYTES", 0)
    got = tfuse(lazy, transform_key="affine", device="cpu", output_chunksize=16)
    assert tcore.last_slab_telemetry["windows"] > 0
    want = tfuse(mem, transform_key="affine", device="cpu", output_chunksize=16)
    diff = np.abs(np.asarray(got.data).astype(int) - np.asarray(want.data).astype(int))
    assert diff.max() <= UINT_COUNTS


STITCH_TILE, STITCH_STEP = 64, 44
STITCH_ERRORS = [(0, 0), (2, -1), (-2, 1), (1, 2)]


def write_stitch_mosaic(path, seed=11):
    """2 x 2 single-z tiles of 64^2 uint16 (2 channels) cut from one smooth
    image at their true positions; the subblock starts hold the true
    positions plus an integer error."""
    rng = np.random.default_rng(seed)
    size = STITCH_STEP + STITCH_TILE
    img = smooth_image(rng, (2, size, size), sigma=2.0)
    planes, truth = [], []
    for m, (iy, ix) in enumerate([(0, 0), (0, 1), (1, 0), (1, 1)]):
        y0, x0 = iy * STITCH_STEP, ix * STITCH_STEP
        truth.append((y0, x0))
        ey, ex = STITCH_ERRORS[m]
        for c in range(2):
            plane = np.ascontiguousarray(img[c, y0:y0 + STITCH_TILE, x0:x0 + STITCH_TILE])
            dims = {"X": (x0 + ex, STITCH_TILE), "Y": (y0 + ey, STITCH_TILE), "C": (c, 1),
                    "M": (m, 1), "S": (0, 1)}
            planes.append((dims, np.uint16, 0, plane.tobytes()))
    write_czi(path, planes, czi_xml({"X": 1.0, "Y": 1.0}, ["a", "b"]))
    return np.asarray(truth, float)


def test_register_device_tiles_on_lazy_czi_matches_eager(tmp_path, _empty_cache):
    path = tmp_path / "stitch.czi"
    write_stitch_mosaic(path)
    out = {}
    for lazy in (True, False):
        sims = tczi.read_mosaic_into_sims_czifile(path, lazy=lazy)
        msims = [tmsi.get_msim_from_sim(s, scale_factors=[]) for s in sims]
        out[lazy] = treg.register(msims, transform_key=KEY, reg_channel_index=0,
                                  device_tiles=True, device="cpu")
        assert treg.last_telemetry["device_tiles"] is True
    for a, b in zip(out[True], out[False]):
        np.testing.assert_array_equal(np.asarray(a.data), np.asarray(b.data))


def test_stitch_of_a_czi_mosaic_matches_jax(tmp_path, _empty_cache):
    path = tmp_path / "stitch.czi"
    truth = write_stitch_mosaic(path)
    tmsims = [tmsi.get_msim_from_sim(s, scale_factors=[])
              for s in tio.read_mosaic_into_sims(path)]
    fused = tstitch(tmsims, transform_key=KEY, new_transform_key="registered",
                    register_kwargs={"reg_channel_index": 0}, device="cpu")
    tparams = [np.asarray(tmsi.get_transform_from_msim(m, "registered").data) for m in tmsims]

    jmsims = [jmsi.get_msim_from_sim(s, scale_factors=[]) for s in jio.read_mosaic_into_sims(path)]
    jparams = jreg.register(jmsims, transform_key=KEY, new_transform_key="registered",
                            reg_channel_index=0)
    for tp, jp in zip(tparams, jparams):
        np.testing.assert_allclose(tp, np.asarray(jp.data), rtol=0, atol=1e-3)
    # the registration undid the metadata error of up to 2 px (up to a
    # common offset; phase correlation on these small overlaps is off by
    # up to 0.55 px)
    origins = np.asarray([[s.origin["y"], s.origin["x"]] for s in
                          (tmsi.get_sim_from_msim(m) for m in tmsims)])
    placed = origins + np.asarray([p[:2, 2] for p in tparams])
    err = placed - truth
    np.testing.assert_allclose(err - err[0], 0, atol=1.0)
    jsims = [jmsi.get_sim_from_msim(m) for m in jmsims]
    ref = np.asarray(jfuse(jsims, transform_key="registered").data)
    got = np.asarray(fused.data)
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.uint16
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= UINT_COUNTS
