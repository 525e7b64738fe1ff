"""The port's streaming tier, its zarr v2 / OME-Zarr IO and
``fuse(output_zarr_url=...)`` against the JAX package, and the dtype cast of
the kernels' outputs (fault F1) against jnp.

Inputs are made from a seed with numpy, on the grid shapes of
tests/test_streaming_fusion.py (n=5-7, tiles of 40-48, overlap 10-12). The
reference runs on the CPU (its Pallas kernels in interpret mode) with
``MVS_TPU_STREAM_BYTES=0``, so it streams too; its zarr IO is tensorstore,
which also reads what the port writes. The port runs with ``device="cpu"``.

Tolerances: the port's streaming output is bit-equal to its monolithic
output; against the reference, uint16 within 1 count (truncation ties) and
f32 rtol 1e-4, atol 1e-3 (tests/test_pallas_fusion.py:98); the cast equals
jnp's ``astype`` exactly.
"""

import json
import sys
import types
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import tensorstore as ts
import torch

from multiview_stitcher_torch import convert, msi_utils as tmsi
from multiview_stitcher_torch import residency
from multiview_stitcher_torch import si_utils as tsi
from multiview_stitcher_torch.fusion import _core as tcore
from multiview_stitcher_torch.fusion import _streaming as tstream
from multiview_stitcher_torch.fusion import fuse as tfuse
from multiview_stitcher_torch.io import ngff_utils as tngff
from multiview_stitcher_torch.io import zarr_backend as tzb
from multiview_stitcher_torch.ops import translation_fusion as ttf
from multiview_stitcher_tpu import msi_utils, si_utils
from multiview_stitcher_tpu.fusion import _core as jcore
from multiview_stitcher_tpu.fusion import _streaming as jstream
from multiview_stitcher_tpu.fusion import fuse as jfuse
from multiview_stitcher_tpu.io import ngff_utils as jngff
from multiview_stitcher_tpu.io import zarr_backend as jzb

KEY = si_utils.DEFAULT_TRANSFORM_KEY


def _to_port(sims):
    return [
        convert.sim_from_numpy(
            s.data, s.dims, s.spacing, s.origin,
            {k: v.data for k, v in s.transforms.items()}, coords=s.coords,
        )
        for s in sims
    ]


def _grid_sims(n=5, tile=48, overlap=12, ndim=2, dtype=np.uint16, seed=0, channels=None):
    """The reference tests' grid: n x n tiles (1 x n x n in 3D), values in
    [0, 3000), as JAX sims; with ``channels`` a leading ``c`` axis."""
    rng = np.random.default_rng(seed)
    sdims = ["z", "y", "x"][-ndim:]
    step = tile - overlap
    grid = (1, n, n) if ndim == 3 else (n, n)
    lead = () if channels is None else (len(channels),)
    sims = []
    for idx in np.ndindex(grid):
        data = rng.integers(0, 3000, lead + (tile,) * ndim).astype(dtype)
        sims.append(si_utils.get_sim_from_array(
            data, dims=(["c"] if channels else []) + sdims, c_coords=channels,
            translation={d: float(idx[i] * step) for i, d in enumerate(sdims)},
        ))
    return sims


def _assert_close(got, ref):
    assert got.dtype == ref.dtype and got.shape == ref.shape, (got.shape, ref.shape)
    if np.issubdtype(ref.dtype, np.integer):
        assert np.abs(got.astype(np.int64) - ref.astype(np.int64)).max(initial=0) <= 1
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-3)


@pytest.fixture
def jax_streams(monkeypatch):
    """The reference streams test-sized grids (its fixture's settings)."""
    monkeypatch.setenv("MVS_TPU_STREAM_BYTES", "0")
    monkeypatch.setenv("MVS_TPU_PALLAS_TILE_2D", "64,64")
    monkeypatch.setenv("MVS_TPU_PALLAS_TILE_3D", "8,32,64")
    jcore.clear_device_tile_cache()
    yield
    jcore.clear_device_tile_cache()


def _spy_streaming(monkeypatch, module):
    ran = []
    orig = module.execute_streaming

    def spy(*a, **k):
        res = orig(*a, **k)
        ran.append(res is not None)
        return res

    monkeypatch.setattr(module, "execute_streaming", spy)
    return ran


# ---------------------------------------------------------------------------
# zarr v2 IO against tensorstore
# ---------------------------------------------------------------------------

_COMPRESSORS = {"none": None, "zlib": {"id": "zlib", "level": 3}}


@pytest.mark.parametrize("sep", [".", "/"])
@pytest.mark.parametrize("compressor", ["none", "zlib"])
def test_port_writes_and_tensorstore_reads(tmp_path, sep, compressor):
    rng = np.random.default_rng(1)
    a = rng.integers(0, 60000, (13, 17, 9)).astype(np.uint16)  # edge chunks on every axis
    url = str(tmp_path / "a.zarr")
    arr = tzb.create_zarr_array(url, a.shape, (5, 8, 4), a.dtype, fill_value=7,
                                compressor=_COMPRESSORS[compressor], dimension_separator=sep)
    expect = np.full(a.shape, 7, np.uint16)  # chunks never written read as fill_value
    arr[0:10, 0:16, 0:8] = a[0:10, 0:16, 0:8]  # whole chunks
    arr[2:7, 3:11, 1:2] = 5  # an unaligned region: read, modify, write
    arr[12, 16, 8] = 9  # the last voxel, in the last edge chunk
    expect[0:10, 0:16, 0:8] = a[0:10, 0:16, 0:8]
    expect[2:7, 3:11, 1:2] = 5
    expect[12, 16, 8] = 9
    np.testing.assert_array_equal(jzb.open_zarr_array(url).read(), expect)
    np.testing.assert_array_equal(np.asarray(tzb.open_zarr_array(url)), expect)
    meta = json.loads((tmp_path / "a.zarr" / ".zarray").read_text())
    assert meta["compressor"] == _COMPRESSORS[compressor] and meta["dimension_separator"] == sep


@pytest.mark.parametrize("sep", [".", "/"])
@pytest.mark.parametrize("compressor", ["none", "zlib"])
@pytest.mark.parametrize("dtype", ["<u2", "<f4"])
def test_tensorstore_writes_and_port_reads(tmp_path, sep, compressor, dtype):
    rng = np.random.default_rng(2)
    a = (rng.random((13, 17, 9)) * 1000).astype(dtype)
    url = str(tmp_path / "a.zarr")
    fill = 3 if dtype == "<u2" else "NaN"
    store = ts.open({
        "driver": "zarr", "kvstore": {"driver": "file", "path": url},
        "metadata": {"shape": list(a.shape), "chunks": [6, 6, 6], "dtype": dtype,
                     "fill_value": fill, "compressor": _COMPRESSORS[compressor],
                     "dimension_separator": sep},
        "create": True, "delete_existing": True,
    }).result()
    store[0:6, 0:6, 0:6] = a[0:6, 0:6, 0:6]
    store[10:13, 12:17, 6:9] = a[10:13, 12:17, 6:9]  # parts of edge chunks
    expect = np.full(a.shape, 3 if dtype == "<u2" else np.nan, a.dtype)
    expect[0:6, 0:6, 0:6] = a[0:6, 0:6, 0:6]
    expect[10:13, 12:17, 6:9] = a[10:13, 12:17, 6:9]
    lazy = tzb.open_zarr_array(url)
    assert lazy.shape == a.shape and lazy.dtype == a.dtype
    np.testing.assert_array_equal(np.asarray(lazy), expect)
    np.testing.assert_array_equal(np.asarray(lazy[4:12, 1, ::3]), expect[4:12, 1, ::3])


def test_lazy_views_compose_and_write_regions(tmp_path):
    rng = np.random.default_rng(3)
    a = rng.integers(0, 255, (2, 11, 14)).astype(np.uint8)
    arr = tzb.create_zarr_array(str(tmp_path / "a.zarr"), a.shape, (1, 4, 5), a.dtype)
    arr[...] = a
    view = arr[1, 2:9:2]
    assert isinstance(view, tzb.LazyZarrArray) and view.shape == (4, 14)
    for idx in [(slice(1, 3), 5), (-1,), (Ellipsis, slice(3, None, 4)), np.s_[::-1]]:
        np.testing.assert_array_equal(np.asarray(view[idx]), a[1, 2:9:2][idx])
    assert arr[0, 3, 4] == a[0, 3, 4]
    np.testing.assert_array_equal(np.asarray(arr[:, [1, 3]]), a[:, [1, 3]])
    arr[1, 2:9][1:3, 2:6] = 200  # a region write through a view: rows 3-4 of channel 1
    a[1, 3:5, 2:6] = 200
    with pytest.raises(NotImplementedError, match="step"):
        view[1:3, 2:6] = 0
    np.testing.assert_array_equal(jzb.open_zarr_array(str(tmp_path / "a.zarr")).read(), a)


def test_blosc_and_other_compressors_are_refused_with_their_name(tmp_path, monkeypatch):
    url = str(tmp_path / "blosc.zarr")
    # the reference's create_zarr_array sets no compressor: tensorstore's
    # default, blosc-lz4, applies
    jzb.create_zarr_array(url, (8, 8), (4, 4), np.uint16)[...] = np.ones((8, 8), np.uint16)
    assert json.loads((tmp_path / "blosc.zarr" / ".zarray").read_text())["compressor"]["id"] == "blosc"
    monkeypatch.setitem(sys.modules, "numcodecs", None)  # neither blosc module imports
    monkeypatch.setitem(sys.modules, "blosc", None)
    with pytest.raises(NotImplementedError, match="blosc"):
        tzb.open_zarr_array(url)
    with pytest.raises(NotImplementedError, match="blosc"):
        tzb.create_zarr_array(str(tmp_path / "b.zarr"), (4,), (2,), np.uint8,
                              compressor={"id": "blosc", "cname": "lz4"})
    with pytest.raises(NotImplementedError, match="zstd"):
        tzb.create_zarr_array(str(tmp_path / "c.zarr"), (4,), (2,), np.uint8,
                              compressor={"id": "zstd", "level": 1})


class _FakeBlosc:
    """Stands in for numcodecs' codec and the blosc module: zlib under
    blosc's name, to run both of the port's blosc paths."""

    def encode(self, chunk):
        return zlib.compress(chunk.tobytes())

    def compress(self, raw, **kw):
        return zlib.compress(raw)

    def decode(self, raw):
        return zlib.decompress(raw)

    decompress = decode


@pytest.mark.parametrize("module", ["numcodecs", "blosc"])
def test_blosc_chunks_go_through_whichever_blosc_module_imports(tmp_path, monkeypatch, module):
    fake = _FakeBlosc()
    if module == "numcodecs":
        monkeypatch.setitem(sys.modules, "numcodecs", types.SimpleNamespace(get_codec=lambda c: fake))
    else:
        monkeypatch.setitem(sys.modules, "numcodecs", None)
        monkeypatch.setitem(sys.modules, "blosc", fake)
    a = np.arange(6 * 7, dtype=np.uint16).reshape(6, 7)
    url = str(tmp_path / "a.zarr")
    blosc = {"id": "blosc", "cname": "lz4", "clevel": 5, "shuffle": -1, "blocksize": 0}
    tzb.create_zarr_array(url, a.shape, (4, 4), a.dtype, compressor=blosc)[...] = a
    np.testing.assert_array_equal(np.asarray(tzb.open_zarr_array(url)), a)
    assert zlib.decompress((tmp_path / "a.zarr" / "1.1").read_bytes())[:2] == a[4, 4:5].tobytes()


def test_zarr_v3_is_refused_naming_its_roadmap_item(tmp_path):
    """Zarr v3 was refused until its item was ported; the calls that raised
    now read and write what tensorstore does (tests/test_torch_zarr3.py
    holds the rest): a v3 array the port creates, one the reference wrote,
    and an NGFF 0.5 ``fuse()``, each against the reference."""
    a = np.arange(4, dtype=np.uint8)
    arr = tzb.create_zarr_array(str(tmp_path / "a.zarr"), (4,), (2,), np.uint8, zarr_format=3)
    arr[...] = a
    np.testing.assert_array_equal(jzb.open_zarr_array(str(tmp_path / "a.zarr")).read(), a)
    url = str(tmp_path / "v3.zarr")
    b = np.arange(16, dtype=np.uint16).reshape(4, 4)
    jzb.create_zarr_array(url, (4, 4), (2, 2), np.uint16, zarr_format=3)[...] = b
    np.testing.assert_array_equal(np.asarray(tzb.open_zarr_array(url)), b)
    sims = _grid_sims(n=2)
    kw = dict(transform_key=KEY, zarr_options={"ngff_version": "0.5"})
    got = tfuse(_to_port(sims), device="cpu", output_zarr_url=str(tmp_path / "out.zarr"), **kw)
    ref = jfuse(sims, output_zarr_url=str(tmp_path / "ref.zarr"), **kw)
    assert jzb.read_group_metadata(str(tmp_path / "out.zarr")) == jzb.read_group_metadata(
        str(tmp_path / "ref.zarr"))
    _assert_close(np.asarray(got.data), np.asarray(ref.data))


def test_group_metadata_reads_back_in_both_packages(tmp_path):
    attrs = {"multiscales": [{"version": "0.4", "datasets": [{"path": "0"}]}]}
    tzb.write_group_metadata(str(tmp_path / "g"), attrs)
    assert jzb.read_group_metadata(str(tmp_path / "g")) == (attrs, 2)
    jzb.write_group_metadata(str(tmp_path / "h"), attrs)
    assert tzb.read_group_metadata(str(tmp_path / "h")) == (attrs, 2)


# ---------------------------------------------------------------------------
# pyramid plan, NGFF metadata, lazy sims
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [{"z": 64, "y": 1676, "x": 1676}, {"y": 228, "x": 90},
                                   {"y": 50, "x": 40}])
def test_resolution_levels_and_coarsening_match_the_reference(shape):
    assert tmsi.calc_resolution_levels(shape) == msi_utils.calc_resolution_levels(shape)
    _, _, abs_f = tmsi.calc_resolution_levels(shape)
    props = {"spacing": {d: 0.5 for d in shape}, "origin": {d: 3.0 for d in shape}}
    assert (tngff.calc_ngff_coordinate_transformations_and_axes(props, abs_f, nsdims=["c"])
            == jngff.calc_ngff_coordinate_transformations_and_axes(props, abs_f, nsdims=["c"]))
    data = np.random.default_rng(4).integers(0, 65535, (2, 9, 13)).astype(np.uint16)
    np.testing.assert_array_equal(tmsi._coarsen_mean(data, (1, 2, 3)),
                                  msi_utils._coarsen_mean(data, (1, 2, 3)))


def test_sims_keep_a_zarr_array_lazy(tmp_path, monkeypatch):
    a = np.arange(2 * 6 * 7, dtype=np.uint16).reshape(2, 6, 7)
    arr = tzb.create_zarr_array(str(tmp_path / "a.zarr"), a.shape, (1, 3, 3), a.dtype)
    arr[...] = a
    reads = []
    orig = tzb.ZarrV2.read
    monkeypatch.setattr(tzb.ZarrV2, "read", lambda self, box: reads.append(box) or orig(self, box))
    sim = tsi.get_sim_from_array(tzb.open_zarr_array(str(tmp_path / "a.zarr")),
                                 dims=("c", "y", "x"), c_coords=["a", "b"])
    one = tsi.sim_sel_coords(sim, {"c": "b"})
    crop = tsi.sim_sel_coords(one, {"y": slice(2, 4)})
    assert isinstance(crop.data, tzb.LazyZarrArray) and crop.data.shape == (3, 7)
    assert crop.origin == {"y": 2.0, "x": 0.0} and not reads
    np.testing.assert_array_equal(crop.to_numpy(), a[1, 2:5])
    assert reads == [[(1, 2), (2, 5), (0, 7)]]


def test_lazy_tiles_that_do_not_band_take_the_monolithic_tier(tmp_path, monkeypatch):
    sims = _grid_sims(n=2)  # two rows of tiles: fewer than 3 bands
    _, psims = _zarr_tiles(tmp_path, sims)
    ran = _spy_streaming(monkeypatch, tstream)
    got = _port_fuse(psims)
    assert ran == [False]
    np.testing.assert_array_equal(got, _port_fuse(_to_port(sims)))


def test_lazy_tile_reads_retry_transient_errors_only(monkeypatch):
    monkeypatch.setattr(residency.time, "sleep", lambda s: None)
    data = np.arange(12, dtype=np.uint16).reshape(3, 4)

    class Flaky:
        shape, dtype = data.shape, data.dtype

        def __init__(self, failures, error):
            self.failures, self.error = failures, error

        def __array__(self, dtype=None, copy=None):
            if self.failures:
                self.failures -= 1
                raise self.error
            return data

    def sims(failures, error):
        return [tsi.get_sim_from_array(Flaky(failures, error), dims=("y", "x"))]

    np.testing.assert_array_equal(residency.materialize_tiles(sims(2, OSError("reset")))[0], data)
    with pytest.raises(OSError):
        residency.materialize_tiles(sims(3, OSError("reset")))  # one more than the retries
    with pytest.raises(ValueError):
        residency.materialize_tiles(sims(1, ValueError("not transient")))


# ---------------------------------------------------------------------------
# band plan and streaming tier
# ---------------------------------------------------------------------------


def _layout(name):
    """(offs, extents, out_shape, tile_shape, axis_chunk) of a band plan."""
    if name == "column":
        offs = np.zeros((8, 2), np.float32)
        offs[:, 0] = -np.arange(8) * 32.0
        return offs, np.full((8, 2), 64.0, np.float32), (288, 64), (16, 16), None
    if name == "grid_3d_zarr":
        # the north star's grid: 32 x 32 tiles of 64^3 at a step of 52
        yy, xx = np.meshgrid(np.arange(32), np.arange(32), indexing="ij")
        offs = np.stack([np.zeros(1024), -52.0 * yy.ravel(), -52.0 * xx.ravel()], 1)
        return (offs.astype(np.float32), np.full((1024, 3), 64.0, np.float32),
                (64, 1676, 1676), (64, 8, 32), (128, 128, 128))
    if name == "irregular":
        # a sparse column of tiles, then a dense row sharing one band
        offs = np.array([[-30.0 * i, 0.0] for i in range(6)]
                        + [[-200.0, -12.0 * i] for i in range(12)], np.float32)
        return offs, np.full((18, 2), 40.0, np.float32), (240, 172), (16, 16), None
    if name == "degenerate":
        return np.zeros((4, 2), np.float32), np.full((4, 2), 64.0, np.float32), (64, 64), (16, 16), None
    if name == "mixed_extents":
        offs = np.zeros((6, 2), np.float32)
        offs[:, 1] = -np.arange(6) * 30.0
        ext = np.full((6, 2), 40.0, np.float32)
        ext[::2, 1] = 36.0  # band axis 1 has mixed extents; axis 0 one band
        return offs, ext, (40, 190), (8, 8), None
    raise KeyError(name)


@pytest.mark.parametrize("name", ["column", "grid_3d_zarr", "irregular", "degenerate",
                                  "mixed_extents"])
def test_plan_bands_matches_the_reference(name):
    args = _layout(name)
    got, ref = tstream.plan_bands(*args), jstream.plan_bands(*args)
    if ref is None:
        assert got is None
        return
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def _port_fuse(sims, **kw):
    return tfuse(sims, transform_key=KEY, device="cpu", **kw).to_numpy()


@pytest.mark.parametrize("ndim,dtype", [(2, np.uint16), (2, np.float32), (3, np.uint16),
                                        (3, np.float32)])
def test_streaming_is_bit_equal_to_monolithic(ndim, dtype, monkeypatch):
    sims = _to_port(_grid_sims(n=5 if ndim == 2 else 4, tile=48 if ndim == 2 else 32,
                               overlap=12 if ndim == 2 else 8, ndim=ndim, dtype=dtype))
    ran = _spy_streaming(monkeypatch, tstream)
    monkeypatch.setattr(tcore, "STREAM_BYTES", 0)
    streamed = _port_fuse(sims)
    assert ran == [True]
    tele = tstream.last_telemetry
    assert tele["bands_done"] == tele["bands_total"] >= 3 and tele["voxels_written"] == streamed.size
    monkeypatch.setattr(tcore, "STREAM_BYTES", 1 << 40)
    mono = _port_fuse(sims)
    assert ran == [True]
    np.testing.assert_array_equal(streamed, mono)


def test_streaming_windows_of_single_view_batches(monkeypatch):
    """One view a batch: a band's window spans many batches and runs past the
    last one; the sparse column and the dense row of the reference's test."""
    rng = np.random.default_rng(33)
    sims = [si_utils.get_sim_from_array(rng.integers(0, 3000, (40, 40)).astype(np.uint16),
                                        translation={"y": float(iy * 30), "x": 0.0})
            for iy in range(6)]
    sims += [si_utils.get_sim_from_array(rng.integers(0, 3000, (40, 40)).astype(np.uint16),
                                         translation={"y": 200.0, "x": float(ix * 12)})
             for ix in range(12)]
    monkeypatch.setattr(tstream, "_BATCH_BYTES", 1)
    monkeypatch.setattr(tcore, "STREAM_BYTES", 0)
    streamed = _port_fuse(_to_port(sims))
    assert tstream.last_telemetry["batch_views"] == 1 and tstream.last_telemetry["bands_done"] > 3
    monkeypatch.setattr(tcore, "STREAM_BYTES", 1 << 40)
    np.testing.assert_array_equal(streamed, _port_fuse(_to_port(sims)))


@pytest.mark.parametrize("dtype", [np.uint16, np.float32])
def test_streaming_matches_the_reference_streaming(dtype, jax_streams, monkeypatch):
    sims = _grid_sims(n=6, tile=48, overlap=12, dtype=dtype)
    jran = _spy_streaming(monkeypatch, jstream)
    ref = np.asarray(jfuse(sims, transform_key=KEY, output_chunksize=64).data)
    assert jran == [True]
    ran = _spy_streaming(monkeypatch, tstream)
    monkeypatch.setattr(tcore, "STREAM_BYTES", 0)
    got = _port_fuse(_to_port(sims), output_chunksize=64)
    assert ran == [True]
    _assert_close(got, ref)


def test_deadline_aborts_with_telemetry():
    sims = _to_port(_grid_sims(n=6))
    osp = tcore.process_output_stack_properties(sims, transform_key=KEY)
    with pytest.raises(tstream.StreamingDeadlineError) as ei:
        tstream.execute_streaming(
            {"sparams": [np.eye(3)] * len(sims)}, sims, osp, ["y", "x"],
            blending_widths=None, shrink_distance=0, out_dtype=np.uint16, deadline_s=0,
        )
    tele = ei.value.telemetry
    assert tele["aborted"] and tele["deadline_s"] == 0
    assert tele["bands_done"] < tele["bands_total"]
    assert tele is tstream.last_telemetry


def test_a_failing_band_write_raises_and_nothing_falls_back(tmp_path, monkeypatch):
    sims = _to_port(_grid_sims(n=6))
    called = []
    monkeypatch.setattr(tcore, "_execute_fusion_plan_translation", lambda *a, **k: called.append(1))

    def failing_write(self, box, value):
        raise OSError("injected band write failure")

    monkeypatch.setattr(tzb.ZarrV2, "write", failing_write)
    with pytest.raises(OSError, match="injected"):
        _port_fuse(_zarr_tiles(tmp_path, sims)[1], output_chunksize=64,
                   output_zarr_url=str(tmp_path / "out.zarr"))
    assert not called


def test_a_failing_batch_read_raises_and_nothing_falls_back(streams, monkeypatch):
    """A batch whose read fails on a reader thread raises from fuse():
    nothing falls back to another tier and nothing hangs."""
    sims = _to_port(_grid_sims(n=6))
    called = []
    monkeypatch.setattr(tcore, "_execute_fusion_plan_translation", lambda *a, **k: called.append(1))

    def failing_read(*a, **k):
        raise OSError("injected batch read failure")

    monkeypatch.setattr(residency, "materialize_tiles", failing_read)
    with pytest.raises(OSError, match="injected"):
        _port_fuse(sims, output_chunksize=64)
    assert not called


# ---------------------------------------------------------------------------
# zarr -> zarr end to end
# ---------------------------------------------------------------------------


def _zarr_tiles(tmp_path, sims):
    """Each tile as its own zarr v2 array (tensorstore, zlib); the reference's
    and the port's sims of them, lazy."""
    jsims, psims = [], []
    for i, s in enumerate(sims):
        url = str(tmp_path / "tiles" / f"tile_{i}.zarr")
        data = np.asarray(s.data)
        jzb.create_zarr_array(url, data.shape, data.shape, data.dtype,
                              compressor={"id": "zlib", "level": 1})[...] = data
        kw = dict(dims=s.dims, translation=dict(s.origin),
                  c_coords=s.coords.get("c") if "c" in s.dims else None)
        jsim = si_utils.get_sim_from_array(jzb.open_zarr_array(url), **kw)
        psim = tsi.get_sim_from_array(tzb.open_zarr_array(url), **kw)
        for key, x in s.transforms.items():
            si_utils.set_sim_affine(jsim, x.data, transform_key=key)
            tsi.set_sim_affine(psim, x.data, transform_key=key)
        jsims.append(jsim)
        psims.append(psim)
    return jsims, psims


def _rotated_sims():
    sims = _grid_sims(n=2, tile=120, overlap=24)
    for i, s in enumerate(sims):
        c, sn = np.cos(0.04 * (i - 1.5)), np.sin(0.04 * (i - 1.5))
        m = np.eye(3)
        m[:2, :2] = [[c, -sn], [sn, c]]
        si_utils.set_sim_affine(s, m, transform_key=KEY)
    return sims


_ZARR_CASES = {
    # (sims, zarr options): two pyramid levels in every OME-Zarr case
    "grid_2d": (lambda: _grid_sims(n=6, tile=48, overlap=12), {}),
    "grid_2d_channels": (lambda: _grid_sims(n=6, tile=48, overlap=12, channels=["a", "b"]), {}),
    "plain_array": (lambda: _grid_sims(n=6, tile=48, overlap=12), {"ome_zarr": False}),
    "rotated_affine_tier": (_rotated_sims, {}),
}


@pytest.mark.parametrize("name", list(_ZARR_CASES))
def test_zarr_to_zarr_matches_the_reference(name, tmp_path, jax_streams, monkeypatch):
    make, zarr_options = _ZARR_CASES[name]
    jsims, psims = _zarr_tiles(tmp_path, make())
    if name == "rotated_affine_tier":
        monkeypatch.setenv("MVS_TPU_EXACT_AFFINE", "1")
        monkeypatch.setenv("MVS_TPU_SHEAR", "0")
    ran = _spy_streaming(monkeypatch, tstream)
    kw = dict(transform_key=KEY, output_chunksize=64, zarr_options=zarr_options)
    jurl, purl = str(tmp_path / "jax.ome.zarr"), str(tmp_path / "port.ome.zarr")
    ref = jfuse(jsims, output_zarr_url=jurl, **kw)
    got = tfuse(psims, output_zarr_url=purl, device="cpu", **kw)
    # lazy translation tiles always stream, once a channel; the affine tier
    # has no bands
    assert ran == ([] if name == "rotated_affine_tier" else [True] * (2 if "channels" in name else 1))
    assert isinstance(got.data, tzb.LazyZarrArray)
    assert got.dims == ref.dims and got.spacing == ref.spacing and got.origin == ref.origin
    np.testing.assert_array_equal(got.transforms[KEY].data, ref.transforms[KEY].data)
    if not zarr_options.get("ome_zarr", True):
        _assert_close(jzb.open_zarr_array(purl).read(), jzb.open_zarr_array(jurl).read())
        _assert_close(np.asarray(got.data), np.asarray(ref.data))
        return
    jattrs, pattrs = jzb.read_group_metadata(jurl), jzb.read_group_metadata(purl)
    assert pattrs == jattrs
    datasets = jattrs[0]["multiscales"][0]["datasets"]
    assert len(datasets) >= 2
    for ds in datasets:
        p = jzb.open_zarr_array(f"{purl}/{ds['path']}").read()
        _assert_close(p, jzb.open_zarr_array(f"{jurl}/{ds['path']}").read())
        assert p.any()
    _assert_close(np.asarray(got.data), np.asarray(ref.data))


def test_zarr_to_zarr_3d_equals_the_in_memory_fusion(tmp_path, monkeypatch):
    """A 3D grid of zarr tiles fused into an OME-Zarr: level 0 bit-equal to
    the in-memory monolithic fusion of the same tiles, each pyramid level the
    reference's block mean of the level before (the 3D kernel is held
    against the reference in tests/test_torch_fuse.py; the reference's 3D
    interpret-mode streaming would cost this file a minute of compiling)."""
    sims = _grid_sims(n=7, tile=40, overlap=10, ndim=3)
    _, psims = _zarr_tiles(tmp_path, sims)
    ran = _spy_streaming(monkeypatch, tstream)
    url = str(tmp_path / "port.ome.zarr")
    got = tfuse(psims, transform_key=KEY, device="cpu", output_chunksize=64,
                output_zarr_url=url)
    assert ran == [True] and tstream.last_telemetry["bands_done"] >= 3
    monkeypatch.setattr(tcore, "STREAM_BYTES", 1 << 40)
    mono = _port_fuse(_to_port(sims), output_chunksize=64)
    np.testing.assert_array_equal(np.asarray(got.data), mono)
    attrs, fmt = jzb.read_group_metadata(url)
    datasets = attrs["multiscales"][0]["datasets"]
    assert fmt == 2 and len(datasets) == 2
    prev = jzb.open_zarr_array(f"{url}/0").read()
    np.testing.assert_array_equal(prev, mono)
    level1 = jzb.open_zarr_array(f"{url}/1").read()
    np.testing.assert_array_equal(level1, msi_utils._coarsen_mean(prev, (1, 2, 2)))
    assert attrs == {"multiscales": [{
        "axes": [{"name": d, "type": "space", "unit": "micrometer"} for d in "zyx"],
        "datasets": [
            {"path": str(i), "coordinateTransformations": [
                {"type": "scale", "scale": [1.0, 2.0**i, 2.0**i]},
                {"type": "translation", "translation": [0.0, 0.5 * (2**i - 1), 0.5 * (2**i - 1)]},
            ]} for i in range(2)
        ],
        "version": "0.4",
    }]}


# ---------------------------------------------------------------------------
# F1: outputs in dtypes the kernels do not write
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["int16", "uint16", "uint8", "int8", "int32", "uint32",
                                   "int64", "uint64", "float16", "float64"])
def test_cast_matches_jnp_astype(dtype):
    # truncation, negative values, values out of range and at the ends of
    # the 32- and 64-bit ranges, inf and NaN (the tests run jnp with x64)
    x = np.array([-70000.7, -40000.2, -32768.9, -5.7, -0.5, 0.4, 3.9, 254.6, 32767.9, 40000.5,
                  65535.9, 70000.1, 3e9, -3e9, 2147483520.0, 5e9, 1e19, 2e19, -1e19,
                  np.inf, -np.inf, np.nan], np.float32)
    ref = np.asarray(jnp.nan_to_num(jnp.asarray(x)).astype(jnp.dtype(dtype)))
    got = ttf._cast(torch.from_numpy(x), residency.torch_dtype(np.dtype(dtype))).numpy()
    assert got.dtype == ref.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(got, ref)


def _f1_sims(dtype, rotated):
    """ROADMAP F1's inputs: a 2 x 2 grid of 40^2 tiles at offsets 0 and 30,
    values 0-999; ``rotated`` turns each tile a little about its centre."""
    rng = np.random.default_rng(17)
    sims = []
    for iy in range(2):
        for ix in range(2):
            sim = si_utils.get_sim_from_array(
                (rng.random((40, 40)) * 999).astype(dtype),
                translation={"y": 30.0 * iy, "x": 30.0 * ix},
            )
            if rotated:
                th = 0.05 * (2 * iy + ix - 1.5)
                lin = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
                centre = np.array([30.0 * iy, 30.0 * ix]) + 19.5
                m = np.eye(3)
                m[:2, :2], m[:2, 2] = lin, centre - lin @ centre
                si_utils.set_sim_affine(sim, m, transform_key=KEY)
            sims.append(sim)
    return sims


@pytest.mark.parametrize("tier", ["translation", "affine"])
@pytest.mark.parametrize("dtype", [np.int16, np.float64])
def test_fuse_keeps_int16_and_float64_as_the_reference(tier, dtype, monkeypatch):
    monkeypatch.setenv("MVS_TPU_EXACT_AFFINE", "1")
    monkeypatch.setenv("MVS_TPU_SHEAR", "0")
    jcore.clear_device_tile_cache()
    sims = _f1_sims(dtype, rotated=tier == "affine")
    ref = np.asarray(jfuse(sims, transform_key=KEY, output_chunksize=32).data)
    got = _port_fuse(_to_port(sims), output_chunksize=32)
    assert got.dtype == ref.dtype == dtype and got.shape == ref.shape
    if dtype == np.int16:
        assert np.abs(got.astype(np.int64) - ref.astype(np.int64)).max() <= 1
    elif tier == "translation":
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-3)
    else:
        # the exact-affine bound, 5e-3 on data in [0, 100), on data in [0, 999)
        np.testing.assert_allclose(got, ref, rtol=0, atol=5e-2)
    jcore.clear_device_tile_cache()
    jax.clear_caches()


# ---------------------------------------------------------------------------
# reuse across calls: the resident stack, seeding, the resume stash
# ---------------------------------------------------------------------------


@pytest.fixture
def streams(monkeypatch, jax_streams):
    """The port streams test-sized grids; its caches start empty."""
    monkeypatch.setattr(tcore, "STREAM_BYTES", 0)
    tcore.clear_device_tile_cache()
    yield
    tcore.clear_device_tile_cache()


_JAX_REFS: dict = {}


def _jax_ref(name, sims):
    """The reference's streamed fuse() of a named grid, computed once."""
    if name not in _JAX_REFS:
        jcore.clear_device_tile_cache()
        _JAX_REFS[name] = np.asarray(jfuse(sims, transform_key=KEY, output_chunksize=64).data)
    return _JAX_REFS[name]


def _gaussian_sims(n=6, tile=48, overlap=12):
    """Band-limited tiles: locally constant gradients (delta2 content)."""
    from scipy.ndimage import gaussian_filter

    step = tile - overlap
    rng = np.random.default_rng(7)
    sims = []
    for idx in np.ndindex((n, n)):
        d = gaussian_filter(rng.random((tile, tile)), 3.0)
        d -= d.min()
        sims.append(si_utils.get_sim_from_array(
            (d * (3000 / max(d.max(), 1e-9))).astype(np.uint16), dims=["y", "x"],
            translation={"y": float(idx[0] * step), "x": float(idx[1] * step)}))
    return sims


def _count_reads(monkeypatch):
    reads = []
    materialize = residency.materialize_tiles
    monkeypatch.setattr(residency, "materialize_tiles",
                        lambda *a, **k: (reads.append(1), materialize(*a, **k))[1])
    return reads


class _FakeClock:
    """``time.perf_counter`` advancing 0.5 s a call: a 2 s deadline trips
    after the first band."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.5
        return self.t


def _aborted_pass(sims, **kw):
    import time as time_mod

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(time_mod, "perf_counter", _FakeClock())
        mp.setattr(tstream, "STREAM_DEADLINE_S", 2)
        with pytest.raises(tstream.StreamingDeadlineError):
            _port_fuse(sims, output_chunksize=64, **kw)


def test_streaming_seeds_device_tile_cache(streams, monkeypatch):
    """The reference's test of the same name: a pass keeps its batches and
    seeds the device tile cache, and the next fuse() gathers every batch
    from the resident stack, reading and uploading no tile."""
    sims = _grid_sims(n=4)
    jran = _spy_streaming(monkeypatch, jstream)
    ref = np.asarray(jfuse(sims, transform_key=KEY).data)
    assert jran == [True]
    psims = _to_port(sims)
    ran = _spy_streaming(monkeypatch, tstream)
    reads = _count_reads(monkeypatch)
    first = _port_fuse(psims)
    tele = dict(tstream.last_telemetry)
    assert reads and tele["up_bytes"] > 0 and tele["up_batches_resident"] == 0
    stack = residency.device_tile_cache.get(residency.device_tile_cache.key_for(psims, "cpu"))
    np.testing.assert_array_equal(stack.numpy(), np.stack([np.asarray(s.data) for s in sims]))
    reads.clear()
    second = _port_fuse(psims)
    tele = tstream.last_telemetry
    assert ran == [True, True] and not reads and tele["up_bytes"] == 0
    assert tele["up_batches_resident"] == tele["batches"] and tele["up_batches_reused"] == 0
    np.testing.assert_array_equal(first, second)
    _assert_close(first, ref)


def test_streaming_abort_stashes_uploads_for_resume(streams, monkeypatch):
    """The reference's test of the same name: a pass past its deadline
    (``STREAM_DEADLINE_S``, a fake clock) leaves its completed uploads in
    the resume stash; the retry reuses them, uploads less, completes
    bit-equal, seeds the cache and retires the stash."""
    # two tiles a batch: 18 batches, of which the first band's window and
    # prefetch submit about 13 before the deadline trips
    monkeypatch.setattr(tstream, "_BATCH_BYTES", 2 * 48 * 48 * 2)
    sims = _grid_sims(n=6, tile=48, overlap=12)
    psims = _to_port(sims)
    clean = _port_fuse(psims, output_chunksize=64)
    control_up = tstream.last_telemetry["up_bytes"]
    assert control_up > 0
    tcore.clear_device_tile_cache()
    assert tstream._upload_stash == {}
    _aborted_pass(psims)
    entry = tstream._upload_stash
    assert entry and 0 < len(entry["batches"]) < tstream.last_telemetry["batches"]
    n_stashed = len(entry["batches"])
    resumed = _port_fuse(psims, output_chunksize=64)
    tele = tstream.last_telemetry
    assert tele["up_batches_reused"] == n_stashed and tele["up_bytes"] < control_up
    np.testing.assert_array_equal(resumed, clean)
    assert tstream._upload_stash == {}
    again = _port_fuse(psims, output_chunksize=64)
    assert tstream.last_telemetry["up_bytes"] == 0
    np.testing.assert_array_equal(again, clean)
    _assert_close(clean, _jax_ref("grid_6", sims))


def test_the_resume_stash_dies_with_the_views_arrays(streams, monkeypatch):
    import gc

    monkeypatch.setattr(tstream, "_BATCH_BYTES", 2 * 48 * 48 * 2)
    psims = _to_port(_grid_sims(n=6, tile=48, overlap=12, seed=5))
    _aborted_pass(psims)
    assert tstream._upload_stash["batches"]
    del psims
    gc.collect()
    assert tstream._upload_stash == {}


def test_a_tile_cache_seeding_failure_warns_and_the_output_stands(streams, monkeypatch):
    """A seeding that fails warns, the fused output stands, nothing is
    cached or stashed, and the repeat pass reads and uploads every batch
    again."""
    monkeypatch.setattr(tstream, "_BATCH_BYTES", 6 * 48 * 48 * 2)

    def boom(*a, **k):
        raise RuntimeError("simulated reorder failure")

    monkeypatch.setattr(tstream, "_reorder_concat", boom)
    sims = _grid_sims(n=6, tile=48, overlap=12)
    psims = _to_port(sims)
    reads = _count_reads(monkeypatch)
    with pytest.warns(RuntimeWarning, match="seeding failed"):
        out1 = _port_fuse(psims, output_chunksize=64)
    tele1 = dict(tstream.last_telemetry)
    assert tele1["up_bytes"] > 0 and len(reads) == tele1["batches"]
    assert not residency.device_tile_cache._entries and tstream._upload_stash == {}
    reads.clear()
    with pytest.warns(RuntimeWarning, match="seeding failed"):
        out2 = _port_fuse(psims, output_chunksize=64)
    tele2 = tstream.last_telemetry
    assert tele2["up_bytes"] == tele1["up_bytes"] and len(reads) == tele2["batches"]
    assert tele2["up_batches_reused"] == tele2["up_batches_resident"] == 0
    np.testing.assert_array_equal(out1, out2)
    _assert_close(out1, _jax_ref("grid_6", sims))


def test_uploads_take_the_resume_stash_then_the_resident_stack(streams, monkeypatch):
    monkeypatch.setattr(tstream, "_BATCH_BYTES", 2 * 48 * 48 * 2)  # 18 batches
    sims = _grid_sims(n=6, tile=48, overlap=12)
    psims = _to_port(sims)
    clean = _port_fuse(psims, output_chunksize=64)
    n = tstream.last_telemetry["batches"]

    def run():
        np.testing.assert_array_equal(_port_fuse(psims, output_chunksize=64), clean)
        tele = tstream.last_telemetry
        return tele["up_batches_reused"], tele["up_batches_resident"], tele["up_bytes"]

    # the first call seeded the resident stack: every batch a gather
    assert run() == (0, n, 0)
    # the resume stash before a read: an aborted pass's batches are reused,
    # the rest read and uploaded, and the pass seeds the stack again
    tcore.clear_device_tile_cache()
    _aborted_pass(psims)
    stashed = set(tstream._upload_stash["batches"])
    assert 0 < len(stashed) < n
    reused, resident, up = run()
    assert (reused, resident) == (len(stashed), 0) and up > 0
    assert tstream._upload_stash == {}
    assert run() == (0, n, 0)
    _assert_close(clean, _jax_ref("grid_6", sims))


def test_tiles_above_the_cache_budget_retain_and_seed_nothing(streams, monkeypatch):
    monkeypatch.setattr(tstream, "_BATCH_BYTES", 20000)
    sims = _grid_sims(n=6, tile=48, overlap=12)
    psims = _to_port(sims)
    monkeypatch.setattr(residency, "TILE_CACHE_BYTES", 36 * 48 * 48 * 2 - 1)
    reorders = []
    reorder = tstream._reorder_concat
    monkeypatch.setattr(tstream, "_reorder_concat",
                        lambda *a, **k: (reorders.append(1), reorder(*a, **k))[1])
    first = _port_fuse(psims, output_chunksize=64)
    up = tstream.last_telemetry["up_bytes"]
    assert up > 0 and not reorders
    assert not residency.device_tile_cache._entries and tstream._upload_stash == {}
    second = _port_fuse(psims, output_chunksize=64)
    tele = tstream.last_telemetry
    assert tele["up_bytes"] == up and tele["up_batches_resident"] == tele["up_batches_reused"] == 0
    np.testing.assert_array_equal(first, second)
    _assert_close(first, _jax_ref("grid_6", sims))


def test_a_pass_over_part_of_the_views_seeds_nothing(streams, monkeypatch):
    """An output window that ends before the last views (as a block of
    ``prepare_block_fusion`` does) never uploads their batches: the pass
    keeps none and seeds nothing, warns nothing, and once a whole pass has
    seeded the stack the window's repeat gathers from it."""
    import warnings

    rng = np.random.default_rng(21)
    sims = _to_port([
        si_utils.get_sim_from_array(rng.integers(0, 3000, (48, 48)).astype(np.uint16),
                                    translation={"y": float(iy * 36), "x": float(ix * 36)})
        for iy in range(12) for ix in range(2)
    ])
    osp = tcore.process_output_stack_properties(sims, transform_key=KEY)
    window = {k: dict(v) for k, v in osp.items()}
    window["shape"]["y"] = 200
    monkeypatch.setattr(tstream, "_BATCH_BYTES", 1)  # one view a batch
    ran = _spy_streaming(monkeypatch, tstream)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        part = _port_fuse(sims, output_stack_properties=window)
    tele = tstream.last_telemetry
    assert ran == [True] and tele["bands_total"] >= 3
    assert not residency.device_tile_cache._entries and tstream._upload_stash == {}
    monkeypatch.setattr(tcore, "STREAM_BYTES", 1 << 40)
    np.testing.assert_array_equal(part, _port_fuse(sims, output_stack_properties=window))
    monkeypatch.setattr(tcore, "STREAM_BYTES", 0)
    tcore.clear_device_tile_cache()
    _port_fuse(sims)  # the whole output: every batch, seeded
    assert residency.device_tile_cache._entries
    np.testing.assert_array_equal(_port_fuse(sims, output_stack_properties=window), part)
    tele = tstream.last_telemetry
    assert tele["up_bytes"] == 0 and tele["up_batches_resident"] > 0


def test_lazy_zarr_repeat_reads_no_tile(streams, monkeypatch, tmp_path):
    sims = _gaussian_sims()
    _, psims = _zarr_tiles(tmp_path, sims)
    reads = _count_reads(monkeypatch)
    cold = _port_fuse(psims, output_chunksize=64)
    assert reads
    reads.clear()
    repeat = _port_fuse(psims, output_chunksize=64)
    tele = tstream.last_telemetry
    assert not reads and tele["up_bytes"] == 0 and tele["up_batches_resident"] == tele["batches"]
    np.testing.assert_array_equal(repeat, cold)
    _assert_close(cold, _jax_ref("gaussian", sims))


def test_3d_resident_repeat_equals_cold_and_monolithic(streams, monkeypatch):
    sims = _to_port(_grid_sims(n=4, tile=32, overlap=8, ndim=3))
    cold = _port_fuse(sims)
    assert tstream.last_telemetry["up_bytes"] > 0
    repeat = _port_fuse(sims)
    tele = tstream.last_telemetry
    assert tele["up_bytes"] == 0 and tele["up_batches_resident"] == tele["batches"]
    monkeypatch.setattr(tcore, "STREAM_BYTES", 1 << 40)
    up0 = residency.tile_upload_bytes
    mono_cached = _port_fuse(sims)
    assert residency.tile_upload_bytes == up0  # the monolithic tier takes the seeded stack
    tcore.clear_device_tile_cache()
    mono = _port_fuse(sims)
    for out in (repeat, mono_cached, cold):
        np.testing.assert_array_equal(out, mono)


_F7_CHILD = """
import sys
import numpy as np
import torch
sys.path.insert(0, {root!r})
import chip_smoke
from multiview_stitcher_torch import si_utils as tsi
from multiview_stitcher_torch.fusion import _core as tcore, _streaming as tstream, fuse

sims = chip_smoke.grid_sims(np, tsi, 3, 6, 32, 12, seed=3)
tcore.STREAM_BYTES = 0
tstream._BATCH_BYTES = 4 * 32 ** 3 * 2
assert tstream._warm_vml_cos.cache_info().misses == 0
streamed = fuse(sims, transform_key="affine_metadata", device="cpu").to_numpy()
assert tstream.last_telemetry["bands_done"] == tstream.last_telemetry["bands_total"] >= 3
assert tstream._warm_vml_cos.cache_info().misses == 1
tcore.STREAM_BYTES = 1 << 40
torch.set_num_threads(1)
plain = fuse(sims, transform_key="affine_metadata", device="cpu").to_numpy()
print(int(np.abs(streamed.astype(np.int64) - plain.astype(np.int64)).max()))
"""


def test_first_3d_streamed_call_of_a_process_is_bit_equal():
    """Fault F7: the first 3D streamed call of a fresh process (reader and
    writer threads running while the band loop computes) warms
    ``torch.cos`` before its threads start and is bit-equal to a
    single-threaded monolithic call on the same inputs."""
    import os
    import subprocess
    from pathlib import Path

    root = str(Path(__file__).resolve().parents[1])
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST")}
    procs = [
        subprocess.Popen([sys.executable, "-c", _F7_CHILD.format(root=root)], cwd=root, env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(3)
    ]
    try:
        results = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, results):
        assert p.returncode == 0, err[-2000:]
        assert out.split()[-1] == "0", out
