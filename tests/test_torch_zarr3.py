"""The port's zarr v3 arrays (plain and sharded) and NGFF 0.5 OME-Zarr
against the JAX package, whose zarr IO is tensorstore.

The port writes and reads zarr v3 on numpy and the standard library; here
tensorstore reads what the port writes and the port reads what tensorstore
wrote, each array equal element for element; the port's ``zarr.json`` and
NGFF 0.5 group attributes equal the JAX package's JSON; ``fuse()`` into NGFF
0.5 equals the reference's (uint16 within 1 count: truncation ties of the
kernels, as in tests/test_torch_streaming.py) and the port's own NGFF 0.4
output bit for bit (the layout does not change the values). The reference
streams with ``MVS_TPU_STREAM_BYTES=0`` and its small interpret-mode tiles;
the port with ``fusion._core.STREAM_BYTES = 0``.
"""

import json
import os

import numpy as np
import pytest

from multiview_stitcher_torch import convert
from multiview_stitcher_torch.fusion import _core as tcore
from multiview_stitcher_torch.fusion import _streaming as tstream
from multiview_stitcher_torch.fusion import fuse as tfuse
from multiview_stitcher_torch.io import ngff_utils as tngff
from multiview_stitcher_torch.io import zarr_backend as tzb
from multiview_stitcher_tpu import si_utils
from multiview_stitcher_tpu.fusion import _core as jcore
from multiview_stitcher_tpu.fusion import fuse as jfuse
from multiview_stitcher_tpu.io import ngff_utils as jngff
from multiview_stitcher_tpu.io import zarr_backend as jzb

KEY = si_utils.DEFAULT_TRANSFORM_KEY


def _json(path):
    with open(path) as f:
        return json.load(f)


def _files(root):
    return sorted(
        os.path.relpath(os.path.join(r, f), root)
        for r, _, fs in os.walk(root) for f in fs
    )


def test_crc32c_test_vector():
    assert tzb.crc32c(b"123456789") == 0xE3069283
    assert tzb.crc32c(b"") == 0


@pytest.mark.parametrize("shards", [None, (32, 32)])
def test_zarr_json_is_what_tensorstore_writes(tmp_path, shards):
    """A (40, 50) uint16 array in chunks of 16, plain and with
    shards of 32: the same ``zarr.json`` and the same files, byte for byte."""
    a = (np.arange(2000).reshape(40, 50) % 977).astype(np.uint16)
    a[:16, 16:32] = 0  # one inner chunk of fill only: not stored
    t = tzb.create_zarr_array(str(tmp_path / "t"), a.shape, (16, 16), a.dtype, zarr_format=3,
                              shards=shards)
    j = jzb.create_zarr_array(str(tmp_path / "j"), a.shape, (16, 16), a.dtype, zarr_format=3,
                              shards=shards)
    t[...] = a
    j[...] = a
    assert _json(tmp_path / "t" / "zarr.json") == _json(tmp_path / "j" / "zarr.json")
    assert _files(tmp_path / "t") == _files(tmp_path / "j")
    for f in _files(tmp_path / "j"):
        assert (tmp_path / "t" / f).read_bytes() == (tmp_path / "j" / f).read_bytes(), f


@pytest.mark.parametrize("dtype", [np.uint16, np.float32, np.int8])
@pytest.mark.parametrize("shards", [None, (8, 12, 10)])
def test_port_writes_v3_and_tensorstore_reads(tmp_path, dtype, shards):
    rng = np.random.default_rng(2)
    a = (rng.random((13, 17, 9)) * 100).astype(dtype)  # edge chunks and shards on every axis
    url = str(tmp_path / "a.zarr")
    arr = tzb.create_zarr_array(url, a.shape, (4, 6, 5), a.dtype, fill_value=3, zarr_format=3,
                                shards=shards)
    assert (arr.zarr_format, arr.chunks, arr.shards) == (3, (4, 6, 5), shards)
    expect = np.full(a.shape, 3, dtype)
    arr[0:8, 0:12, 0:5] = a[0:8, 0:12, 0:5]  # whole chunks (and a whole shard)
    arr[2:7, 3:11, 1:2] = 5  # an unaligned region: read, modify, write
    arr[12, 16, 8] = 9  # the last voxel, in the last edge chunk
    expect[0:8, 0:12, 0:5] = a[0:8, 0:12, 0:5]
    expect[2:7, 3:11, 1:2] = 5
    expect[12, 16, 8] = 9
    np.testing.assert_array_equal(jzb.open_zarr_array(url).read(), expect)
    np.testing.assert_array_equal(np.asarray(tzb.open_zarr_array(url)), expect)
    np.testing.assert_array_equal(tzb.open_zarr_array(url)[1:12, 5:16, 2:9], expect[1:12, 5:16, 2:9])


@pytest.mark.parametrize("dtype", [np.uint16, np.float32])
@pytest.mark.parametrize("shards", [None, (16, 32)])
def test_tensorstore_writes_v3_and_port_reads(tmp_path, dtype, shards):
    rng = np.random.default_rng(3)
    a = (rng.random((45, 70)) * 1000).astype(dtype)
    url = str(tmp_path / "j.zarr")
    j = jzb.create_zarr_array(url, a.shape, (8, 16), a.dtype, zarr_format=3, shards=shards)
    j[...] = a
    j[10:20, 3:9] = np.zeros((10, 6), dtype)  # inner chunks of fill are dropped
    a[10:20, 3:9] = 0
    got = tzb.open_zarr_array(url)
    assert got.zarr_format == 3 and got.shards == shards
    np.testing.assert_array_equal(np.asarray(got), a)
    np.testing.assert_array_equal(got[7:41, 15:66], a[7:41, 15:66])
    # a lazy view reopens from its spec, and writes back into the shards
    view = tzb.LazyZarrArray.from_spec(got[5:30, 10:50].spec())
    view[0:10, 0:20] = np.full((10, 20), 7, dtype)
    a[5:15, 10:30] = 7
    np.testing.assert_array_equal(j.read(), a)


def test_v3_errors_are_the_reference_ones(tmp_path):
    with pytest.raises(ValueError, match="multiple"):
        tzb.create_zarr_array(str(tmp_path / "a"), (40, 40), (12, 12), np.uint16,
                              zarr_format=3, shards=(30, 30))
    with pytest.raises(ValueError, match="zarr_format=3"):
        tzb.create_zarr_array(str(tmp_path / "b"), (40, 40), (12, 12), np.uint16, shards=(24, 24))
    url = str(tmp_path / "c")
    meta = {"chunk_grid": {"configuration": {"chunk_shape": [4]}, "name": "regular"},
            "chunk_key_encoding": {"name": "default"},
            "codecs": [{"name": "bytes"}, {"name": "blosc", "configuration": {}}],
            "data_type": "uint8", "fill_value": 0, "node_type": "array", "shape": [8],
            "zarr_format": 3}
    os.makedirs(url)
    with open(os.path.join(url, "zarr.json"), "w") as f:
        json.dump(meta, f)
    with pytest.raises(NotImplementedError, match="blosc"):
        tzb.open_zarr_array(url)


def test_v2_key_encoding_and_gzip_are_read(tmp_path):
    """A v3 array of tensorstore's with ``"v2"`` chunk keys and the gzip
    codec."""
    import tensorstore as ts

    a = np.arange(60, dtype=np.uint16).reshape(6, 10)
    url = str(tmp_path / "g.zarr")
    ts.open({
        "driver": "zarr3", "kvstore": {"driver": "file", "path": url}, "create": True,
        "metadata": {
            "shape": [6, 10], "data_type": "uint16",
            "chunk_grid": {"name": "regular", "configuration": {"chunk_shape": [4, 4]}},
            "chunk_key_encoding": {"name": "v2", "configuration": {"separator": "."}},
            "codecs": [{"name": "bytes", "configuration": {"endian": "big"}},
                       {"name": "gzip", "configuration": {"level": 5}}],
        },
    }).result()[...].write(a).result()
    assert "1.2" in os.listdir(url)
    np.testing.assert_array_equal(np.asarray(tzb.open_zarr_array(url)), a)


def test_group_metadata_v3_in_both_packages(tmp_path):
    attrs = {"ome": {"version": "0.5", "multiscales": [{"datasets": [{"path": "0"}]}]}}
    tzb.write_group_metadata(str(tmp_path / "g"), attrs, zarr_format=3)
    assert jzb.read_group_metadata(str(tmp_path / "g")) == (attrs, 3)
    jzb.write_group_metadata(str(tmp_path / "h"), attrs, zarr_format=3)
    assert tzb.read_group_metadata(str(tmp_path / "h")) == (attrs, 3)
    assert _json(tmp_path / "g" / "zarr.json") == _json(tmp_path / "h" / "zarr.json")


# ---------------------------------------------------------------------------
# NGFF 0.5: the reference's tests/test_io.py cases, and its JSON
# ---------------------------------------------------------------------------


def _sim_pair(data, **kw):
    jsim = si_utils.get_sim_from_array(data, **kw)
    return jsim, convert.sim_from_numpy(data, jsim.dims, jsim.spacing, jsim.origin,
                                        {k: v.data for k, v in jsim.transforms.items()},
                                        coords=jsim.coords)


def test_ngff05_sharded_write_roundtrip_and_metadata(tmp_path):
    """tests/test_io.py's case on the port: shard files on disk, inner-chunk
    metadata, the ``ome`` attributes, readback bit for bit; every level's
    array, and the group's attributes, equal to the reference's."""
    data = np.random.default_rng(4).integers(0, 2000, (192, 240), dtype=np.uint16)
    jsim, tsim = _sim_pair(data, dims=("y", "x"), scale={"y": 2.0, "x": 0.5},
                           translation={"y": 3.0, "x": -1.0})
    kw = dict(overwrite=True, ngff_version="0.5", chunks=[16, 16], shards=[48, 48])
    turl, jurl = str(tmp_path / "t.ome.zarr"), str(tmp_path / "j.ome.zarr")
    out = tngff.write_sim_to_ome_zarr(tsim, turl, **kw)
    jngff.write_sim_to_ome_zarr(jsim, jurl, **kw)
    np.testing.assert_array_equal(np.asarray(out.data), data)
    meta = _json(os.path.join(turl, "0", "zarr.json"))
    assert meta == _json(os.path.join(jurl, "0", "zarr.json"))
    assert meta["chunk_grid"]["configuration"]["chunk_shape"] == [48, 48]
    assert meta["codecs"][0]["configuration"]["chunk_shape"] == [16, 16]
    assert len(_files(os.path.join(turl, "0", "c"))) == 20
    assert _json(os.path.join(turl, "zarr.json")) == _json(os.path.join(jurl, "zarr.json"))
    levels = _json(os.path.join(jurl, "zarr.json"))["attributes"]["ome"]["multiscales"][0][
        "datasets"]
    assert len(levels) >= 2
    for ds in levels:
        lt, lj = os.path.join(turl, ds["path"]), os.path.join(jurl, ds["path"])
        assert _json(os.path.join(lt, "zarr.json")) == _json(os.path.join(lj, "zarr.json"))
        np.testing.assert_array_equal(np.asarray(tzb.open_zarr_array(lt)), jzb.open_zarr_array(lj).read())
    msim = tngff.read_msim_from_ome_zarr(turl)
    assert msim.get_scale("scale1").sizes["x"] == 120


def test_ngff05_shard_not_multiple_of_chunk_rounds_up(tmp_path):
    data = np.random.default_rng(5).integers(0, 100, (40, 40), dtype=np.uint16)
    _, tsim = _sim_pair(data, dims=("y", "x"))
    url = str(tmp_path / "s.ome.zarr")
    tngff.write_sim_to_ome_zarr(tsim, url, overwrite=True, ngff_version="0.5",
                                chunks=[12, 12], shards=[30, 30])
    assert _json(os.path.join(url, "0", "zarr.json"))["chunk_grid"]["configuration"][
        "chunk_shape"] == [36, 36]
    np.testing.assert_array_equal(jzb.open_zarr_array(url + "/0").read(), data)


def test_ngff04_shards_rejected(tmp_path):
    _, tsim = _sim_pair(np.zeros((8, 8), np.uint16), dims=("y", "x"))
    with pytest.raises(ValueError, match="zarr v3"):
        tngff.write_sim_to_ome_zarr(tsim, str(tmp_path / "x.ome.zarr"), overwrite=True,
                                    ngff_version="0.4", shards=[8, 8])


def test_ngff05_channels_and_finalize_match_the_reference(tmp_path):
    """A (c, y, x) sim at 0.5: the omero channels beside ``ome``, as the
    reference writes them; ``finalize_ome_zarr_levels`` and
    ``write_multiscales_metadata`` at 0.5 write the reference's JSON."""
    data = np.random.default_rng(6).integers(0, 500, (2, 256, 192), dtype=np.uint16)
    jsim, tsim = _sim_pair(data, dims=("c", "y", "x"), c_coords=["a", "b"])
    turl, jurl = str(tmp_path / "t.ome.zarr"), str(tmp_path / "j.ome.zarr")
    tngff.write_sim_to_ome_zarr(tsim, turl, ngff_version="0.5")
    jngff.write_sim_to_ome_zarr(jsim, jurl, ngff_version="0.5")
    assert _json(os.path.join(turl, "zarr.json")) == _json(os.path.join(jurl, "zarr.json"))
    got = tngff.read_sim_from_ome_zarr(jurl)
    assert list(got.coords["c"]) == ["a", "b"]
    np.testing.assert_array_equal(np.asarray(got.data), data)

    props = {"spacing": {"y": 1.0, "x": 1.0}, "origin": {"y": 0.0, "x": 0.0},
             "shape": {"y": 256, "x": 192}}
    for pkg, zb, name in ((tngff, tzb, "tf"), (jngff, jzb, "jf")):
        url = str(tmp_path / name)
        zb.create_zarr_array(url + "/0", data.shape, (1, 32, 32), data.dtype,
                             zarr_format=3)[...] = data
        pkg.finalize_ome_zarr_levels(url, dims=("c", "y", "x"), stack_properties=props,
                                     ngff_version="0.5", c_coords=["a", "b"])
    assert _json(tmp_path / "tf" / "zarr.json") == _json(tmp_path / "jf" / "zarr.json")
    np.testing.assert_array_equal(np.asarray(tzb.open_zarr_array(str(tmp_path / "tf" / "1"))),
                                  jzb.open_zarr_array(str(tmp_path / "jf" / "1")).read())
    ms = _json(tmp_path / "jf" / "zarr.json")["attributes"]["ome"]["multiscales"][0]
    tngff.write_multiscales_metadata(tmp_path / "tm", ms["axes"], ms["datasets"], "0.5")
    jngff.write_multiscales_metadata(tmp_path / "jm", ms["axes"], ms["datasets"], "0.5")
    assert _json(tmp_path / "tm" / "zarr.json") == _json(tmp_path / "jm" / "zarr.json")


# ---------------------------------------------------------------------------
# fuse() into NGFF 0.5
# ---------------------------------------------------------------------------


def _grid_sims(n, tile, overlap, ndim=2, seed=0):
    rng = np.random.default_rng(seed)
    sdims = ["z", "y", "x"][-ndim:]
    step = tile - overlap
    grid = (1, n, n) if ndim == 3 else (n, n)
    return [
        si_utils.get_sim_from_array(
            rng.integers(0, 3000, (tile,) * ndim).astype(np.uint16), dims=sdims,
            translation={d: float(idx[i] * step) for i, d in enumerate(sdims)},
        )
        for idx in np.ndindex(grid)
    ]


def _to_port(sims):
    return [
        convert.sim_from_numpy(s.data, s.dims, s.spacing, s.origin,
                               {k: v.data for k, v in s.transforms.items()}, coords=s.coords)
        for s in sims
    ]


def _close(got, ref):
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert np.abs(got.astype(np.int64) - ref.astype(np.int64)).max(initial=0) <= 1


@pytest.mark.parametrize("tier", ["streamed", "monolithic"])
def test_fuse_into_ngff05_matches_the_reference(tmp_path, monkeypatch, tier):
    monkeypatch.setenv("MVS_TPU_PALLAS_TILE_2D", "64,64")
    if tier == "streamed":
        monkeypatch.setenv("MVS_TPU_STREAM_BYTES", "0")
        monkeypatch.setattr(tcore, "STREAM_BYTES", 0)
    jcore.clear_device_tile_cache()
    sims = _grid_sims(n=6, tile=48, overlap=12)
    kw = dict(transform_key=KEY, output_chunksize=64,
              zarr_options={"ngff_version": "0.5"})
    jurl, turl = str(tmp_path / "j.ome.zarr"), str(tmp_path / "t.ome.zarr")
    ref = jfuse(sims, output_zarr_url=jurl, **kw)
    tstream.last_telemetry = {}
    got = tfuse(_to_port(sims), output_zarr_url=turl, device="cpu", **kw)
    assert bool(tstream.last_telemetry) == (tier == "streamed")
    assert isinstance(got.data, tzb.LazyZarrArray) and got.data.zarr_format == 3
    assert got.dims == ref.dims and got.spacing == ref.spacing and got.origin == ref.origin
    assert _json(os.path.join(turl, "zarr.json")) == _json(os.path.join(jurl, "zarr.json"))
    levels = _json(os.path.join(jurl, "zarr.json"))["attributes"]["ome"]["multiscales"][0][
        "datasets"]
    assert len(levels) >= 2
    for ds in levels:
        lt, lj = os.path.join(turl, ds["path"]), os.path.join(jurl, ds["path"])
        assert _json(os.path.join(lt, "zarr.json")) == _json(os.path.join(lj, "zarr.json"))
        _close(jzb.open_zarr_array(lt).read(), jzb.open_zarr_array(lj).read())
    # the values do not depend on the layout: NGFF 0.4 of the port, bit for bit
    v2 = tfuse(_to_port(sims), output_zarr_url=str(tmp_path / "v2.ome.zarr"), device="cpu",
               transform_key=KEY, output_chunksize=64)
    for ds in levels:
        np.testing.assert_array_equal(
            np.asarray(tzb.open_zarr_array(os.path.join(turl, ds["path"]))),
            np.asarray(tzb.open_zarr_array(os.path.join(str(tmp_path / "v2.ome.zarr"), ds["path"]))),
        )
    assert isinstance(v2.data, tzb.LazyZarrArray) and v2.data.zarr_format == 2


@pytest.mark.parametrize("ndim", [2, 3])
def test_sharded_fuse_bands_whole_shards(tmp_path, monkeypatch, ndim):
    """Streamed into a sharded level 0: bands align to whole shards (no two
    writer threads share a shard file), the reference reads the shards, and
    level 0 and the pyramid equal the port's unsharded NGFF 0.4 output."""
    monkeypatch.setattr(tcore, "STREAM_BYTES", 0)
    sims = _to_port(_grid_sims(n=7, tile=40, overlap=10, ndim=ndim))
    shards = [64] * ndim
    written = []
    orig = tzb.ZarrV3._update_cell

    def spy(self, idx, box, value):
        written.append((os.path.basename(self.path), tuple(idx)))
        return orig(self, idx, box, value)

    monkeypatch.setattr(tzb.ZarrV3, "_update_cell", spy)
    url = str(tmp_path / "s.ome.zarr")
    got = tfuse(sims, transform_key=KEY, device="cpu", output_chunksize=32,
                output_zarr_url=url,
                zarr_options={"ngff_version": "0.5",
                              "zarr_array_creation_kwargs": {"shards": shards}})
    tele = tstream.last_telemetry
    assert tele["bands_done"] >= 3 and tele["band_height"] % shards[tele["band_axis"]] == 0
    level0 = [idx for level, idx in written if level == "0"]
    assert level0 and len(set(level0)) == len(level0), "a shard written twice"
    assert got.data.shards == tuple(shards)
    ref = tfuse(sims, transform_key=KEY, device="cpu", output_chunksize=32,
                output_zarr_url=str(tmp_path / "v2.ome.zarr"))
    for level in range(2):
        np.testing.assert_array_equal(
            jzb.open_zarr_array(f"{url}/{level}").read(),
            np.asarray(tzb.open_zarr_array(str(tmp_path / "v2.ome.zarr" / str(level)))),
        )
    np.testing.assert_array_equal(np.asarray(got.data), np.asarray(ref.data))
