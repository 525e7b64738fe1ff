"""The port's host-slab route against the JAX package: ``fuse()`` of lazy
views whose bytes exceed ``TILES_MAX_BYTES`` in every tier that takes them.

Each view is written by the port's zarr writer and opened lazily in both
packages (tensorstore on the JAX side). The JAX ``fuse`` runs with
``MVS_TPU_TILES_MAX_BYTES=0`` (monkeypatched env), so that it cuts host
slabs; the port's with ``fusion._core.TILES_MAX_BYTES = 0`` (the module
constant, monkeypatched) and ``device="cpu"``. Rotated integer views are
held to the JAX exact tier (``MVS_TPU_EXACT_AFFINE=1``, interpret mode);
everything else to its CPU defaults (gather, host tiers).

Tolerances: integer outputs at most 1 count (the f32 blend lands on either
side of a truncation tie); float outputs rtol 1e-4, atol 1e-3 on data in
[0, 1100), NaN masks exactly. Every case also checks that the port took the
host slabs (``last_slab_telemetry``) and neither stacked nor uploaded a tile.
"""

import jax
import numpy as np
import pytest

from multiview_stitcher_torch import residency
from multiview_stitcher_torch import si_utils as tsi
from multiview_stitcher_torch import weights as tweights
from multiview_stitcher_torch.fusion import _core as tcore
from multiview_stitcher_torch.fusion import fuse as tfuse
from multiview_stitcher_torch.io import zarr_backend as tzb
from multiview_stitcher_tpu import si_utils, weights
from multiview_stitcher_tpu.fusion import _core as jcore
from multiview_stitcher_tpu.fusion import fuse as jfuse
from multiview_stitcher_tpu.io import zarr_backend as jzb

KEY = "affine"


@pytest.fixture(autouse=True)
def _host_slabs(monkeypatch):
    """Both packages past their on-device limit, the reference at its CPU
    defaults, and a port that may not stack or upload tiles."""
    for var in ("MVS_TPU_EXACT_AFFINE", "MVS_TPU_SHEAR"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("MVS_TPU_TILES_MAX_BYTES", "0")
    monkeypatch.setenv("MVS_TPU_PALLAS_TILE_2D", "64,64")
    monkeypatch.setenv("MVS_TPU_PALLAS_TILE_3D", "8,32,64")
    monkeypatch.setattr(tcore, "TILES_MAX_BYTES", 0)

    def no_stack(*a, **k):
        raise AssertionError("the host-slab route stacked whole tiles")

    monkeypatch.setattr(residency, "materialize_tiles", no_stack)
    jcore.clear_device_tile_cache()
    tcore.clear_device_tile_cache()
    uploaded = residency.tile_upload_bytes
    yield
    assert residency.tile_upload_bytes == uploaded
    jcore.clear_device_tile_cache()


def _rot(theta, axes, ndim):
    m = np.eye(ndim + 1)
    c, s = np.cos(theta), np.sin(theta)
    i, j = axes
    m[i, i], m[i, j], m[j, i], m[j, j] = c, -s, s, c
    return m


def _views(name, dtype, seed=0):
    """(arrays, origins, affines, dims, chunksize) of a layout."""
    rng = np.random.default_rng(seed)

    def data(shape):
        vals = rng.integers(100, 1100, size=shape)
        return (vals if np.issubdtype(dtype, np.integer) else vals * 0.1).astype(dtype)

    if name == "mixed_translation":
        shapes = [(40, 48), (48, 36), (36, 40)]
        origins = [(0.0, 0.0), (30.0, 5.0), (10.0, 40.0)]
        return [data(s) for s in shapes], origins, [np.eye(3)] * 3, ("y", "x"), 24
    if name == "grid_translation":
        origins = [(float(iy * 40), float(ix * 40)) for iy in range(2) for ix in range(2)]
        return [data((48, 48)) for _ in origins], origins, [np.eye(3)] * 4, ("y", "x"), 32
    if name == "rot2d":
        shapes = [(40, 80), (60, 60)]
        return ([data(s) for s in shapes], [(0.0, 0.0), (20.0, 30.0)],
                [np.eye(3), _rot(0.07, (0, 1), 2)], ("y", "x"), 32)
    if name == "roty3d":
        return ([data((24, 20, 28)) for _ in range(2)], [(0.0, 0.0, 0.0), (0.0, 0.0, 20.0)],
                [np.eye(4), _rot(0.3, (0, 2), 3)], ("z", "y", "x"), 16)
    if name == "coupled3d":
        return ([data((20, 24, 24)) for _ in range(2)], [(0.0, 0.0, 0.0), (0.0, 0.0, 18.0)],
                [np.eye(4), _rot(0.08, (1, 2), 3)], ("z", "y", "x"), 16)
    raise KeyError(name)


def _lazy_pair(tmp_path, name, dtype, nan_blob=False):
    """The layout's views as lazy sims of each package over the same zarr
    arrays, and the arrays."""
    arrays, origins, affines, dims, cs = _views(name, dtype)
    if nan_blob:
        arrays[0][5:9, 10:16] = np.nan
    jsims, tsims = [], []
    for i, (arr, org, aff) in enumerate(zip(arrays, origins, affines)):
        url = str(tmp_path / f"{name}_{np.dtype(dtype).name}_{i}.zarr")
        tzb.create_zarr_array(url, arr.shape, (16,) * arr.ndim, arr.dtype)[...] = arr
        for pkg, zb, out in ((si_utils, jzb, jsims), (tsi, tzb, tsims)):
            sim = pkg.get_sim_from_array(zb.open_zarr_array(url), dims=dims,
                                         translation=dict(zip(dims, org)))
            pkg.set_sim_affine(sim, aff, transform_key=KEY)
            out.append(sim)
    return jsims, tsims, cs


def _assert_close(got, ref):
    assert got.shape == ref.shape and got.dtype == ref.dtype
    if np.issubdtype(ref.dtype, np.integer):
        assert np.abs(got.astype(np.int64) - ref.astype(np.int64)).max() <= 1
    else:
        assert (np.isnan(got) == np.isnan(ref)).all()
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-3, equal_nan=True)


def _both(jsims, tsims, cs, jkw=None, **kw):
    ref = np.asarray(jfuse(jsims, transform_key=KEY, output_chunksize=cs, **(jkw or kw)).data)
    tcore.last_slab_telemetry.clear()
    got = tfuse(tsims, transform_key=KEY, output_chunksize=cs, device="cpu", **kw).data
    _assert_close(got, ref)
    tele = dict(tcore.last_slab_telemetry)
    assert tele["units"] >= 1 and tele["window_bytes"] > 0
    return tele


@pytest.mark.parametrize("name,fusion", [
    ("mixed_translation", "weighted_average"),
    ("grid_translation", "max"),
])
def test_translation_grids_fuse_through_host_slabs(tmp_path, name, fusion):
    """Grids that do not band: the weighted average leaves the translation
    tier (JAX: the same fall-through, :3102 / :3148), and ``max_fusion``
    leaves the tiles tier; both take the batched tier's host slabs."""
    jsims, tsims, cs = _lazy_pair(tmp_path, name, np.uint16)
    kw, jkw = {}, {}
    if fusion == "max":
        kw, jkw = {"fusion_func": tcore.max_fusion}, {"fusion_func": jcore.max_fusion}
    tele = _both(jsims, tsims, cs, jkw=jkw, **kw)
    assert (tele["tier"], tele["route"]) == ("batched", "exact")


@pytest.mark.parametrize("name,kind", [("rot2d", "2d"), ("roty3d", "sepy"),
                                       ("coupled3d", "general")])
def test_rotated_uint16_views_take_the_exact_kernels_on_slabs(tmp_path, monkeypatch, name,
                                                              kind):
    monkeypatch.setenv("MVS_TPU_EXACT_AFFINE", "1")
    jsims, tsims, cs = _lazy_pair(tmp_path, name, np.uint16)
    kinds = []
    orig = tcore._fuse_chunk_batch_kernel_exact

    def spy(data, *a, **k):
        # (B, K, *S_max) slabs, not the tile stack with its tile_idx
        assert k.get("tile_idx") is None and data.dim() == len(a[7]) + 2
        kinds.append(a[10])
        return orig(data, *a, **k)

    monkeypatch.setattr(tcore, "_fuse_chunk_batch_kernel_exact", spy)
    try:
        tele = _both(jsims, tsims, cs)
    finally:
        jax.clear_caches()
    assert (tele["tier"], tele["route"]) == ("batched", "exact")
    assert kinds and set(kinds) == {kind}
    # every window lands in a (B, K, *S_max) slab: uploads hold padding too
    assert tele["upload_bytes"] >= tele["window_bytes"]


def test_float_views_with_nan_take_the_gather_route_on_slabs(tmp_path):
    jsims, tsims, cs = _lazy_pair(tmp_path, "rot2d", np.float32, nan_blob=True)
    tele = _both(jsims, tsims, cs)
    assert (tele["tier"], tele["route"]) == ("batched", "gather")


@pytest.mark.parametrize("name", ["rot2d", "mixed_translation"])
def test_content_based_weights_take_the_host_tier_on_slabs(tmp_path, name):
    jsims, tsims, cs = _lazy_pair(tmp_path, name, np.uint16)
    tele = _both(jsims, tsims, cs, jkw={"weights_func": weights.content_based},
                 weights_func=tweights.content_based)
    assert tele["tier"] == "host"


@pytest.mark.parametrize("fusion", ["max", "weighted_average"])
def test_untrimmed_layout_on_slabs(tmp_path, fusion):
    jsims, tsims, cs = _lazy_pair(tmp_path, "rot2d", np.float32)
    kw = {"overlap_in_pixels": 4, "trim_overlap": False}
    jkw = dict(kw)
    if fusion == "max":
        kw["fusion_func"], jkw["fusion_func"] = tcore.max_fusion, jcore.max_fusion
    tele = _both(jsims, tsims, cs, jkw=jkw, **kw)
    assert tele["tier"] == "batched"


class _ReadLogArray:
    """Lazy-array stand-in that records every window read."""

    def __init__(self, data):
        self._data = np.asarray(data)
        self.shape = self._data.shape
        self.dtype = self._data.dtype
        self.ndim = self._data.ndim
        self.reads = []

    def __getitem__(self, idx):
        self.reads.append(idx)
        return self._data[idx]


@pytest.mark.parametrize("weights_func", [None, "content_based"])
def test_slabs_read_windows_only(weights_func):
    """The JAX package's test_fusion_reads_only_needed_windows on the port:
    every read is a window of a chunk with its halo, never a whole tile."""
    rng = np.random.default_rng(1)
    n, tile, overlap = 2, 64, 16
    step = tile - overlap
    arrays, sims = [], []
    for iy in range(n):
        for ix in range(n):
            arr = _ReadLogArray(rng.integers(0, 1000, (tile, tile)).astype(np.uint16))
            arrays.append(arr)
            sims.append(tsi.get_sim_from_array(
                arr, translation={"y": float(iy * step), "x": float(ix * step)}))
    kw = {"weights_func": tweights.content_based} if weights_func else {}
    halo = tcore.misc_utils.get_required_overlap(tweights.content_based, {}) if kw else 0
    fused = tfuse(sims, transform_key=tsi.DEFAULT_TRANSFORM_KEY, output_chunksize=32,
                  device="cpu", **kw)
    assert fused.data.shape == (2 * step + overlap,) * 2
    for arr in arrays:
        assert arr.reads, "every tile overlaps some chunk"
        for idx in arr.reads:
            assert isinstance(idx, tuple)
            for sl in idx:
                span = (sl.stop or tile) - (sl.start or 0)
                assert span <= 32 + 2 * (overlap + halo) + 8, f"window read too large: {idx}"
