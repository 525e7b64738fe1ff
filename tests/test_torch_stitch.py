"""The port's ``stitch()`` and its device tile cache against the JAX package.

``stitch(device="cpu")`` registers with the tiles cut from the resident
stack and fuses under the resolved transforms; it is held to the JAX
``stitch()`` (Pallas in interpret mode) on the same uint16 grids within 1
count (truncation ties of the weighted average). A ``fuse()`` after
``register(device_tiles=True)`` reads the stack the registration uploaded:
0 tile bytes are uploaded (counted by ``residency.tile_upload_bytes``)
and the output is bit-equal to a ``fuse()`` that uploads.
"""

import gc

import numpy as np
import pytest
import torch

from multiview_stitcher_torch import convert
from multiview_stitcher_torch import msi_utils as tmsi
from multiview_stitcher_torch import registration as treg
from multiview_stitcher_torch import residency
from multiview_stitcher_torch import weights as tweights
from multiview_stitcher_torch.fusion import _core as tcore
from multiview_stitcher_torch.fusion import fuse as tfuse
from multiview_stitcher_torch.parallel.mesh import Mesh
from multiview_stitcher_torch.stitch import stitch as tstitch
from multiview_stitcher_tpu import msi_utils, sample_data, si_utils
from multiview_stitcher_tpu.stitch import stitch as jstitch

KEY = si_utils.DEFAULT_TRANSFORM_KEY
UINT_COUNTS = 1

_GRIDS = {
    2: dict(ndim=2, tiles_x=3, tiles_y=3, tile_size=30, overlap=6),
    3: dict(ndim=3, tiles_x=2, tiles_y=2, tiles_z=1, tile_size=20, overlap=8, zoom=3,
            shift_scale=3),
}


def _to_port(sims):
    return [
        convert.sim_from_numpy(
            s.data, s.dims, s.spacing, s.origin,
            {k: v.data for k, v in s.transforms.items()}, coords=s.coords,
        )
        for s in sims
    ]


def _grid(ndim):
    sims = sample_data.generate_tiled_dataset(N_c=1, N_t=1, **_GRIDS[ndim])
    return [s.isel({"c": 0, "t": 0}) for s in sims]


@pytest.fixture(autouse=True)
def _empty_cache():
    tcore.clear_device_tile_cache()
    yield
    tcore.clear_device_tile_cache()


@pytest.mark.parametrize("ndim", [2, 3])
def test_stitch_matches_jax(ndim):
    jsims = _grid(ndim)
    ref = jstitch(jsims)
    got = tstitch(_to_port(jsims), device="cpu")
    ref_data = np.asarray(ref.data)
    assert got.data.shape == ref_data.shape and got.data.dtype == ref_data.dtype == np.uint16
    assert got.spacing == ref.spacing
    assert got.origin == pytest.approx(ref.origin, abs=1e-9)
    diff = np.abs(got.data.astype(np.int64) - ref_data.astype(np.int64))
    assert diff.max() <= UINT_COUNTS


def test_stitch_writes_the_resolved_transforms_and_fuses_under_them():
    jsims = _grid(2)
    msims = [tmsi.get_msim_from_sim(s, scale_factors=[]) for s in _to_port(jsims)]
    fused = tstitch(msims, new_transform_key="reg", device="cpu")
    assert treg.last_telemetry["device_tiles"] is True
    sims = [tmsi.get_sim_from_msim(m) for m in msims]
    assert all("reg" in s.transforms for s in sims)
    again = tfuse(sims, transform_key="reg", device="cpu")
    np.testing.assert_array_equal(again.data, fused.data)


def test_fuse_after_register_with_device_tiles_uploads_nothing():
    sims = _to_port(_grid(2))
    before = residency.tile_upload_bytes
    treg.register(sims, transform_key=KEY, new_transform_key="reg", device_tiles=True,
                  device="cpu")
    uploaded = residency.tile_upload_bytes - before
    assert uploaded == sum(s.data.nbytes for s in sims)
    assert treg.last_telemetry["tile_upload_bytes"] == uploaded
    before = residency.tile_upload_bytes
    first = tfuse(sims, transform_key=KEY, device="cpu")
    assert residency.tile_upload_bytes == before
    second = tfuse(sims, transform_key=KEY, device="cpu")
    assert residency.tile_upload_bytes == before
    np.testing.assert_array_equal(first.data, second.data)
    tcore.clear_device_tile_cache()
    third = tfuse(sims, transform_key=KEY, device="cpu")
    assert residency.tile_upload_bytes - before == uploaded
    np.testing.assert_array_equal(third.data, first.data)


@pytest.mark.parametrize("tier", ["host", "tiles"])
def test_general_fuse_after_register_with_device_tiles_uploads_nothing(tier):
    """The host tier (a weights function) and the tiles tier (max fusion)
    read the integer stack the registration uploaded: the host tier's stack
    with NaN kept is the same entry for integer tiles."""
    sims = _to_port(_grid(2))
    treg.register(sims, transform_key=KEY, new_transform_key="reg", device_tiles=True,
                  device="cpu")
    kw = (
        {"weights_func": tweights.content_based} if tier == "host"
        else {"fusion_func": tcore.max_fusion}
    )
    before = residency.tile_upload_bytes
    first = tfuse(sims, transform_key=KEY, device="cpu", **kw)
    assert residency.tile_upload_bytes == before
    tcore.clear_device_tile_cache()
    again = tfuse(sims, transform_key=KEY, device="cpu", **kw)
    assert residency.tile_upload_bytes - before == sum(s.data.nbytes for s in sims)
    np.testing.assert_array_equal(again.data, first.data)


def test_register_auto_device_tiles_uses_the_stack_only_when_resident():
    sims = _to_port(_grid(2))
    treg.register(sims, transform_key=KEY, device="cpu")
    assert treg.last_telemetry["device_tiles"] is False
    assert treg.last_telemetry["crop_upload_bytes"] > 0
    tfuse(sims, transform_key=KEY, device="cpu")  # leaves the stack resident
    before = residency.tile_upload_bytes
    treg.register(sims, transform_key=KEY, device="cpu")
    assert treg.last_telemetry["device_tiles"] is True
    assert treg.last_telemetry["crop_upload_bytes"] == 0
    assert residency.tile_upload_bytes == before


def test_device_tile_cache_keys_on_the_source_arrays(monkeypatch):
    rng = np.random.default_rng(3)
    data = [rng.integers(0, 100, (8, 8)).astype(np.uint16) for _ in range(2)]
    sims = [
        si_utils.get_sim_from_array(d, dims=["y", "x"], translation={"y": 0.0, "x": 6.0 * i})
        for i, d in enumerate(data)
    ]
    sims = _to_port(sims)
    cpu = torch.device("cpu")
    first = residency.tiles_to_device(sims, cpu)
    assert residency.tiles_to_device(sims, cpu) is first
    # the same arrays under new sims hit; another array of equal content misses
    assert residency.tiles_to_device([s.copy() for s in sims], cpu) is first
    other = [s.copy(data=s.data.copy()) for s in sims]
    assert residency.tiles_to_device(other, cpu) is not first
    # a source array changed in place misses
    sims[0].data[0, 0] += 1
    changed = residency.tiles_to_device(sims, cpu)
    assert changed is not first and int(changed[0, 0, 0]) == int(sims[0].data[0, 0])
    # an entry dies with its source arrays
    n = len(residency.device_tile_cache._entries)
    del other
    gc.collect()
    assert len(residency.device_tile_cache._entries) == n - 1
    # a stack over the budget is not cached
    monkeypatch.setattr(residency, "TILE_CACHE_BYTES", 64)
    tcore.clear_device_tile_cache()
    assert residency.tiles_to_device(sims, cpu) is not residency.tiles_to_device(sims, cpu)


def test_msim_transforms_follow_jax():
    jsim = _grid(2)[0]
    base = np.array([[1.0, 0.0, 2.0], [0.0, 1.0, -1.5], [0.0, 0.0, 1.0]])
    new = np.array([[1.0, 0.0, 0.25], [0.0, 1.0, 0.5], [0.0, 0.0, 1.0]])
    si_utils.set_sim_affine(jsim, base, transform_key="base")
    jm = msi_utils.get_msim_from_sim(jsim, scale_factors=[])
    tm = tmsi.get_msim_from_sim(_to_port([jsim])[0], scale_factors=[])
    msi_utils.set_affine_transform(jm, new, transform_key="new", base_transform_key="base")
    tmsi.set_affine_transform(tm, new, transform_key="new", base_transform_key="base")
    np.testing.assert_array_equal(tm.transforms["new"].data, jm.transforms["new"].data)
    tsim = tmsi.get_sim_from_msim(tm)
    np.testing.assert_array_equal(tsim.transforms["new"].data,
                                  msi_utils.get_sim_from_msim(jm).transforms["new"].data)
    assert tsim.data is tm.sims[0].data


def test_stitch_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: stitch() runs there by default")
    with pytest.raises(RuntimeError, match="CUDA"):
        tstitch(_to_port(_grid(2)))


def test_stitch_refuses_a_mesh():
    """Anything but a ``parallel.mesh.Mesh`` is refused (TypeError); a CPU
    mesh gives the unsharded output bit for bit."""
    with pytest.raises(TypeError, match="Mesh"):
        tstitch(_to_port(_grid(2)), mesh=object(), device="cpu")
    ref = tstitch(_to_port(_grid(2)), device="cpu")
    got = tstitch(_to_port(_grid(2)), mesh=Mesh([torch.device("cpu")] * 3))
    np.testing.assert_array_equal(got.to_numpy(), ref.to_numpy())
