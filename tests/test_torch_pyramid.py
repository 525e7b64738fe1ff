"""The port's pyramid block means (``ops.pyramid.coarsen_mean``) and their
route through ``io.ngff_utils._build_levels``.

The plain version, and every level ``_build_levels`` writes, are held bit
for bit to the JAX package's ``msi_utils._coarsen_mean`` (the numpy float64
mean that the port keeps for every other dtype and every call off the card);
the CUDA kernel is held to the plain version and to the port's numpy mean on
the card, in the one test marked ``card``, which skips without a CUDA device
(the card has no JAX, so that test imports none)."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from multiview_stitcher_torch import msi_utils as tmsi
from multiview_stitcher_torch import si_utils as tsi
from multiview_stitcher_torch.fusion import fuse as tfuse
from multiview_stitcher_torch.io import ngff_utils as tngff
from multiview_stitcher_torch.io import zarr_backend as tzb
from multiview_stitcher_torch.ops import pyramid as tpyr

KEY = tsi.DEFAULT_TRANSFORM_KEY
FACTORS = [(1, 2, 2), (2, 2, 2), (1, 2, 3), (1, 1, 4)]
DTYPES = [np.uint8, np.uint16]
# (shape, factors): odd shapes that trim on every factored axis, a leading c
# dim, 2D and 1D data, rows whose 16-byte groups are aligned (the kernel's
# vector loads) and an x factor above 4 (its scalar loads)
CASES = [((7, 37, 41), f) for f in FACTORS] + [
    ((2, 5, 19, 23), (1, 2, 2, 3)),
    ((3, 33, 47), (1, 3, 2)),
    ((45, 61), (2, 4)),
    ((99,), (4,)),
    ((4, 64, 16), (1, 1, 1)),
    ((5, 16, 96), (1, 2, 3)),
    ((5, 16, 128), (2, 1, 4)),
    ((3, 40, 1030), (1, 2, 5)),
]


def _jax_coarsen_mean(data, factors):
    """The JAX package's block mean, the reference of the CPU tests."""
    from multiview_stitcher_tpu import msi_utils as jmsi

    return jmsi._coarsen_mean(data, factors)


def _data(shape, dtype, seed=0):
    return np.random.default_rng(seed).integers(
        0, np.iinfo(dtype).max, shape, dtype=dtype, endpoint=True)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,factors", CASES)
def test_plain_is_bit_equal_to_the_float64_mean(shape, factors, dtype):
    data = _data(shape, dtype)
    got = tpyr.coarsen_mean(torch.from_numpy(data), factors)
    assert got.dtype == torch.from_numpy(data).dtype
    np.testing.assert_array_equal(got.numpy(), _jax_coarsen_mean(data, factors))
    np.testing.assert_array_equal(
        tpyr.coarsen_mean_plain(torch.from_numpy(data), factors).numpy(), got.numpy())


# the largest block each dtype's 32-bit sums take: max * n = 2^32 - 1 exactly
# (uint16: 65537 = 2^16 + 1 voxels, uint8: 257 * 65537), on all-max data
LARGEST = [(np.uint16, (2, 3, 2 * 65537 + 5), (1, 1, 65537)),
           (np.uint8, (1, 257, 65537 + 3), (1, 257, 65537))]


@pytest.mark.parametrize("dtype,shape,factors", LARGEST)
def test_all_max_data_at_the_largest_factor_product(dtype, shape, factors):
    assert np.iinfo(dtype).max * math.prod(factors) == 2**32 - 1
    data = np.full(shape, np.iinfo(dtype).max, dtype)
    got = tpyr.coarsen_mean(torch.from_numpy(data), factors).numpy()
    assert (got == np.iinfo(dtype).max).all()
    np.testing.assert_array_equal(got, _jax_coarsen_mean(data, factors))


@pytest.mark.parametrize("bad,match", [
    (lambda: tpyr.coarsen_mean(torch.zeros((4, 4), dtype=torch.int16), (2, 2)), "uint8 or uint16"),
    (lambda: tpyr.coarsen_mean(torch.zeros((4, 4), dtype=torch.float32), (2, 2)),
     "uint8 or uint16"),
    (lambda: tpyr.coarsen_mean(torch.zeros((2, 4, 4, 4), dtype=torch.uint16), (2, 1, 1, 1)),
     "last three"),
    (lambda: tpyr.coarsen_mean(torch.zeros((4, 4), dtype=torch.uint16), (2,)), "one factor"),
    (lambda: tpyr.coarsen_mean(torch.zeros((4, 4), dtype=torch.uint16), (0, 2)), "positive"),
    (lambda: tpyr.coarsen_mean(torch.zeros((1, 1, 1), dtype=torch.uint16), (1, 1, 65538)),
     "overflow"),
    (lambda: tpyr.coarsen_mean(torch.zeros((4, 4), dtype=torch.uint16, device="meta"), (2, 2)),
     "CPU or a CUDA device"),
])
def test_refuses_what_the_kernel_does_not_take(bad, match):
    with pytest.raises(ValueError, match=match):
        bad()


def test_the_cpu_path_counts_no_launch():
    before = tpyr.coarsen_mean.launches
    tpyr.coarsen_mean(torch.from_numpy(_data((4, 8, 8), np.uint16)), (1, 2, 2))
    assert tpyr.coarsen_mean.launches == before


@pytest.fixture
def spies(monkeypatch):
    """Records each call of the op and of the numpy mean from ``_build_levels``."""
    calls = {"op": [], "numpy": []}
    op, mean = tpyr.coarsen_mean, tmsi._coarsen_mean

    def spy_op(x, factors):
        calls["op"].append((x.device.type, tuple(x.shape)))
        return op(x, factors)

    def spy_numpy(data, factors):
        calls["numpy"].append(tuple(np.shape(data)))
        return mean(data, factors)

    monkeypatch.setattr(tpyr, "coarsen_mean", spy_op)
    monkeypatch.setattr(tmsi, "_coarsen_mean", spy_numpy)
    return calls


def _level0_store(tmp_path, dtype, shape=(3, 230, 250), seed=1):
    url = str(tmp_path / f"{np.dtype(dtype).name}.ome.zarr")
    if np.issubdtype(dtype, np.integer):
        data = _data(shape, dtype, seed)
        if np.iinfo(dtype).min < 0:
            data = np.random.default_rng(seed).integers(-3000, 3000, shape).astype(dtype)
    else:
        data = np.random.default_rng(seed).normal(100, 30, shape).astype(dtype)
    tzb.create_zarr_array(url + "/0", shape, (1, 64, 64), data.dtype)[...] = data
    return url, data


def _finalize(url, shape, device):
    props = {"spacing": {d: 1.0 for d in "zyx"}, "origin": {d: 0.0 for d in "zyx"},
             "shape": dict(zip("zyx", shape))}
    tngff.finalize_ome_zarr_levels(url, dims=("z", "y", "x"), stack_properties=props,
                                   block_size=64, device=device)


@pytest.mark.parametrize("device,dtype,on_card", [
    ("cuda", np.uint16, True),
    ("cuda:0", np.uint8, True),
    (torch.device("cuda"), np.uint16, True),
    ("cuda", np.int16, False),
    ("cuda", np.float32, False),
    ("cpu", np.uint16, False),
    (torch.device("cpu"), np.uint8, False),
    (None, np.uint16, False),
])
def test_only_a_cuda_device_averages_unsigned_data_on_the_card(device, dtype, on_card):
    assert tngff._averages_on_card(device, dtype) is on_card


def _check_levels(url, data, spies, route, n_blocks=4):
    other = "numpy" if route == "op" else "op"
    # level 1 is (3, 115, 125), in blocks of (3, 64, 64): 1 x 2 x 2
    assert len(spies[route]) == n_blocks and spies[other] == []
    level1 = np.asarray(tzb.open_zarr_array(url + "/1"))
    assert level1.dtype == data.dtype
    np.testing.assert_array_equal(level1, _jax_coarsen_mean(data, (1, 2, 2)))


@pytest.mark.parametrize("dtype,device,route", [
    (np.uint16, "cpu", "numpy"),
    (np.uint8, "cpu", "numpy"),
    (np.uint16, None, "numpy"),
    (np.int16, "cpu", "numpy"),
    (np.float32, "cpu", "numpy"),
])
def test_build_levels_routes_on_dtype_and_device(tmp_path, spies, dtype, device, route):
    url, data = _level0_store(tmp_path, dtype)
    _finalize(url, data.shape, device)
    _check_levels(url, data, spies, route)


@pytest.mark.parametrize("dtype,route", [
    (np.uint16, "op"), (np.uint8, "op"), (np.int16, "numpy"), (np.float32, "numpy"),
])
def test_build_levels_on_the_card_route_sends_unsigned_blocks_through_the_op(
        tmp_path, spies, monkeypatch, dtype, route):
    # the route as on a CUDA device, its blocks on the CPU (the op's plain
    # version): each block goes to the op as read and comes back to be written
    on_card = tngff._averages_on_card
    monkeypatch.setattr(tngff, "_averages_on_card", lambda device, dt: on_card("cuda", dt))
    url, data = _level0_store(tmp_path, dtype)
    _finalize(url, data.shape, "cpu")
    _check_levels(url, data, spies, route)
    if route == "op":
        assert spies["op"] == [("cpu", (3, 128, 128)), ("cpu", (3, 128, 122)),
                               ("cpu", (3, 102, 128)), ("cpu", (3, 102, 122))]


def _grid_sims(n=6, tile=96, overlap=16, seed=2):
    rng = np.random.default_rng(seed)
    step = tile - overlap
    return [
        tsi.get_sim_from_array(
            rng.integers(0, 65535, (tile, tile), endpoint=True).astype(np.uint16),
            dims=["y", "x"], translation={d: float(idx[k] * step) for k, d in enumerate("yx")},
            transform_key=KEY)
        for idx in np.ndindex((n, n))
    ]


def test_cpu_fuse_store_levels_equal_the_float64_pyramid(tmp_path, spies):
    url = str(tmp_path / "fused.ome.zarr")
    tfuse(_grid_sims(), transform_key=KEY, device="cpu", output_chunksize=64,
          output_zarr_url=url)
    # one block a level (512-wide), both through the numpy mean on the CPU
    assert spies["numpy"] == [(496, 496), (248, 248)]
    assert spies["op"] == []
    attrs, _ = tzb.read_group_metadata(url)
    paths = [d["path"] for d in attrs["multiscales"][0]["datasets"]]
    assert paths == ["0", "1", "2"]  # 496^2 -> 248^2 -> 124^2
    prev = np.asarray(tzb.open_zarr_array(f"{url}/0"))
    assert prev.dtype == np.uint16 and prev.shape == (496, 496)
    for p in paths[1:]:
        prev = _jax_coarsen_mean(prev, (2, 2))
        np.testing.assert_array_equal(np.asarray(tzb.open_zarr_array(f"{url}/{p}")), prev)


@pytest.mark.card
def test_kernel_equals_the_plain_version_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    cases = [((101, 1024, 1024), (1, 2, 2), np.uint16)] + [
        (shape, factors, dtype) for shape, factors in CASES for dtype in DTYPES
    ] + [(shape, factors, dtype) for dtype, shape, factors in LARGEST]
    before = tpyr.coarsen_mean.launches
    for i, (shape, factors, dtype) in enumerate(cases):
        host = _data(shape, dtype, seed=i)
        if np.iinfo(dtype).max * math.prod(factors) == 2**32 - 1:
            host[...] = np.iinfo(dtype).max
        x = torch.from_numpy(host).cuda()
        got = tpyr.coarsen_mean(x, factors)
        torch.cuda.synchronize()
        assert got.device == x.device and got.dtype == x.dtype
        assert torch.equal(got.cpu(), tpyr.coarsen_mean_plain(x, factors).cpu()), (shape, factors)
        np.testing.assert_array_equal(got.cpu().numpy(), tmsi._coarsen_mean(host, factors))
    assert tpyr.coarsen_mean.launches == before + len(cases)
    # a strided view is made contiguous, not misread
    x = torch.from_numpy(_data((6, 40, 64), np.uint16)).cuda()[:, :, 3:55]
    assert torch.equal(tpyr.coarsen_mean(x, (1, 2, 2)).cpu(),
                       tpyr.coarsen_mean_plain(x.cpu(), (1, 2, 2)))


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES)
def test_build_levels_on_a_cuda_device_launches_the_kernel_a_block(tmp_path, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    url, data = _level0_store(tmp_path, dtype)
    before = tpyr.coarsen_mean.launches
    _finalize(url, data.shape, "cuda")
    # the one level after level 0, (3, 115, 125), in 2 x 2 blocks of 64
    assert tpyr.coarsen_mean.launches == before + 4
    np.testing.assert_array_equal(np.asarray(tzb.open_zarr_array(url + "/1")),
                                  tmsi._coarsen_mean(data, (1, 2, 2)))
