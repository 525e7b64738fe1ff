"""Host copies through the pinned staging ring of ``residency``.

A large upload of in-memory views is made on the device and filled piece by
piece through a few host slots (``_upload_staged``), and a large download
comes back the same way (``_download_staged``). On the CPU the staging
helpers run with CPU tensors and a ring of a few bytes a slot (plain host
slots, no streams) and must give the very bytes of the direct route; the
rules that choose a route are held case by case. The tests marked ``card``
run the real ring on a CUDA device and skip without one (on the card:
``python -m pytest --noconftest -m card tests/test_torch_host_copies.py``).
"""

import sys
import threading
import types

import numpy as np
import pytest
import torch

from multiview_stitcher_torch import residency, si_utils
from multiview_stitcher_torch.fusion import _core as tcore
from multiview_stitcher_torch.io import zarr_backend

CPU = torch.device("cpu")
# a name only: deciding a route reads the device's type and touches no card
CUDA = torch.device("cuda", 0)


def _ring(slots=3, slot_bytes=64):
    return residency._Ring(slots, slot_bytes, pinned=False)


def _sims(arrays):
    return [types.SimpleNamespace(data=a) for a in arrays]


def _direct_stack(arrays, keep_nan=False) -> np.ndarray:
    """What the direct route uploads: the host stack, NaN replaced in float
    data unless ``keep_nan``."""
    stack = residency.materialize_tiles(_sims(arrays))
    if np.issubdtype(stack.dtype, np.floating) and not keep_nan:
        stack = np.nan_to_num(stack)
    return stack


def _bytes(x) -> np.ndarray:
    """The raw bytes of an array or tensor (NaN compares equal to itself)."""
    if isinstance(x, torch.Tensor):
        x = x.cpu().contiguous().numpy()
    return np.ascontiguousarray(x).reshape(-1).view(np.uint8)


def _rng_views(n, shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    if np.issubdtype(np.dtype(dtype), np.floating):
        return [rng.normal(size=shape).astype(dtype) for _ in range(n)]
    return [rng.integers(0, np.iinfo(dtype).max, size=shape, dtype=dtype) for _ in range(n)]


def _with_nan(views):
    for k, v in enumerate(views):
        v.reshape(-1)[k::7] = np.nan
        v.reshape(-1)[3 + k::11] = np.inf
        v.reshape(-1)[5 + k::13] = -np.inf
    return views


# (views, slot bytes, pieces): rows of (3, 4) uint16 are 24 bytes, two a
# 64-byte slot, so pieces cross the views' boundaries (a view's 5 rows) and
# the last holds one row
UPLOADS = {
    "pieces_cross_views": (_rng_views(3, (5, 3, 4), np.uint16), 64, 8),
    "exactly_one_slot": (_rng_views(2, (2, 2, 4), np.uint16), 64, 1),
    "one_row_views": (_rng_views(5, (1, 10), np.uint16), 64, 2),
    "one_row_a_slot": (_rng_views(3, (4, 8), np.float32), 32, 12),
    "float32_3d": (_rng_views(4, (3, 2, 5), np.float32), 96, 6),
    "strided_sources": ([a[:, ::2, ::-1] for a in _rng_views(3, (6, 8, 5), np.int16)], 80, 9),
    "cast_to_the_first_dtype": ([_rng_views(1, (3, 4), np.float32)[0],
                                 _rng_views(1, (3, 4), np.float64)[0]], 40, 3),
}


@pytest.mark.parametrize("case", list(UPLOADS))
def test_staged_upload_equals_the_direct_stack(case):
    views, slot_bytes, pieces = UPLOADS[case]
    stack, n = residency._upload_staged(_sims(views), CPU, False, _ring(2, slot_bytes))
    assert n == pieces
    direct = _direct_stack(views)
    assert stack.shape == direct.shape and stack.dtype == residency.torch_dtype(direct.dtype)
    np.testing.assert_array_equal(_bytes(stack), _bytes(direct))


@pytest.mark.parametrize("keep_nan", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_staged_upload_of_float_views_with_nan(keep_nan, dtype):
    views = _with_nan(_rng_views(3, (7, 3, 5), dtype, seed=1))
    stack, _ = residency._upload_staged(_sims(views), CPU, keep_nan, _ring(3, 160))
    np.testing.assert_array_equal(_bytes(stack), _bytes(_direct_stack(views, keep_nan)))
    assert bool(torch.isnan(stack).any()) == keep_nan
    assert bool(torch.isinf(stack).any()) == keep_nan


# (shape, dtype, slot bytes, pieces): exactly one slot, three slots and an
# odd remainder, and more pieces than the ring has slots
DOWNLOADS = {
    "exactly_one_slot": ((4, 8), torch.uint16, 64, 1),
    "three_slots_and_an_odd_remainder": ((199,), torch.uint8, 64, 4),
    "uint16_3d": ((5, 7, 9), torch.uint16, 96, 7),
    "float32_3d": ((3, 5, 6), torch.float32, 100, 4),
}


@pytest.mark.parametrize("case", list(DOWNLOADS))
def test_staged_download_equals_the_direct_copy(case):
    shape, dtype, slot_bytes, pieces = DOWNLOADS[case]
    fused = (torch.arange(int(np.prod(shape))) * 7919 % 65521).reshape(shape).to(dtype)
    out = np.zeros(shape, dtype=si_utils.numpy_dtype(dtype))
    assert residency._download_staged(fused, out, _ring(2, slot_bytes)) == pieces
    np.testing.assert_array_equal(out, fused.numpy())


def test_a_poisoned_ring_holds_nothing_that_reaches_a_copy():
    """Slots filled with a poison value between copies, as they would be
    by earlier copies of other data, leave no trace in the next ones."""
    ring = _ring(3, 64)
    views = _rng_views(3, (5, 3, 4), np.uint16, seed=2)
    residency._upload_staged(_sims(views), CPU, False, ring)
    for slot in list(ring._free.queue):
        slot.array[...] = 0xA5
    views = _rng_views(3, (5, 3, 4), np.uint16, seed=3)
    stack, _ = residency._upload_staged(_sims(views), CPU, False, ring)
    np.testing.assert_array_equal(stack.numpy(), _direct_stack(views))
    for slot in list(ring._free.queue):
        slot.array[...] = 0x5A
    out = np.zeros(stack.shape, np.uint16)
    residency._download_staged(stack, out, ring)
    np.testing.assert_array_equal(out, _direct_stack(views))
    assert ring._free.qsize() == ring.n


class _Unreadable:
    """A view whose rows cannot be read."""

    shape, dtype, ndim = (4, 8), np.dtype(np.uint16), 2

    def __getitem__(self, sel):
        raise OSError("unreadable")


def test_a_failed_piece_returns_its_slot():
    ring = _ring(2, 64)
    with pytest.raises(OSError):
        residency._upload_staged(_sims([np.zeros((4, 8), np.uint16), _Unreadable()]), CPU, False,
                                 ring)
    assert ring._free.qsize() == ring.n


def test_threads_sharing_a_ring_each_get_their_own_bytes():
    """More threads than cores stage copies through one small ring at once
    (under a short switch interval): each gets exactly its own data."""
    ring = _ring(3, 48)
    errors = []

    def work(k):
        try:
            for j in range(4):
                views = _rng_views(3, (5, 2, 3), np.uint16, seed=100 * k + j)
                stack, _ = residency._upload_staged(_sims(views), CPU, False, ring)
                out = np.zeros(stack.shape, np.uint16)
                residency._download_staged(stack, out, ring)
                if not np.array_equal(out, _direct_stack(views)):
                    errors.append(k)
        except Exception as e:  # reported by the assertion below
            errors.append(repr(e))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert errors == []
    assert ring._free.qsize() == ring.n


def _tiny_ring_everywhere(monkeypatch, slot_bytes=64):
    """Route every copy through a small host ring, as a CUDA device's
    copies of more than a slot would go."""
    ring = _ring(3, slot_bytes)
    monkeypatch.setattr(residency, "_staging_ring", lambda device: ring)
    monkeypatch.setattr(residency, "_upload_route", lambda sims, device, slot_bytes: "staged")
    monkeypatch.setattr(residency, "_download_route", lambda fused, out, slot_bytes: "staged")
    return ring


def _real_sims(arrays):
    return [si_utils.get_sim_from_array(a, dims=["z", "y", "x"]) for a in arrays]


def test_a_mixed_shape_group_staged_equals_the_direct_stack(monkeypatch):
    arrays = [a for pair in zip(_rng_views(2, (4, 3, 5), np.uint16, seed=4),
                                _rng_views(2, (3, 3, 4), np.uint16, seed=5)) for a in pair]
    tcore.clear_device_tile_cache()
    direct = residency.tiles_to_device(_real_sims(arrays), "cpu")
    assert residency.last_copy_telemetry["upload"]["route"] == "direct"
    tcore.clear_device_tile_cache()
    _tiny_ring_everywhere(monkeypatch)
    staged = residency.tiles_to_device(_real_sims(arrays), "cpu")
    tcore.clear_device_tile_cache()
    tele = residency.last_copy_telemetry["upload"]
    assert tele["route"] == "staged"
    assert tele["bytes"] == sum(a.nbytes for a in arrays)
    # two groups: 8 rows of 30 bytes and 6 of 24, two rows a slot
    assert tele["pieces"] == 4 + 3 and tele["slots"] == 3
    assert torch.equal(staged, direct)


def test_the_row0_band_download_staged_equals_the_direct_one(monkeypatch):
    fused = (torch.arange(5 * 6 * 7) % 251).reshape(5, 6, 7).to(torch.uint16)
    direct = np.zeros((10, 6, 7), np.uint16)
    residency.download(fused, direct, row0=3)
    assert residency.last_copy_telemetry["download"]["route"] == "direct"
    _tiny_ring_everywhere(monkeypatch)
    staged = np.zeros((10, 6, 7), np.uint16)
    residency.download(fused, staged, row0=3)
    tele = residency.last_copy_telemetry["download"]
    assert tele == {"route": "staged", "bytes": fused.numel() * 2, "pieces": 7, "slots": 3}
    np.testing.assert_array_equal(staged, direct)
    assert not staged[:3].any() and not staged[8:].any()


def test_the_upload_route_engages_only_on_large_in_memory_views_for_a_cuda_device():
    big = _sims(_rng_views(3, (4, 8), np.uint16))  # 192 bytes, rows of 16
    assert residency._upload_route(big, CUDA, 64) == "staged"
    assert residency._upload_route(big, CPU, 64) == "direct"
    assert residency._upload_route(big, CUDA, 192) == "direct"  # one slot or less
    assert residency._upload_route(big, CUDA, 8) == "direct"  # a row exceeds a slot
    assert residency._upload_route(_sims([np.zeros((0, 8), np.uint16)] * 3), CUDA, 64) == "direct"
    lazy = zarr_backend.LazyZarrArray.__new__(zarr_backend.LazyZarrArray)
    lazy_sims = big[:2] + [types.SimpleNamespace(data=lazy)]
    assert residency._upload_route(lazy_sims, CUDA, 64) == "direct"


def _fake_cuda_result(shape, dtype):
    """What the download route reads of a CUDA result, without a card."""
    host = torch.zeros(shape, dtype=dtype)
    return types.SimpleNamespace(is_cuda=True, shape=host.shape, dtype=dtype,
                                 numel=host.numel, element_size=host.element_size)


def test_the_download_route_engages_only_on_large_cuda_results_into_host_arrays():
    fused = _fake_cuda_result((4, 8), torch.uint16)  # 64 bytes
    out = np.zeros((4, 8), np.uint16)
    assert residency._download_route(fused, out, 32) == "staged"
    assert residency._download_route(fused, out, 64) == "direct"  # one slot or less
    assert residency._download_route(torch.zeros(4, 8, dtype=torch.uint16), out, 32) == "direct"
    assert residency._download_route(fused, torch.zeros(4, 8, dtype=torch.uint16), 32) == "direct"
    sink = tcore._PrefixedSink(np.zeros((1, 4, 8), np.uint16), (0,))
    assert residency._download_route(fused, sink, 32) == "direct"
    assert residency._download_route(fused, np.zeros((8, 4), np.uint16).T, 32) == "direct"
    assert residency._download_route(fused, np.zeros((4, 8), np.int32), 32) == "direct"
    readonly = np.zeros((4, 8), np.uint16)
    readonly.flags.writeable = False
    assert residency._download_route(fused, readonly, 32) == "direct"


def test_copies_on_the_cpu_sinks_and_device_tensors_report_the_direct_route():
    arrays = _rng_views(2, (3, 300, 200), np.uint16)
    tcore.clear_device_tile_cache()
    tiles = residency.tiles_to_device(_real_sims(arrays), "cpu")
    tcore.clear_device_tile_cache()
    assert residency.last_copy_telemetry["upload"] == {
        "route": "direct", "bytes": 2 * 3 * 300 * 200 * 2, "pieces": 0, "slots": 0}
    for out in (np.zeros(tiles.shape, np.uint16), torch.zeros_like(tiles),
                tcore._PrefixedSink(np.zeros((1,) + tuple(tiles.shape), np.uint16), (0,))):
        residency.download(tiles, out)
        assert residency.last_copy_telemetry["download"] == {
            "route": "direct", "bytes": tiles.numel() * 2, "pieces": 0, "slots": 0}
        got = out.array[0] if isinstance(out, tcore._PrefixedSink) else out
        np.testing.assert_array_equal(np.asarray(got), tiles.numpy())


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the ring stages copies to and from a card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.card
def test_staged_copies_on_the_card_equal_the_direct_route():
    device = _card()
    ring = residency._staging_ring(device)
    before = dict(residency.ring_bytes)
    # five views of rows of 521216 bytes, over three slots' rows and an odd
    # remainder: every piece but the last a slot's whole rows, several
    # across the views' boundaries
    per = ring.slot_bytes // (512 * 509 * 2)
    shape = ((3 * per + 7) // 5 + 1, 512, 509)
    rows = 5 * shape[0]
    nbytes = rows * 512 * 509 * 2
    pieces_up, pieces_down = -(-rows // per), -(-nbytes // ring.slot_bytes)
    assert pieces_up >= 4 and rows % per % 2 == 1
    for seed, poison in ((10, None), (11, 0xA5)):
        if poison is not None:
            torch.cuda.synchronize()
            for slot in list(ring._free.queue):
                slot.array[...] = poison
        arrays = _rng_views(5, shape, np.uint16, seed=seed)
        sims = [si_utils.get_sim_from_array(a, dims=["z", "y", "x"]) for a in arrays]
        tcore.clear_device_tile_cache()
        stack = residency.tiles_to_device(sims, device)
        tcore.clear_device_tile_cache()
        assert residency.last_copy_telemetry["upload"] == {
            "route": "staged", "bytes": nbytes, "pieces": pieces_up,
            "slots": min(pieces_up, ring.n)}
        assert torch.equal(stack.cpu(), torch.from_numpy(np.stack(arrays)))
        # the download: the stack, shifted so it differs from the upload
        fused = (stack.view(torch.int16) + 3).view(torch.uint16).view(rows, *shape[1:])
        out = np.zeros(fused.shape, np.uint16)
        residency.download(fused, out)
        assert residency.last_copy_telemetry["download"] == {
            "route": "staged", "bytes": nbytes, "pieces": pieces_down,
            "slots": min(pieces_down, ring.n)}
        np.testing.assert_array_equal(out, fused.cpu().numpy())
        # and a band of a larger host array
        band = np.zeros((7 + rows,) + shape[1:], np.uint16)
        residency.download(fused, band, row0=7)
        np.testing.assert_array_equal(band[7:], out)
        assert not band[:7].any()
    assert residency.ring_bytes["upload"] - before["upload"] == 2 * nbytes
    assert residency.ring_bytes["download"] - before["download"] == 4 * nbytes
    assert residency._staging_ring(device) is ring
    assert ring.n * ring.slot_bytes <= 256 * 10**6


@pytest.mark.card
def test_fuse_of_rotated_views_is_the_same_with_the_ring_and_without(monkeypatch):
    from multiview_stitcher_torch.fusion import fuse
    from portbench import jobkit, multiview

    device = _card()
    config = {"tile": [16, 32, 32], "views": 4, "angle_step_deg": 90, "spacing": [2.0, 1.0, 1.0],
              "output_spacing": 1.0, "position_jitter_px": [0.5, 0.5, 0.5],
              "correction_deg": [0.5, 2.0], "stage_error_px": [1.0, 5.0],
              "psf_sigma_px": 0.85, "dtype": "uint16"}
    views = multiview.make_views(config, 2**31 + 11, "cpu")
    # slots of 4 KiB: the 64 KiB of views and the fused volume cross in pieces
    monkeypatch.setattr(residency, "_RING_SLOT_BYTES", 4096)
    monkeypatch.setattr(residency, "_RINGS", {})

    def run():
        tcore.clear_device_tile_cache()
        out = fuse(multiview.to_sims(views, jobkit.KEY), transform_key=jobkit.KEY,
                   device=device, output_spacing={"z": 1.0, "y": 1.0, "x": 1.0})
        return np.asarray(out.data), {k: dict(v) for k, v in residency.last_copy_telemetry.items()}

    staged, tele = run()
    assert tele["upload"]["route"] == "staged" and tele["download"]["route"] == "staged"
    assert tele["upload"]["bytes"] == views.views.nbytes
    monkeypatch.setattr(residency, "_upload_route", lambda sims, device, slot_bytes: "direct")
    monkeypatch.setattr(residency, "_download_route", lambda fused, out, slot_bytes: "direct")
    direct, tele = run()
    assert tele["upload"]["route"] == "direct" and tele["download"]["route"] == "direct"
    np.testing.assert_array_equal(staged, direct)
