"""The port's link codec (``multiview_stitcher_torch.ops.link_codec``) against
the JAX package's.

Each test of tests/test_link_codec.py has its counterpart here, on the same
inputs made from a seed with numpy: the port's torch half (``*_torch``) is
held to the JAX package's ``pack_np`` and to its jitted ``*_jax``, and the
port's transfers run on the CPU (``device="cpu"``) and are held to the JAX
package's ``put_packed`` / ``fetch_packed`` on the same array (their
``info``, and the bytes of every part of their ``keep_packed`` records). The
codec is lossless, so every comparison is exact (tolerance 0).
"""

from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from multiview_stitcher_torch.ops import link_codec as tl
from multiview_stitcher_tpu.ops import link_codec as jl


def _put(arr, **kw):
    """The port's put_packed on the CPU and the JAX package's on the same
    array: both arrays must be ``arr`` and both ``info`` equal; returns it."""
    ip, ij = {}, {}
    got = tl.put_packed(arr, info=ip, device="cpu", **kw)
    ref = jl.put_packed(arr, info=ij, **kw)
    np.testing.assert_array_equal(got.numpy(), arr)
    np.testing.assert_array_equal(np.asarray(ref), arr)
    assert got.dtype == tl._torch_dtype(arr.dtype) and ip == ij, (ip, ij)
    return ip


def _fetch(arr, **kw):
    """The port's fetch_packed of ``arr`` as a CPU tensor and the JAX
    package's of ``arr`` as a jax array: both ``arr``, both ``info`` equal,
    and with ``out`` given the port writes into it; returns the info."""
    ip, ij = {}, {}
    got = tl.fetch_packed(torch.from_numpy(arr), info=ip, **kw)
    ref = jl.fetch_packed(jnp.asarray(arr), info=ij, **kw)
    np.testing.assert_array_equal(got, arr)
    np.testing.assert_array_equal(ref, arr)
    assert ip == ij, (ip, ij)
    buf = np.empty(arr.shape, arr.dtype)
    assert tl.fetch_packed(torch.from_numpy(arr), out=buf, **kw) is buf
    np.testing.assert_array_equal(buf, arr)
    return ip


def _ramp(n, seed, lo=2000, step=2):
    rng = np.random.default_rng(seed)
    return (lo + np.cumsum(rng.integers(-step, step + 1, n))).astype(np.uint16)


def _smooth_2d(shape, seed=0, scale=3000.0):
    rng = np.random.default_rng(seed)
    d = gaussian_filter(rng.random(shape), 3.0)
    d -= d.min()
    return (d * (scale / max(d.max(), 1e-9))).astype(np.uint16)


def _smooth_3d(shape, seed=0, scale=1200.0, sigma=2.0):
    rng = np.random.default_rng(seed)
    d = gaussian_filter(rng.random(shape), sigma)
    d -= d.min()
    return (d * (scale / max(d.max(), 1e-9))).astype(np.uint16)


# ---------------------------------------------------------------------------
# bit packing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nbits", list(tl.ALLOWED_NBITS))
@pytest.mark.parametrize("count", [1, 7, 16, 1000, 12345])
def test_np_roundtrip(nbits, count):
    rng = np.random.default_rng(count + nbits)
    vals = rng.integers(0, 1 << min(nbits, 16), count).astype(np.uint16)
    buf = tl.pack_np(vals, nbits)
    np.testing.assert_array_equal(buf, jl.pack_np(vals, nbits))
    np.testing.assert_array_equal(tl.unpack_np(buf, nbits, count), vals)
    assert buf.dtype == np.uint8 and buf.size == tl.packed_byte_count(count, nbits)
    if nbits < 16:
        assert count * nbits <= buf.size * 8 <= (count + 8) * nbits


@pytest.mark.parametrize("nbits", list(tl.ALLOWED_NBITS))
@pytest.mark.parametrize("count", [1, 7, 4097])
def test_torch_matches_np_and_jax(nbits, count):
    """pack_torch's bytes are pack_np's and pack_jax's at every width, the
    sub-byte groups and the wide (two-accumulator) groups of 5 and 7 bits
    included; unpack_torch inverts both, for uint16 and int16 tensors."""
    rng = np.random.default_rng(count * 31 + nbits)
    vals = rng.integers(0, 1 << nbits, count).astype(np.uint16)
    ref = jl.pack_np(vals, nbits)
    np.testing.assert_array_equal(np.asarray(jl.pack_jax(jnp.asarray(vals), nbits)), ref)
    for t in (torch.from_numpy(vals), torch.from_numpy(vals.view(np.int16))):
        got = tl.pack_torch(t, nbits)
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), ref)
    back = tl.unpack_torch(torch.from_numpy(ref), nbits, count)
    assert back.dtype == torch.uint16
    np.testing.assert_array_equal(back.numpy(), vals)
    signed = tl.unpack_torch(torch.from_numpy(ref), nbits, count, torch.int16)
    np.testing.assert_array_equal(signed.numpy(), vals.view(np.int16))
    np.testing.assert_array_equal(
        np.asarray(jl.unpack_jax(jnp.asarray(ref), nbits, count, jnp.int16)), signed.numpy())


def test_nbits_for_max():
    for m in (0, 3, 4, 7, 15, 16, 31, 63, 64, 127, 255, 256, 511, 1023, 1024, 4095, 4096, 65535):
        assert tl.nbits_for_max(m) == jl.nbits_for_max(m)
    assert [tl.nbits_for_max(m) for m in (0, 4, 64, 255, 1024, 4096)] == [2, 3, 7, 8, 12, 16]


@pytest.mark.parametrize("shape", [(64, 64), (3, 50, 41)])
def test_put_fetch_packed(shape):
    arr = np.random.default_rng(1).integers(0, 3000, shape).astype(np.uint16)
    info = _put(arr)
    assert info == {"nbits": None, "delta": False, "bytes": arr.nbytes}  # under 1 MiB
    _fetch(arr)


def test_put_fetch_packed_large_path():
    # above 1 MiB, so the packed path runs
    arr = np.random.default_rng(2).integers(0, 1000, (1 << 21,)).astype(np.uint16)
    assert _put(arr)["nbits"] == 10
    assert _fetch(arr)["nbits"] == 10


def test_float_passthrough():
    arr = np.linspace(0, 1, 100, dtype=np.float32)
    assert _put(arr)["nbits"] is None
    _fetch(arr)
    big = np.random.default_rng(3).random((600, 600)).astype(np.float32)  # the raw bands
    _fetch(big)


def test_concurrent_put_fetch_threads():
    """Round trips from four threads at once stay exact."""
    rng = np.random.default_rng(7)
    arrays = [rng.integers(0, 2**12, (257, 129 + i)).astype(np.uint16) for i in range(8)]

    def roundtrip(a):
        return tl.fetch_packed(tl.put_packed(a, nbits=12, device="cpu"), nbits=12)

    with ThreadPoolExecutor(max_workers=4) as pool:
        outs = list(pool.map(roundtrip, arrays))
    for a, o in zip(arrays, outs):
        np.testing.assert_array_equal(a, o)


def test_concurrent_interleaved_put_then_fetch(monkeypatch):
    """Puts on one pool while fetches of earlier puts run on another, on
    the packed path."""
    monkeypatch.setattr(tl, "_MIN_PACK_SIZE", 0)
    rng = np.random.default_rng(8)
    arrays = [rng.integers(0, 2**10, (129, 257)).astype(np.uint16) for _ in range(6)]

    def put(a):
        return tl.put_packed(a, nbits=10, device="cpu")

    with ThreadPoolExecutor(max_workers=2) as up, ThreadPoolExecutor(max_workers=2) as down:
        devs = list(up.map(put, arrays))
        futs = [down.submit(tl.fetch_packed, d, nbits=10) for d in devs]
        new_devs = list(up.map(put, arrays))
        outs = [f.result() for f in futs]
        outs2 = [tl.fetch_packed(d, nbits=10) for d in new_devs]
    for a, o, o2 in zip(arrays, outs, outs2):
        np.testing.assert_array_equal(a, o)
        np.testing.assert_array_equal(a, o2)


# ---------------------------------------------------------------------------
# delta transform
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("count", [1, 100, 2048, 2049, 5000, 2048 * 3 + 17])
def test_delta_np_roundtrip(count):
    rng = np.random.default_rng(count)
    # smooth ramps with hard jumps and full-range values
    vals = (np.cumsum(rng.integers(-3, 4, count)) % 65536).astype(np.uint16)
    vals[::97] = rng.integers(0, 65536, vals[::97].size)
    firsts, resid = tl.delta_encode_np(vals)
    jf, jr = jl.delta_encode_np(vals)
    np.testing.assert_array_equal(firsts, jf)
    np.testing.assert_array_equal(resid, jr)
    assert firsts.dtype == np.uint16 and resid.dtype == np.uint16
    assert firsts.size == tl._delta_rows(count)
    assert resid.size == firsts.size * (tl._DELTA_ROW - 1)
    np.testing.assert_array_equal(tl.delta_decode_np(firsts, resid, count), vals)
    tf, tr = tl.delta_encode_torch(torch.from_numpy(vals))
    np.testing.assert_array_equal(tf.numpy(), jf)
    np.testing.assert_array_equal(tr.numpy(), jr)
    np.testing.assert_array_equal(tl.delta_decode_torch(tf, tr, count).numpy(), vals)


def test_delta_torch_matches_np_wire_format():
    vals = (np.cumsum(np.random.default_rng(0).integers(-5, 6, 6000)) % 65536).astype(np.uint16)
    f_np, r_np = jl.delta_encode_np(vals)
    f_j, r_j = (np.asarray(a) for a in jl.delta_encode_jax(jnp.asarray(vals)))
    f_t, r_t = tl.delta_encode_torch(torch.from_numpy(vals))
    for got in (f_j, f_t.numpy()):
        np.testing.assert_array_equal(got, f_np)
    for got in (r_j, r_t.numpy()):
        np.testing.assert_array_equal(got, r_np)
    back = tl.delta_decode_torch(torch.from_numpy(f_np), torch.from_numpy(r_np), vals.size)
    np.testing.assert_array_equal(back.numpy(), vals)


def test_delta_byte_count_accounting():
    for count in (1, 10000, 2048 * 5):
        for nb in tl.ALLOWED_NBITS:
            assert tl.delta_byte_count(count, nb) == jl.delta_byte_count(count, nb)
            assert tl.delta2_byte_count(count, 100, nb) == jl.delta2_byte_count(count, 100, nb)
            assert tl.delta3_byte_count(count, 100, nb) == jl.delta3_byte_count(count, 100, nb)
    n_rows = tl._delta_rows(10000)
    assert tl.delta_byte_count(10000, 8) == 2 * n_rows + tl.packed_byte_count(
        n_rows * (tl._DELTA_ROW - 1), 8)


def test_put_packed_delta_smooth_wins_and_roundtrips():
    # smooth 12-bit data: residuals (|d| <= 2, zigzag <= 4) fit the 4-bit tier
    n = 1 << 20
    vals = _ramp(n, 1)
    assert vals.max() > 1 << 10
    info = _put(vals.reshape(1024, 1024), delta=True)
    assert info["delta"] is True and info["nbits"] <= 4
    assert info["bytes"] < tl.packed_byte_count(n, 12)


def test_put_packed_delta_noisy_falls_back_to_plain():
    vals = np.random.default_rng(2).integers(0, 1 << 10, 1 << 20).astype(np.uint16)
    info = _put(vals, delta=True)
    assert info["delta"] is False and info["nbits"] == 10


def test_fetch_packed_delta_smooth_wins_and_roundtrips():
    vals = _ramp(1 << 20, 3).reshape(64, 128, 128)
    info = _fetch(vals, delta=True)
    assert info["delta"] is True and info["nbits"] <= 4


def test_fetch_packed_delta_noisy_falls_back_to_plain():
    vals = np.random.default_rng(4).integers(0, 1 << 10, 1 << 20).astype(np.uint16)
    info = _fetch(vals, delta=True)
    assert info["delta"] is False and info["nbits"] == 10


def test_delta_defaults_on_as_module_constants(monkeypatch):
    """The candidates default on (the codec ships one only where it packs
    smaller), as module constants: the port reads none of the reference's
    MVS_TPU_LINK_* variables."""
    assert (tl.DELTA, tl.DELTA2, tl.DELTA3, tl.STREAMS) == (True, True, True, 32)
    vals = _ramp(1 << 20, 1).reshape(1024, 1024)
    for var in ("MVS_TPU_LINK_DELTA", "MVS_TPU_LINK_DELTA2", "MVS_TPU_LINK_DELTA3"):
        monkeypatch.setenv(var, "0")
    monkeypatch.setenv("MVS_TPU_LINK_STREAMS", "1")
    info = {}
    tl.put_packed(vals, info=info, device="cpu")
    assert info["delta"] is True
    monkeypatch.setattr(tl, "DELTA", False)
    tl.put_packed(vals, info=info, device="cpu")
    assert info["delta"] is False


def test_delta_exception_list_outlier_tolerance():
    """A few large jumps travel as sparse exceptions; the stream keeps its
    narrow width."""
    rng = np.random.default_rng(7)
    n = 1 << 20
    vals = (1000 + np.cumsum(rng.integers(-3, 4, n))).astype(np.uint16)
    vals[rng.choice(n, 50, replace=False)] = 60000
    info = _put(vals, delta=True)
    assert info["delta"] is True and info["nbits"] <= 4
    assert info["bytes"] < tl.packed_byte_count(n, 8)


def test_choose_delta_width_tradeoff():
    cases = [np.full(1 << 16, 3, np.uint16)]
    cases.append(cases[0].copy())
    cases[1][: cases[1].size // 4] = 4000
    cases.append(np.full(1 << 16, 3, np.uint16))
    cases[2][[5, 500, 5000]] = 65535
    expect = [(2, None), (12, None), (2, [5, 500, 5000])]
    for r, (nb_want, idx_want) in zip(cases, expect):
        nb, idx, val = tl._choose_delta_width_np(r)
        jnb, jidx, jval = jl._choose_delta_width_np(r)
        assert nb == jnb == nb_want
        if idx_want is None:
            assert idx is None and jidx is None
        else:
            assert list(idx) == list(jidx) == idx_want
            assert list(val) == list(jval) == [65535] * 3


def test_fetch_packed_delta_exceptions_narrow_width():
    rng = np.random.default_rng(11)
    n = 1 << 20
    vals = (1000 + np.cumsum(rng.integers(-3, 4, n))).astype(np.uint16)
    vals[rng.choice(n, 40, replace=False)] = 64000
    info = _fetch(vals, delta=True)
    assert info["delta"] is True and info["nbits"] <= 4
    assert info["bytes"] < tl.packed_byte_count(n, 8)


def test_fetch_packed_delta_exceptions_prefer_wider_when_many():
    vals = np.cumsum(np.random.default_rng(12).integers(-600, 601, 1 << 20)).astype(np.uint16)
    _fetch(vals, delta=True)


def test_sub_byte_tier_six_bits():
    vals = _ramp(1 << 20, 21, lo=5000, step=25)
    info = _put(vals, delta=True)
    assert info["delta"] is True and info["nbits"] == 6
    assert info["bytes"] < tl.packed_byte_count(vals.size, 8)
    info = _fetch(vals, delta=True)
    assert info["delta"] is True and info["nbits"] == 6


def test_sub_byte_wire_bits_per_vox():
    vals = _ramp(1 << 20, 22, lo=100, step=1)
    info = _put(vals, delta=True)
    assert info["delta"] is True and info["nbits"] == 2
    assert info["bytes"] * 8 / vals.size < 2.2


def test_fetch_packed_exception_at_residual_zero():
    """Residual 0 is itself an exception and the exception buffer has
    unused slots: they must not overwrite residual 0's true value."""
    vals = _ramp(1 << 20, 31, lo=248)
    vals[0] = 60000
    info = _fetch(vals, delta=True)
    assert info["delta"] is True and info["nbits"] < 16


def test_put_packed_info_bytes_count_padded_exceptions():
    vals = _ramp(1 << 20, 32, lo=1000, step=3)
    vals[12345] = 64000  # one hot pixel: 2 exceptions, capacity 16
    info = _put(vals, delta=True)
    assert info["delta"] is True
    base = tl.delta_byte_count(vals.size, info["nbits"])
    assert (info["bytes"] - base) % tl._EXC_BYTES == 0
    n_exc_shipped = (info["bytes"] - base) // tl._EXC_BYTES
    assert n_exc_shipped == tl._exc_capacity(n_exc_shipped) == 16


# ---------------------------------------------------------------------------
# second and third differences
# ---------------------------------------------------------------------------


def test_delta2_roundtrip_np_torch_jax_parity():
    rng = np.random.default_rng(0)
    for shape in [(64, 130), (7, 33, 257), (3, 5, 9)]:
        for vals in [rng.integers(0, 1 << 16, shape).astype(np.uint16),
                     np.zeros(shape, np.uint16), _smooth_2d(shape, seed=1)]:
            flat = vals.reshape(-1)
            X = shape[-1]
            f, z = jl.delta2_encode_np(flat, X)
            tf_, tz_ = tl.delta2_encode_np(flat, X)
            fj, zj = jl.delta2_encode_jax(flat, X)
            ft, zt = tl.delta2_encode_torch(torch.from_numpy(flat), X)
            for a, b in ((tf_, f), (tz_, z), (np.asarray(fj), f), (np.asarray(zj), z),
                         (ft.numpy(), f), (zt.numpy(), z)):
                np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(tl.delta2_decode_np(f, z, X, flat.size), flat)
            back = tl.delta2_decode_torch(torch.from_numpy(f), torch.from_numpy(z), X, flat.size)
            np.testing.assert_array_equal(back.numpy(), flat)


def test_put_packed_delta2_smooth_2d_wins_and_roundtrips():
    vals = _smooth_2d((1024, 1024), seed=2)
    info = _put(vals, delta=True)
    assert info["delta"] is True and info["mode"] == "delta2"
    _, r1 = tl.delta_encode_np(vals.reshape(-1))
    nb1, ei, _ = tl._choose_delta_width_np(r1)
    d1_bytes = tl.delta_byte_count(vals.size, nb1) + tl._EXC_BYTES * tl._exc_capacity(
        0 if ei is None else ei.size)
    assert info["bytes"] < d1_bytes


def test_fetch_packed_delta2_smooth_2d_wins_and_roundtrips():
    info = _fetch(_smooth_2d((40, 181, 211), seed=3), delta=True)
    assert info["delta"] is True and info["mode"] in ("delta2", "delta3")


def test_delta2_exception_path_roundtrips_both_directions():
    vals = _smooth_2d((512, 1100), seed=4)
    vals[0, 1] = 65000  # the first residual is an exception
    vals[100, 500] = 64000
    vals[511, 1099] = 63000
    assert _put(vals, delta=True)["mode"] == "delta2"
    assert _fetch(vals, delta=True)["mode"] == "delta2"


def test_delta2_switched_off(monkeypatch):
    monkeypatch.setattr(tl, "DELTA2", False)
    monkeypatch.setenv("MVS_TPU_LINK_DELTA2", "0")  # the reference's switch, for its side
    vals = _smooth_2d((1024, 1024), seed=5)
    assert _put(vals, delta=True)["mode"] in ("delta", "plain")
    assert _fetch(vals, delta=True)["mode"] in ("delta", "plain")


def test_delta2_ineligible_1d_falls_back():
    info = _put(_ramp(1 << 20, 6), delta=True)
    assert info["mode"] in ("delta", "plain")


def test_odd_width_tier_engages_on_microscopy_like_content():
    """Gaussian-filtered noise ships a delta2/delta3 width under 8 bits,
    cheaper than any even width."""
    rng = np.random.default_rng(0)
    d = gaussian_filter(rng.random((16, 256, 256)), 1.5)
    d -= d.min()
    vals = (d * (1000.0 / d.max())).astype(np.uint16)
    for info in (_put(vals, delta=True), _fetch(vals, delta=True)):
        assert info["mode"] in ("delta2", "delta3") and info["nbits"] < 8
    _, resid = tl.delta2_encode_np(vals.reshape(-1), vals.shape[-1])
    nb, ei, _ = tl._choose_delta_width_np(resid)
    cost = tl.delta2_byte_count(vals.size, vals.shape[-1], nb) + (
        tl._EXC_BYTES * tl._exc_capacity(0 if ei is None else ei.size))
    best_even = min(
        tl.delta2_byte_count(vals.size, vals.shape[-1], onb)
        + tl._EXC_BYTES * tl._exc_capacity(int((resid > (1 << onb) - 1).sum()) if onb < 16 else 0)
        for onb in (2, 4, 6, 8, 10, 12, 16)
    )
    assert cost < best_even


def test_delta3_roundtrip_np_torch_jax_parity():
    rng = np.random.default_rng(10)
    for shape in [(2, 5, 9), (4, 7, 33), (3, 2, 8, 17)]:
        X, Y = shape[-1], shape[-2]
        for vals in [rng.integers(0, 1 << 16, shape).astype(np.uint16),
                     np.zeros(shape, np.uint16), _smooth_3d(shape, seed=11)]:
            flat = vals.reshape(-1)
            f, z = jl.delta3_encode_np(flat, X, Y)
            tf_, tz_ = tl.delta3_encode_np(flat, X, Y)
            fj, zj = jl.delta3_encode_jax(flat, X, Y)
            ft, zt = tl.delta3_encode_torch(torch.from_numpy(flat), X, Y)
            for a, b in ((tf_, f), (tz_, z), (np.asarray(fj), f), (np.asarray(zj), z),
                         (ft.numpy(), f), (zt.numpy(), z)):
                np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(tl.delta3_decode_np(f, z, X, Y, flat.size), flat)
            back = tl.delta3_decode_torch(torch.from_numpy(f), torch.from_numpy(z), X, Y,
                                          flat.size)
            np.testing.assert_array_equal(back.numpy(), flat)


def test_put_packed_delta3_zsmooth_wins_and_roundtrips():
    vals = _smooth_3d((16, 288, 288), seed=12, sigma=3.0)
    info = _put(vals, delta=True)
    assert info["mode"] == "delta3"
    _, r2 = tl.delta2_encode_np(vals.reshape(-1), vals.shape[-1])
    nb2, ei2, _ = tl._choose_delta_width_np(r2)
    d2_bytes = tl.delta2_byte_count(vals.size, vals.shape[-1], nb2) + tl._EXC_BYTES * (
        tl._exc_capacity(0 if ei2 is None else ei2.size))
    assert info["bytes"] < d2_bytes


def test_fetch_packed_delta3_zsmooth_wins_and_roundtrips():
    info = _fetch(_smooth_3d((16, 208, 208), seed=13, sigma=3.0), delta=True)
    assert info["mode"] == "delta3"


def test_delta3_exception_path_roundtrips_both_directions():
    vals = _smooth_3d((12, 256, 256), seed=14, sigma=3.0)
    vals[0, 0, 1] = 65000
    vals[5, 128, 100] = 64000
    vals[11, 255, 255] = 63000
    assert _put(vals, delta=True)["mode"] == "delta3"
    assert _fetch(vals, delta=True)["mode"] == "delta3"


def test_delta3_switched_off(monkeypatch):
    monkeypatch.setattr(tl, "DELTA3", False)
    monkeypatch.setenv("MVS_TPU_LINK_DELTA3", "0")
    vals = _smooth_3d((16, 208, 208), seed=13, sigma=3.0)
    assert _put(vals, delta=True)["mode"] in ("delta", "delta2", "plain")
    assert _fetch(vals, delta=True)["mode"] in ("delta", "delta2", "plain")


def test_delta3_ineligible_2d_falls_back():
    assert _put(_smooth_2d((1024, 1024), seed=15), delta=True)["mode"] in (
        "delta", "delta2", "plain")


def test_device_probes_match_the_reference():
    """The probes' counts, which arrive on the host in one small fetch."""
    vals = _smooth_3d((6, 40, 50), seed=16)
    vals[2, 3, 4] = 60000
    flat = vals.reshape(-1)
    got = tl._delta_probe_all(torch.from_numpy(flat), 50, 40).numpy()
    ref = np.asarray(jl._delta_probe_all_jax(jnp.asarray(flat), 50, 40))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(tl._delta_probe_both(torch.from_numpy(flat), 50).numpy(),
                                  np.asarray(jl._delta_probe_both_jax(jnp.asarray(flat), 50)))


# ---------------------------------------------------------------------------
# records across the two packages
# ---------------------------------------------------------------------------


def _record_case(name):
    """(array, put_packed kwargs) of a named record case."""
    if name.startswith("plain_"):
        nb = int(name.split("_")[1])
        rng = np.random.default_rng(nb)
        return rng.integers(0, 1 << nb, (600, 1000)).astype(np.uint16), dict(nbits=nb,
                                                                              delta=False)
    exc = name.endswith("_exc")
    kind = name.split("_")[0]
    if kind == "delta":
        vals = _ramp(1 << 20, 40, lo=1000, step=3)
    elif kind == "delta2":
        vals = _smooth_2d((800, 1400), seed=41)
    elif kind == "delta3":
        vals = _smooth_3d((16, 208, 208), seed=42, sigma=3.0)
    else:  # an exception at residual 0
        vals = _ramp(1 << 20, 43, lo=248).reshape(512, 2048)
        vals[0, 0] = 60000
        return vals, dict(delta=True)
    if exc:
        flat = vals.reshape(-1)
        flat[[1, flat.size // 3, flat.size - 1]] = [65000, 64000, 63000]
    return vals, dict(delta=True)


_RECORD_CASES = ([f"plain_{nb}" for nb in tl.ALLOWED_NBITS]
                 + [f"{m}{e}" for m in ("delta", "delta2", "delta3") for e in ("", "_exc")]
                 + ["exception_at_residual_0"])


def _np_of(x):
    return None if x is None else (x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x))


@pytest.mark.parametrize("name", _RECORD_CASES)
def test_records_are_the_references_and_reassemble_across_packages(name):
    arr, kw = _record_case(name)
    rp, rj, ip, ij = {}, {}, {}, {}
    tl.put_packed(arr, info=ip, keep_packed=rp, device="cpu", **kw)
    jl.put_packed(arr, info=ij, keep_packed=rj, **kw)
    assert ip == ij
    want_mode = {"plain": "plain", "exception": "delta"}.get(name.split("_")[0], name.split("_")[0])
    assert rp["mode"] == want_mode
    if name.endswith("_exc") or name.startswith("exception"):
        assert rp["exc_idx"] is not None
    assert set(rp) == set(rj)
    for k in ("mode", "nbits", "counts", "count", "X", "Y", "shape", "dtype", "packed_bytes"):
        assert rp[k] == rj[k], (k, rp[k], rj[k])
    for k in ("firsts", "exc_idx", "exc_val"):
        a, b = _np_of(rp[k]), _np_of(rj[k])
        assert (a is None) == (b is None), k
        if a is not None:
            assert a.dtype == b.dtype, k
            np.testing.assert_array_equal(a, b)
    assert len(rp["parts"]) == len(rj["parts"])
    for p, q in zip(rp["parts"], rj["parts"]):
        np.testing.assert_array_equal(p.numpy(), np.asarray(q))
    # each package rebuilds the other's record
    as_torch = dict(rj, parts=[torch.from_numpy(np.array(q)) for q in rj["parts"]],
                    **{k: None if rj[k] is None else torch.from_numpy(np.array(rj[k]))
                       for k in ("firsts", "exc_idx", "exc_val")})
    np.testing.assert_array_equal(tl.reassemble_packed(as_torch).numpy(), arr)
    as_jax = dict(rp, parts=[jnp.asarray(p.numpy()) for p in rp["parts"]],
                  **{k: None if rp[k] is None else jnp.asarray(rp[k].numpy())
                     for k in ("firsts", "exc_idx", "exc_val")})
    np.testing.assert_array_equal(np.asarray(jl.reassemble_packed(as_jax)), arr)
    np.testing.assert_array_equal(tl.reassemble_packed(rp).numpy(), arr)


@pytest.mark.parametrize("name", ["plain_12", "delta_exc", "delta2_exc", "delta3_exc",
                                  "exception_at_residual_0"])
def test_fetch_info_is_the_references(name):
    arr, _ = _record_case(name)
    _fetch(arr, delta=not name.startswith("plain"))


def test_int16_and_negative_values():
    """int16 arrays pack at their width; negative values ship at 16 bits."""
    rng = np.random.default_rng(50)
    pos = rng.integers(0, 900, (600, 1000)).astype(np.int16)
    assert _put(pos)["nbits"] == 10
    assert _fetch(pos)["nbits"] == 10
    neg = rng.integers(-900, 900, (600, 1000)).astype(np.int16)
    assert _put(neg)["nbits"] == 16
    _fetch(neg)


def test_numpy_route_without_the_native_library(monkeypatch):
    """With no native library the numpy route runs, and its bytes and
    values are the native route's."""
    monkeypatch.setattr(tl, "_MIN_PACK_SIZE", 0)
    rng = np.random.default_rng(60)
    cases = {nb: rng.integers(0, 1 << nb, 5003).astype(np.uint16) for nb in tl.ALLOWED_NBITS}
    smooth = _smooth_3d((8, 64, 96), seed=61)
    native = {nb: tl.pack_np(v, nb) for nb, v in cases.items()}
    native_delta = tl.delta_encode_np(smooth.reshape(-1))
    native_put, native_fetch = {}, {}
    tl.put_packed(smooth, keep_packed=native_put, device="cpu", n_streams=1)
    assert tl._native_codecs() is not None
    monkeypatch.setattr(tl, "_native_codecs", lambda: None)
    for nb, v in cases.items():
        np.testing.assert_array_equal(tl.pack_np(v, nb), native[nb])
        np.testing.assert_array_equal(tl.unpack_np(native[nb], nb, v.size), v)
        out = np.empty(native[nb].size, np.uint8)
        tl._pack_into(v, nb, out)
        np.testing.assert_array_equal(out, native[nb])
    f, r = tl.delta_encode_np(smooth.reshape(-1))
    np.testing.assert_array_equal(f, native_delta[0])
    np.testing.assert_array_equal(r, native_delta[1])
    np.testing.assert_array_equal(tl.delta_decode_np(f, r, smooth.size), smooth.reshape(-1))
    rec = {}
    got = tl.put_packed(smooth, keep_packed=rec, device="cpu", n_streams=1)
    np.testing.assert_array_equal(got.numpy(), smooth)
    for p, q in zip(rec["parts"], native_put["parts"]):
        np.testing.assert_array_equal(p.numpy(), q.numpy())
    info = {}
    np.testing.assert_array_equal(tl.fetch_packed(torch.from_numpy(smooth), info=info), smooth)
    assert info["delta"]


def test_entry_points_default_to_the_card():
    """put_packed runs on the CUDA device unless the caller names another
    (and raises where there is none)."""
    arr = np.zeros(8, np.uint16)
    if torch.cuda.is_available():
        assert tl.put_packed(arr).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            tl.put_packed(arr)
