"""The port's exact-affine fusion tier against the JAX package.

Inputs are made from a seed with numpy. The JAX ``fuse`` runs with
``MVS_TPU_EXACT_AFFINE=1`` and ``MVS_TPU_SHEAR=0`` (set through monkeypatch),
which sends rotated and affine views through its exact Pallas tier in
interpret mode, with source windows planned without the shear tier's margin;
the port's ``fuse`` runs with ``device="cpu"`` and takes the kernels' plain
PyTorch versions.

Tolerances: the host planning (chunk plans, kernel parameters) is the same
float64 numpy arithmetic on both sides and must agree exactly. Fused integer
outputs differ by at most 1 count (the f32 blend lands on either side of a
truncation tie); fused f32 outputs agree to rtol 1e-4, atol 1e-3 (f32 ulps of
the sample coordinates on data in [0, 100)).
"""

import jax
import numpy as np
import pytest
import torch

from multiview_stitcher_torch import convert
from multiview_stitcher_torch import mv_graph as tmv
from multiview_stitcher_torch import residency
from multiview_stitcher_torch import si_utils as tsi
from multiview_stitcher_torch.fusion import _core as tcore
from multiview_stitcher_torch.fusion import fuse as tfuse
from multiview_stitcher_torch.ops import exact_affine as tea
from multiview_stitcher_tpu import mv_graph, si_utils
from multiview_stitcher_tpu.fusion import _core as jcore
from multiview_stitcher_tpu.fusion import fuse as jfuse

KEY = "affine"


def _to_port(sims):
    return [
        convert.sim_from_numpy(
            s.data, s.dims, s.spacing, s.origin,
            {k: v.data for k, v in s.transforms.items()}, coords=s.coords,
        )
        for s in sims
    ]


def _smooth(shape, seed=3):
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(seed)
    return gaussian_filter(rng.random(shape), 1.5).astype(np.float32)


def _rot2(theta):
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s], [s, c]])


def _sims(arrays, translations, mats, dims):
    sims = []
    for data, tr, m in zip(arrays, translations, mats):
        sim = si_utils.get_sim_from_array(data, dims=dims, translation=dict(zip(dims, tr)))
        si_utils.set_sim_affine(sim, m, transform_key=KEY)
        sims.append(sim)
    return sims


def _case(name, dtype=np.float32):
    """(JAX sims, output chunksize): the layouts of tests/test_exact_affine.py."""
    if name == "roty2":
        img = (_smooth((80, 80)) * 100).astype(dtype)
        R = np.eye(3)
        R[:2, :2] = _rot2(0.06)
        return _sims([img, img.copy()], [(0.0, 0.0), (0.0, 60.0)], [np.eye(3), R], ("y", "x")), 48
    if name == "roty3":
        vol = (_smooth((40, 48, 48)) * 100).astype(dtype)
        R = np.eye(4)
        c, s = np.cos(0.05), np.sin(0.05)
        R[0, 0], R[0, 2], R[2, 0], R[2, 2] = c, -s, s, c  # rotate around y
        return _sims([vol, vol.copy()], [(0.0, 0.0, 0.0), (0.0, 0.0, 36.0)],
                     [np.eye(4), R], ("z", "y", "x")), 32
    if name == "multiview92":
        # two views of one volume, the second rotated by 92 degrees about y
        # through the common centre: the light-sheet multi-view geometry
        vol = (_smooth((28, 20, 28)) * 100).astype(dtype)
        c, s = np.cos(np.deg2rad(92)), np.sin(np.deg2rad(92))
        lin = np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]])
        centre = (np.array(vol.shape) - 1) / 2
        R = np.eye(4)
        R[:3, :3] = lin
        R[:3, 3] = centre - lin @ centre
        return _sims([vol, np.ascontiguousarray(vol[::-1])], [(0.0, 0.0, 0.0)] * 2,
                     [np.eye(4), R], ("z", "y", "x")), 16
    if name == "coupled":
        vol = (_smooth((24, 32, 32)) * 100).astype(dtype)
        R = np.eye(4)
        R[1:3, 1:3] = _rot2(0.08)  # couples y with x
        return _sims([vol, vol.copy()], [(0.0, 0.0, 0.0), (0.0, 0.0, 24.0)],
                     [np.eye(4), R], ("z", "y", "x")), 32
    if name == "affine_resolved":
        # identity + couplings in [1e-2, 3e-2] in every entry
        rng = np.random.default_rng(5)
        vol = (_smooth((24, 32, 32), seed=7) * 100).astype(dtype)
        params = []
        for _ in range(2):
            m = np.eye(4)
            m[:3, :3] += rng.uniform(1e-2, 3e-2, (3, 3)) * rng.choice([-1, 1], (3, 3))
            m[:3, 3] = rng.uniform(-1.5, 1.5, 3)
            params.append(m)
        return _sims([vol, vol.copy()], [(0.0, 0.0, 0.0), (0.0, 0.0, 24.0)],
                     params, ("z", "y", "x")), 32
    if name == "mixed_shapes":
        rng = np.random.default_rng(9)
        R = np.eye(3)
        R[:2, :2] = _rot2(0.07)
        # integer counts in [100, 1100); floats in [10, 110), the range the
        # f32 tolerance is stated for
        unit = 1 if np.issubdtype(dtype, np.integer) else 0.1
        arrays = [
            (rng.integers(100, 1100, size=shp) * unit).astype(dtype)
            for shp in [(40, 80), (60, 60)]
        ]
        return _sims(arrays, [(0.0, 0.0), (20.0, 30.0)], [np.eye(3), R], ("y", "x")), 32
    raise KeyError(name)


@pytest.fixture
def exact_tier(monkeypatch):
    monkeypatch.setenv("MVS_TPU_EXACT_AFFINE", "1")
    monkeypatch.setenv("MVS_TPU_SHEAR", "0")
    jcore.clear_device_tile_cache()
    yield
    jcore.clear_device_tile_cache()
    # the reference's jitted entries keep their traces at these shapes; a
    # later test that spies on a function they call while tracing (the JAX
    # package's own exact-tier tests) would not see it called
    jax.clear_caches()


def _jax_fuse_spied(monkeypatch, sims, **kw):
    """The reference ``fuse`` and the ``kind3d`` of every exact-tier batch."""
    kinds = []
    # the outer, device-resident entry: the inner one is traced once per
    # shape under jit and a Python spy on it would miss cached calls
    orig = jcore._fuse_chunk_batch_kernel_exact_devtiles

    def spy(*a, **k):
        kinds.append(k.get("kind3d", "sepy"))
        return orig(*a, **k)

    monkeypatch.setattr(jcore, "_fuse_chunk_batch_kernel_exact_devtiles", spy)
    out = jfuse(sims, transform_key=KEY, **kw)
    assert kinds, "the reference did not take its exact tier"
    return out, kinds


def _assert_fused_close(got, ref):
    assert got.dtype == ref.dtype and got.shape == ref.shape
    if np.issubdtype(ref.dtype, np.integer):
        assert np.abs(got.astype(np.int64) - ref.astype(np.int64)).max() <= 1
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-3)


_FUSE_CASES = [
    ("roty2", np.uint16, "weighted_average_fusion"),
    ("roty2", np.float32, "weighted_average_fusion"),
    ("roty3", np.uint16, "weighted_average_fusion"),
    ("roty3", np.float32, "weighted_average_fusion"),
    ("multiview92", np.uint16, "weighted_average_fusion"),
    ("coupled", np.uint16, "weighted_average_fusion"),
    ("coupled", np.float32, "weighted_average_fusion"),
    ("affine_resolved", np.uint16, "weighted_average_fusion"),
    ("affine_resolved", np.float32, "weighted_average_fusion"),
    ("mixed_shapes", np.uint16, "weighted_average_fusion"),
    ("mixed_shapes", np.float32, "weighted_average_fusion"),
    ("roty2", np.float32, "max_fusion"),
    ("roty3", np.uint16, "max_fusion"),
    ("roty2", np.uint16, "simple_average_fusion"),
    ("coupled", np.float32, "simple_average_fusion"),
]


@pytest.mark.parametrize("name,dtype,func", _FUSE_CASES)
def test_fuse_affine_matches_jax(name, dtype, func, exact_tier, monkeypatch):
    sims, cs = _case(name, dtype)
    ref, kinds = _jax_fuse_spied(
        monkeypatch, sims, output_chunksize=cs, fusion_func=getattr(jcore, func)
    )
    # the port picks the kernel the reference picks
    picked = []
    orig = tcore._fuse_chunk_batch_kernel_exact_devtiles

    def spy(*a, **k):
        picked.append(a[13])
        return orig(*a, **k)

    monkeypatch.setattr(tcore, "_fuse_chunk_batch_kernel_exact_devtiles", spy)
    got = tfuse(_to_port(sims), transform_key=KEY, output_chunksize=cs,
                fusion_func=getattr(tcore, func), device="cpu")
    expected = "2d" if len(ref.spatial_dims) == 2 else kinds[0]
    assert picked and set(picked) == {expected}, (picked, kinds)
    assert isinstance(got.data, np.ndarray)
    assert got.dims == ref.dims and got.spacing == ref.spacing and got.origin == ref.origin
    np.testing.assert_array_equal(got.transforms[KEY].data, ref.transforms[KEY].data)
    _assert_fused_close(got.data, np.asarray(ref.data))


def test_fuse_affine_with_a_trimmed_halo_matches_jax(exact_tier, monkeypatch):
    sims, cs = _case("roty2", np.uint16)
    ref, _ = _jax_fuse_spied(monkeypatch, sims, output_chunksize=cs, overlap_in_pixels=5)
    got = tfuse(_to_port(sims), transform_key=KEY, output_chunksize=cs,
                overlap_in_pixels=5, device="cpu")
    _assert_fused_close(got.data, np.asarray(ref.data))


def test_fuse_affine_over_channels_matches_jax(exact_tier, monkeypatch):
    rng = np.random.default_rng(12)
    R = np.eye(3)
    R[:2, :2] = _rot2(-0.05)
    sims = []
    for iv in range(2):
        sim = si_utils.get_sim_from_array(
            (rng.random((2, 40, 48)) * 900).astype(np.uint16), dims=("c", "y", "x"),
            translation={"y": 0.0, "x": 36.0 * iv}, c_coords=["a", "b"],
        )
        si_utils.set_sim_affine(sim, R if iv else np.eye(3), transform_key=KEY)
        sims.append(sim)
    ref, _ = _jax_fuse_spied(monkeypatch, sims, output_chunksize=32)
    got = tfuse(_to_port(sims), transform_key=KEY, output_chunksize=32, device="cpu")
    assert got.dims == ref.dims
    _assert_fused_close(got.data, np.asarray(ref.data))


def _port_plan(sims, cs, overlap=0):
    sdims = tsi.get_spatial_dims_from_sim(sims[0])
    osp = tcore.process_output_stack_properties(sims, transform_key=KEY)
    osp = {
        "shape": {d: int(osp["shape"][d]) for d in sdims},
        "spacing": {d: float(osp["spacing"][d]) for d in sdims},
        "origin": {d: float(osp["origin"][d]) for d in sdims},
    }
    chunks = {d: cs for d in sdims}
    ov = {d: overlap for d in sdims}
    bbs, idx = tmv.get_chunk_bbs(osp, chunks)
    plan = tcore._build_spatial_fusion_plan(
        sparams=[np.asarray(s.transforms[KEY].data) for s in sims],
        views_bb=[tsi.get_stack_properties_from_sim(s) for s in sims],
        output_stack_properties=osp, output_chunksize=chunks, output_chunk_bbs=bbs,
        output_chunk_bbs_with_overlap=[tcore._extend_bb(bb, ov) for bb in bbs],
        block_indices=idx, overlap_in_pixels=ov, interpolation_order=1, sdims=sdims,
    )
    return plan, osp, sdims


@pytest.mark.parametrize("name,overlap", [("roty2", 0), ("roty2", 3), ("roty3", 0), ("affine_resolved", 2)])
def test_spatial_fusion_plan_matches_jax_exactly(name, overlap):
    jsims, cs = _case(name)
    plan, osp, sdims = _port_plan(_to_port(jsims), cs, overlap)
    chunks = {d: cs for d in sdims}
    ov = {d: overlap for d in sdims}
    jbbs, jidx = mv_graph.get_chunk_bbs(osp, chunks)
    ref = jcore._build_spatial_fusion_plan(
        sparams=[np.asarray(s.transforms[KEY].data) for s in jsims],
        views_bb=[si_utils.get_stack_properties_from_sim(s) for s in jsims],
        output_stack_properties=osp, output_chunksize=chunks, output_chunk_bbs=jbbs,
        output_chunk_bbs_with_overlap=[jcore._extend_bb(bb, ov) for bb in jbbs],
        block_indices=jidx, overlap_in_pixels=ov, interpolation_order=1, sdims=sdims,
    )
    assert len(plan["per_chunk_entries"]) == len(ref["per_chunk_entries"]) > 1
    assert any(len(e["views"]) > 1 for e in ref["per_chunk_entries"])
    # dict equality compares every float64 exactly
    assert plan["per_chunk_entries"] == ref["per_chunk_entries"]


@pytest.mark.parametrize("name", ["roty2", "roty3", "coupled", "mixed_shapes"])
def test_exact_kernel_params_match_jax_exactly(name, exact_tier, monkeypatch):
    jsims, cs = _case(name, np.uint16)
    _jax_fuse_spied(monkeypatch, jsims, output_chunksize=cs)
    (jplan,) = jcore._plan_cache.values()
    jentries = [e for e in jplan["per_chunk_entries"] if e["views"]]

    sims = _to_port(jsims)
    plan, _, sdims = _port_plan(sims, cs)
    entries = [e for e in plan["per_chunk_entries"] if e["views"]]
    K_max, S_max, O_max = tcore._plan_window_shapes(entries, sdims)
    stack_shape = tuple(max(s.data.shape[i] for s in sims) for i in range(len(sdims)))
    params = tcore.exact_kernel_params(
        entries, sims, plan["sparams"], sdims, S_max, O_max, stack_shape, True, None, 0,
    )
    assert len(params) == len(jentries)
    for kp, je in zip(params, jentries):
        assert len(kp) == len(je["_kernel_params"])
        for it, jit in zip(kp, je["_kernel_params"]):
            assert it["iview"] == jit["iview"]
            assert list(it["start"]) == list(jit["start"])
            assert list(it["extent"]) == list(jit["extent"])
            for k in ("m", "o", "g", "wm", "wo"):
                assert np.asarray(it[k]).dtype == np.asarray(jit[k]).dtype
                np.testing.assert_array_equal(it[k], jit[k])
    ndim = len(sdims)
    all_m = np.stack([it["m"] for kp in params for it in kp])
    assert tcore._exact_kind(ndim, params, True) == (
        "2d" if ndim == 2 else "sepy" if tea.is_y_decoupled(all_m) else "general"
    )


def test_exact_batch_pads_slots_as_the_reference_does():
    sims = _to_port(_case("roty2", np.uint16)[0])
    plan, _, sdims = _port_plan(sims, 48)
    entries = [e for e in plan["per_chunk_entries"] if e["views"]]
    K_max, S_max, O_max = tcore._plan_window_shapes(entries, sdims)
    params = tcore.exact_kernel_params(
        entries, sims, plan["sparams"], sdims, S_max, O_max, (80, 80), True, None, 0,
    )
    assert K_max == 2 and any(len(kp) == 1 for kp in params)
    t = tcore._build_exact_batch(params, K_max, 2, True)
    for bi, kp in enumerate(params):
        n = len(kp)
        assert t["valid"][bi].tolist() == [True] * n + [False] * (K_max - n)
        for vi in range(n, K_max):
            # identity maps, extent 1, no weight: the reference's padding slots
            np.testing.assert_array_equal(t["mats"][bi, vi], np.eye(2))
            np.testing.assert_array_equal(t["wmats"][bi, vi], np.eye(2))
            assert (t["extents"][bi, vi] == 1).all() and (t["offs"][bi, vi] == 0).all()
            assert (t["wgrids"][bi, vi] == 0).all() and t["tile_idx"][bi, vi] == 0


@pytest.mark.parametrize("name", ["roty2", "coupled"])
def test_slab_batches_equal_device_resident_batches(name):
    """Sampling slabs sliced out of the stack equals sampling the stack
    through ``tile_idx`` and ``starts``, bit for bit."""
    sims = _to_port(_case(name, np.uint16)[0])
    plan, _, sdims = _port_plan(sims, 32)
    ndim = len(sdims)
    entries = [e for e in plan["per_chunk_entries"] if e["views"]]
    K_max, S_max, O_max = tcore._plan_window_shapes(entries, sdims)
    params = tcore.exact_kernel_params(
        entries, sims, plan["sparams"], sdims, S_max, O_max, sims[0].data.shape, True, None, 0,
    )
    t = tcore._build_exact_batch(params, K_max, ndim, True)
    tiles = residency.tiles_to_device(sims, torch.device("cpu"))
    kind = tcore._exact_kind(ndim, params, True)
    tables = (t["mats"], t["offs"], t["extents"], t["wgrids"], t["wmats"], t["woffs"], t["valid"])
    dev = tcore._fuse_chunk_batch_kernel_exact_devtiles(
        tiles, t["tile_idx"], t["starts"], *tables, O_max, "weighted_average", True, kind,
    )
    slabs = torch.stack([
        torch.stack([
            tiles[(int(t["tile_idx"][b, k]),) + tuple(
                slice(int(st), int(st) + n) for st, n in zip(t["starts"][b, k], S_max)
            )]
            for k in range(K_max)
        ])
        for b in range(len(params))
    ])
    host = tcore._fuse_chunk_batch_kernel_exact(
        slabs, *tables, O_max, "weighted_average", True, kind,
    )
    assert dev.shape == (len(params),) + O_max and dev.dtype == torch.float32
    assert torch.equal(dev, host)


@pytest.mark.parametrize("mode,use_bw", [
    ("weighted_average", True), ("max", False), ("simple_average", False),
])
def test_reduce_views_matches_jax(mode, use_bw):
    """rtol 1e-6 with atol 1e-5 on data in [0, 100): the two cosines of the
    weight taper differ by an f32 ulp, which a normalized weight passes on."""
    rng = np.random.default_rng(4)
    data = (rng.random((3, 14, 18)) * 100).astype(np.float32)
    data[0, :4] = np.nan
    data[1, 2:9, :5] = np.nan
    data[:, 12:, 15:] = np.nan  # no valid view
    bw = (rng.random((3, 14, 18)) * 1.4).astype(np.float32)
    bw[2, 5:7] = 0.0
    bw[:, 9, 9] = 0.0  # zero total weight with valid data: plain average
    ref, ref_bw = jcore._reduce_views(data, bw if use_bw else None, data.shape[1:], mode, use_bw)
    got, got_bw = tcore._reduce_views(
        torch.from_numpy(data), torch.from_numpy(bw) if use_bw else None, mode, use_bw
    )
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(np.asarray(ref)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-5)
    if use_bw:
        np.testing.assert_allclose(got_bw.numpy(), np.asarray(ref_bw), rtol=1e-6, atol=1e-6)
    # the batched form reduces over dim 1
    got_b, _ = tcore._reduce_views(
        torch.from_numpy(data)[None], torch.from_numpy(bw)[None] if use_bw else None,
        mode, use_bw, dim=1,
    )
    np.testing.assert_array_equal(got_b[0].numpy(), got.numpy())


@pytest.mark.parametrize("func", ["max_fusion", "simple_average_fusion"])
def test_builtin_fusion_functions_match_jax(func):
    rng = np.random.default_rng(6)
    views = rng.random((3, 10, 12)).astype(np.float32)
    views[0, :2] = np.nan
    views[:, 5, 5] = np.nan
    with np.errstate(all="ignore"):
        import warnings

        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            ref = getattr(jcore, func)(views)
    got = getattr(tcore, func)(torch.from_numpy(views)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7, equal_nan=True)
    assert set(tcore._BUILTIN_FUSION_MODES.values()) == set(jcore._BUILTIN_FUSION_MODES.values())
    assert tcore._BUILTIN_FUSION_MODES[getattr(tcore, func)] == jcore._BUILTIN_FUSION_MODES[
        getattr(jcore, func)
    ]


def test_has_keyword_matches_jax():
    from multiview_stitcher_torch.utils import misc as tmisc
    from multiview_stitcher_tpu.utils import misc as jmisc

    def catch_all(transformed_views, **kwargs):
        return transformed_views

    for m, core in ((tmisc, tcore), (jmisc, jcore)):
        assert m.has_keyword(core.weighted_average_fusion, "blending_weights")
        assert not m.has_keyword(core.max_fusion, "blending_weights")
        assert not m.has_keyword(catch_all, "blending_weights")
        assert not m.has_keyword(None, "blending_weights")


def test_rotated_sim_carries_its_affine_across():
    jsims, _ = _case("affine_resolved")
    for js, ts in zip(jsims, _to_port(jsims)):
        ja = si_utils.get_affine_from_sim(js, transform_key=KEY)
        ta = tsi.get_affine_from_sim(ts, transform_key=KEY)
        assert ta.data.shape == (4, 4)
        np.testing.assert_array_equal(ta.data, ja.data)
        np.testing.assert_array_equal(ts.data, js.data)
        assert ts.spacing == js.spacing and ts.origin == js.origin


def test_fuse_affine_refuses_what_needs_the_gather_tier(tmp_path, monkeypatch):
    """Float views that hold NaN, other interpolation orders and the
    untrimmed layout now fuse (the gather route, the plan's wider windows
    and the untrimmed writes; each is held to the reference in
    tests/test_torch_general_fusion.py): here the NaN view against the
    reference's gather tier, the CPU default. Rotated lazy tiles above the
    on-card limit take the batched tier's host slabs (the gather route:
    lazy float views may hold NaN), each window read and uploaded on its
    own, no tile stacked or uploaded; held here to the reference on the same
    tiles in memory (tests/test_torch_slabs.py holds the route to the
    reference's own host slabs)."""
    from multiview_stitcher_torch.io import zarr_backend as tzb

    monkeypatch.delenv("MVS_TPU_EXACT_AFFINE", raising=False)
    monkeypatch.delenv("MVS_TPU_SHEAR", raising=False)
    sims, cs = _case("roty2", np.float32)
    sims[0].data = sims[0].data.copy()
    sims[0].data[8:12, 20:30] = np.nan
    ref = np.asarray(jfuse(sims, transform_key=KEY, output_chunksize=cs).data)
    got = tfuse(_to_port(sims), transform_key=KEY, output_chunksize=cs, device="cpu").data
    assert not np.isnan(got).any()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-3)

    clean, _ = _case("roty2", np.float32)
    lazy = []
    for i, s in enumerate(_to_port(clean)):
        url = str(tmp_path / f"tile_{i}.zarr")
        tzb.create_zarr_array(url, s.data.shape, s.data.shape, s.data.dtype)[...] = s.data
        sim = tsi.get_sim_from_array(tzb.open_zarr_array(url), dims=s.dims,
                                     translation=dict(s.origin))
        tsi.set_sim_affine(sim, s.transforms[KEY].data, transform_key=KEY)
        lazy.append(sim)
    monkeypatch.setattr(tcore, "TILES_MAX_BYTES", 0)
    uploaded = residency.tile_upload_bytes
    for kw in ({}, {"interpolation_order": 3}, {"overlap_in_pixels": 4, "trim_overlap": False}):
        ref = np.asarray(jfuse(clean, transform_key=KEY, output_chunksize=cs, **kw).data)
        tcore.last_slab_telemetry.clear()
        got = tfuse(lazy, transform_key=KEY, output_chunksize=cs, device="cpu", **kw).data
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-3)
        tele = tcore.last_slab_telemetry
        assert (tele["tier"], tele["route"]) == ("batched", "gather")
        assert tele["units"] >= 1 and 0 < tele["window_bytes"] <= tele["upload_bytes"]
    assert residency.tile_upload_bytes == uploaded


def test_a_failing_kernel_raises_and_nothing_retries(monkeypatch):
    """The reference retries a failed exact tier on its XLA tiers; the port
    has no other tier and lets the error through."""
    sims, cs = _case("roty2", np.uint16)

    def boom(*a, **k):
        raise RuntimeError("exact_affine_2d launch failed (simulated)")

    monkeypatch.setattr(tea, "exact_affine_batch_2d", boom)
    with pytest.raises(RuntimeError, match="simulated"):
        tfuse(_to_port(sims), transform_key=KEY, output_chunksize=cs, device="cpu")
