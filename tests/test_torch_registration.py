"""The port's registration against the JAX package: its building blocks
(phase correlation, resampling, the box filter, SSIM, Spearman), the batched
pairwise core, the view graph and its pruning (held to networkx), the
groupwise resolution and ``register()`` end to end.

Inputs are made from a seed with numpy and go through the JAX function and
its port on the CPU (``device="cpu"``). Tolerances: shifts within 1e-3 px;
resampled images, filters and SSIM maps rtol 1e-4, atol 1e-4 (NaN where the
reference is NaN); link qualities within 1e-3; resolved parameters within
1e-3 physical units; graphs, edge orders and pruned edge sets exactly.
"""

import random

import jax.numpy as jnp
import networkx as nx
import numpy as np
import pytest
import torch
from scipy import ndimage

from multiview_stitcher_torch import convert
from multiview_stitcher_torch import msi_utils as tmsi
from multiview_stitcher_torch import mv_graph as tmv
from multiview_stitcher_torch import param_resolution as tpr
from multiview_stitcher_torch import registration as treg
from multiview_stitcher_torch.ops import filters as tfilters
from multiview_stitcher_torch.ops import image_metrics as tim
from multiview_stitcher_torch.ops import phase_correlation as tpc
from multiview_stitcher_torch.ops import resample as tresample
from multiview_stitcher_torch.parallel.mesh import Mesh
from multiview_stitcher_tpu import msi_utils, mv_graph, param_resolution, registration, sample_data
from multiview_stitcher_tpu import si_utils
from multiview_stitcher_tpu.ops import filters as jfilters
from multiview_stitcher_tpu.ops import image_metrics as jim
from multiview_stitcher_tpu.ops import phase_correlation as jpc
from multiview_stitcher_tpu.ops import resample as jresample

KEY = si_utils.DEFAULT_TRANSFORM_KEY
SHIFT_ATOL = 1e-3
MAP_TOL = dict(rtol=1e-4, atol=1e-4)
QUALITY_ATOL = 1e-3
PARAM_ATOL = 1e-3


def _to_port(sims):
    return [
        convert.sim_from_numpy(
            s.data, s.dims, s.spacing, s.origin,
            {k: v.data for k, v in s.transforms.items()}, coords=s.coords,
        )
        for s in sims
    ]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _smooth(rng, shape, sigma=1.5):
    return ndimage.gaussian_filter(rng.random(shape), sigma).astype(np.float32)


def _shifted_pairs(rng, ndim, n, shape):
    """``n`` pairs cut from one smooth image at integer and half-pixel
    offsets of up to 4 px."""
    big = _smooth(rng, tuple(s + 12 for s in shape))
    ims0, ims1 = [], []
    for _ in range(n):
        off = rng.integers(-4, 5, ndim) + 0.5 * rng.integers(0, 2, ndim)
        sl = tuple(slice(6, 6 + s) for s in shape)
        ims0.append(big[sl])
        ims1.append(ndimage.shift(big, -off, order=1)[sl].astype(np.float32))
    return np.stack(ims0), np.stack(ims1)


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ndim,shape", [(2, (40, 48)), (3, (10, 24, 20))])
@pytest.mark.parametrize("normalization", ["phase", None])
def test_phase_cross_correlation_matches_jax(ndim, shape, normalization):
    rng = np.random.default_rng(ndim)
    ims0, ims1 = _shifted_pairs(rng, ndim, 4, shape)
    uf = 10 if ndim == 2 else 2
    ref_s, ref_p = jpc.phase_cross_correlation_batch(ims0, ims1, uf, normalization)
    got_s, got_p = tpc.phase_cross_correlation_batch(_t(ims0), _t(ims1), uf, normalization)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(ref_s), atol=SHIFT_ATOL, rtol=0)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(ref_p), rtol=1e-4)
    s1, _ = tpc.phase_cross_correlation_batch(_t(ims0), _t(ims1), 1, normalization)
    r1, _ = jpc.phase_cross_correlation_batch(ims0, ims1, 1, normalization)
    np.testing.assert_allclose(s1.numpy(), np.asarray(r1), atol=SHIFT_ATOL, rtol=0)
    one, peak = tpc.phase_cross_correlation(_t(ims0[1]), _t(ims1[1]), uf, normalization)
    ref_one, ref_peak = jpc.phase_cross_correlation(ims0[1], ims1[1], uf, normalization)
    np.testing.assert_allclose(one.numpy(), np.asarray(ref_one), atol=SHIFT_ATOL, rtol=0)
    assert abs(float(peak) - float(ref_peak)) <= 1e-4 * abs(float(ref_peak))


@pytest.mark.parametrize("ndim,shape", [(2, (30, 36)), (3, (8, 18, 16))])
def test_masked_phase_cross_correlation_matches_jax(ndim, shape):
    rng = np.random.default_rng(10 + ndim)
    ims0, ims1 = _shifted_pairs(rng, ndim, 3, shape)
    m0 = np.ones(ims0.shape, bool)
    m1 = np.ones(ims1.shape, bool)
    m0[0, :3] = False
    m1[1, ..., -4:] = False
    m1[2, 2:5] = False
    ref_s, ref_p = jpc.masked_phase_cross_correlation_batch(ims0, ims1, m0, m1)
    got_s, got_p = tpc.masked_phase_cross_correlation_batch(_t(ims0), _t(ims1), _t(m0), _t(m1))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(ref_s), atol=SHIFT_ATOL, rtol=0)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(ref_p), rtol=1e-4, atol=1e-4)
    one, _ = tpc.masked_phase_cross_correlation(_t(ims0[2]), _t(ims1[2]), _t(m0[2]), _t(m1[2]))
    ref_one, _ = jpc.masked_phase_cross_correlation(ims0[2], ims1[2], m0[2], m1[2])
    np.testing.assert_allclose(one.numpy(), np.asarray(ref_one), atol=SHIFT_ATOL, rtol=0)


def _assert_maps_close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_allclose(got[~np.isnan(ref)], ref[~np.isnan(ref)], **MAP_TOL)


@pytest.mark.parametrize("ndim", [2, 3])
def test_affine_resample_matches_jax(ndim):
    rng = np.random.default_rng(20 + ndim)
    shape = (12, 14, 10)[-ndim:]
    out_shape = (9, 16, 11)[-ndim:]
    data = rng.random((3,) + shape).astype(np.float32) * 100
    data[1, 2:4] = np.nan
    mats = np.stack([np.eye(ndim) + rng.normal(0, 0.05, (ndim, ndim)) for _ in range(3)])
    mats[0] = np.eye(ndim)
    offs = rng.normal(0, 2, (3, ndim))
    offs[0] = np.round(offs[0])
    mats, offs = mats.astype(np.float32), offs.astype(np.float32)
    ref = jresample.affine_resample_batch(data, mats, offs, out_shape, order=1, cval=np.nan)
    got = tresample.affine_resample_batch(_t(data), _t(mats), _t(offs), out_shape)
    _assert_maps_close(got, ref)
    ref0 = jresample.affine_resample(data[2], mats[2], offs[2], out_shape, order=1, cval=0.0)
    got0 = tresample.affine_resample(_t(data[2]), _t(mats[2]), _t(offs[2]), out_shape, cval=0.0)
    _assert_maps_close(got0, ref0)
    ref_u = jresample.affine_resample(data[0].astype(np.uint16), mats[0], offs[0], out_shape)
    got_u = tresample.affine_resample(_t(data[0].astype(np.uint16)), _t(mats[0]), _t(offs[0]),
                                      out_shape)
    _assert_maps_close(got_u, ref_u)
    # nearest-neighbour resampling is ported too; other orders are refused, as
    # the reference refuses them
    ref_n = jresample.affine_resample_batch(data, mats, offs, out_shape, order=0, cval=np.nan)
    got_n = tresample.affine_resample_batch(_t(data), _t(mats), _t(offs), out_shape, order=0)
    _assert_maps_close(got_n, ref_n)
    with pytest.raises(NotImplementedError, match="order"):
        tresample.affine_resample_batch(_t(data), _t(mats), _t(offs), out_shape, order=2)


@pytest.mark.parametrize("ndim", [2, 3])
def test_separable_axis_aligned_resample_matches_jax(ndim):
    rng = np.random.default_rng(30 + ndim)
    shape = (10, 13, 11)[-ndim:]
    data = rng.random((4,) + shape).astype(np.float32)
    offsets = np.stack([
        rng.integers(-5, 6, ndim).astype(np.float32),
        (rng.integers(-8, 9, ndim) / 2).astype(np.float32),
        rng.uniform(-3, 3, ndim).astype(np.float32),
        np.zeros(ndim, np.float32),
    ])
    diag = np.ones(ndim, np.float32)
    for cval in (np.nan, 0.0):
        got = tresample.separable_axis_aligned_resample(_t(data), _t(diag), _t(offsets), shape,
                                                        cval=cval)
        for b in range(4):
            ref = jresample.separable_axis_aligned_resample(data[b], diag, offsets[b], shape,
                                                            cval=cval)
            _assert_maps_close(got[b], ref)
    scaled = np.array([1.5, 0.5, 2.0][-ndim:], np.float32)
    got = tresample.separable_axis_aligned_resample(_t(data[:1]), _t(scaled), _t(offsets[2]),
                                                    (7, 9, 6)[-ndim:])
    ref = jresample.separable_axis_aligned_resample(data[0], scaled, offsets[2], (7, 9, 6)[-ndim:])
    _assert_maps_close(got[0], ref)


@pytest.mark.parametrize("in_range,out_range", [
    (None, (0.0, 1.0)), (None, (-1.0, 3.5)), ((10.0, 60.0), (0.0, 1.0)),
    ((10.0, 60.0), (100.0, 200.0)), ((7.0, 7.0), (0.0, 1.0)), ((0.3, 0.1), (0.0, 255.0)),
])
def test_rescale_intensity_ranges_match_jax(in_range, out_range):
    """``in_range`` / ``out_range`` as the reference takes them (an empty
    input range divides by 1), NaN kept, on each item of a batch."""
    rng = np.random.default_rng(44)
    batch = (rng.random((3, 12, 10)) * 80).astype(np.float32)
    batch[1, 2:4, 3] = np.nan
    got = tpc.rescale_intensity(_t(batch), 2, in_range, out_range).numpy()
    for i in range(len(batch)):
        ref = np.asarray(jpc.rescale_intensity(jnp.asarray(batch[i]), in_range, out_range))
        np.testing.assert_array_equal(np.isnan(got[i]), np.isnan(ref))
        np.testing.assert_allclose(got[i], ref, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("ndim", [1, 2, 3])
@pytest.mark.parametrize("size", [3, 5, 7])
def test_uniform_filter_matches_jax(ndim, size):
    rng = np.random.default_rng(40 + ndim)
    data = rng.random((6, 9, 5)[-ndim:]).astype(np.float32)
    ref = jfilters.uniform_filter(data, size)
    np.testing.assert_allclose(tfilters.uniform_filter(_t(data), size).numpy(), ref, **MAP_TOL)
    batch = np.stack([data, data * 2])
    got = tfilters.uniform_filter(_t(batch), size, ndim)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(jfilters.uniform_filter(batch[1], size)),
                               **MAP_TOL)


@pytest.mark.parametrize("ndim", [2, 3])
def test_ssim_maps_and_box_means_match_jax(ndim):
    rng = np.random.default_rng(50 + ndim)
    shape = (12, 16, 14)[-ndim:]
    im0 = rng.random(shape).astype(np.float32)
    im1 = (im0 * 0.7 + rng.random(shape) * 0.3).astype(np.float32)
    lo = np.array([1, 2, 0][-ndim:], np.int32)
    hi = np.array([10, 13, 12][-ndim:], np.int32)
    for w in (3, 5, 7):
        ux, uxx = jim.ssim_fixed_maps(im0, w)
        tux, tuxx = tim.ssim_fixed_maps(_t(im0), w, ndim)
        np.testing.assert_allclose(tux.numpy(), ux, **MAP_TOL)
        np.testing.assert_allclose(tuxx.numpy(), uxx, **MAP_TOL)
        ref_map = jim.ssim_map_precomputed(im0, ux, uxx, im1, w, 1.0)
        got_map = tim.ssim_map_precomputed(_t(im0), tux, tuxx, _t(im1), w, 1.0, ndim)
        np.testing.assert_allclose(got_map.numpy(), ref_map, **MAP_TOL)
        ref = jim.ssim_mean_over_box_precomputed(im0, ux, uxx, im1, lo, hi, w, 1.0)
        got = tim.ssim_mean_over_box_precomputed(
            _t(im0)[None], tux[None], tuxx[None], _t(im1)[None], _t(lo)[None], _t(hi)[None], w,
            torch.ones(1), ndim,
        )
        np.testing.assert_allclose(got.numpy()[0], float(ref), **MAP_TOL)
    mask = im0 > 0.3
    mask[..., :2] = False
    ref = np.stack([np.asarray(x) for x in jim._bbox_bounds_from_mask(mask)])
    got = torch.stack(tim._bbox_bounds_from_mask(_t(mask)[None], ndim))[:, 0].numpy()
    np.testing.assert_array_equal(got, ref)


def test_masked_spearman_and_ncc_match_jax():
    rng = np.random.default_rng(60)
    a = rng.random((3, 9, 11)).astype(np.float32)
    b = (a + rng.random((3, 9, 11)) * 0.5).astype(np.float32)
    b[1] = np.round(b[1] * 4) / 4  # ties
    a[2, :, :3] = a[2, 0, 0]  # a run of ties
    mask = rng.random((3, 9, 11)) > 0.2
    got = tim.masked_spearman(_t(a), _t(b), _t(mask), 2).numpy()
    for i in range(3):
        ref = float(jim.masked_spearman(a[i], b[i], mask[i]))
        assert abs(got[i] - ref) <= QUALITY_ATOL
    none = tim.masked_spearman(_t(a[:1]), _t(b[:1]), torch.zeros(1, 9, 11, dtype=torch.bool), 2)
    assert np.isnan(none.numpy()[0])
    a[0, 0, :4] = np.nan
    for i in range(3):
        ref = float(jim.nan_aware_ncc(a[i], b[i]))
        got_i = float(tim.nan_aware_ncc(_t(a[i]), _t(b[i])))
        assert abs(got_i - ref) <= 1e-5


# ---------------------------------------------------------------------------
# the pairwise core
# ---------------------------------------------------------------------------


def _core_bucket(ndim):
    """A bucket of pairs: shifted crops, crops with NaN margins (as the
    overlap resample leaves them), a constant crop."""
    rng = np.random.default_rng(70 + ndim)
    shape = (24, 30) if ndim == 2 else (8, 20, 18)
    ims0, ims1 = _shifted_pairs(rng, ndim, 5, shape)
    ims0[2, ..., :3] = np.nan
    ims1[2, ..., -5:] = np.nan
    ims0[3, :2] = np.nan
    ims1[4] = 0.25  # constant
    return ims0, ims1


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("region_mode", [None, "union", "intersection"])
def test_pcc_register_core_batch_matches_jax(ndim, region_mode):
    ims0, ims1 = _core_bucket(ndim)
    uf = 10 if ndim == 2 else 2
    ref_t, ref_q = registration._pcc_register_core_batch(ims0, ims1, uf, region_mode)
    got_t, got_q = treg._pcc_register_core_batch(_t(ims0), _t(ims1), uf, region_mode)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(ref_t), atol=SHIFT_ATOL, rtol=0)
    np.testing.assert_allclose(got_q.numpy(), np.asarray(ref_q), atol=QUALITY_ATOL, rtol=0)


@pytest.mark.parametrize("ndim", [2, 3])
def test_resample_and_register_batch_matches_jax(ndim):
    """The overlap resample into the fixed grid of NaN-padded crops of two
    true shapes, then the core."""
    ims0, ims1 = _core_bucket(ndim)
    f, m = ims0[:3].copy(), ims1[:3].copy()
    f[1, -2:] = np.nan  # a shorter true crop in a padded bucket
    out_shape = tuple(s - 2 for s in f.shape[1:])
    eye = np.broadcast_to(np.eye(ndim, dtype=np.float32), (3, ndim, ndim)).copy()
    foffs = np.zeros((3, ndim), np.float32)
    moffs = np.full((3, ndim), 1.0, np.float32)
    uf = 10 if ndim == 2 else 2
    ref_t, ref_q = registration._resample_and_register_batch(
        f, m, eye, foffs, eye, moffs, out_shape, uf, None
    )
    got_t, got_q = treg._resample_and_register_batch(
        _t(f), _t(m), _t(eye), _t(foffs), _t(eye), _t(moffs), out_shape, uf
    )
    np.testing.assert_allclose(got_t.numpy(), np.asarray(ref_t), atol=SHIFT_ATOL, rtol=0)
    np.testing.assert_allclose(got_q.numpy(), np.asarray(ref_q), atol=QUALITY_ATOL, rtol=0)


def test_phase_correlation_registration_matches_jax():
    ims0, ims1 = _core_bucket(2)
    ref = registration.phase_correlation_registration(ims0[0], ims1[0])
    got = treg.phase_correlation_registration(ims0[0], ims1[0], device="cpu")
    np.testing.assert_allclose(got["affine_matrix"], ref["affine_matrix"], atol=SHIFT_ATOL)
    assert abs(got["quality"] - ref["quality"]) <= QUALITY_ATOL


@pytest.mark.parametrize("dtype", [np.uint16, np.uint8, np.int16])
def test_crops_from_resident_match_jax(dtype):
    rng = np.random.default_rng(80)
    tiles = rng.integers(0, 120, (3, 9, 12, 10)).astype(dtype)
    views = np.array([0, 2, 1, 2], np.int32)
    starts = np.array([[0, 3, 4], [5, 0, 0], [2, 6, 7], [8, 11, 9]], np.int32)
    shapes = np.array([[7, 9, 6], [4, 5, 10], [7, 6, 3], [1, 1, 1]], np.int32)
    bucket = (7, 9, 10)
    ref = np.asarray(registration._crops_from_resident(tiles, views, starts, shapes, bucket))
    got = treg._crops_from_resident(_t(tiles), views, starts, shapes, bucket).numpy()
    np.testing.assert_array_equal(got, ref)
    ref_c = np.asarray(registration._crop_const_flags(ref, ref[::-1]))
    np.testing.assert_array_equal(treg._crop_const_flags(_t(got), _t(got[::-1])).numpy(), ref_c)


def test_host_crop_upload_rebuilds_the_nan_pad():
    rng = np.random.default_rng(81)
    refs = []
    for shape in ((4, 5), (3, 6)):
        r = treg._CropRef(0, (0, 0), shape, None)
        r.arr = rng.integers(0, 4000, shape).astype(np.uint16)
        refs.append(r)
    got, nbytes = treg._host_crops_to_device(refs, (4, 6), torch.device("cpu"))
    assert nbytes == 2 * 4 * 6 * 2
    ref = np.full((2, 4, 6), np.nan, np.float32)
    for b, r in enumerate(refs):
        ref[b][tuple(slice(0, s) for s in r.shape)] = r.arr
    np.testing.assert_array_equal(got.numpy(), ref)
    refs[1].arr = refs[1].arr.astype(np.float32) + 0.5
    got, nbytes = treg._host_crops_to_device(refs, (4, 6), torch.device("cpu"))
    ref[1][:3, :6] += 0.5
    assert nbytes == 2 * 4 * 6 * 4
    np.testing.assert_array_equal(got.numpy(), ref)


# ---------------------------------------------------------------------------
# the view graph, held to networkx
# ---------------------------------------------------------------------------


def _grid_msims(ny, nx_, tile, step, jitter, seed):
    """2D grid of views whose diagonal neighbours overlap too; with
    ``jitter`` 0 every overlap of a kind ties."""
    rng = np.random.default_rng(seed)
    sims = []
    for iy in range(ny):
        for ix in range(nx_):
            off = rng.integers(-jitter, jitter + 1, 2) if jitter else np.zeros(2)
            sims.append(si_utils.get_sim_from_array(
                np.zeros((tile, tile), np.uint16), dims=["y", "x"],
                translation={"y": float(iy * step + off[0]), "x": float(ix * step + off[1])},
            ))
    return sims


@pytest.mark.parametrize("ny,nx_", [(2, 2), (3, 3), (4, 5)])
@pytest.mark.parametrize("jitter", [0, 2])
def test_adjacency_graph_and_pruning_match_networkx(ny, nx_, jitter):
    jsims = _grid_msims(ny, nx_, 20, 16, jitter, seed=ny * 10 + nx_)
    jmsims = [msi_utils.get_msim_from_sim(s, scale_factors=[]) for s in jsims]
    tmsims = [tmsi.get_msim_from_sim(s, scale_factors=[]) for s in _to_port(jsims)]
    for tol in (None, {"y": 1.0, "x": 1.0}):
        g = mv_graph.build_view_adjacency_graph_from_msims(jmsims, KEY, overlap_tolerance=tol)
        tg = tmv.build_view_adjacency_graph_from_msims(tmsims, KEY, overlap_tolerance=tol)
        assert list(tg.nodes) == list(g.nodes)
        assert list(tg.edges) == list(g.edges)
        assert tmv.get_edge_attributes(tg, "overlap") == nx.get_edge_attributes(g, "overlap")
        n_diag = sum(1 for u, v in g.edges if abs(u - v) not in (1, nx_))
        assert n_diag > 0
        pruned = mv_graph.prune_view_adjacency_graph(g, "alternating_pattern")
        tpruned = tmv.prune_view_adjacency_graph(tg, "alternating_pattern")
        assert list(tpruned.edges) == list(pruned.edges)
        for method in ("shortest_paths_overlap_weighted", "otsu_threshold_on_overlap"):
            ref = mv_graph.prune_view_adjacency_graph(g.copy(), method)
            got = tmv.prune_view_adjacency_graph(tg.copy(), method)
            assert sorted(got.edges) == sorted(ref.edges)


def test_graph_algorithms_match_networkx_on_random_graphs():
    """Betweenness (bit for bit), greedy colouring, components, copies,
    subgraph orders, in-place relabelling and Dijkstra paths on random
    graphs with tied weights."""
    rng = random.Random(0)
    for _ in range(60):
        n = rng.randint(2, 22)
        a, b = nx.Graph(), tmv.Graph()
        for i in range(n):
            a.add_node(i)
            b.add_node(i)
        for _ in range(rng.randint(1, 3 * n)):
            u, v = rng.sample(range(n), 2)
            w = float(rng.choice([1, 2, 2, 3, 5.5]))
            a.add_edge(u, v, overlap=w)
            b.add_edge(u, v, overlap=w)
        assert list(a.edges) == list(b.edges)
        assert list(nx.edge_betweenness_centrality(a).items()) == list(
            tmv.edge_betweenness_centrality(b).items()
        )
        assert nx.greedy_color(a) == tmv.greedy_color(b)
        assert nx.degree_centrality(a) == tmv.degree_centrality(b)
        assert list(a.copy().edges) == list(b.copy().edges)
        comps = list(nx.connected_components(a))
        assert comps == list(tmv.connected_components(b))
        for comp in comps:
            sa, sb = a.subgraph(list(comp)), b.subgraph(list(comp))
            assert list(sa.nodes) == list(sb.nodes) and list(sa.edges) == list(sb.edges)
            ra, rb = nx.Graph(), tmv.Graph()
            ra.add_nodes_from(sa.nodes)
            ra.add_edges_from(sa.edges)
            rb.add_nodes_from(sb.nodes)
            rb.add_edges_from(sb.edges)
            mapping = {x: i for i, x in enumerate(ra.nodes)}
            nx.relabel_nodes(ra, mapping, copy=False)
            tmv.relabel_nodes_inplace(rb, mapping)
            assert list(ra.nodes) == list(rb.nodes) and list(ra.edges) == list(rb.edges)
            src = min(comp)
            assert nx.single_source_dijkstra_path(a, src, weight="overlap") == (
                tmv.single_source_dijkstra_path(b, src, "overlap")
            )
            assert nx.has_path(a, src, max(comp)) == tmv.has_path(b, src, max(comp))


# ---------------------------------------------------------------------------
# groupwise resolution
# ---------------------------------------------------------------------------


def _reg_graphs(seed, n_side=3, bad_edge=True):
    """The same registration graph for networkx and the port: a grid of
    views, edges with noisy translations, qualities and overlap boxes, one
    edge far off (the optimiser must drop it)."""
    from multiview_stitcher_tpu import param_utils as jpu

    rng = np.random.default_rng(seed)
    truth = {
        i: rng.normal(0, 2, 2) for i in range(n_side * n_side)
    }
    g, tg = nx.Graph(), tmv.Graph()
    for i in range(n_side * n_side):
        sp = {"spacing": {"y": 0.5, "x": 0.5}, "shape": {"y": 20, "x": 20},
              "origin": {"y": 0.0, "x": 0.0}}
        g.add_node(i, stack_props=sp)
        tg.add_node(i, stack_props=sp)
    edges = []
    for iy in range(n_side):
        for ix in range(n_side):
            i = iy * n_side + ix
            if ix + 1 < n_side:
                edges.append((i, i + 1))
            if iy + 1 < n_side:
                edges.append((i, i + n_side))
            if ix + 1 < n_side and iy + 1 < n_side:
                edges.append((i, i + n_side + 1))
    for k, (u, v) in enumerate(edges):
        t = truth[u] - truth[v] + rng.normal(0, 0.05, 2)
        if bad_edge and k == 3:
            t = t + 7.0
        mat = np.eye(3)
        mat[:2, 2] = t
        lo = rng.uniform(0, 5, 2)
        attrs = dict(
            transform=tmv.param_utils.affine_to_xaffine(mat), quality=float(rng.uniform(0.5, 1)),
            bbox=np.array([lo, lo + rng.uniform(2, 6, 2)]), overlap=float(rng.uniform(1, 4)),
        )
        g.add_edge(u, v, **{**attrs, "transform": jpu.affine_to_xaffine(mat)})
        tg.add_edge(u, v, **attrs)
    return g, tg


@pytest.mark.parametrize("method", ["global_optimization", "shortest_paths"])
@pytest.mark.parametrize("bad_edge", [False, True])
def test_groupwise_resolution_matches_jax(method, bad_edge):
    g, tg = _reg_graphs(3, bad_edge=bad_edge)
    ref, ref_info = param_resolution.groupwise_resolution(g, method=method)
    got, got_info = tpr.groupwise_resolution(tg, method=method)
    assert sorted(got) == sorted(ref)
    for n in ref:
        np.testing.assert_allclose(got[n].data, ref[n].data, atol=PARAM_ATOL)
    assert got_info["used_edges"] == ref_info["used_edges"]
    for e, r in ref_info["edge_residuals"][0].items():
        assert abs(got_info["edge_residuals"][0][e] - r) <= 1e-6
    if method == "global_optimization":
        df = ref_info["metrics"]
        assert sorted(got_info["metrics"]) == sorted(df.columns)
        for col in df.columns:
            np.testing.assert_allclose(got_info["metrics"][col], df[col].to_numpy(), atol=1e-6)


@pytest.mark.parametrize("transform", ["rigid", "similarity", "affine"])
def test_global_optimization_of_other_transforms_matches_jax(transform):
    g, tg = _reg_graphs(6, bad_edge=True)
    ref, _ = param_resolution.groupwise_resolution(g, transform=transform)
    got, _ = tpr.groupwise_resolution(tg, transform=transform)
    for n in ref:
        np.testing.assert_allclose(got[n].data, ref[n].data, atol=PARAM_ATOL)


def test_groupwise_resolution_of_two_components_matches_jax():
    """Views 6 and 7 joined to each other only, view 8 to none."""
    from multiview_stitcher_tpu import param_utils as jpu

    g, tg = _reg_graphs(4, n_side=3, bad_edge=False)
    for gg in (g, tg):
        gg.remove_edges_from([(u, v) for u, v in list(gg.edges) if {6, 7, 8} & {u, v}])
    bbox = np.array([[0.0, 0.0], [2.0, 3.0]])
    mat = np.eye(3)
    mat[:2, 2] = (1.5, -0.5)

    g.add_edge(6, 7, transform=jpu.affine_to_xaffine(mat), quality=0.9, bbox=bbox, overlap=2.0)
    tg.add_edge(6, 7, transform=tmv.param_utils.affine_to_xaffine(mat), quality=0.9, bbox=bbox,
                overlap=2.0)
    ref, ref_info = param_resolution.groupwise_resolution(g)
    got, got_info = tpr.groupwise_resolution(tg)
    for n in ref:
        np.testing.assert_allclose(got[n].data, ref[n].data, atol=PARAM_ATOL)
    np.testing.assert_array_equal(got_info["metrics"]["icc"], ref_info["metrics"]["icc"].to_numpy())


def test_linear_two_pass_is_refused():
    """No longer refused: the port's linear two-pass resolution gives the
    JAX package's params on the same graph (within 1e-6)."""
    g, tg = _reg_graphs(5, bad_edge=False)
    ref, _ = param_resolution.groupwise_resolution(g, method="linear_two_pass")
    got, _ = tpr.groupwise_resolution(tg, method="linear_two_pass")
    for n in ref:
        np.testing.assert_allclose(got[n].data, ref[n].data, atol=1e-6)


# ---------------------------------------------------------------------------
# register()
# ---------------------------------------------------------------------------

_GRIDS = {
    2: dict(ndim=2, tiles_x=3, tiles_y=3, tile_size=30, overlap=6),
    3: dict(ndim=3, tiles_x=2, tiles_y=2, tiles_z=1, tile_size=20, overlap=8, zoom=3,
            shift_scale=3),
}


@pytest.fixture(scope="module")
def grids():
    out = {}
    for ndim, kw in _GRIDS.items():
        sims = sample_data.generate_tiled_dataset(N_c=1, N_t=1, **kw)
        out[ndim] = [s.isel({"c": 0, "t": 0}) for s in sims]
    return out


@pytest.fixture(scope="module")
def jax_register(grids):
    """The JAX package's register() results, computed once per case."""
    cache = {}

    def get(ndim, prune, method, device_tiles):
        key = (ndim, prune, method, device_tiles)
        if key not in cache:
            cache[key] = registration.register(
                grids[ndim], transform_key=KEY, pre_registration_pruning_method=prune,
                groupwise_resolution_method=method, device_tiles=device_tiles,
            )
        return cache[key]

    return get


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("prune", [None, "alternating_pattern"])
@pytest.mark.parametrize("method", ["global_optimization", "shortest_paths"])
@pytest.mark.parametrize("device_tiles", [False, True])
def test_register_matches_jax(grids, jax_register, ndim, prune, method, device_tiles):
    ref = jax_register(ndim, prune, method, device_tiles)
    sims = _to_port(grids[ndim])
    got = treg.register(
        sims, transform_key=KEY, pre_registration_pruning_method=prune,
        groupwise_resolution_method=method, device_tiles=device_tiles, device="cpu",
    )
    assert treg.last_telemetry["device_tiles"] is device_tiles
    assert len(got) == len(ref)
    for p, r in zip(got, ref):
        np.testing.assert_allclose(p.data, r.data, atol=PARAM_ATOL, rtol=0)
    # the grid is not registered to identity: the test sees real shifts
    assert max(np.abs(np.asarray(r.data)[:-1, -1]).max() for r in ref) > 0.1


def _rotated(sims, degrees):
    """The sims with their metadata affine turned by ``degrees`` about the
    grid's centre (overlaps are then halfspace intersections)."""
    th = np.deg2rad(degrees)
    rot = np.array([[np.cos(th), -np.sin(th), 0.0], [np.sin(th), np.cos(th), 0.0], [0, 0, 1]])
    centre = np.eye(3)
    centre[:2, 2] = 20.0
    mat = centre @ rot @ np.linalg.inv(centre)
    out = []
    for s in sims:
        s = s.copy()
        si_utils.set_sim_affine(s, mat, transform_key=KEY)
        out.append(s)
    return out


@pytest.mark.parametrize("case", ["rotated", "binned", "tolerance"])
def test_register_options_match_jax(grids, case):
    """Rotated views (halfspace overlaps, affine crop resamples), binning
    (host crops of binned views) and an overlap tolerance (NaN margins)."""
    sims = grids[2]
    kw = dict(transform_key=KEY)
    if case == "rotated":
        sims = _rotated(sims, 2.0)
    elif case == "binned":
        kw["registration_binning"] = {"y": 2, "x": 2}
    else:
        kw["overlap_tolerance"] = {"y": 1.5, "x": 1.5}
    ref = registration.register(sims, **kw)
    got = treg.register(_to_port(sims), device="cpu", **kw)
    for p, r in zip(got, ref):
        np.testing.assert_allclose(p.data, r.data, atol=PARAM_ATOL, rtol=0)
    if case == "binned":
        assert treg.last_telemetry["device_tiles"] is False


def test_register_return_dict_and_new_transform_key(grids, jax_register):
    ref = jax_register(2, "alternating_pattern", "global_optimization", False)
    msims = [tmsi.get_msim_from_sim(s, scale_factors=[]) for s in _to_port(grids[2])]
    out = treg.register(msims, transform_key=KEY, new_transform_key="registered",
                        return_dict=True, device="cpu")
    g = out["pairwise_registration"]["graph"]
    assert isinstance(g, tmv.Graph)
    assert set(out["pairwise_registration"]["metrics"]["qualities"]) == set(g.edges)
    metrics = out["groupwise_resolution"]["metrics"]["metrics"]
    assert set(metrics) == {"mean_residual", "max_residual", "iteration", "icc"}
    for m, p, r in zip(msims, out["params"], ref):
        np.testing.assert_allclose(p.data, r.data, atol=PARAM_ATOL)
        base = m.transforms[KEY].data
        np.testing.assert_allclose(m.transforms["registered"].data, p.data @ base)


def test_register_reduces_a_singleton_z_to_2d(grids, jax_register):
    """3D views one plane deep register as 2D and come back 3D."""
    ref2 = jax_register(2, "alternating_pattern", "global_optimization", False)
    jsims = []
    for s in grids[2]:
        sim = si_utils.get_sim_from_array(
            np.asarray(s.data)[None], dims=["z", "y", "x"],
            translation={"z": 0.0, **s.origin}, scale={"z": 1.0, **s.spacing},
        )
        jsims.append(sim)
    ref = registration.register(jsims, transform_key=KEY)
    got = treg.register(_to_port(jsims), transform_key=KEY, device="cpu")
    for p, r, r2 in zip(got, ref, ref2):
        np.testing.assert_allclose(p.data, r.data, atol=PARAM_ATOL)
        np.testing.assert_allclose(np.asarray(p.data)[1:, 1:], r2.data, atol=PARAM_ATOL)


def test_register_picks_the_channel_as_jax_does():
    sims = sample_data.generate_tiled_dataset(ndim=2, N_c=2, N_t=1, tiles_x=2, tiles_y=2,
                                              tile_size=30, overlap=6)
    sims = [s.isel({"t": 0}) for s in sims]
    ref = registration.register(sims, transform_key=KEY, reg_channel_index=1)
    got = treg.register(_to_port(sims), transform_key=KEY, reg_channel_index=1, device="cpu")
    for p, r in zip(got, ref):
        np.testing.assert_allclose(p.data, r.data, atol=PARAM_ATOL)
    with pytest.raises(ValueError, match="channel"):
        treg.register(_to_port(sims), transform_key=KEY, device="cpu")


def test_register_without_device_needs_cuda(grids):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: register() runs there by default")
    with pytest.raises(RuntimeError, match="CUDA"):
        treg.register(_to_port(grids[2]), transform_key=KEY)


def test_register_refuses_what_the_slice_does_not_cover(grids):
    sims = _to_port(grids[2])
    kw = dict(transform_key=KEY, device="cpu")
    # what item 27 covered is no longer refused: plot_summary draws the
    # summary figures and returns them
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plotted = treg.register(sims, **kw, plot_summary=True, return_dict=True)
    assert plotted["pairwise_registration"]["summary_plot"][0] is not None
    assert plotted["groupwise_resolution"]["summary_plot"] == (None, None)
    plt.close("all")
    default = treg.register(sims, **kw)
    # what item 12 covered is no longer refused: a mesh is a
    # parallel.mesh.Mesh (anything else raises TypeError), and a CPU mesh
    # registers as the unsharded call does
    with pytest.raises(TypeError, match="Mesh"):
        treg.register(sims, **kw, mesh=object())
    meshed = treg.register(sims, transform_key=KEY, mesh=Mesh([torch.device("cpu")] * 3))
    for p, r in zip(meshed, default):
        np.testing.assert_allclose(p.data, r.data, atol=1e-8)
    # what item 8's rest covered is no longer refused: the per-pair path, an
    # executor and the linear two-pass resolution run
    for extra in (
        dict(pairwise_reg_func_kwargs={"use_fused_core": False}),
        dict(pairwise_executor=lambda m, edges, k: [
            treg.register_pair_of_msims(m[i], m[j], **k) for i, j in edges
        ]),
    ):
        for p, r in zip(treg.register(sims, **kw, **extra), default):
            np.testing.assert_allclose(p.data, r.data, atol=PARAM_ATOL)
    linear = treg.register(sims, groupwise_resolution_method="linear_two_pass", **kw)
    assert all(np.isfinite(p.data).all() for p in linear)
    # what items 16 and 23 covered is no longer refused: a resolution level
    # (of a one-level msim, level 0 alone), a t dim, the default pyramid
    level0 = treg.register(sims, reg_res_level=0, **kw)
    for p, r in zip(level0, treg.register(sims, **kw)):
        np.testing.assert_array_equal(p.data, r.data)
    with pytest.raises(ValueError, match="does not exist"):
        treg.register(sims, reg_res_level=1, **kw)
    tsims = sample_data.generate_tiled_dataset(ndim=2, N_c=1, N_t=2, tiles_x=2, tiles_y=1,
                                               tile_size=20, overlap=6)
    over_t = treg.register([s.isel({"c": 0}) for s in _to_port(tsims)], **kw)
    assert all(p.has_t and list(p.t_coords) == [0, 1] for p in over_t)
    assert len(tmsi.get_msim_from_sim(sims[0]).sims) == 1


def test_global_optimization_matches_jax_on_a_large_grid():
    """An exact 32 x 32 registration graph (translations of whole pixels):
    the global optimisation gives the JAX package's params bit for bit
    (it stops before it converges there, in both); shortest paths resolve
    the offsets exactly."""
    from multiview_stitcher_tpu import param_utils as jpu

    n = 32
    rng = np.random.default_rng(0)
    pert = np.stack([rng.integers(-1, 2, n * n), rng.integers(-3, 4, n * n),
                     rng.integers(-3, 4, n * n)], 1).astype(float)
    sp = {"spacing": {"z": 1.0, "y": 1.0, "x": 1.0}, "shape": {"z": 64, "y": 64, "x": 64},
          "origin": {"z": 0.0, "y": 0.0, "x": 0.0}}
    g, tg = nx.Graph(), tmv.Graph()
    for i in range(n * n):
        g.add_node(i, stack_props=sp)
        tg.add_node(i, stack_props=sp)
    for iy in range(n):
        for ix in range(n):
            i = iy * n + ix
            for j in ([i + 1] if ix + 1 < n else []) + ([i + n] if iy + 1 < n else []):
                m = np.eye(4)
                m[:3, 3] = pert[j] - pert[i]
                lo = np.array([0.0, iy * 52 + 52 * (j == i + n), ix * 52 + 52 * (j == i + 1)])
                attrs = dict(quality=0.98, bbox=np.array([lo, lo + [64, 12, 12]]), overlap=1.0)
                g.add_edge(i, j, transform=jpu.affine_to_xaffine(m), **attrs)
                tg.add_edge(i, j, transform=tmv.param_utils.affine_to_xaffine(m), **attrs)
    ref, _ = param_resolution.groupwise_resolution(g)
    got, _ = tpr.groupwise_resolution(tg)
    for k in range(n * n):
        np.testing.assert_array_equal(got[k].data, ref[k].data)
    sp_params, _ = tpr.groupwise_resolution(tg, method="shortest_paths")
    reg = np.array([np.asarray(sp_params[k].data)[:3, 3] for k in range(n * n)]) + pert
    np.testing.assert_allclose(reg - reg.mean(axis=0), 0.0, atol=1e-9)
