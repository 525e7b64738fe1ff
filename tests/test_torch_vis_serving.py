"""Virtual OME-Zarr stores, neuroglancer state and the figures of the port,
held to the JAX package on the CPU.

Every case of ``tests/test_vis_and_serving.py`` runs here on the same seeded
inputs through both packages: the virtual stores give the same bytes for
every key (metadata documents and chunks, edge chunks padded, out-of-range
and malformed keys), the served stores read back over HTTP through the
port's ``zarr_backend.open_zarr_array(url)``, the neuroglancer states are
equal as dicts (floats within 1e-12) and their URLs equal, the figures
(matplotlib's ``Agg`` backend) carry the same data (lines, colours, texts,
points, images), and the refusals raise the same exception types. Besides:
a sim over a tensor (``fuse(..., output_on_backend=True)`` on the CPU)
serves the same bytes as the same sim over numpy; a multiscale msim serves
every level; a chunk whose read fails is a 500, never zeros.
"""

from __future__ import annotations

import copy
import json
import socket
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from multiview_stitcher_torch import convert  # noqa: E402
from multiview_stitcher_torch import fusion as tfusion  # noqa: E402
from multiview_stitcher_torch import msi_utils as tmsi  # noqa: E402
from multiview_stitcher_torch import neuroglancer as tng  # noqa: E402
from multiview_stitcher_torch import registration as treg  # noqa: E402
from multiview_stitcher_torch import si_utils as tsi  # noqa: E402
from multiview_stitcher_torch import vis_utils as tvis  # noqa: E402
from multiview_stitcher_torch.io import ngff_utils as tngff  # noqa: E402
from multiview_stitcher_torch.io import virtual_ngff as tvn  # noqa: E402
from multiview_stitcher_torch.io import zarr_backend as tzb  # noqa: E402
from multiview_stitcher_tpu import msi_utils as jmsi  # noqa: E402
from multiview_stitcher_tpu import neuroglancer as jng  # noqa: E402
from multiview_stitcher_tpu import registration as jreg  # noqa: E402
from multiview_stitcher_tpu import sample_data as jsd  # noqa: E402
from multiview_stitcher_tpu import si_utils as jsi  # noqa: E402
from multiview_stitcher_tpu import vis_utils as jvis  # noqa: E402
from multiview_stitcher_tpu.io import ngff_utils as jngff  # noqa: E402
from multiview_stitcher_tpu.io import virtual_ngff as jvn  # noqa: E402

KEY = jsi.DEFAULT_TRANSFORM_KEY
# registration parameters of the two packages agree within this (px)
PARAM_ATOL = 1e-3
# figure colours drawn from a colormap of a registration quality: qualities
# within PARAM_ATOL land within this of each other in RGBA
COLOR_ATOL = 2e-2


def _port(jsim):
    """The port's sim of a JAX sim: the same data, metadata and attrs."""
    sim = convert.sim_from_numpy(
        np.asarray(jsim.data), jsim.dims, jsim.spacing, jsim.origin,
        {k: v.data for k, v in jsim.transforms.items()}, coords=jsim.coords,
    )
    sim.attrs = copy.deepcopy(jsim.attrs)
    return sim


def _both(data, **kw):
    """The same image as a JAX sim and a port sim."""
    return jsi.get_sim_from_array(data, **kw), tsi.get_sim_from_array(data, **kw)


def _grid():
    return jsd.generate_tiled_dataset(
        ndim=2, N_c=1, N_t=1, tile_size=40, tiles_x=2, tiles_y=2,
        overlap=8, zoom=4, shift_scale=1.0, drift_scale=0.0,
    )


def _grid_msims():
    sims = _grid()
    return ([jmsi.get_msim_from_sim(s, scale_factors=[]) for s in sims],
            [tmsi.get_msim_from_sim(_port(s), scale_factors=[]) for s in sims])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _store_keys(store) -> list:
    """Every key of a virtual store: its metadata documents, every chunk of
    every level, an out-of-range chunk and malformed keys."""
    keys = [".zattrs", ".zgroup", "", "x", "a/b/c", "x/.zarray", f"{len(store.msim.sims)}/.zarray"]
    for level in range(len(store.msim.sims)):
        meta = json.loads(store.get(f"{level}/.zarray"))
        grid = [-(-s // c) for s, c in zip(meta["shape"], meta["chunks"])]
        keys += [f"{level}/.zarray", f"{level}/.zattrs", f"{level}/0", f"{level}/a.b",
                 f"{level}/" + ".".join(str(g) for g in grid)]
        keys += [f"{level}/" + ".".join(map(str, i)) for i in np.ndindex(*grid)]
    return keys


def assert_stores_equal(tstore, jstore):
    keys = _store_keys(jstore)
    assert keys == _store_keys(tstore)
    for key in keys:
        assert tstore.get(key) == jstore.get(key), key
    return keys


def assert_json_close(got, ref, path="", atol=1e-12):
    """Two JSON-like values equal, floats within ``atol``."""
    if isinstance(ref, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(ref), (path, got, ref)
        for k in ref:
            assert_json_close(got[k], ref[k], f"{path}/{k}", atol)
    elif isinstance(ref, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(ref), (path, got, ref)
        for i, (g, r) in enumerate(zip(got, ref)):
            assert_json_close(g, r, f"{path}/{i}", atol)
    elif isinstance(ref, float) and not isinstance(ref, bool):
        assert abs(float(got) - ref) <= atol, (path, got, ref)
    else:
        assert got == ref, (path, got, ref)


def _axes_data(ax) -> dict:
    """What an axes draws: its lines (data, colour, style, width), texts,
    scatter points, images, labels and title."""
    lines = []
    for ln in ax.get_lines():
        data = [np.asarray(d, float) for d in ln.get_data_3d()] if hasattr(
            ln, "get_data_3d") else [np.asarray(d, float) for d in ln.get_data()]
        lines.append((data, np.asarray(matplotlib.colors.to_rgba(ln.get_color())),
                      ln.get_linestyle(), ln.get_linewidth()))
    texts = [(np.asarray(t.get_position(), float), t.get_text()) for t in ax.texts]
    points = [np.asarray(c.get_offsets(), float) for c in ax.collections]
    images = [np.asarray(im.get_array()) for im in ax.images]
    return {"lines": lines, "texts": texts, "points": points, "images": images,
            "labels": (ax.get_xlabel(), ax.get_ylabel(), ax.get_title())}


def assert_axes_equal(tax, jax_, coord_atol=1e-9, color_atol=0.0):
    got, ref = _axes_data(tax), _axes_data(jax_)
    assert got["labels"] == ref["labels"]
    assert len(got["lines"]) == len(ref["lines"])
    for (gd, gc, gs, gw), (rd, rc, rs, rw) in zip(got["lines"], ref["lines"]):
        for a, b in zip(gd, rd):
            np.testing.assert_allclose(a, b, atol=coord_atol)
        np.testing.assert_allclose(gc, rc, atol=color_atol)
        assert (gs, gw) == (rs, rw)
    assert [t for _, t in got["texts"]] == [t for _, t in ref["texts"]]
    for (gp, _), (rp, _) in zip(got["texts"], ref["texts"]):
        np.testing.assert_allclose(gp, rp, atol=coord_atol)
    assert len(got["points"]) == len(ref["points"])
    for a, b in zip(got["points"], ref["points"]):
        np.testing.assert_allclose(a, b, atol=coord_atol)
    assert len(got["images"]) == len(ref["images"])
    for a, b in zip(got["images"], ref["images"]):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def registered():
    """One registration of the 2 x 2 grid with plot_summary, in each
    package (the JAX side compiles its phase correlation once here)."""
    jm, tm = _grid_msims()
    kw = dict(transform_key=KEY, new_transform_key="registered", reg_channel_index=0,
              pre_registration_pruning_method=None, plot_summary=True, return_dict=True)
    ref = jreg.register(jm, **kw)
    got = treg.register(tm, device="cpu", **kw)
    yield jm, tm, ref, got
    plt.close("all")


# ---------------------------------------------------------------------------
# figures
# ---------------------------------------------------------------------------


def test_plot_positions_2d_matches_jax(tmp_path):
    jm, tm = _grid_msims()
    figs = []
    for vis, msims, name in ((jvis, jm, "j.png"), (tvis, tm, "t.png")):
        figs.append(vis.plot_positions(
            msims, transform_key=KEY, show_plot=False,
            output_filename=str(tmp_path / name)))
        assert (tmp_path / name).exists()
    (jfig, jax_), (tfig, tax) = figs
    # positional colours: overlapping tiles differ, as in JAX
    assert_axes_equal(tax, jax_)
    plt.close(jfig)
    plt.close(tfig)


def test_plot_positions_with_edges_matches_jax():
    jm, tm = _grid_msims()
    kw = dict(transform_key=KEY, edges=[(0, 1), (2, 3)], edge_color_vals=[0.5, 0.9],
              use_positional_colors=False, show_plot=False,
              edge_linestyle_labels={"--": "dashed"})
    jfig, jax_ = jvis.plot_positions(jm, **kw)
    tfig, tax = tvis.plot_positions(tm, **kw)
    assert_axes_equal(tax, jax_)
    assert [t.get_text() for t in tax.get_legend().get_texts()] == ["dashed"]
    plt.close(jfig)
    plt.close(tfig)


def test_register_plot_summary_matches_jax(registered):
    jm, tm, ref, got = registered
    for p, r in zip(got["params"], ref["params"]):
        np.testing.assert_allclose(p.data, r.data, atol=PARAM_ATOL)
    tfig, tax = got["pairwise_registration"]["summary_plot"]
    jfig, jax_ = ref["pairwise_registration"]["summary_plot"]
    assert tfig is not None and tax is not None
    # the edges' qualities colour the lines: the same edges, colours within
    # what the qualities' difference allows
    assert_axes_equal(tax, jax_, coord_atol=PARAM_ATOL, color_atol=COLOR_ATOL)
    tq = treg.mv_graph.get_edge_attributes(got["pairwise_registration"]["graph"], "quality")
    jq = {(u, v): d["quality"] for u, v, d in ref["pairwise_registration"]["graph"].edges(data=True)}
    assert sorted(tq) == sorted(jq)
    for e, q in jq.items():
        np.testing.assert_allclose(tq[e], q, atol=PARAM_ATOL)
    # the residual figure: under the new key, used edges solid; its colours
    # spread the residuals' own range, so the residuals are held instead
    tfig_r, tax_r = got["groupwise_resolution"]["summary_plot"]
    jfig_r, jax_r = ref["groupwise_resolution"]["summary_plot"]
    assert_axes_equal(tax_r, jax_r, coord_atol=PARAM_ATOL, color_atol=1.0)
    tres = got["groupwise_resolution"]["metrics"]["edge_residuals"][0]
    jres = ref["groupwise_resolution"]["metrics"]["edge_residuals"][0]
    assert sorted(tres) == sorted(jres)
    for e in jres:
        np.testing.assert_allclose(tres[e], jres[e], atol=PARAM_ATOL)


def test_plot_registration_summaries_matches_jax(registered):
    """The summary figures drawn again from the same graph and resolution
    metrics in both packages: the same lines and colours."""
    jm, tm, ref, got = registered
    g = ref["pairwise_registration"]["graph"]
    tg = treg.mv_graph.Graph()
    tg.add_nodes_from(g.nodes())
    tg.add_edges_from((u, v, {"quality": d["quality"]}) for u, v, d in g.edges(data=True))
    info = ref["groupwise_resolution"]["metrics"]
    jout = jvis.plot_registration_summaries(jm, KEY, "registered", g, info, show_plot=False)
    tout = tvis.plot_registration_summaries(tm, KEY, "registered", tg, info, show_plot=False)
    for k in ("ax_pair_reg", "ax_group_res"):
        assert_axes_equal(tout[k], jout[k], coord_atol=PARAM_ATOL)
    plt.close("all")


def test_imshow_matches_jax():
    data = np.random.default_rng(0).random((3, 20, 30)).astype(np.float32)
    js, ts = _both(data, dims=("z", "y", "x"))
    assert_axes_equal(tvis.imshow(ts), jvis.imshow(js))
    # a sim over a tensor is downloaded for its pixels
    ts_t = ts.copy(data=torch.from_numpy(data))
    assert_axes_equal(tvis.imshow(ts_t), jvis.imshow(js))
    plt.close("all")


def _points_sims():
    js, ts = _both(np.zeros((6, 30, 20), np.float32), dims=("z", "y", "x"),
                   scale={"z": 2.0, "y": 1.0, "x": 1.0},
                   translation={"z": 0.0, "y": 5.0, "x": 3.0})
    pts = np.array([[4.0, 10.0, 7.0], [8.0, 20.0, 12.0]])
    jsi.set_point_set(js, pts, points_key="beads")
    tsi.set_point_set(ts, pts, points_key="beads")
    return js, ts


def test_imshow_projection_axes_and_points_match_jax():
    js, ts = _points_sims()
    tax = tvis.imshow(ts, points_key="beads")
    assert_axes_equal(tax, jvis.imshow(js, points_key="beads"))
    np.testing.assert_allclose(np.asarray(tax.collections[0].get_offsets()), [[7, 10], [12, 20]])
    tax = tvis.imshow(ts, project_dim="y", vertical_dim="z")
    assert_axes_equal(tax, jvis.imshow(js, project_dim="y", vertical_dim="z"))
    assert tax.images[0].get_array().shape == (6, 20)
    assert tvis.plot_msim_with_points is not None
    assert_axes_equal(tvis.plot_msim_with_points(ts, points_key="beads"),
                      jvis.plot_msim_with_points(js, points_key="beads"))
    plt.close("all")
    for kw, match in ((dict(project_dim="q"), "must be one of"),
                      (dict(project_dim="z", vertical_dim="z"), "differ from")):
        with pytest.raises(ValueError, match=match):
            jvis.imshow(js, **kw)
        with pytest.raises(ValueError, match=match):
            tvis.imshow(ts, **kw)


def test_imshow_rejects_duplicate_display_axes_as_jax():
    js, ts = _both(np.zeros((4, 10, 12), np.float32), dims=("z", "y", "x"))
    for vis, sim in ((jvis, js), (tvis, ts)):
        with pytest.raises(ValueError, match="must differ"):
            vis.imshow(sim, horizontal_dim="x", vertical_dim="x")


def test_imshow_slice_with_points_tolerance_matches_jax():
    data = np.zeros((6, 30, 20), np.float32)
    data[2] = 7.0
    js, ts = _both(data, dims=("z", "y", "x"), scale={"z": 2.0, "y": 1.0, "x": 1.0})
    pts = np.array([[4.0, 10.0, 7.0], [12.0, 20.0, 12.0]])
    jsi.set_point_set(js, pts, points_key="beads")
    tsi.set_point_set(ts, pts, points_key="beads")
    kw = dict(nscoord={"z": 4.5}, points_key="beads", points_tolerance=1.0)
    tax = tvis.imshow(ts, **kw)
    assert_axes_equal(tax, jvis.imshow(js, **kw))
    assert np.asarray(tax.images[0].get_array()).max() == 7.0
    np.testing.assert_allclose(np.asarray(tax.collections[0].get_offsets()), [[7.0, 10.0]])
    plt.close("all")
    for vis, sim in ((jvis, js), (tvis, ts)):
        with pytest.raises(ValueError, match=">= 0"):
            vis.imshow(sim, points_tolerance=-1)


def test_plot_tile_pair_image_metrics_and_stack_props_match_jax():
    result = {"pairs": {(0, 1): {"a": {"ncc": 0.5}, "b": {"ncc": 0.7}},
                        (1, 2): {"a": {"ncc": 0.9}, "b": {}}}}
    tax = tvis.plot_tile_pair_image_metrics(result)
    jax_ = jvis.plot_tile_pair_image_metrics(result)
    heights = [[p.get_height() for p in ax.patches] for ax in (tax, jax_)]
    np.testing.assert_array_equal(*heights)
    assert [t.get_text() for t in tax.get_xticklabels()] == [
        t.get_text() for t in jax_.get_xticklabels()]
    props = {"spacing": {"y": 0.5, "x": 2.0}, "origin": {"y": 1.0, "x": -3.0},
             "shape": {"y": 10, "x": 7}, "transform": np.array(
                 [[0.9, -0.1, 2.0], [0.1, 0.9, 1.0], [0.0, 0.0, 1.0]])}
    _, (a1, a2) = plt.subplots(1, 2)
    assert_axes_equal(tvis.plot_stack_props(props, a1, color="red"),
                      jvis.plot_stack_props(props, a2, color="red"))
    plt.close("all")


# ---------------------------------------------------------------------------
# neuroglancer
# ---------------------------------------------------------------------------


def _ng_sims(shape=(2, 32, 32), **kw):
    pairs = [_both(np.zeros(shape, dtype=np.uint16), **kw) for _ in range(2)]
    return [p[0] for p in pairs], [p[1] for p in pairs]


def test_neuroglancer_json_and_url_match_jax():
    jsims, tsims = _ng_sims(dims=("c", "y", "x"))
    shift = np.array([[1, 0, 5.0], [0, 1, -3.0], [0, 0, 1]])
    for si, sims in ((jsi, jsims), (tsi, tsims)):
        si.set_sim_affine(sims[1], shift, transform_key="registered")
        si.set_sim_affine(sims[0], np.eye(3), transform_key="registered")
    args = (None, ["http://localhost/0", "http://localhost/1"])
    ref = jng.generate_neuroglancer_json(*args, sims=jsims, transform_key="registered")
    got = tng.generate_neuroglancer_json(*args, sims=tsims, transform_key="registered")
    assert_json_close(got, ref)
    assert got["layout"] == "xy" and len(got["layers"]) == 2
    assert tng.get_neuroglancer_url(got) == jng.get_neuroglancer_url(ref)
    assert tng.get_neuroglancer_url(got, "http://ng") == jng.get_neuroglancer_url(ref, "http://ng")


def test_neuroglancer_channel_coord_and_single_layer_match_jax():
    jsims, tsims = _ng_sims((3, 16, 16), dims=("c", "y", "x"), c_coords=["dapi", "gfp", "tritc"])
    for si, sims in ((jsi, jsims), (tsi, tsims)):
        for s in sims:
            si.set_sim_affine(s, np.eye(3), transform_key="registered")
    urls = ["http://localhost/0", "http://localhost/1"]
    for kw in (dict(channel_coord="gfp"), dict(channel_coord="tritc", single_layer=True),
               dict(contrast_limits=(0, 100), layer_dicts=[{"opacity": 0.5}],
                    global_dict={"showSlices": False}, layout="4panel")):
        ref = jng.generate_neuroglancer_json(None, urls, sims=jsims, transform_key="registered",
                                             **kw)
        got = tng.generate_neuroglancer_json(None, urls, sims=tsims, transform_key="registered",
                                             **kw)
        assert_json_close(got, ref)
    for ng, sims in ((jng, jsims), (tng, tsims)):
        with pytest.raises(ValueError, match="not found"):
            ng.generate_neuroglancer_json(None, urls, sims=sims, transform_key="registered",
                                          channel_coord="nope")


def test_neuroglancer_positional_colors_match_jax():
    jsims = jsd.generate_tiled_dataset(
        ndim=2, N_c=1, N_t=1, tile_size=32, tiles_x=2, tiles_y=1,
        overlap=8, zoom=4, shift_scale=0.0, drift_scale=0.0,
    )
    tsims = [_port(s) for s in jsims]
    urls = [f"http://localhost/{i}" for i in range(len(jsims))]
    ref = jng.generate_neuroglancer_json(None, urls, sims=jsims, transform_key=KEY,
                                         use_positional_colors=True)
    got = tng.generate_neuroglancer_json(None, urls, sims=tsims, transform_key=KEY,
                                         use_positional_colors=True)
    assert_json_close(got, ref)
    assert got["layers"][0]["shader"] != got["layers"][1]["shader"]
    for ng, sims in ((jng, jsims), (tng, tsims)):
        with pytest.raises(ValueError, match="transform_key"):
            ng.generate_neuroglancer_json(None, ["u0"], sims=sims[:1],
                                          use_positional_colors=True)


def test_neuroglancer_positional_colors_rejects_single_layer_as_jax():
    for si, ng in ((jsi, jng), (tsi, tng)):
        sims = [si.get_sim_from_array(np.zeros((8, 8), np.uint16),
                                      translation={"y": 0.0, "x": 6.0 * i}) for i in range(2)]
        for s in sims:
            si.set_sim_affine(s, np.eye(3), transform_key="affine")
        with pytest.raises(ValueError, match="single merged layer"):
            ng.generate_neuroglancer_json(
                ome_zarr_paths=None, ome_zarr_urls=["http://h/0.zarr", "http://h/1.zarr"],
                sims=sims, transform_key="affine", use_positional_colors=True,
                single_layer=True)


def test_neuroglancer_corrects_spacing_origin_mismatch_as_jax(tmp_path):
    spacing_zarr = {"y": 0.5, "x": 0.5}
    js_disk, ts_disk = _both(np.zeros((16, 16), np.uint16), dims=("y", "x"), scale=spacing_zarr)
    jpath, tpath = str(tmp_path / "j.ome.zarr"), str(tmp_path / "t.ome.zarr")
    jngff.write_sim_to_ome_zarr(js_disk, jpath)
    tngff.write_sim_to_ome_zarr(ts_disk, tpath)
    theta = np.deg2rad(15)
    mem_affine = np.eye(3)
    mem_affine[:2, :2] = [[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]]
    mem_affine[:2, 2] = [3.0, -2.0]
    js, ts = _both(np.zeros((16, 16), np.uint16), dims=("y", "x"),
                   scale={"y": 1.0, "x": 2.0}, translation={"y": 10.0, "x": -5.0})
    jsi.set_sim_affine(js, mem_affine, transform_key="registered")
    tsi.set_sim_affine(ts, mem_affine, transform_key="registered")
    ref = jng.generate_neuroglancer_json([jpath], ["http://h/m.ome.zarr"], sims=[js],
                                         transform_key="registered")
    got = tng.generate_neuroglancer_json([tpath], ["http://h/m.ome.zarr"], sims=[ts],
                                         transform_key="registered")
    assert_json_close(got, ref)
    # without sims, the stores are read back in both packages
    ref = jng.generate_neuroglancer_json([jpath], ["http://h/m.ome.zarr"])
    got = tng.generate_neuroglancer_json([tpath], ["http://h/m.ome.zarr"])
    assert_json_close(got, ref)


def test_neuroglancer_state_declares_time_scale_as_jax():
    for tf in (None, {"scale": 2.5, "unit": "second"},
               {"scale": 100.0, "unit": "millisecond"}):
        js, ts = _both(np.zeros((2, 8, 8), np.uint16), dims=["t", "y", "x"])
        if tf is not None:
            jngff.set_ngff_time_transform(js, tf)
            tngff.set_ngff_time_transform(ts, tf)
        args = (None, ["http://x/0.ome.zarr"])
        ref = jng.generate_neuroglancer_json(*args, sims=[js], transform_key=KEY)
        got = tng.generate_neuroglancer_json(*args, sims=[ts], transform_key=KEY)
        assert_json_close(got, ref)
    assert got["dimensions"]["t"] == [0.1, "s"]


# ---------------------------------------------------------------------------
# virtual stores
# ---------------------------------------------------------------------------


def test_virtual_store_keys_match_jax():
    js, ts = _both(np.arange(64, dtype=np.uint16).reshape(8, 8))
    keys = assert_stores_equal(tvn.VirtualOMEZarr(ts), jvn.VirtualOMEZarr(js))
    assert "0/0.0" in keys
    arr = np.frombuffer(tvn.VirtualOMEZarr(ts).get("0/0.0"), dtype=np.uint16).reshape(8, 8)
    np.testing.assert_array_equal(arr, np.arange(64).reshape(8, 8))


@pytest.mark.parametrize("dtype", [np.uint16, np.float32, np.uint8])
def test_virtual_store_of_every_view_kind_matches_jax(dtype):
    """Views with channels and time, float data, 3D, and msims of several
    levels: the same bytes for every key."""
    rng = np.random.default_rng(1)
    data = (rng.random((2, 3, 5, 21, 33)) * 200).astype(dtype)
    js, ts = _both(data, dims=("t", "c", "z", "y", "x"), c_coords=["a", "b", "c"],
                   scale={"z": 2.0, "y": 0.5, "x": 0.5}, translation={"z": 1.0, "y": -2.0, "x": 3.0})
    chunks = {"t": 1, "c": 2, "z": 4, "y": 8, "x": 16}
    assert_stores_equal(tvn.VirtualOMEZarr(ts, chunks=chunks), jvn.VirtualOMEZarr(js, chunks=chunks))
    js2, ts2 = _both(data[0, 0], dims=("z", "y", "x"))
    assert_stores_equal(tvn.VirtualOMEZarr(ts2), jvn.VirtualOMEZarr(js2))
    big = (rng.random((240, 230)) * 200).astype(dtype)
    js3, ts3 = _both(big, dims=("y", "x"), scale={"y": 0.5, "x": 0.5})
    jm = jmsi.get_msim_from_sim(js3)
    tm = tmsi.get_msim_from_sim(ts3)
    assert len(tm.sims) == len(jm.sims) > 1
    c = {"y": 64, "x": 64}
    assert_stores_equal(tvn.VirtualOMEZarr(tm, chunks=c), jvn.VirtualOMEZarr(jm, chunks=c))


def test_virtual_store_edge_chunk_padding_matches_jax():
    data = np.arange(5 * 6, dtype=np.uint16).reshape(5, 6)
    js, ts = _both(data)
    c = {"y": 3, "x": 4}
    tstore = tvn.VirtualOMEZarr(ts, chunks=c)
    assert_stores_equal(tstore, jvn.VirtualOMEZarr(js, chunks=c))
    chunk = np.frombuffer(tstore.get("0/1.1"), dtype=np.uint16).reshape(3, 4)
    np.testing.assert_array_equal(chunk[:2, :2], data[3:5, 4:6])
    assert (chunk[2, :] == 0).all() and (chunk[:, 2:] == 0).all()


def test_virtual_store_of_a_tensor_sim_serves_the_numpy_bytes():
    """A sim over a tensor (``fuse(..., output_on_backend=True)``) serves the
    bytes of the same sim over numpy, chunk by chunk."""
    sims = [_port(s) for s in _grid()]
    on_backend = tfusion.fuse(sims, transform_key=KEY, output_on_backend=True, device="cpu")
    assert isinstance(on_backend.data, torch.Tensor)
    host = on_backend.copy(data=on_backend.data.numpy())
    c = {d: 1 if d in ("t", "c") else 24 for d in host.dims}
    keys = assert_stores_equal(tvn.VirtualOMEZarr(on_backend, chunks=c),
                               tvn.VirtualOMEZarr(host, chunks=c))
    assert sum(k.count(".") == len(host.dims) - 1 for k in keys) > 4
    # and the JAX store of the same data
    jhost = jsi.get_sim_from_array(host.data, dims=host.dims, scale=host.spacing,
                                   translation=host.origin, c_coords=host.coords.get("c"),
                                   t_coords=host.coords.get("t"))
    assert_stores_equal(tvn.VirtualOMEZarr(on_backend, chunks=c),
                        jvn.VirtualOMEZarr(jhost, chunks=c))


def test_virtual_store_of_a_lazy_zarr_sim_matches_jax(tmp_path):
    data = np.random.default_rng(2).integers(0, 999, (37, 45)).astype(np.uint16)
    arr = tzb.create_zarr_array(str(tmp_path / "a.zarr"), data.shape, (16, 16), np.uint16)
    arr[...] = data
    lazy = tzb.open_zarr_array(str(tmp_path / "a.zarr"))
    ts = tsi.get_sim_from_array(lazy, dims=("y", "x"))
    js = jsi.get_sim_from_array(data, dims=("y", "x"))
    c = {"y": 10, "x": 20}
    assert_stores_equal(tvn.VirtualOMEZarr(ts, chunks=c), jvn.VirtualOMEZarr(js, chunks=c))


def test_virtual_ome_zarr_reports_source_time_scale_as_jax():
    for tf in ({"scale": 3.0, "translation": 1.5, "unit": "minute"}, None):
        js, ts = _both(np.zeros((2, 8, 8), np.uint16), dims=("t", "y", "x"))
        if tf is not None:
            jngff.set_ngff_time_transform(js, tf)
            tngff.set_ngff_time_transform(ts, tf)
        tstore = tvn.VirtualOMEZarr(ts)
        assert_stores_equal(tstore, jvn.VirtualOMEZarr(js))
    ms = json.loads(tstore.get(".zattrs"))["multiscales"][0]
    assert "unit" not in ms["axes"][[a["name"] for a in ms["axes"]].index("t")]


def test_serve_virtual_ome_zarrs_omero_override_matches_jax():
    omero = {"channels": [{"color": "ff0000", "label": "0", "active": True,
                           "window": {"min": 0, "max": 10, "start": 1, "end": 9}}]}
    js, ts = _both(np.zeros((5, 6), dtype=np.uint16))
    servers = [jvn.serve_virtual_ome_zarrs([js], port=0, omero_channels=[omero]),
               tvn.serve_virtual_ome_zarrs([ts], port=0, omero_channels=[omero])]
    try:
        jstore, tstore = (next(iter(s.RequestHandlerClass.stores.values())) for s in servers)
        assert_stores_equal(tstore, jstore)
        assert json.loads(tstore.get(".zattrs"))["omero"] == omero
    finally:
        for s in servers:
            s.shutdown()


def test_serve_virtual_ome_zarrs_rejects_length_mismatch_as_jax():
    js, ts = _both(np.zeros((5, 6), dtype=np.uint16))
    for vn, sim in ((jvn, js), (tvn, ts)):
        with pytest.raises(ValueError, match="must match len"):
            vn.serve_virtual_ome_zarrs([sim] * 3, port=0, omero_channels=[{"channels": []}])
        with pytest.raises(ValueError, match="must match len"):
            vn.serve_virtual_ome_zarrs([sim] * 3, port=0, names=["only.zarr"])


def _wells(seed=3):
    rng = np.random.default_rng(seed)
    data = {"A/1": rng.integers(0, 1000, (12, 16)).astype(np.uint16),
            "B/3": rng.integers(0, 1000, (12, 16)).astype(np.uint16)}
    return ({k: jsi.get_sim_from_array(v) for k, v in data.items()},
            {k: tsi.get_sim_from_array(v) for k, v in data.items()}, data)


def test_virtual_plate_store_matches_jax():
    jw, tw, data = _wells()
    jplate, tplate = jvn.VirtualOMEZarrPlate(jw), tvn.VirtualOMEZarrPlate(tw)
    keys = [".zattrs", ".zgroup", "A", "A/1", "A/1/.zgroup", "A/1/.zattrs", "A/1/0",
            "A/1/0/.zattrs", "A/1/0/0/.zarray", "A/1/0/0/0.0", "A/1/0/0/1.0", "B/3/0/0/0.0",
            "C/1/.zattrs", "A/1/x", "A/1/0/1/.zarray"]
    for key in keys:
        assert tplate.get(key) == jplate.get(key), key
    arr = np.frombuffer(tplate.get("A/1/0/0/0.0"), np.uint16).reshape(12, 16)
    np.testing.assert_array_equal(arr, data["A/1"])


def test_virtual_plate_served_readback_through_the_port():
    jw, tw, data = _wells()
    port = _free_port()
    server = tvn.serve_virtual_plate(tw, port=port)
    try:
        base = f"http://127.0.0.1:{port}/plate.ome.zarr"
        attrs = json.loads(urllib.request.urlopen(base + "/.zattrs").read())
        assert attrs == json.loads(jvn.VirtualOMEZarrPlate(jw).get(".zattrs"))
        for well, arr in data.items():
            np.testing.assert_array_equal(
                np.asarray(tzb.open_zarr_array(f"{base}/{well}/0/0")), arr)
    finally:
        server.shutdown()


def test_http_roundtrip_through_the_port_zarr_backend():
    data = np.random.default_rng(4).integers(0, 1000, (2, 40, 50)).astype(np.uint16)
    kw = dict(dims=("c", "y", "x"), c_coords=["a", "b"], scale={"y": 0.5, "x": 0.5},
              translation={"y": 0.0, "x": 0.0})
    js, ts = _both(data, **kw)
    ports = [_free_port(), _free_port()]
    servers = [tvn.serve_virtual_ome_zarrs([ts], port=ports[0]),
               jvn.serve_virtual_ome_zarrs([js], port=ports[1])]
    try:
        for port in ports:
            base = f"http://127.0.0.1:{port}/0.ome.zarr"
            attrs = json.loads(urllib.request.urlopen(base + "/.zattrs").read())
            assert attrs["multiscales"][0]["axes"][0]["name"] == "c"
            arr = tzb.open_zarr_array(base + "/0")
            assert arr.shape == data.shape and arr.dtype == data.dtype
            np.testing.assert_array_equal(np.asarray(arr), data)
            np.testing.assert_array_equal(arr[1, 3:17, 40:], data[1, 3:17, 40:])
            # an unknown array is no array; HTTP arrays are read only
            with pytest.raises(FileNotFoundError):
                tzb.open_zarr_array(base + "/1")
            with pytest.raises(NotImplementedError, match="read only"):
                arr[0, 0, 0] = 1
    finally:
        for s in servers:
            s.shutdown()


def test_virtual_server_concurrent_readers():
    data = np.random.default_rng(5).integers(0, 4000, (64, 96)).astype(np.uint16)
    ts = tsi.get_sim_from_array(data, dims=("y", "x"))
    port = _free_port()
    server = tvn.serve_virtual_ome_zarrs([ts], port=port, names=["v.ome.zarr"])
    try:
        base = f"http://127.0.0.1:{port}/v.ome.zarr"
        cy, cx = 24, 40
        store = server.RequestHandlerClass.stores["v.ome.zarr"]
        store.chunks = {"y": cy, "x": cx}
        jstore = jvn.VirtualOMEZarr(jsi.get_sim_from_array(data, dims=("y", "x")),
                                    chunks={"y": cy, "x": cx})

        def fetch_chunk(idx):
            key = f"0/{idx[0]}.{idx[1]}"
            assert urllib.request.urlopen(f"{base}/{key}").read() == jstore.get(key)
            return idx

        def fetch_whole(_):
            np.testing.assert_array_equal(np.asarray(tzb.open_zarr_array(base + "/0")), data)
            return "whole"

        ids = [(iy, ix) for iy in range(-(-64 // cy)) for ix in range(-(-96 // cx))] * 4
        with ThreadPoolExecutor(max_workers=8) as pool:
            assert list(pool.map(fetch_chunk, ids)) == ids
            assert list(pool.map(fetch_whole, range(4))) == ["whole"] * 4
    finally:
        server.shutdown()


def test_a_failed_chunk_read_fails_its_request():
    """A chunk that cannot be read is a 500 (and logged), never zeros; an
    unknown key is a 404."""

    class Failing:
        shape, dtype = (8, 8), np.dtype(np.uint16)

        def __getitem__(self, idx):
            raise OSError("the source went away")

    ts = tsi.get_sim_from_array(Failing(), dims=("y", "x"))
    with pytest.raises(OSError, match="went away"):
        tvn.VirtualOMEZarr(ts).get("0/0.0")
    port = _free_port()
    server = tvn.serve_virtual_ome_zarrs([ts], port=port)
    try:
        base = f"http://127.0.0.1:{port}/0.ome.zarr"
        assert json.loads(urllib.request.urlopen(base + "/0/.zarray").read())["shape"] == [8, 8]
        for key, code in (("0/0.0", 500), ("0/9/9", 404), ("nope", 404)):
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(f"{base}/{key}")
            assert err.value.code == code, key
        with pytest.raises(urllib.error.HTTPError, match="500"):
            np.asarray(tzb.open_zarr_array(base + "/0"))
    finally:
        server.shutdown()


def test_serving_names_are_reached_from_ngff_utils():
    assert tngff.VirtualOMEZarr is tvn.VirtualOMEZarr
    assert tngff.VirtualOMEZarrHCSPlate is tvn.VirtualOMEZarrPlate
    assert tngff.VirtualOMEZarrServer is tvn.VirtualOMEZarrServer
    js, ts = _both(np.arange(12, dtype=np.uint16).reshape(3, 4))
    server = tvn.VirtualOMEZarrServer({"a.ome.zarr": tvn.VirtualOMEZarr(ts)}, port=0).start()
    nserver = tngff.serve_virtual_ome_zarrs([ts], port=0)
    try:
        for base in (server.base_url + "/a.ome.zarr",
                     f"http://127.0.0.1:{nserver.server_address[1]}/0.ome.zarr"):
            assert urllib.request.urlopen(base + "/0/0.0").read() == jvn.VirtualOMEZarr(js).get(
                "0/0.0")
    finally:
        server.shutdown()
        nserver.shutdown()


# ---------------------------------------------------------------------------
# viewer entry points
# ---------------------------------------------------------------------------


def test_view_neuroglancer_with_virtual_store_matches_jax():
    js, ts = _both(np.zeros((16, 16), dtype=np.uint16))
    port = _free_port()
    url, server = tvis.view_neuroglancer([ts], transform_key=KEY, port=port)
    try:
        # the JAX state of the same sims at the same URLs
        jstate = jng.generate_neuroglancer_json(
            None, [f"http://127.0.0.1:{port}/0.ome.zarr"], sims=[js], transform_key=KEY)
        assert url == jng.get_neuroglancer_url(jstate)
        raw = urllib.request.urlopen(f"http://127.0.0.1:{port}/0.ome.zarr/0/0.0").read()
        assert raw == jvn.VirtualOMEZarr(js).get("0/0.0")
    finally:
        server.shutdown()


def test_view_neuroglancer_channel_colormaps_match_jax():
    js, ts = _both(np.zeros((2, 8, 8), np.uint16), dims=("c", "y", "x"), c_coords=["dapi", "gfp"])
    jsi.set_sim_affine(js, np.eye(3), transform_key="registered")
    tsi.set_sim_affine(ts, np.eye(3), transform_key="registered")
    kw = dict(transform_key="registered", port=0, channel_colormaps=["Blues", "Greens"])
    (jurl, jserver), (turl, tserver) = (jvis.view_neuroglancer(images=[js], **kw),
                                        tvis.view_neuroglancer(images=[ts], **kw))
    try:
        assert turl == jurl
        jstore, tstore = (next(iter(s.RequestHandlerClass.stores.values()))
                          for s in (jserver, tserver))
        assert_stores_equal(tstore, jstore)
        assert len({c["color"] for c in json.loads(tstore.get(".zattrs"))["omero"]["channels"]}) == 2
    finally:
        jserver.shutdown()
        tserver.shutdown()
    for vis, sim in ((jvis, js), (tvis, ts)):
        with pytest.raises(ValueError, match="number of colormaps"):
            vis._omero_channels_for_colormaps(sim, ["Blues"])
    fs, ft = _both(np.zeros((4, 4), np.float32))
    assert tvis._omero_channels_for_colormaps(ft, [None]) == jvis._omero_channels_for_colormaps(
        fs, [None])


def test_view_neuroglancer_ondisk_display_metadata_is_restored_as_jax(tmp_path):
    js, ts = _both(np.zeros((2, 8, 8), np.uint16), dims=("c", "y", "x"), c_coords=["a", "b"])
    jpath, tpath = str(tmp_path / "j" / "sim.ome.zarr"), str(tmp_path / "t" / "sim.ome.zarr")
    jngff.write_sim_to_ome_zarr(js, jpath)
    tngff.write_sim_to_ome_zarr(ts, tpath)
    original, _ = tzb.read_group_metadata(tpath)
    kw = dict(port=0, channel_colormaps=["Reds", "Greens"])
    jurl, jserver = jvis.view_neuroglancer(ome_zarr_paths=[jpath], **kw)
    turl, tserver = tvis.view_neuroglancer(ome_zarr_paths=[tpath], **kw)
    try:
        assert turl == jurl
        served, _ = tzb.read_group_metadata(tpath)
        jserved, _ = tzb.read_group_metadata(jpath)
        assert served["omero"] == jserved["omero"] and served != original
        raw = urllib.request.urlopen(
            f"http://127.0.0.1:{tserver.server_address[1]}/.zattrs").read()
        assert json.loads(raw) == served
    finally:
        jserver.shutdown()
        tserver.shutdown()
    assert tzb.read_group_metadata(tpath)[0] == original
    # view_ome_zarr is view_neuroglancer of one store
    turl2, tserver2 = tvis.view_ome_zarr(tpath, port=0)
    jurl2, jserver2 = jvis.view_ome_zarr(jpath, port=0)
    tserver2.shutdown()
    jserver2.shutdown()
    assert turl2 == jurl2


def test_contrast_from_omero_metadata_channel_label_matches_jax(tmp_path):
    js, ts = _both(np.zeros((2, 8, 8), np.uint16), dims=("c", "y", "x"), c_coords=["DAPI", "GFP"])
    jpath, tpath = str(tmp_path / "j.ome.zarr"), str(tmp_path / "t.ome.zarr")
    jngff.write_sim_to_ome_zarr(js, jpath)
    tngff.write_sim_to_ome_zarr(ts, tpath)
    for label in (None, "GFP", "DAPI"):
        got = tvis.get_contrast_min_max_from_ome_zarr_omero_metadata(tpath, channel_label=label)
        ref = jvis.get_contrast_min_max_from_ome_zarr_omero_metadata(jpath, channel_label=label)
        np.testing.assert_array_equal(got, ref)
        assert got is not None and len(got) == 2
    for vis, path in ((jvis, jpath), (tvis, tpath)):
        with pytest.raises(ValueError, match="not found"):
            vis.get_contrast_min_max_from_ome_zarr_omero_metadata(path, channel_label="nope")


def test_serve_dir_serves_files_with_cors(tmp_path):
    (tmp_path / "a.txt").write_bytes(b"abc")
    server, thread = tvis.serve_dir(str(tmp_path), port=0)
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{server.server_address[1]}/a.txt") as r:
            assert r.read() == b"abc"
            assert r.headers["Access-Control-Allow-Origin"] == "*"
    finally:
        server.shutdown()
