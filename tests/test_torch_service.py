"""The port's service runtime (sessions, specs, workers, bridges), held to
the JAX package on the CPU.

Every case of ``tests/test_service.py`` runs here through both packages on
the same views: small 2D tile pairs written as OME-Zarr by the port (the
JAX package reads them through tensorstore; the JAX package's own stores
are blosc-compressed, which the port reads only where numcodecs imports, so
the JAX side's fused stores are read through the JAX reader). Held: the
specs' and options' JSON byte-equal, ``Session.register`` params within
1e-3 of the JAX session's (in process, over a ``LocalBridge`` and over a
``ProcessPoolBridge`` of two spawned CPU workers), the preview routes and
their retirement, ``fusion_plan`` equal, ``fuse_to_zarr`` over a bridge
byte-equal to the direct store and within 1 count of the JAX store, the
worker protocol's responses equal as JSON (floats within 1e-12; the
session ids are random), and the CUDA default without CUDA raising.
"""

from __future__ import annotations

import importlib.util
import json
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from multiview_stitcher_torch import fusion as tfusion
from multiview_stitcher_torch import msi_utils as tmsi
from multiview_stitcher_torch import param_utils as tpu
from multiview_stitcher_torch import registration as treg
from multiview_stitcher_torch import sample_data as tsd
from multiview_stitcher_torch.io import ngff_utils as tngff
from multiview_stitcher_torch.io import zarr_backend as tzb
from multiview_stitcher_torch.parallel.executors import SourceSpec as TSourceSpec
from multiview_stitcher_torch.service import (
    FusionOptions,
    LocalBridge,
    ProcessPoolBridge,
    RegistrationOptions,
    Session,
    SessionSpec,
    WorkerRuntime,
)
from multiview_stitcher_torch.service import session as tsession
from multiview_stitcher_torch.service import worker as tworker
from multiview_stitcher_tpu import fusion as jfusion
from multiview_stitcher_tpu import msi_utils as jmsi
from multiview_stitcher_tpu import registration as jreg
from multiview_stitcher_tpu import sample_data as jsd
from multiview_stitcher_tpu.io import zarr_backend as jzb
from multiview_stitcher_tpu.parallel.executors import SourceSpec as JSourceSpec
from multiview_stitcher_tpu.service import FusionOptions as JFusionOptions
from multiview_stitcher_tpu.service import LocalBridge as JLocalBridge
from multiview_stitcher_tpu.service import RegistrationOptions as JRegistrationOptions
from multiview_stitcher_tpu.service import Session as JSession
from multiview_stitcher_tpu.service import WorkerRuntime as JWorkerRuntime

REPO = Path(__file__).resolve().parents[1]
CPU = "cpu"
# registration parameters of the two packages agree within this (px)
PARAM_ATOL = 1e-3
# the bridge and the in-process path of one package agree within this
BRIDGE_ATOL = 1e-6
# seconds the process-pool case may take, its workers' start included
POOL_TIMEOUT_S = 240


def _dataset(n=2, tile=48, overlap=12, shift=2.4):
    kw = dict(ndim=2, N_t=1, N_c=1, tile_size=tile, tiles_x=n, tiles_y=1, overlap=overlap,
              zoom=6, drift_scale=0, shift_scale=shift, dtype=np.uint16)
    return jsd.generate_tiled_dataset(**kw), tsd.generate_tiled_dataset(**kw)


@pytest.fixture(scope="module")
def views(tmp_path_factory):
    """A 2D tile pair with a known shift, written as OME-Zarr by the port
    (both packages read these stores); returns (JAX sims, URLs)."""
    root = tmp_path_factory.mktemp("views")
    jsims, tsims = _dataset()
    for j, t in zip(jsims, tsims):
        np.testing.assert_array_equal(np.asarray(j.data), t.data)
    urls = []
    for i, sim in enumerate(tsims):
        url = str(root / f"view{i}.ome.zarr")
        tngff.write_sim_to_ome_zarr(sim, url)
        urls.append(url)
    return jsims, urls


@pytest.fixture(scope="module")
def jax_registered(views):
    """The JAX session's in-process register() of the pair (its phase
    correlation compiles once here)."""
    _, urls = views
    session = JSession()
    session.load(urls)
    return session.register(JRegistrationOptions(new_transform_key="reg"))


def _session(urls=None, **kw):
    s = Session(device=CPU, **kw)
    if urls is not None:
        s.load(urls)
    return s


def assert_json_close(got, ref, path="", atol=1e-12, skip=()):
    if isinstance(ref, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(ref), (path, got, ref)
        for k in ref:
            if k not in skip:
                assert_json_close(got[k], ref[k], f"{path}/{k}", atol, skip)
    elif isinstance(ref, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(ref), (path, got, ref)
        for i, (g, r) in enumerate(zip(got, ref)):
            assert_json_close(g, r, f"{path}/{i}", atol, skip)
    elif isinstance(ref, float) and not isinstance(ref, bool):
        assert abs(float(got) - ref) <= atol, (path, got, ref)
    else:
        assert got == ref, (path, got, ref)


def assert_summaries_close(got, ref, atol=PARAM_ATOL):
    assert got["transform_key"] == ref["transform_key"]
    assert got["edges"] == ref["edges"]
    np.testing.assert_allclose(np.asarray(got["params"]), np.asarray(ref["params"]), atol=atol)
    for q, r in zip(got["qualities"], ref["qualities"]):
        assert (q is None) == (r is None)
        if q is not None:
            assert abs(q - r) <= atol


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------


def test_registration_options_json_roundtrip_and_validation_match_jax():
    kw = dict(transform_key="affine_metadata", new_transform_key="reg",
              registration_binning={"y": 2, "x": 2}, pairs=[[0, 1]])
    opts = RegistrationOptions(**kw)
    assert opts.to_json() == JRegistrationOptions(**kw).to_json()
    assert RegistrationOptions().to_json() == JRegistrationOptions().to_json()
    opts2 = RegistrationOptions.from_json(opts.to_json())
    assert opts2 == opts
    assert RegistrationOptions.from_json(json.loads(opts.to_json())) == opts
    kwargs = opts2.to_register_kwargs()
    assert kwargs["pairwise_reg_func"] is treg.phase_correlation_registration
    assert kwargs["pairs"] == [(0, 1)]
    jkwargs = JRegistrationOptions(**kw).to_register_kwargs()
    assert sorted(kwargs) == sorted(jkwargs)
    assert RegistrationOptions(pairwise_reg_func="marker_based").to_register_kwargs()[
        "pairwise_reg_func"] is treg.registration_marker_based
    for bad, match in ((dict(pairwise_reg_func="nope"), "unknown pairwise registration"),
                       (dict(groupwise_resolution_method="nope"), "unknown groupwise"),
                       (dict(pre_registration_pruning_method="nope"), "unknown pruning")):
        for cls in (RegistrationOptions, JRegistrationOptions):
            with pytest.raises(KeyError, match=match):
                cls(**bad)


def test_fusion_options_json_roundtrip_and_validation_match_jax():
    kw = dict(fusion_func="max", output_spacing={"y": 2.0, "x": 2.0}, output_chunksize=32)
    opts = FusionOptions(**kw)
    assert opts.to_json() == JFusionOptions(**kw).to_json()
    opts2 = FusionOptions.from_json(opts.to_json())
    assert opts2 == opts
    assert opts2.to_fuse_kwargs()["fusion_func"] is tfusion.max_fusion
    assert sorted(opts2.to_fuse_kwargs()) == sorted(JFusionOptions(**kw).to_fuse_kwargs())
    for name, func in (("weighted_average", tfusion.weighted_average_fusion),
                       ("simple_average", tfusion.simple_average_fusion)):
        assert FusionOptions(fusion_func=name).to_fuse_kwargs()["fusion_func"] is func
    for cls in (FusionOptions, JFusionOptions):
        with pytest.raises(KeyError, match="unknown fusion func"):
            cls(fusion_func="nope")


# ---------------------------------------------------------------------------
# session lifecycle
# ---------------------------------------------------------------------------


def test_session_load_describe_spec_roundtrip_matches_jax(views):
    _, urls = views
    session, jsession = Session(device=CPU), JSession()
    assert session.is_empty
    views_t, views_j = session.load(urls), jsession.load(urls)
    assert_json_close(views_t, views_j)
    assert views_t[0]["url"] == urls[0] and views_t[0]["dims"][-2:] == ["y", "x"]

    mats = [tpu.affine_from_translation([1.5, -0.5]) for _ in urls]
    session.set_params("manual", mats)
    jsession.set_params("manual", mats)
    assert session.generation == jsession.generation
    spec = session.spec()
    # clients and workers of either package share the spec: byte-equal
    assert spec.to_json() == jsession.spec().to_json()
    assert SessionSpec.from_json(spec.to_json()).to_json() == spec.to_json()
    assert session.transforms_json() == jsession.transforms_json()

    rebuilt = Session.from_spec(spec.to_json(), device=CPU)
    assert rebuilt.device == torch.device("cpu")
    assert rebuilt.transform_keys == session.transform_keys
    assert rebuilt.generation == spec.generation
    for v_orig, v_new in zip(session.msims, rebuilt.msims):
        np.testing.assert_allclose(v_new.transforms["manual"].squeeze(),
                                   v_orig.transforms["manual"].squeeze())
    session.remove(0)
    jsession.remove(0)
    assert_json_close(session.describe(), jsession.describe())
    session.clear()
    assert session.is_empty


def test_session_in_memory_views_cannot_spec_as_jax(views):
    jsims, _ = views
    _, tsims = _dataset()
    session, jsession = Session(device=CPU), JSession()
    session.add_msims([tmsi.get_msim_from_sim(s, scale_factors=[]) for s in tsims])
    jsession.add_msims([jmsi.get_msim_from_sim(s, scale_factors=[]) for s in jsims])
    assert_json_close(session.describe(), jsession.describe())
    for s in (session, jsession):
        with pytest.raises(ValueError, match="no zarr URL"):
            s.spec()


def test_session_copy_transform_and_default_key_match_jax(views):
    _, urls = views
    for s in (_session(urls), JSession()):
        if not s.msims:
            s.load(urls)
        assert s.default_transform_key() == "affine_metadata"
        s.copy_transform("affine_metadata", "registered")
        assert s.default_transform_key() == "registered"
        with pytest.raises(KeyError):
            s.copy_transform("missing", "x")
    assert Session(device=CPU).default_transform_key() is None


def test_load_replace_semantics_match_jax(views):
    _, urls = views
    for s in (Session(device=CPU), JSession()):
        s.load(urls)
        s.load(urls[:1], replace=False)
        assert len(s.describe()) == 3
        s.load(urls[:1], replace=True)
        assert len(s.describe()) == 1


def _czi_module():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _write_mosaic_czi(path, n=2, tile=40, overlap=10):
    """A CZI mosaic of n tiles in a row, 2 channels, raw uint16 subblocks."""
    cs = _czi_module()
    rng = np.random.default_rng(9)
    planes = []
    for m in range(n):
        for c in range(2):
            data = rng.integers(0, 4000, (tile, tile)).astype(np.uint16)
            dims = {"X": (m * (tile - overlap), tile), "Y": (0, tile), "C": (c, 1), "M": (m, 1),
                    "S": (0, 1)}
            planes.append((dims, 1, 0, data))
    cs.write_czi(path, cs.czi_metadata_xml({"X": 0.5, "Y": 0.5}, ["DAPI", "GFP"]), planes)


def test_session_load_mosaic_czi_and_spec_roundtrip_match_jax(tmp_path):
    path = str(tmp_path / "mosaic.czi")
    _write_mosaic_czi(path)
    session, jsession = Session(device=CPU), JSession()
    views_t, views_j = session.load_mosaic(path), jsession.load_mosaic(path)
    assert_json_close(views_t, views_j)
    assert len(views_t) == 2 and views_t[0]["url"] == path
    assert session.spec().to_json() == jsession.spec().to_json()
    rebuilt = Session.from_spec(session.spec().to_json(), device=CPU)
    assert len(rebuilt.msims) == 2
    for a, b in zip(session.msims, rebuilt.msims):
        np.testing.assert_allclose(a.transforms["affine_metadata"].squeeze(),
                                   b.transforms["affine_metadata"].squeeze())
    for a, b in zip(rebuilt.msims, jsession.msims):
        np.testing.assert_array_equal(np.asarray(tmsi.get_sim_from_msim(a).data),
                                      np.asarray(jmsi.get_sim_from_msim(b).data))


def test_source_spec_view_index_out_of_range_as_jax(tmp_path):
    path = str(tmp_path / "mosaic.czi")
    _write_mosaic_czi(path)
    for cls in (TSourceSpec, JSourceSpec):
        with pytest.raises(IndexError, match="view_index 5 out of range"):
            cls(url=path, view_index=5).open_msim()


def test_session_and_workers_need_cuda_by_default():
    """Without ``device``, sessions, workers and bridges run on the CUDA
    device, and raise where there is none: no CPU fallback."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the service runs there by default")
    for make in (Session, WorkerRuntime, LocalBridge, lambda: ProcessPoolBridge(n_workers=1),
                 lambda: Session.from_spec(SessionSpec())):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    assert Session(device="cpu").device == torch.device("cpu")
    assert WorkerRuntime(device="cpu").device == torch.device("cpu")


# ---------------------------------------------------------------------------
# registration: in-process and over the bridge
# ---------------------------------------------------------------------------


def test_session_register_in_process_matches_jax(views, jax_registered):
    jsims, urls = views
    session = _session(urls)
    gen = session.generation
    summary = session.register(RegistrationOptions(new_transform_key="reg"))
    assert session.generation == gen + 1
    assert_summaries_close(summary, jax_registered)
    assert all("reg" in msim.transforms for msim in session.msims)
    # the relative shift between the stage positions is corrected to
    # within the simulated shift scale
    gt_rel = (np.asarray(jsims[1].transforms["affine_metadata"].squeeze())[:-1, -1]
              - np.asarray(jsims[0].transforms["affine_metadata"].squeeze())[:-1, -1])
    p0, p1 = (np.asarray(p) for p in summary["params"])
    assert np.all(np.abs((p1[:-1, -1] - p0[:-1, -1]) - gt_rel) < 4.0)


def test_session_register_over_local_bridge_matches_in_process_and_jax(views, jax_registered):
    _, urls = views
    opts = RegistrationOptions(new_transform_key="reg")
    r_local = _session(urls).register(opts)
    progress = []
    r_bridge = _session(urls).register(
        opts, bridge=LocalBridge(device=CPU), progress=lambda d, t: progress.append((d, t)))
    np.testing.assert_allclose(np.asarray(r_bridge["params"]), np.asarray(r_local["params"]),
                               atol=BRIDGE_ATOL)
    assert progress and progress[-1][0] == progress[-1][1]
    assert_summaries_close(r_bridge, jax_registered)


def test_session_register_pairs_option_restricts_edges_as_jax(views):
    _, urls = views
    opts = RegistrationOptions(new_transform_key="reg", pairs=[[0, 1]])
    got = _session(urls + urls[:1]).register(opts)
    jsession = JSession()
    jsession.load(urls + urls[:1])
    ref = jsession.register(JRegistrationOptions(new_transform_key="reg", pairs=[[0, 1]]))
    assert got["edges"] == ref["edges"] == [[0, 1]]
    assert_summaries_close(got, ref)


def test_register_over_process_pool_bridge_matches_in_process(views):
    """Two spawned CPU workers: the JSON protocol crosses a process
    boundary and gives the in-process result."""
    _, urls = views
    opts = RegistrationOptions(new_transform_key="reg")
    r_local = _session(urls).register(opts)
    bridge = ProcessPoolBridge(n_workers=2, platform="cpu")
    try:
        with ThreadPoolExecutor(1) as pool:
            fut = pool.submit(_session(urls).register, opts, bridge=bridge)
            r_pool = fut.result(timeout=POOL_TIMEOUT_S)
    except BaseException:
        for proc in list(bridge._pool._processes.values()):
            proc.kill()
        raise
    finally:
        bridge.close()
    np.testing.assert_allclose(np.asarray(r_pool["params"]), np.asarray(r_local["params"]),
                               atol=BRIDGE_ATOL)


# ---------------------------------------------------------------------------
# fusion: preview routes, plan, block fusion over the bridge
# ---------------------------------------------------------------------------


def _preview_array(session, preview):
    store = session.preview_store(preview["route"])
    meta = json.loads(store.get("0/.zarray"))
    assert meta["chunks"] == meta["shape"]
    key = "0/" + ".".join("0" for _ in meta["shape"])
    return np.frombuffer(store.get(key), dtype=meta["dtype"]).reshape(meta["shape"]), store


def test_fuse_preview_route_retires_on_state_change_as_jax(views):
    _, urls = views
    session, jsession = _session(urls), JSession()
    jsession.load(urls)
    got, ref = session.fuse_preview(max_voxels=32**2), jsession.fuse_preview(max_voxels=32**2)
    assert_json_close(got, ref)
    assert np.prod(list(got["shape"].values())) <= 4 * 32**2
    arr, store = _preview_array(session, got)
    jarr, jstore = _preview_array(jsession, ref)
    np.testing.assert_allclose(arr.astype(np.int32), jarr.astype(np.int32), atol=1)
    assert store.get(".zattrs") == jstore.get(".zattrs")
    assert store.get("0/.zarray") == jstore.get("0/.zarray")
    for s in (session, jsession):
        s.copy_transform("affine_metadata", "other")
        assert s.preview_store(got["route"]) is None


def test_fuse_preview_respects_fusion_func_as_jax(views):
    _, urls = views
    session = _session(urls)
    p_avg = session.fuse_preview(FusionOptions(fusion_func="weighted_average"),
                                 max_voxels=48**2)
    arr_avg, _ = _preview_array(session, p_avg)
    session.bump_generation()
    p_max = session.fuse_preview(FusionOptions(fusion_func="max"), max_voxels=48**2)
    arr_max, _ = _preview_array(session, p_max)
    assert p_max["route"] != p_avg["route"]
    assert session.preview_store(p_avg["route"]) is None
    assert arr_max.size == arr_avg.size
    assert np.all(arr_max.astype(np.int32) >= arr_avg.astype(np.int32) - 1)
    assert np.any(arr_max > arr_avg)
    # the max preview against the JAX package's
    jsession = JSession()
    jsession.load(urls)
    ref = jsession.fuse_preview(JFusionOptions(fusion_func="max"), max_voxels=48**2)
    jarr, _ = _preview_array(jsession, ref)
    np.testing.assert_array_equal(arr_max, jarr)


def test_fusion_plan_deterministic_across_participants_and_equal_to_jax(views):
    _, urls = views
    s1 = _session(urls)
    s2 = Session.from_spec(s1.spec().to_json(), device=CPU)
    jsession = JSession()
    jsession.load(urls)
    plan1 = s1.fusion_plan(FusionOptions(), output_chunksize=32)
    assert plan1 == s2.fusion_plan(FusionOptions(), output_chunksize=32)
    assert plan1 == jsession.fusion_plan(JFusionOptions(), output_chunksize=32)
    assert plan1["n_blocks"] >= 2


def test_fusion_plan_chunksize_override_matches_jax(views):
    _, urls = views
    session, jsession = _session(urls), JSession()
    jsession.load(urls)
    for cs in (16, 1024, None):
        assert session.fusion_plan(output_chunksize=cs) == jsession.fusion_plan(
            output_chunksize=cs)
    small, big = session.fusion_plan(output_chunksize=16), session.fusion_plan(
        output_chunksize=1024)
    assert small["n_blocks"] > big["n_blocks"] == 1
    assert small["shape"] == big["shape"]


def test_fuse_to_zarr_over_bridge_matches_direct_and_jax(views, tmp_path):
    _, urls = views
    session = _session(urls)
    opts = FusionOptions(output_chunksize=32)
    direct = tfusion.fuse([tmsi.get_sim_from_msim(m) for m in session.msims],
                          transform_key="affine_metadata", device=CPU)
    out_bridge, out_direct = str(tmp_path / "bridge.zarr"), str(tmp_path / "direct.zarr")
    r = session.fuse_to_zarr(out_bridge, opts, bridge=LocalBridge(device=CPU), batch_size=3)
    assert r["written"] == r["n_blocks"]
    r2 = session.fuse_to_zarr(out_direct, opts)
    assert r2 == r
    a_bridge = np.asarray(tzb.attach_zarr_array(out_bridge)[...])
    a_direct = np.asarray(tzb.attach_zarr_array(out_direct)[...])
    np.testing.assert_array_equal(a_bridge, a_direct)
    # the stores byte for byte: the same chunk files with the same bytes
    for f in sorted(Path(out_direct).iterdir()):
        assert (Path(out_bridge) / f.name).read_bytes() == f.read_bytes(), f.name
    np.testing.assert_allclose(a_bridge.squeeze().astype(np.int32),
                               np.asarray(direct.data).squeeze().astype(np.int32), atol=1)
    # the JAX session's store of the same blocks, read by the JAX reader
    jsession = JSession()
    jsession.load(urls)
    out_jax = str(tmp_path / "jax.zarr")
    assert jsession.fuse_to_zarr(out_jax, JFusionOptions(output_chunksize=32)) == r
    a_jax = np.asarray(jzb.attach_zarr_array(out_jax)[...])
    assert a_jax.shape == a_direct.shape and a_jax.dtype == a_direct.dtype
    np.testing.assert_allclose(a_direct.astype(np.int32), a_jax.astype(np.int32), atol=1)
    # and the JAX whole-image fuse
    jdirect = jfusion.fuse([jmsi.get_sim_from_msim(m) for m in jsession.msims],
                           transform_key="affine_metadata")
    np.testing.assert_allclose(np.asarray(direct.data).astype(np.int32),
                               np.asarray(jdirect.data).astype(np.int32), atol=1)


# ---------------------------------------------------------------------------
# worker protocol
# ---------------------------------------------------------------------------


def test_worker_command_protocol_full_flow_matches_jax(views):
    _, urls = views
    runtime, jruntime = WorkerRuntime(device=CPU), JWorkerRuntime()
    flow = [
        ("info", None), ("load", {"sources": urls}), ("transform_keys", None), ("spec", None),
        ("set_params", {"transform_key": "manual", "params": [np.eye(3).tolist()] * 2}),
        ("transforms", None), ("describe", None),
        ("copy_transform", {"source_transform_key": "manual", "new_transform_key": "m2"}),
        ("fusion_plan", {"options": {"transform_key": "affine_metadata"}}),
        ("neuroglancer_state", {}),
        ("neuroglancer_state", {"base_url": "http://h:1", "transform_key": "manual"}),
        ("add", {"sources": urls[:1]}), ("remove", {"index": 2}), ("info", None),
        ("clear", None), ("info", None),
    ]
    for command, payload in flow:
        got, ref = runtime.handle(command, payload), jruntime.handle(command, payload)
        assert_json_close(got, ref, path=command, skip=("session_id",))
        if command == "spec":
            assert json.dumps(got) == json.dumps(ref)
    for rt in (runtime, jruntime):
        with pytest.raises(KeyError, match="unknown command"):
            rt.handle("nope")
        with pytest.raises(KeyError, match="unknown task"):
            rt.run_task(json.dumps({"task": "nope"}))


def test_worker_session_cache_reuses_by_generation(views):
    _, urls = views
    session = _session(urls)
    spec_json = session.spec().to_json()
    runtime = WorkerRuntime(device=CPU)
    s1 = runtime.session_for(spec_json)
    assert runtime.session_for(spec_json) is s1
    assert s1.device == torch.device("cpu")
    session.bump_generation()
    assert runtime.session_for(session.spec().to_json()) is not s1
    for _ in range(tworker.SESSION_CACHE_SIZE + 2):
        session.bump_generation()
        runtime.session_for(session.spec().to_json())
    assert len(runtime._session_cache) == tworker.SESSION_CACHE_SIZE == 2
    runtime.invalidate()
    assert not runtime._session_cache


def test_worker_register_command_full_flow_matches_jax(views, jax_registered, tmp_path):
    _, urls = views
    runtime = WorkerRuntime(device=CPU)
    runtime.handle("load", {"sources": urls})
    gen0 = runtime.handle("info")["generation"]
    summary = runtime.handle("register", {"options": {"new_transform_key": "reg"}})
    assert_summaries_close(summary, jax_registered)
    assert "reg" in runtime.handle("transform_keys")["transform_keys"]
    assert runtime.handle("info")["generation"] > gen0
    out = str(tmp_path / "cmd_fused.zarr")
    r = runtime.handle("fuse_to_zarr", {"output_zarr_url": out,
                                        "options": {"transform_key": "reg"}})
    assert r["written"] == r["n_blocks"] >= 1
    fused = tfusion.fuse([tmsi.get_sim_from_msim(m) for m in runtime.session.msims],
                         transform_key="reg", device=CPU)
    np.testing.assert_allclose(np.asarray(tzb.open_zarr_array(out)).astype(np.int32),
                               np.asarray(fused.data).astype(np.int32), atol=1)
    preview = runtime.handle("fuse_preview", {"options": {"transform_key": "reg"}})
    assert preview["route"] == f"fused-g{runtime.session.generation}.ome.zarr"


def test_worker_run_task_register_pairs_json_contract_matches_jax(views):
    _, urls = views
    session = _session(urls)
    task = {"task": "register_pairs", "session": session.spec().to_json(),
            "edges": [[0, 1]], "options": RegistrationOptions().to_json()}
    out = json.loads(WorkerRuntime(device=CPU).run_task(json.dumps(task)))
    ref = json.loads(JLocalBridge()._runtime.run_task(json.dumps(task)))
    (r,), (rj,) = out["results"], ref["results"]
    assert sorted(r) == sorted(rj) == ["bbox", "quality", "transform"]
    assert np.asarray(r["transform"]).shape == (3, 3)
    np.testing.assert_allclose(r["transform"], rj["transform"], atol=PARAM_ATOL)
    np.testing.assert_allclose(r["bbox"], rj["bbox"], atol=1e-9)
    assert r["quality"] is None or abs(r["quality"] - rj["quality"]) <= PARAM_ATOL
    # the task's result equals register_pair_of_msims of the views' first
    # channel and timepoint
    def first(m, msi):
        sim = msi.get_sim_from_msim(m)
        return msi.multiscale_sel_coords(m, {d: np.asarray(sim.coords[d])[0] for d in ("c", "t")})

    direct = treg.register_pair_of_msims(*(first(m, tmsi) for m in session.msims),
                                         transform_key="affine_metadata", device=CPU)
    np.testing.assert_allclose(r["transform"], np.asarray(direct["transform"].squeeze()),
                               atol=BRIDGE_ATOL)
    jmsims = JSession.from_spec(session.spec().to_json()).msims
    ref_direct = jreg.register_pair_of_msims(*(first(m, jmsi) for m in jmsims),
                                             transform_key="affine_metadata")
    np.testing.assert_allclose(np.asarray(ref_direct["transform"].squeeze()), rj["transform"],
                               atol=BRIDGE_ATOL)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def test_session_serve_routes_track_state_as_jax(views):
    _, urls = views
    session, jsession = _session(urls), JSession()
    jsession.load(urls)
    info, jinfo = session.serve(port=0), jsession.serve(port=0)
    try:
        base, jbase = info["base_url"], jinfo["base_url"]
        assert info["routes"] == jinfo["routes"] == ["0.ome.zarr", "1.ome.zarr"]
        for key in (".zattrs", "0/.zarray", "0/0.0.0.0"):
            got = urllib.request.urlopen(f"{base}/1.ome.zarr/{key}").read()
            assert got == urllib.request.urlopen(f"{jbase}/1.ome.zarr/{key}").read(), key
        # every chunk of a view over HTTP through the port's reader
        view = tzb.open_zarr_array(f"{base}/1.ome.zarr/0")
        np.testing.assert_array_equal(
            np.asarray(view), np.asarray(tmsi.get_sim_from_msim(session.msims[1]).data))

        prev = session.fuse_preview(max_voxels=32**2)
        jprev = jsession.fuse_preview(max_voxels=32**2)
        assert prev["route"] == jprev["route"]
        raw = urllib.request.urlopen(f"{base}/{prev['route']}/.zattrs").read()
        assert raw == urllib.request.urlopen(f"{jbase}/{prev['route']}/.zattrs").read()
        arr = tzb.open_zarr_array(f"{base}/{prev['route']}/0")
        jarr = tzb.open_zarr_array(f"{jbase}/{prev['route']}/0")
        np.testing.assert_allclose(np.asarray(arr).astype(np.int32),
                                   np.asarray(jarr).astype(np.int32), atol=1)

        session.copy_transform("affine_metadata", "new")
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"{base}/{prev['route']}/.zattrs")
        with urllib.request.urlopen(f"{base}/0.ome.zarr/.zattrs") as r:
            assert r.status == 200
        # a view list change republishes the view routes
        session.remove(1)
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"{base}/1.ome.zarr/.zattrs")
        state = session.neuroglancer_state(base_url=base)
        assert state["layers"][0]["source"]["url"] == f"zarr://{base}/0.ome.zarr"
    finally:
        session.stop_serving()
        jsession.stop_serving()
    assert session._server is None
    assert tsession.DEFAULT_PREVIEW_MAX_VOXELS == 64**3
