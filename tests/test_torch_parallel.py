"""The port's multi-device and multi-process paths against the JAX package.

Mirrors ``tests/test_executors.py`` and ``tests/test_multihost.py`` on the
CPU: the JAX side runs on the 8 virtual CPU devices of the conftest (Pallas
in interpret mode), the port on ``Mesh([cpu] * 8)`` and ``Mesh([cpu] * 3)``
(an odd size, which pads). Every input is made by a numpy generator with the
seed each test states, or is a file the test writes.

Tolerances: a sharded output of the port equals its unsharded output bit for
bit, and its registration parameters within 1e-8. Against JAX, fused uint16
within 1 count (truncation ties of the weighted average), float32 within
rtol 1e-4 / atol 1e-3, registration parameters within 1e-3 and pair shifts
within 1e-5 px.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from multiview_stitcher_torch import fusion as tfusion
from multiview_stitcher_torch import msi_utils as tmsi
from multiview_stitcher_torch import registration as treg
from multiview_stitcher_torch import si_utils as tsi
from multiview_stitcher_torch import stitch as tstitch
from multiview_stitcher_torch.fusion import _core as tcore
from multiview_stitcher_torch.io import ngff_utils as tngff
from multiview_stitcher_torch.io import zarr_backend as tzb
from multiview_stitcher_torch.ops import exact_affine as tea
from multiview_stitcher_torch.ops import phase_correlation as tpc
from multiview_stitcher_torch.ops import translation_fusion as ttf
from multiview_stitcher_torch.parallel import executors as texec
from multiview_stitcher_torch.parallel import mesh as tmesh
from multiview_stitcher_torch.parallel import multihost as tmh
from multiview_stitcher_torch.parallel import pipeline as tpipe
from multiview_stitcher_torch.utils import profiling as tprof
from multiview_stitcher_tpu import fusion as jfusion
from multiview_stitcher_tpu import msi_utils as jmsi
from multiview_stitcher_tpu import registration as jreg
from multiview_stitcher_tpu import sample_data as jsd
from multiview_stitcher_tpu import si_utils as jsi
from multiview_stitcher_tpu.fusion import _core as jcore
from multiview_stitcher_tpu.io import zarr_backend as jzb
from multiview_stitcher_tpu.ops import exact_affine as jea
from multiview_stitcher_tpu.parallel import executors as jexec
from multiview_stitcher_tpu.parallel import mesh as jmesh
from multiview_stitcher_tpu.parallel import multihost as jmh
from multiview_stitcher_tpu.parallel import pipeline as jpipe
from multiview_stitcher_tpu.utils import profiling as jprof

KEY = jsi.DEFAULT_TRANSFORM_KEY
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UINT_COUNTS = 1
F32 = dict(rtol=1e-4, atol=1e-3)
PARAM_SHARDED_ATOL = 1e-8
PARAM_JAX_ATOL = 1e-3
MESH_SIZES = [8, 3]


def cpu_mesh(n):
    return tmesh.Mesh([torch.device("cpu")] * n)


def jax_mesh():
    return jmesh.get_mesh(len(jax.devices()))


@pytest.fixture(autouse=True)
def _empty_caches():
    tcore.clear_device_tile_cache()
    jcore.clear_device_tile_cache()
    yield
    tcore.clear_device_tile_cache()
    jcore.clear_device_tile_cache()


def _grid_arrays(seed, n, tile, step, ndim=2):
    """n x n tiles of uint16 noise (seed ``seed``) at ``step`` px."""
    rng = np.random.default_rng(seed)
    shape = (tile,) * ndim
    out = []
    for iy in range(n):
        for ix in range(n):
            origin = {"y": float(iy * step), "x": float(ix * step)}
            if ndim == 3:
                origin = {"z": 0.0, **origin}
            out.append((rng.integers(0, 1000, shape).astype(np.uint16), origin))
    return out


def _both_sims(arrays, **kw):
    jsims = [jsi.get_sim_from_array(a, translation=o, **kw) for a, o in arrays]
    tsims = [tsi.get_sim_from_array(a, translation=o, **kw) for a, o in arrays]
    return jsims, tsims


def _assert_counts(got, ref):
    assert got.shape == ref.shape
    diff = np.abs(got.astype(np.int64) - ref.astype(np.int64))
    assert diff.max() <= UINT_COUNTS, diff.max()


# ---------------------------------------------------------------------------
# the mesh and the profiling helpers
# ---------------------------------------------------------------------------


def test_mesh_helpers_match_jax():
    mesh = cpu_mesh(3)
    assert mesh.size == 3 and mesh.axis_names == ("data",) and mesh.shape["data"] == 3
    assert mesh.devices == (torch.device("cpu"),) * 3
    assert mesh.distinct_devices == (torch.device("cpu"),)
    jm = jax_mesh()
    assert jm.axis_names == mesh.axis_names
    rng = np.random.default_rng(0)
    arr = rng.random((7, 3)).astype(np.float32)
    for mult in (1, 3, 4, 8):
        for fill in (0.0, -1.0):
            (jp, jn), (tp, tn) = (
                m.pad_to_multiple(arr, mult, fill_value=fill) for m in (jmesh, tmesh)
            )
            np.testing.assert_array_equal(tp, jp)
            assert tn == jn
    # the even split of a padded batch is the reference's shard_map split
    padded, _ = tmesh.pad_to_multiple(arr, 8)
    parts = tmesh.shard_batch(padded, cpu_mesh(8))
    jparts = jmesh.shard_batch(padded, jm)
    for shard in jparts.addressable_shards:
        k = shard.index[0].start // 1
        np.testing.assert_array_equal(parts[k].numpy(), np.asarray(shard.data))
    # an uneven split: contiguous parts in order, the last ones shorter
    assert tmesh.shard_bounds(7, mesh) == [(0, 3), (3, 6), (6, 7)]
    assert [len(p) for p in tmesh.shard_batch(arr, mesh)] == [3, 3, 1]
    reps = tmesh.replicate(torch.from_numpy(arr), mesh)
    assert len(reps) == 3 and reps[0] is reps[1] is reps[2]
    assert tmesh.batch_sharding(mesh).axis_name == "data"
    assert tmesh.replicated_sharding(mesh).axis_name is None
    with pytest.raises(ValueError):
        tmesh.batch_sharding(mesh, "model")
    with pytest.raises(TypeError):
        tmesh.check_mesh(object())


def test_get_mesh_takes_the_cuda_devices():
    if torch.cuda.is_available():
        mesh = tmesh.get_mesh()
        assert mesh.size == torch.cuda.device_count()
        assert all(d.type == "cuda" for d in mesh.devices)
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.get_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.get_mesh(2)


def test_profiling_stage_matches_jax():
    for prof in (jprof, tprof):
        prof.reset_stage_times()
        for _ in range(3):
            with prof.stage("a"):
                pass
        with pytest.raises(ZeroDivisionError):
            with prof.stage("b"):
                1 / 0
    jt, tt = jprof.get_stage_times(), tprof.get_stage_times()
    assert set(jt) == set(tt) == {"a", "b"}
    for k in jt:
        assert set(jt[k]) == set(tt[k]) == {"total_s", "count"}
        assert jt[k]["count"] == tt[k]["count"]
        assert tt[k]["total_s"] >= 0
    tprof.reset_stage_times()
    assert tprof.get_stage_times() == {}


def test_device_trace_and_block_and_time(tmp_path):
    x = torch.arange(1000, dtype=torch.float32)
    with tprof.device_trace(str(tmp_path / "trace")) as prof:
        y = (x * 2).sum()
    assert float(y) == 999000.0
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert trace["traceEvents"]
    assert any(e.key.startswith("aten::") for e in prof.key_averages())
    out, secs = tprof.block_and_time(lambda a: {"s": [a * 3, (a + 1,)]}, x)
    assert secs >= 0 and torch.equal(out["s"][0], x * 3)


def test_register_and_fuse_record_the_jax_stage_names():
    jsims = jsd.generate_tiled_dataset(
        ndim=2, N_c=1, N_t=1, tile_size=30, tiles_x=2, tiles_y=2, overlap=8,
    )
    jsims = [s.isel({"c": 0, "t": 0}) for s in jsims]
    tsims = [
        tsi.get_sim_from_array(s.data, dims=s.dims, scale=s.spacing, translation=s.origin)
        for s in jsims
    ]
    names = {}
    for name, prof, reg, fus, sims, kw in (
        ("jax", jprof, jreg, jfusion, jsims, {}),
        ("port", tprof, treg, tfusion, tsims, {"device": "cpu"}),
    ):
        prof.reset_stage_times()
        reg.register(sims, transform_key=KEY, new_transform_key="r", **kw)
        reg_names = set(prof.get_stage_times())
        prof.reset_stage_times()
        # a geometry no other test fuses, so the JAX plan cache misses
        fus.fuse(sims, transform_key=KEY, output_spacing={"y": 1.25, "x": 1.25}, **kw)
        names[name] = (reg_names, set(prof.get_stage_times()))
    # register() records the JAX package's stages exactly; the port's fuse()
    # adds its host-copy stages (utils.profiling) to the JAX package's
    assert names["port"][0] == names["jax"][0] == {
        "register.adjacency_graph", "register.pairwise_registrations",
        "register.groupwise_resolution",
    }
    assert names["jax"][1] == {"fuse.plan"}
    assert names["port"][1] == names["jax"][1] | {"tiles.upload", "fuse.download"}


# ---------------------------------------------------------------------------
# the cases of tests/test_executors.py
# ---------------------------------------------------------------------------


def _write_tiles(tmp_path, shift=(1.5, -2.0)):
    """Two overlapping tiles of one smoothed scene (seed 0), written as
    OME-Zarr by the port; the second spec's origin is off by ``shift``."""
    rng = np.random.default_rng(0)
    scene = (gaussian_filter(rng.random((80, 150)), 1.2) * 1000).astype(np.uint16)
    t0, t1 = scene[:, :90], scene[:, 60:]
    tspecs, jspecs = [], []
    for i, (tile, x0) in enumerate([(t0, 0.0), (t1, 60.0)]):
        url = str(tmp_path / f"tile{i}.ome.zarr")
        s = tsi.get_sim_from_array(
            tile, dims=("y", "x"), translation={"y": 0.0, "x": x0}, scale={"y": 1.0, "x": 1.0},
        )
        tngff.write_sim_to_ome_zarr(s, url, overwrite=True)
        origin = {"y": 0.0, "x": x0}
        if i == 1:
            origin = {"y": shift[0], "x": x0 + shift[1]}
        tspecs.append(texec.SourceSpec(url=url, origin=origin))
        jspecs.append(jexec.SourceSpec(url=url, origin=origin))
    return scene, tspecs, jspecs


def test_spec_roundtrip(tmp_path):
    _, tspecs, jspecs = _write_tiles(tmp_path)
    js = tspecs[1].to_json()
    assert js == jspecs[1].to_json()
    back = texec.SourceSpec.from_json(js)
    assert back == tspecs[1]
    tsim = tmsi.get_sim_from_msim(back.open_msim())
    jsim = jmsi.get_sim_from_msim(jexec.SourceSpec.from_json(js).open_msim())
    assert tsim.sizes["x"] == jsim.sizes["x"] == 90
    assert tsim.origin == jsim.origin
    np.testing.assert_array_equal(tsim.to_numpy(), np.asarray(jsim.data))
    tspec = texec.RegistrationTaskSpec(tspecs[0], tspecs[1], KEY, {"device": "cpu"})
    assert texec.RegistrationTaskSpec.from_json(tspec.to_json()) == tspec


def test_spec_pairwise_executor(tmp_path):
    """register() with work shipped through JSON specs matches the local
    run, and the JAX package's."""
    shift = (1.5, -2.0)
    _, tspecs, jspecs = _write_tiles(tmp_path, shift)
    tparams = treg.register(
        [s.open_msim() for s in tspecs], transform_key=KEY, device="cpu",
        pairwise_executor=texec.make_spec_pairwise_executor(tspecs),
    )
    local = treg.register([s.open_msim() for s in tspecs], transform_key=KEY, device="cpu")
    jparams = jreg.register(
        [s.open_msim() for s in jspecs], transform_key=KEY,
        pairwise_executor=jexec.make_spec_pairwise_executor(jspecs),
    )
    m = np.asarray(tparams[1].data.squeeze())
    np.testing.assert_allclose(m[:2, 2], [-shift[0], -shift[1]], atol=0.3)
    for t, loc, j in zip(tparams, local, jparams):
        np.testing.assert_allclose(t.data, loc.data, atol=PARAM_SHARDED_ATOL)
        np.testing.assert_allclose(t.data.squeeze(), np.asarray(j.squeeze()), atol=PARAM_JAX_ATOL)


def test_partition_blocks():
    for n, w in ((10, 3), (7, 2), (3, 5), (0, 2), (16, 4)):
        parts = [texec.partition_blocks(n, w, i) for i in range(w)]
        assert parts == [jexec.partition_blocks(n, w, i) for i in range(w)]
        assert sorted(b for p in parts for b in p) == list(range(n))
        for a in range(w):
            for b in range(a + 1, w):
                assert not set(parts[a]) & set(parts[b])


def test_multiworker_streaming_fusion(tmp_path):
    """Two workers fuse disjoint block subsets into one shared store, as the
    JAX package's two workers do."""
    scene, tspecs, jspecs = _write_tiles(tmp_path, shift=(0.0, 0.0))
    outs = {}
    for name, ex, specs, zb, kw in (
        ("port", texec, tspecs, tzb, {"device": "cpu"}),
        ("jax", jexec, jspecs, jzb, {}),
    ):
        url = str(tmp_path / f"fused_{name}.zarr")
        n_done = sum(
            ex.fuse_block_subset(
                specs, url, transform_key=KEY, worker_index=w, n_workers=2,
                output_chunksize=64, create_output=True, **kw,
            )
            for w in range(2)
        )
        assert n_done >= 2
        outs[name] = np.asarray(zb.open_zarr_array(url))
    assert outs["port"].shape == scene.shape
    assert np.median(np.abs(outs["port"].astype(float) - scene.astype(float))) < 5
    _assert_counts(outs["port"], outs["jax"])


@pytest.mark.parametrize("fusion_name", ["weighted_average_fusion", "max_fusion"])
def test_fuse_with_mesh_matches_unsharded(fusion_name, monkeypatch):
    """fuse(mesh=) equals the unsharded fuse bit for bit (the translation
    tier in bands, max_fusion the tiles tier in chunk slices), and the JAX
    package's sharded fuse (its XLA tiles tier) within 1 count; seed 5."""
    monkeypatch.setenv("MVS_TPU_PALLAS", "0")
    jsims, tsims = _both_sims(_grid_arrays(5, 3, 40, 30))
    kw = dict(transform_key=KEY, output_chunksize=32,
              fusion_func=getattr(tfusion, fusion_name))
    ref = tfusion.fuse(tsims, device="cpu", **kw).to_numpy()
    for n in MESH_SIZES:
        out = tfusion.fuse(tsims, mesh=cpu_mesh(n), **kw).to_numpy()
        np.testing.assert_array_equal(out, ref)
    kw["fusion_func"] = getattr(jfusion, fusion_name)
    jout = jfusion.fuse(jsims, mesh=jax_mesh(), **kw).to_numpy()
    _assert_counts(ref, np.asarray(jout))


def _registration_grid():
    sims = jsd.generate_tiled_dataset(
        ndim=2, N_c=1, N_t=1, tile_size=40, tiles_x=3, tiles_y=3,
        overlap=10, zoom=4, shift_scale=1.0, drift_scale=0.0,
    )
    return [s.isel({"c": 0, "t": 0}) for s in sims]


def test_register_with_mesh_matches_unsharded():
    """register(mesh=) splits each pair batch over the mesh: the parameters
    equal the unsharded ones within 1e-8 (from host crops and from the
    resident stack) and the JAX package's within 1e-3."""
    jsims = _registration_grid()
    tsims = [
        tsi.get_sim_from_array(s.data, dims=s.dims, scale=s.spacing, translation=s.origin)
        for s in jsims
    ]

    def run(mesh=None, device_tiles=None):
        kw = {"device": "cpu"} if mesh is None else {}
        tcore.clear_device_tile_cache()
        msims = [tmsi.get_msim_from_sim(s, scale_factors=[]) for s in tsims]
        treg.register(
            msims, transform_key=KEY, new_transform_key="registered",
            pre_registration_pruning_method=None, mesh=mesh, device_tiles=device_tiles, **kw,
        )
        assert treg.last_telemetry["device_tiles"] == bool(device_tiles)
        return np.stack([
            tmsi.get_transform_from_msim(m, "registered").data.squeeze() for m in msims
        ])

    ref = run()
    for n in MESH_SIZES:
        for device_tiles in (None, True):
            np.testing.assert_allclose(
                run(cpu_mesh(n), device_tiles), ref, atol=PARAM_SHARDED_ATOL
            )
    jmsims = [jmsi.get_msim_from_sim(s, scale_factors=[]) for s in jsims]
    jreg.register(
        jmsims, transform_key=KEY, new_transform_key="registered",
        pre_registration_pruning_method=None,
    )
    jref = np.stack([
        np.asarray(jmsi.get_transform_from_msim(m, "registered").squeeze()) for m in jmsims
    ])
    np.testing.assert_allclose(ref, jref, atol=PARAM_JAX_ATOL)


def test_fuse_with_odd_mesh_size(monkeypatch):
    """4 x 4 = 16 chunks of 18 px over a mesh of 3 pad to 18 (seed 6); the
    JAX package's 3-device mesh gives the same within 1 count."""
    from jax.sharding import Mesh as JMesh

    monkeypatch.setenv("MVS_TPU_PALLAS", "0")
    jsims, tsims = _both_sims(_grid_arrays(6, 2, 40, 30))
    for name in ("weighted_average_fusion", "max_fusion"):
        kw = dict(transform_key=KEY, output_chunksize=18)
        ref = tfusion.fuse(tsims, device="cpu", fusion_func=getattr(tfusion, name), **kw)
        out = tfusion.fuse(tsims, mesh=cpu_mesh(3), fusion_func=getattr(tfusion, name), **kw)
        np.testing.assert_array_equal(out.to_numpy(), ref.to_numpy())
        jout = jfusion.fuse(
            jsims, mesh=JMesh(np.array(jax.devices()[:3]), ("data",)),
            fusion_func=getattr(jfusion, name), **kw,
        )
        _assert_counts(ref.to_numpy(), np.asarray(jout.to_numpy()))


def _count_plain_bands(monkeypatch):
    calls = []
    plain = ttf._plain

    def spy(*args, **kwargs):
        calls.append(args[-1].origin)
        return plain(*args, **kwargs)

    monkeypatch.setattr(ttf, "_plain", spy)
    return calls


def test_fuse_with_mesh_pallas_tier(monkeypatch):
    """The translation tier under a mesh: one band of whole view-list tiles
    per mesh entry, each at its integer origin, bit-equal to the unsharded
    call, and within 1 count of the JAX package's band-split Pallas tier
    (seed 9)."""
    jsims, tsims = _both_sims(_grid_arrays(9, 3, 40, 30))
    calls = _count_plain_bands(monkeypatch)
    ref = tfusion.fuse(tsims, transform_key=KEY, device="cpu").to_numpy()
    assert len(calls) == 1
    T0 = ttf.TILE_SHAPE_2D[0]
    for n in MESH_SIZES:
        del calls[:]
        out = tfusion.fuse(tsims, transform_key=KEY, mesh=cpu_mesh(n)).to_numpy()
        np.testing.assert_array_equal(out, ref)
        # one call a mesh entry, bands of b_t0 tiles at rows k * b_t0 * T0
        b_t0 = -(-(-(-ref.shape[0] // T0)) // n)
        assert calls == [(k * b_t0 * T0, 0) for k in range(n)]
    monkeypatch.setenv("MVS_TPU_PALLAS_TILE_2D", "8,128")
    jout = jfusion.fuse(jsims, transform_key=KEY, mesh=jax_mesh()).to_numpy()
    _assert_counts(ref, np.asarray(jout))


def test_fuse_with_mesh_output_on_backend_and_zarr(tmp_path):
    """The bands land in every kind of output: a tensor on the device, and
    a zarr sink written by regions (seed 9)."""
    _, tsims = _both_sims(_grid_arrays(9, 3, 40, 30))
    ref = tfusion.fuse(tsims, transform_key=KEY, device="cpu").to_numpy()
    mesh = cpu_mesh(3)
    dev = tfusion.fuse(tsims, transform_key=KEY, mesh=mesh, output_on_backend=True)
    assert isinstance(dev.data, torch.Tensor)
    np.testing.assert_array_equal(dev.to_numpy(), ref)
    url = str(tmp_path / "out.zarr")
    z = tfusion.fuse(tsims, transform_key=KEY, mesh=mesh, output_zarr_url=url,
                     zarr_options={"ome_zarr": False})
    np.testing.assert_array_equal(np.asarray(z.data), ref)


def test_fuse_with_mesh_3d_bands():
    """3D translation bands (seed 11): 2 x 2 tiles of 20 x 24 x 24 at a z
    depth of several view-list tiles."""
    rng = np.random.default_rng(11)
    arrays = [
        (rng.integers(0, 1000, (40, 24, 24)).astype(np.uint16),
         {"z": float(iz * 20), "y": float(iy * 16), "x": float(ix * 16)})
        for iz in range(2) for iy in range(2) for ix in range(2)
    ]
    jsims, tsims = _both_sims(arrays)
    ref = tfusion.fuse(tsims, transform_key=KEY, device="cpu").to_numpy()
    for n in MESH_SIZES:
        out = tfusion.fuse(tsims, transform_key=KEY, mesh=cpu_mesh(n)).to_numpy()
        np.testing.assert_array_equal(out, ref)
    _assert_counts(ref, np.asarray(jfusion.fuse(jsims, transform_key=KEY).to_numpy()))


def _chunk_batch(rng, C, K, S, out_shape, affine=None):
    ndim = len(S)
    slabs = rng.random((C, K) + tuple(s + 4 for s in S)).astype(np.float32)
    slabs[0, 0, :2] = np.nan
    mats = np.broadcast_to(
        np.eye(ndim, dtype=np.float32) if affine is None else affine, (C, K, ndim, ndim)
    ).copy()
    offs = (rng.random((C, K, ndim)) * 2).astype(np.float32)
    wgrids = rng.random((C, K) + (5,) * ndim).astype(np.float32)
    wmats = np.broadcast_to(
        np.diag([0.25] * ndim).astype(np.float32), (C, K, ndim, ndim)
    ).copy()
    woffs = np.zeros((C, K, ndim), np.float32)
    valid = np.ones((C, K), bool)
    valid[-1, -1] = False
    return slabs, mats, offs, wgrids, wmats, woffs, valid


def test_pipeline_sharded_helpers_match_unsharded():
    """parallel.pipeline's pair and chunk batches (seed 4): sharded equals
    unsharded bit for bit, and JAX within the stated tolerances."""
    rng = np.random.default_rng(4)
    N = 8 * 2
    f = rng.random((N, 32, 32)).astype(np.float32)
    m = np.roll(f, 3, axis=2)
    ref_shifts, ref_peaks = tpc.phase_cross_correlation_batch(
        torch.from_numpy(f), torch.from_numpy(m), 10
    )
    jshifts, _ = jpipe.sharded_pairwise_shifts(f, m, jax_mesh())
    np.testing.assert_allclose(ref_shifts.numpy(), np.asarray(jshifts), atol=1e-5)
    C, K, S = N, 2, (16, 16)
    batch = _chunk_batch(rng, C, K, S, S)
    ref = tcore._fuse_chunk_batch_kernel(*batch, S)
    jref = jcore._fuse_chunk_batch_kernel(*batch, S, "weighted_average", True)
    np.testing.assert_allclose(ref.numpy(), np.asarray(jref), **F32)
    for n in MESH_SIZES:
        shifts, peaks = tpipe.sharded_pairwise_shifts(f, m, cpu_mesh(n))
        assert torch.equal(shifts, ref_shifts) and torch.equal(peaks, ref_peaks)
        fused = tpipe.sharded_fuse_chunks(*batch, S, cpu_mesh(n))
        assert torch.equal(fused, ref)
    jstep = jpipe.register_and_fuse_step(f, m, *batch, S)
    tstep = tpipe.register_and_fuse_step(f, m, *batch, S, device="cpu")
    np.testing.assert_allclose(tstep[0].numpy(), np.asarray(jstep[0]), atol=1e-5)
    np.testing.assert_allclose(tstep[2].numpy(), np.asarray(jstep[2]), **F32)


def test_fuse_with_mesh_pallas_tier_nonunit_scale():
    """Band-split translation fusion at a coarser output spacing (seed 13)
    equals the unsharded result, and JAX's within 1 count."""
    jsims, tsims = _both_sims(_grid_arrays(13, 3, 40, 30))
    spacing = {"y": 2.0, "x": 2.0}
    ref = tfusion.fuse(tsims, transform_key=KEY, output_spacing=spacing, device="cpu")
    for n in MESH_SIZES:
        out = tfusion.fuse(tsims, transform_key=KEY, output_spacing=spacing, mesh=cpu_mesh(n))
        np.testing.assert_array_equal(out.to_numpy(), ref.to_numpy())
    jout = jfusion.fuse(jsims, transform_key=KEY, output_spacing=spacing, mesh=jax_mesh())
    _assert_counts(ref.to_numpy(), np.asarray(jout.to_numpy()))


def _exact_case_2d(rng, C, K):
    th = 0.1
    R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]], np.float32)
    S_in, out_shape = (40, 48), (32, 40)
    slabs = (rng.random((C, K) + S_in) * 500).astype(np.float32)
    mats = np.broadcast_to(R, (C, K, 2, 2)).copy()
    offs = rng.random((C, K, 2)).astype(np.float32) * 3
    extents = np.broadcast_to(np.asarray(S_in, np.float32), (C, K, 2)).copy()
    wgrids = np.ones((C, K, 5, 5), np.float32)
    wmats = np.broadcast_to(np.diag([0.1, 0.1]).astype(np.float32), (C, K, 2, 2)).copy()
    woffs = np.zeros((C, K, 2), np.float32)
    valid = np.ones((C, K), bool)
    return (slabs, mats, offs, extents, wgrids, wmats, woffs, valid), out_shape


def test_sharded_exact_affine_chunks_match_unsharded():
    """sharded_fuse_chunks_exact over the plain version of the 2D exact
    kernel (seed 5): bit-equal to the unsharded batch, and within rtol 1e-4
    / atol 1e-3 of JAX's sharded exact tier in interpret mode."""
    rng = np.random.default_rng(5)
    args, out_shape = _exact_case_2d(rng, 8, 2)
    ref = tcore._fuse_chunk_batch_kernel_exact(
        torch.from_numpy(args[0]), *args[1:], out_shape, kind="2d"
    )
    for n in MESH_SIZES:
        fused = tpipe.sharded_fuse_chunks_exact(*args, out_shape, cpu_mesh(n))
        assert torch.equal(fused, ref)
    jfused = jpipe.sharded_fuse_chunks_exact(*args, out_shape, jax_mesh(), interpret=True)
    np.testing.assert_allclose(ref.numpy(), np.asarray(jfused), **F32)


def test_sharded_exact_coupled_weight_maps_take_general_kernel(monkeypatch):
    """y-decoupled view maps with coupled weight maps take the general
    kernel (seed 7): the y-decoupled one would drop the weight maps'
    coupling terms. Bit-equal to the unsharded general batch, and within
    rtol 1e-4 / atol 1e-3 of JAX's general kernel unsharded, step by step:
    ``exact_affine_batch_3d_general`` of the slabs and of the weight grids,
    then ``_reduce_views`` and ``nan_to_num``. JAX's jitted
    ``_fuse_chunk_batch_kernel_exact`` of the same inputs gives both views
    weight 0 at voxel (11, 11, 13) of each chunk, where its own
    ``exact_affine_batch_3d_general`` gives 0.50 and 0.56, and takes the
    plain average there (up to 93.6 off; ROADMAP.md queue 3)."""
    rng = np.random.default_rng(7)
    C, K = 8, 2
    th = 0.08
    Ry = np.array(
        [[np.cos(th), 0.0, -np.sin(th)], [0.0, 1.0, 0.0], [np.sin(th), 0.0, np.cos(th)]],
        np.float32,
    )
    S_in, out_shape = (16, 24, 24), (12, 16, 32)
    slabs = (rng.random((C, K) + S_in) * 500).astype(np.float32)
    mats = np.broadcast_to(Ry, (C, K, 3, 3)).copy()
    assert tea.is_y_decoupled(mats.reshape(-1, 3, 3))
    offs = rng.random((C, K, 3)).astype(np.float32) * 2
    extents = np.broadcast_to(np.asarray(S_in, np.float32), (C, K, 3)).copy()
    wgrids = rng.random((C, K, 5, 5, 5)).astype(np.float32)
    wm = np.diag([0.3, 0.15, 0.15]).astype(np.float32) + 0.02
    wmats = np.broadcast_to(wm, (C, K, 3, 3)).copy()
    assert not tea.is_y_decoupled(wmats.reshape(-1, 3, 3))
    woffs = np.zeros((C, K, 3), np.float32)
    valid = np.ones((C, K), bool)
    args = (slabs, mats, offs, extents, wgrids, wmats, woffs, valid)

    ref = tcore._fuse_chunk_batch_kernel_exact(
        torch.from_numpy(slabs), *args[1:], out_shape, kind="general"
    )

    def refuse(*a, **k):
        raise AssertionError("the y-decoupled kernel took coupled weight maps")

    monkeypatch.setattr(tea, "exact_affine_batch_3d_sepy", refuse)
    for n in MESH_SIZES:
        assert torch.equal(tpipe.sharded_fuse_chunks_exact(*args, out_shape, cpu_mesh(n)), ref)
    tile = (8, 4, 32)
    BK = C * K

    def jresample(data, m, o, ext, win, cval):
        return np.asarray(jea.exact_affine_batch_3d_general(
            data.reshape((BK,) + data.shape[2:]), m.reshape(BK, 3, 3), o.reshape(BK, 3),
            ext.reshape(BK, 3), out_shape, tile=tile, ZS=win[0], YB=win[1], XS=win[2],
            cval=cval, interpret=True,
        )).reshape((C, K) + out_shape)

    data_t = jresample(slabs, mats, offs, extents,
                       jea.plan_windows_3d_general(mats.reshape(-1, 3, 3), tile), np.nan)
    bw = jresample(wgrids, wmats, woffs, np.full((C, K, 3), 5.0, np.float32),
                   jea.plan_windows_3d_general(wmats.reshape(-1, 3, 3), tile), 0.0)
    jref = np.stack([
        np.nan_to_num(np.asarray(jcore._reduce_views(d, b, out_shape, "weighted_average", True)[0]))
        for d, b in zip(data_t, bw)
    ])
    np.testing.assert_allclose(ref.numpy(), jref, **F32)


# ---------------------------------------------------------------------------
# the cases of tests/test_multihost.py
# ---------------------------------------------------------------------------


_DIST_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


def test_initialize_single_process_noop(monkeypatch):
    for var in _DIST_VARS:
        monkeypatch.delenv(var, raising=False)
    tmh.initialize()  # must not raise or try to contact a coordinator
    assert not torch.distributed.is_initialized()
    assert tmh.process_info() == jmh.process_info() == (0, 1)
    tmh.sync()  # no-op barrier
    assert tmh.partition_for_this_host(7) == jmh.partition_for_this_host(7) == list(range(7))
    with pytest.raises(ValueError, match="process"):
        tmh.initialize(coordinator_address="127.0.0.1:1")


def _write_mh_tiles(tmp_path):
    """Two tiles of uint16 noise (seed 1) written as OME-Zarr by the port."""
    rng = np.random.default_rng(1)
    scene = (rng.random((60, 110)) * 1000).astype(np.uint16)
    t0, t1 = scene[:, :70], scene[:, 40:]
    tspecs, jspecs = [], []
    for i, (tile, x0) in enumerate([(t0, 0.0), (t1, 40.0)]):
        url = str(tmp_path / f"tile{i}.ome.zarr")
        s = tsi.get_sim_from_array(tile, dims=("y", "x"), translation={"y": 0.0, "x": x0})
        tngff.write_sim_to_ome_zarr(s, url, overwrite=True)
        tspecs.append(texec.SourceSpec(url=url, origin={"y": 0.0, "x": x0}))
        jspecs.append(jexec.SourceSpec(url=url, origin={"y": 0.0, "x": x0}))
    return scene, tspecs, jspecs


def test_multihost_fuse_single_process(tmp_path):
    scene, tspecs, jspecs = _write_mh_tiles(tmp_path)
    out_url = str(tmp_path / "fused.zarr")
    tmh.multihost_fuse(tspecs, out_url, KEY, output_chunksize=32, device="cpu")
    out = tzb.open_zarr_array(out_url).read().squeeze()
    assert out.shape == scene.shape
    np.testing.assert_allclose(out[:, :40].astype(int), scene[:, :40].astype(int), atol=1)
    jurl = str(tmp_path / "fused_jax.zarr")
    jmh.multihost_fuse(jspecs, jurl, KEY, output_chunksize=32)
    _assert_counts(out, jzb.open_zarr_array(jurl).read().squeeze())


def test_simulated_two_host_fuse_matches_single(tmp_path, monkeypatch):
    _, tspecs, _ = _write_mh_tiles(tmp_path)
    ref_url = str(tmp_path / "fused_single.zarr")
    tmh.multihost_fuse(tspecs, ref_url, KEY, output_chunksize=32, device="cpu")
    ref = tzb.open_zarr_array(ref_url).read()
    out_url = str(tmp_path / "fused_multi.zarr")
    for pid in range(2):
        monkeypatch.setattr(tmh, "process_info", lambda pid=pid: (pid, 2))
        # host 1 must not re-create (clobber) the store
        tmh.multihost_fuse(tspecs, out_url, KEY, output_chunksize=32, device="cpu")
    np.testing.assert_array_equal(tzb.open_zarr_array(out_url).read(), ref)


_DRIVER = """
import json, sys
sys.path.insert(0, {repo!r})
from multiview_stitcher_torch.parallel import multihost
from multiview_stitcher_torch.parallel.executors import SourceSpec

multihost.initialize()
pid, n = multihost.process_info()
assert n == 2, f"expected 2 processes, got {{n}}"
multihost.sync("test_barrier")
cfg = json.load(open(sys.argv[1]))
specs = [SourceSpec(url=s["url"], origin=s["origin"]) for s in cfg["specs"]]
multihost.multihost_fuse(
    specs, cfg["out_url"], "affine_metadata", output_chunksize=32, device="cpu",
)
print("done", pid)
"""

TWO_PROCESS_TIMEOUT_S = 120


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_real_two_process_fuse_byte_parity(tmp_path):
    """Two processes in one torch.distributed group (gloo on localhost,
    torchrun's variables): barrier, then a disjoint-subset fuse into one
    store, byte-equal to one process. Each process has 120 s."""
    _, tspecs, _ = _write_mh_tiles(tmp_path)
    ref_url = str(tmp_path / "fused_single.zarr")
    tmh.multihost_fuse(tspecs, ref_url, KEY, output_chunksize=32, device="cpu")
    driver = tmp_path / "driver.py"
    driver.write_text(_DRIVER.format(repo=REPO))
    cfg = {
        "specs": [{"url": s.url, "origin": s.origin} for s in tspecs],
        "out_url": str(tmp_path / "fused_mp.zarr"),
    }
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(cfg))
    port = _free_port()
    procs = []
    try:
        for rank in range(2):
            env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                       WORLD_SIZE="2", RANK=str(rank), LOCAL_RANK=str(rank),
                       OMP_NUM_THREADS="1")
            procs.append(subprocess.Popen(
                [sys.executable, str(driver), str(cfg_path)], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
        deadline = time.monotonic() + TWO_PROCESS_TIMEOUT_S
        outputs = [p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0]
                   for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(outputs)
    ref_dir, mp_dir = tmp_path / "fused_single.zarr", tmp_path / "fused_mp.zarr"
    names = sorted(f.name for f in ref_dir.iterdir())
    assert names == sorted(f.name for f in mp_dir.iterdir())
    for name in names:
        assert (ref_dir / name).read_bytes() == (mp_dir / name).read_bytes(), name


def test_stitch_with_mesh_matches_unsharded():
    """stitch(mesh=) passes the mesh to register and fuse: the output and
    the resolved transforms equal the unsharded call's (seed of
    ``generate_tiled_dataset``)."""
    jsims = _registration_grid()

    def port_sims():
        return [
            tsi.get_sim_from_array(s.data, dims=s.dims, scale=s.spacing, translation=s.origin)
            for s in jsims
        ]

    ref = tstitch.stitch(port_sims(), device="cpu")
    out = tstitch.stitch(port_sims(), mesh=cpu_mesh(3))
    np.testing.assert_array_equal(out.to_numpy(), ref.to_numpy())
