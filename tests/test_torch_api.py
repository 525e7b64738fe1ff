"""The public API of the port's modules, held to the JAX package on the CPU.

The parity test finds, for every module of the port that has a counterpart
in the JAX package, each public function and class that the JAX module
defines, with the same parameters in the same order: the port may add
``device``, and the extra parameters listed in ``EXTRA_PARAMS``. Names left
out on purpose are listed in ``LEFT_OUT`` with the ROADMAP item that covers
them. The other tests hold each name that the API slice ported to its JAX
counterpart: bit for bit where the code is the same numpy, at the stated
tolerance elsewhere, and block-wise fusion within 1 count, the JAX
package's own tolerance for it (a block's float origin can flip an integer
rounding).
"""

from __future__ import annotations

import importlib
import inspect
import itertools
import json
import logging
import math
import pkgutil

import numpy as np
import pytest
import torch

import multiview_stitcher_torch as tpkg
import multiview_stitcher_tpu as jpkg
from multiview_stitcher_torch import fusion as tfusion
from multiview_stitcher_torch import msi_utils as tmsi
from multiview_stitcher_torch import mv_graph as tmv
from multiview_stitcher_torch import param_utils as tpu
from multiview_stitcher_torch import registration as treg
from multiview_stitcher_torch import sample_data as tsd
from multiview_stitcher_torch import si_utils as tsi
from multiview_stitcher_torch import transforms as ttr
from multiview_stitcher_torch import zarr_utils as tzu
from multiview_stitcher_torch.fusion import _core as tcore
from multiview_stitcher_torch.io import ngff_utils as tngff
from multiview_stitcher_torch.io import zarr_backend as tzb
from multiview_stitcher_torch.parallel.mesh import Mesh
from multiview_stitcher_torch.utils import misc as tmisc
from multiview_stitcher_tpu import fusion as jfusion
from multiview_stitcher_tpu import msi_utils as jmsi
from multiview_stitcher_tpu import mv_graph as jmv
from multiview_stitcher_tpu import param_utils as jpu
from multiview_stitcher_tpu import registration as jreg
from multiview_stitcher_tpu import sample_data as jsd
from multiview_stitcher_tpu import si_utils as jsi
from multiview_stitcher_tpu import transforms as jtr
from multiview_stitcher_tpu import zarr_utils as jzu
from multiview_stitcher_tpu.io import ngff_utils as jngff
from multiview_stitcher_tpu.io import zarr_backend as jzb
from multiview_stitcher_tpu.utils import misc as jmisc

KEY = jsi.DEFAULT_TRANSFORM_KEY

# every module of the port with a counterpart of the same name in the JAX
# package (the port's own modules: convert, ops._build, ops.candidate_scoring,
# ops.pyramid, ops.translation_fusion, residency)
PORTED_MODULES = [
    "", "convert", "detection", "fusion", "fusion._core", "fusion._streaming",
    "fusion.mv_deconv", "io", "io.codecs", "io.czi_utils", "io.fallback", "io.imaris_utils",
    "io.jpeg", "io.ngff_utils", "io.tif_utils", "io.virtual_ngff", "io.zarr_backend", "metrics",
    "msi_utils", "mv_graph", "neuroglancer", "ops", "ops.candidate_scoring", "ops.exact_affine",
    "ops.filters",
    "ops.image_metrics", "ops.link_codec", "ops.phase_correlation", "ops.resample", "ops.shear",
    "parallel", "parallel.executors", "parallel.mesh", "parallel.multihost",
    "parallel.pipeline", "param_resolution",
    "param_resolution.global_optimization", "param_resolution.linear_two_pass",
    "param_resolution.shortest_paths", "param_resolution.utils", "param_utils",
    "registration", "registration_plugins", "residency", "sample_data", "service",
    "service.bridge", "service.session", "service.specs", "service.worker", "si_utils", "stitch",
    "transformation", "transforms", "utils", "utils.misc", "utils.profiling", "vis_utils",
    "weights", "zarr_utils",
]
PORT_ONLY = {"convert", "ops._build", "ops.candidate_scoring", "ops.pyramid",
             "ops.translation_fusion", "residency"}

# public names of the JAX modules the port leaves out, with the item that
# covers them
LEFT_OUT = {
    "io.zarr_backend": {"LazyTSArray": "item 28 leaves tensorstore out"},
    "ops.exact_affine": {
        "plan_windows_2d": "item 28 leaves ops internals out",
        "plan_windows_3d": "item 28 leaves ops internals out",
        "plan_windows_3d_general": "item 28 leaves ops internals out",
    },
}
# JAX parameters the port leaves out (item 28: ops internals; item 12: the
# TPU's VMEM windows and output tile, and Pallas's interpret mode, which the
# CUDA kernels do not take: they stage their own windows)
PARAMS_LEFT_OUT = {
    ("parallel.pipeline", "sharded_fuse_chunks_exact"): {"win", "wwin", "tile", "interpret"},
}
# JAX defaults the port does not share, with the reason
DEFAULTS_CHANGED = {
    # a new directory under the temporary directory, not a fixed path
    ("utils.profiling", "device_trace", "log_dir"): None,
}
# parameters the port adds besides ``device``: batched ops take the number
# of spatial dims (the rest are batch dims), and a few functions take what
# their callers in the port hand them
EXTRA_PARAMS = {
    ("io.ngff_utils", "finalize_ome_zarr_levels"): {"time_transform", "channel_windows"},
    ("io.zarr_backend", "create_zarr_array"): {"dimension_separator"},
    ("registration", "compute_pairwise_registrations"): {"telemetry"},
    ("weights", "normalize_weights"): {"dim"},
}
OPS_EXTRA = {"ndim"}


def _module(pkg, name):
    return importlib.import_module(pkg.__name__ + ("." + name if name else ""))


def _params(obj):
    sig = inspect.signature(obj.__init__ if inspect.isclass(obj) else obj)
    return sig.parameters


def test_every_port_module_with_a_counterpart_is_checked():
    found = set()
    for m in pkgutil.walk_packages(tpkg.__path__, tpkg.__name__ + "."):
        found.add(m.name[len(tpkg.__name__) + 1:])
    assert found - PORT_ONLY == set(PORTED_MODULES) - {""} - PORT_ONLY


@pytest.mark.parametrize("name", PORTED_MODULES)
def test_public_api_matches_jax(name):
    pm = _module(tpkg, name)
    if name in PORT_ONLY:
        with pytest.raises(ModuleNotFoundError):
            _module(jpkg, name)
        return
    jm = _module(jpkg, name)
    left_out = LEFT_OUT.get(name, {})
    for attr, jobj in vars(jm).items():
        if attr.startswith("_") or not (inspect.isfunction(jobj) or inspect.isclass(jobj)):
            continue
        if getattr(jobj, "__module__", None) != jm.__name__:
            continue
        if attr in left_out:
            assert not hasattr(pm, attr), (name, attr, "is ported: take it off LEFT_OUT")
            continue
        assert hasattr(pm, attr), f"{name}.{attr} is missing in the port"
        pobj = getattr(pm, attr)
        assert inspect.isclass(pobj) == inspect.isclass(jobj), (name, attr)
        jp, pp = _params(jobj), _params(pobj)
        extra = {"device"} | EXTRA_PARAMS.get((name, attr), set())
        if name.startswith("ops."):
            extra |= OPS_EXTRA
        extra -= set(jp)  # a parameter JAX has too is held, whatever its name
        dropped = PARAMS_LEFT_OUT.get((name, attr), set())
        want = [p for p in jp if p not in dropped]
        got = [p for p in pp if p not in extra]
        assert got == want, f"{name}.{attr}: port {list(pp)}, JAX {list(jp)}"
        for p in want:
            assert pp[p].kind == jp[p].kind, (name, attr, p)
            jd, pd = jp[p].default, pp[p].default
            if (name, attr, p) in DEFAULTS_CHANGED:
                assert pd == DEFAULTS_CHANGED[(name, attr, p)], (name, attr, p, pd)
            elif isinstance(jd, (type(None), bool, int, float, str)):
                same_nan = isinstance(jd, float) and math.isnan(jd) and math.isnan(pd)
                assert pd == jd or same_nan, (name, attr, p, pd, jd)


def test_package_all_and_aliases():
    assert tpkg.__all__ == jpkg.__all__
    for m in tpkg.__all__:
        importlib.import_module(f"{tpkg.__name__}.{m}")
    assert tpkg.spatial_image_utils is tsi
    assert tpkg.ngff_utils is tngff
    assert tpkg.misc_utils is tmisc
    for reader in ("tif_utils", "czi_utils", "imaris_utils"):
        assert getattr(tpkg, reader) is importlib.import_module(f"{tpkg.__name__}.io.{reader}")
        assert getattr(jpkg, reader).__name__ == f"{jpkg.__name__}.io.{reader}"
    with pytest.raises(AttributeError):
        tpkg.not_a_module  # noqa: B018
    # the virtual stores are reached from io.ngff_utils, as in JAX
    for name, jname in (("VirtualOMEZarr", "VirtualOMEZarr"),
                        ("VirtualOMEZarrPlate", "VirtualOMEZarrPlate"),
                        ("VirtualOMEZarrHCSPlate", "VirtualOMEZarrPlate"),
                        ("VirtualOMEZarrServer", "VirtualOMEZarrServer")):
        assert getattr(tngff, name).__name__ == getattr(jngff, name).__name__ == jname
        assert getattr(tngff, name).__module__ == f"{tpkg.__name__}.io.virtual_ngff"
    with pytest.raises(AttributeError):
        tngff.VirtualOMEZarrNope  # noqa: B018


def test_fusion_package_exports_match_jax():
    exported = {k for k, v in vars(jfusion).items() if callable(v) and not k.startswith("_")}
    assert exported <= set(vars(tfusion))


def _imported_modules(module) -> set:
    """The package modules that ``module``'s source imports, anywhere in it."""
    import ast

    tree = ast.parse(inspect.getsource(module))
    found = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            found.add(node.module)
            found |= {f"{node.module}.{a.name}" for a in node.names}
    return {m for m in found if m.startswith(tpkg.__name__ + ".")}


def test_residency_sits_below_fusion_and_registration():
    """``residency`` holds the views' residency and host copies for fusion
    and registration: it imports neither, and registration reaches the tile
    cache through it, not through ``fusion._core``."""
    from multiview_stitcher_torch import residency

    pkg = tpkg.__name__
    below = _imported_modules(residency)
    assert not {m for m in below if m.startswith(f"{pkg}.fusion")}, below
    assert f"{pkg}.registration" not in below
    assert f"{pkg}.residency" in _imported_modules(treg)
    assert f"{pkg}.fusion._core" not in _imported_modules(treg)


# ---------------------------------------------------------------------------
# utils.misc
# ---------------------------------------------------------------------------


def test_threshold_otsu_matches_jax():
    rng = np.random.default_rng(0)
    samples = [
        np.concatenate([rng.normal(0, 1, 500), rng.normal(6, 2, 300), [np.nan, np.inf]]),
        np.full(7, 3.0), np.array([]), rng.integers(0, 5, 100),
    ]
    for v in samples:
        assert tmisc.threshold_otsu(v) == jmisc.threshold_otsu(v)
    assert tmisc.threshold_otsu(samples[0], nbins=17) == jmisc.threshold_otsu(samples[0], nbins=17)


@pytest.mark.parametrize("nblocks,batch", [((2, 3), 4), ((1, 2, 2), 1), ((3,), 10)])
def test_ndindex_batches_match_jax(nblocks, batch):
    got = list(tmisc.ndindex_batches(nblocks, batch))
    assert got == list(jmisc.ndindex_batches(nblocks, batch))


def test_batch_executors_match_jax():
    batch = [0.0, 1.0, 4.0, 9.0]
    want = jmisc.process_batch_sequential(math.sqrt, batch)
    assert tmisc.process_batch_sequential(math.sqrt, batch) == want
    assert tmisc.process_batch_using_threads(math.sqrt, batch, n_workers=3) == want
    assert tmisc.process_batch_using_processes(math.sqrt, batch, n_workers=2) == want
    assert tmisc.supports_process_scheduler() == jmisc.supports_process_scheduler()
    for fname, kwargs in (
        ("process_batch_using_joblib", {"n_workers": 1}),
        ("process_batch_using_ray", {}),
        ("process_batch_using_dask", {"scheduler": "sync"}),
    ):
        try:
            ref = getattr(jmisc, fname)(math.sqrt, batch, **kwargs)
        except ImportError as e:
            with pytest.raises(ImportError, match=str(e)):
                getattr(tmisc, fname)(math.sqrt, batch, **kwargs)
        else:
            assert getattr(tmisc, fname)(math.sqrt, batch, **kwargs) == ref


def test_logging_helpers_and_shrinkage_declaration_match_jax():
    logger = logging.getLogger("mvs-torch-api-test")
    logger.setLevel(logging.INFO)
    for m in (tmisc, jmisc):
        with m.temporary_log_level(logger, logging.ERROR) as lg:
            assert lg is logger and logger.level == logging.ERROR
        assert logger.level == logging.INFO
        with m.DisableLogger():
            assert logging.root.manager.disable == logging.CRITICAL
        assert logging.root.manager.disable == logging.NOTSET

        @m.requires_source_shrinkage(lambda kw: kw.get("s", 2) * 3)
        def f(x):
            return x

        @m.requires_source_shrinkage({"y": 1})
        def g(x):
            return x

        assert m.get_required_source_shrinkage(f, {"s": 4}) == 12
        assert m.get_required_source_shrinkage(g, {}) == {"y": 1}
    assert tmisc.clear_cupy_memory() is None and jmisc.clear_cupy_memory() is None


# ---------------------------------------------------------------------------
# param_utils and transforms (the same numpy: bit for bit)
# ---------------------------------------------------------------------------


def test_affine_helpers_match_jax():
    rng = np.random.default_rng(1)
    for ndim in (2, 3):
        m = np.eye(ndim + 1)
        m[:ndim] = rng.normal(size=(ndim, ndim + 1))
        lin = jpu.linear_affine_from_affine(m)
        np.testing.assert_array_equal(tpu.linear_affine_from_affine(m), lin)
        np.testing.assert_array_equal(tpu.affine_from_linear_affine(lin),
                                      jpu.affine_from_linear_affine(lin))
        for f in ("translation_from_affine", "invert_coordinate_order"):
            np.testing.assert_array_equal(getattr(tpu, f)(m), getattr(jpu, f)(m))
        assert tpu.get_spatial_dims_from_params(m) == jpu.get_spatial_dims_from_params(m)
    for point in (None, [1.0, -2.0, 3.5]):
        np.testing.assert_array_equal(
            tpu.affine_from_rotation(0.3, [0.2, 0.5, 0.8], point),
            jpu.affine_from_rotation(0.3, [0.2, 0.5, 0.8], point),
        )


def test_xparams_algebra_matches_jax():
    rng = np.random.default_rng(2)
    a = rng.normal(size=(3, 4, 4)) + 3 * np.eye(4)
    b = rng.normal(size=(4, 4)) + 3 * np.eye(4)
    ta = tpu.XAffine(a, t_coords=[0, 1, 2])
    tb = tpu.XAffine(a[:2], t_coords=[2, 0])
    ja = jpu.XAffine(a, t_coords=[0, 1, 2])
    jb = jpu.XAffine(a[:2], t_coords=[2, 0])
    for tx, ty, jx, jy in ((ta, b, ja, b), (b, ta, b, ja), (ta, tb, ja, jb), (b, b, b, b)):
        got, ref = tpu.matmul_xparams(tx, ty), jpu.matmul_xparams(jx, jy)
        np.testing.assert_array_equal(got.data, ref.data)
        np.testing.assert_array_equal(
            np.asarray(got.t_coords if got.t_coords is not None else []),
            np.asarray(ref.t_coords if ref.t_coords is not None else []),
        )
    for tx, jx in ((ta, ja), (b, b)):
        got, ref = tpu.invert_xparams(tx), jpu.invert_xparams(jx)
        np.testing.assert_array_equal(got.data, ref.data)


@pytest.mark.parametrize("ndim", [2, 3])
def test_random_helpers_match_jax_under_one_seed(ndim):
    draws = []
    for m in (tpu, jpu):
        np.random.seed(17)
        draws.append([
            m.random_scale(ndim), m.random_scale(ndim, 0.3), m.random_translation(ndim),
            m.random_translation(ndim, 4), np.atleast_1d(m.random_rotation(ndim)),
            m.random_affine(ndim), m.random_affine(ndim, 5, 0.2, 0.05),
        ])
    for got, ref in zip(*draws):
        np.testing.assert_array_equal(got, ref)
    with pytest.raises(NotImplementedError):
        tpu.random_affine(4)


@pytest.mark.parametrize("cls", ["TranslationTransform", "EuclideanTransform",
                                 "SimilarityTransform", "AffineTransform"])
@pytest.mark.parametrize("ndim", [2, 3])
def test_transform_classes_match_jax(cls, ndim):
    rng = np.random.default_rng(3)
    src = rng.normal(size=(20, ndim)) * 10
    dst = src @ (np.eye(ndim) + 0.05 * rng.normal(size=(ndim, ndim))).T + rng.normal(size=ndim)
    dst += 0.01 * rng.normal(size=dst.shape)
    t, j = getattr(ttr, cls)(dimensionality=ndim), getattr(jtr, cls)(dimensionality=ndim)
    np.testing.assert_array_equal(t.params, j.params)
    assert t.estimate(src, dst) == j.estimate(src, dst)
    np.testing.assert_array_equal(t.params, j.params)
    np.testing.assert_array_equal(t(src), j(src))
    np.testing.assert_array_equal(t.residuals(src, dst), j.residuals(src, dst))
    np.testing.assert_array_equal(t.inverse.params, j.inverse.params)
    assert type(t.inverse) is type(t)
    # a degenerate fit leaves the params as they were, in both
    flat = np.zeros((5, ndim))
    assert t.estimate(flat, flat) == j.estimate(flat, flat)
    np.testing.assert_array_equal(t.params, j.params)


# ---------------------------------------------------------------------------
# sample data, si_utils, msi_utils, zarr_utils
# ---------------------------------------------------------------------------

GRIDS = {
    "2d": dict(ndim=2, N_t=2, N_c=2, tile_size=24, tiles_x=2, tiles_y=2, overlap=6),
    "3d": dict(ndim=3, N_t=1, N_c=1, tile_size=16, tiles_x=2, tiles_y=1, tiles_z=2,
               overlap=4, zoom=3, dtype=np.float32),
    "random": dict(ndim=2, N_t=1, N_c=3, tile_size=10, random_data=True, dtype=np.uint8),
}


def _both(**kwargs):
    return jsd.generate_tiled_dataset(**kwargs), tsd.generate_tiled_dataset(**kwargs)


def _assert_sims_equal(j, t):
    assert tuple(j.dims) == t.dims and j.spacing == t.spacing and j.origin == t.origin
    np.testing.assert_array_equal(np.asarray(j.data), t.to_numpy())
    assert np.asarray(j.data).dtype == t.to_numpy().dtype
    assert sorted(j.coords) == sorted(t.coords)
    for k in j.coords:
        np.testing.assert_array_equal(np.asarray(j.coords[k]), np.asarray(t.coords[k]))
    assert list(j.transforms) == list(t.transforms)
    for k in j.transforms:
        np.testing.assert_array_equal(j.transforms[k].data, t.transforms[k].data)


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_generate_tiled_dataset_matches_jax_bit_for_bit(grid):
    jsims, tsims = _both(**GRIDS[grid])
    assert len(jsims) == len(tsims)
    for j, t in zip(jsims, tsims):
        _assert_sims_equal(j, t)


def test_mosaic_sample_path_behaves_as_in_jax():
    try:
        jsd.get_mosaic_sample_data_path()
    except FileNotFoundError:
        with pytest.raises(FileNotFoundError, match="mosaic_test.czi"):
            tsd.get_mosaic_sample_data_path()
    else:
        try:
            path = tsd.get_mosaic_sample_data_path()
        except FileNotFoundError:
            return
        assert path.name == "mosaic_test.czi" and path.exists()


def test_sim_accessors_match_jax():
    jsims, tsims = _both(**GRIDS["3d"])
    j, t = jsims[1], tsims[1]
    assert tsi.get_dims_from_sim(t) == jsi.get_dims_from_sim(j)
    assert tsi.get_extent_from_sim(t) == jsi.get_extent_from_sim(j)
    assert tsi.get_tranform_keys_from_sim(t) == jsi.get_tranform_keys_from_sim(j)
    np.testing.assert_array_equal(tsi.get_center_of_sim(t), jsi.get_center_of_sim(j))
    aff = jpu.random_affine(3)
    for m, s in ((jsi, j), (tsi, t)):
        m.set_sim_affine(s, aff, transform_key="moved")
        m.set_sim_affine(s, np.diag([2.0, 1, 1, 1]), transform_key="rebased",
                         base_transform_key="moved")
    np.testing.assert_array_equal(tsi.get_center_of_sim(t, "rebased"),
                                  jsi.get_center_of_sim(j, "rebased"))
    np.testing.assert_array_equal(t.transforms["rebased"].data, j.transforms["rebased"].data)


def test_sim_fields_and_projection_match_jax():
    jsims, tsims = _both(**GRIDS["2d"])
    j, t = jsims[0], tsims[0]
    _assert_sims_equal(jsi.get_sim_field(j), tsi.get_sim_field(t))
    sel = {"c": "channel 1", "t": 1}
    _assert_sims_equal(jsi.get_sim_field(j, sel), tsi.get_sim_field(t, sel))
    field = tsi.get_sim_field(t)
    assert tsi.get_sim_field(field) is field

    def double(x, k=2):
        return x * k

    _assert_sims_equal(jsi.process_fields(j, double, k=3), tsi.process_fields(t, double, k=3))
    with pytest.raises(ValueError, match="same-shape"):
        tsi.process_fields(t, lambda x: x[1:])

    jsims3, tsims3 = _both(**GRIDS["3d"])
    over_t = np.stack([jpu.random_affine(3)])
    jsi.set_sim_affine(jsims3[0], jpu.XAffine(over_t, t_coords=[0]), transform_key="over_t")
    tsi.set_sim_affine(tsims3[0], tpu.XAffine(over_t, t_coords=[0]), transform_key="over_t")
    for dim in ("z", "x"):
        _assert_sims_equal(jsi.max_project_sim(jsims3[0], dim), tsi.max_project_sim(tsims3[0], dim))
        _assert_sims_equal(jsi.max_project_sim(j, "y"), tsi.max_project_sim(t, "y"))


@pytest.mark.parametrize("dtype", [np.uint16, np.uint8, np.float32])
def test_max_project_sim_of_a_tensor_matches_numpy(dtype):
    rng = np.random.default_rng(4)
    data = (rng.random((2, 5, 6, 7)) * 200).astype(dtype)
    if data.dtype.kind == "f":
        data[0, :, 1, 2] = np.nan
        data[1, 2, 3, 4] = np.nan
    sim = tsi.get_sim_from_array(data, dims=("c", "z", "y", "x"))
    ref = tsi.max_project_sim(sim, "z")
    got = tsi.max_project_sim(sim.copy(data=torch.from_numpy(data)), "z")
    assert isinstance(got.data, torch.Tensor) and got.data.dtype == torch.from_numpy(data).dtype
    np.testing.assert_array_equal(got.to_numpy(), ref.data)
    assert got.dims == ref.dims and got.spacing == ref.spacing


def test_zarr_backed_sim_serialization_matches_jax(tmp_path):
    jsims, tsims = _both(**GRIDS["2d"])
    data = tsims[0].to_numpy()
    url = str(tmp_path / "tile.zarr")
    arr = tzb.create_zarr_array(url, shape=data.shape, chunks=(1, 1, 16, 16), dtype=data.dtype)
    arr[...] = data
    jarr = jzb.open_zarr_array(url)
    tsim = tsi.get_sim_from_array(
        tzb.open_zarr_array(url), dims=tsims[0].dims, scale=tsims[0].spacing,
        translation=tsims[0].origin, c_coords=tsims[0].coords["c"], t_coords=[3, 5],
    )
    jsim = jsi.get_sim_from_array(
        jarr, dims=jsims[0].dims, scale=jsims[0].spacing, translation=jsims[0].origin,
        c_coords=jsims[0].coords["c"], t_coords=[3, 5],
    )
    aff = np.stack([jpu.random_affine(2)] * 2)
    tsi.set_sim_affine(tsim, tpu.XAffine(aff, t_coords=[3, 5]), transform_key="registered")
    jsi.set_sim_affine(jsim, jpu.XAffine(aff, t_coords=[3, 5]), transform_key="registered")
    tpay = json.loads(json.dumps(tsi.serialize_zarr_backed_sim(tsim)))
    jpay = json.loads(json.dumps(jsi.serialize_zarr_backed_sim(jsim)))
    assert set(tpay) - {"zarr_spec"} == set(jpay) - {"ts_spec"}
    for k in jpay:
        if k != "ts_spec":
            assert tpay[k] == jpay[k], k
    back = tsi.deserialize_zarr_backed_sim(tpay)
    assert isinstance(back.data, tzb.LazyZarrArray)
    _assert_sims_equal(jsi.deserialize_zarr_backed_sim(jpay), back)
    # a view of a larger array keeps its window
    view = tsi.sim_sel_coords(tsim, {"c": "channel 1", "y": slice(2.0, 8.0)})
    vback = tsi.deserialize_zarr_backed_sim(tsi.serialize_zarr_backed_sim(view))
    _assert_sims_equal(view, vback)
    np.testing.assert_array_equal(vback.to_numpy(), data[1, :, 4:17])
    with pytest.raises(ValueError, match="zarr-backed"):
        tsi.serialize_zarr_backed_sim(tsims[0])


def test_msi_and_zarr_utils_names_match_jax():
    jsims, tsims = _both(**GRIDS["2d"])
    jm, tm = jmsi.get_msim_from_sim(jsims[0]), tmsi.get_msim_from_sim(tsims[0])
    for jd, td in ((jm, tm), (jsims[0], tsims[0]), (jsims[0].transforms, tsims[0].transforms)):
        got = tmsi.get_transforms_from_dataset_as_dict(td)
        ref = jmsi.get_transforms_from_dataset_as_dict(jd)
        assert list(got) == list(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k].data, ref[k].data)
    with pytest.raises(TypeError):
        tmsi.get_transforms_from_dataset_as_dict(3)
    shapes = [[(2, 3), (4, 3)], [(2, 3), (2, 5)], [(2, 3, 4), (2, 3, 4)], []]
    for ss in shapes:
        arrays = [np.zeros(s) for s in ss]
        for axis in (0, 1):
            assert (tzu.is_chunk_aligned_concatenate(arrays, axis)
                    == jzu.is_chunk_aligned_concatenate(arrays, axis))


# ---------------------------------------------------------------------------
# mv_graph
# ---------------------------------------------------------------------------


def test_stack_props_helpers_match_jax():
    jsims, tsims = _both(**GRIDS["3d"])
    aff = jpu.random_affine(3, translation_scale=4, rotation_scale=0.4)
    for m, sims in ((jsi, jsims), (tsi, tsims)):
        m.set_sim_affine(sims[1], aff, transform_key="moved")
    jp = [jsi.get_stack_properties_from_sim(s, transform_key=KEY) for s in jsims]
    tp = [tsi.get_stack_properties_from_sim(s, transform_key=KEY) for s in tsims]
    assert tmv.get_ndim_from_stack_props(tp[0]) == jmv.get_ndim_from_stack_props(jp[0])
    bb = {k: tp[0][k] for k in ("shape", "spacing", "origin")}
    assert tmv.project_bb_along_dim(bb, "y") == jmv.project_bb_along_dim(bb, "y")
    tfar = dict(tp[1], origin={"z": 1e4, "y": 0.0, "x": 0.0})
    jfar = dict(jp[1], origin={"z": 1e4, "y": 0.0, "x": 0.0})
    for (ta, tb), (ja, jb) in (((tp[0], tp[1]), (jp[0], jp[1])), ((tp[0], tfar), (jp[0], jfar))):
        assert tmv.strack_props_are_far_apart(ta, tb) == jmv.strack_props_are_far_apart(ja, jb)
    assert not tmv.strack_props_are_far_apart(tp[0], tp[1])
    assert tmv.strack_props_are_far_apart(tp[0], tfar)
    for key in (KEY, "moved"):
        for i in range(1, len(tsims)):
            assert (tmv.sims_are_far_apart(tsims[0], tsims[i], KEY)
                    == jmv.sims_are_far_apart(jsims[0], jsims[i], KEY))
    rng = np.random.default_rng(5)
    pts = rng.random((200, 3)) * np.array([80.0, 10.0, 20.0]) - 5
    for key in (KEY, "moved"):
        np.testing.assert_array_equal(
            tmv.points_inside_sim(pts, tsims[1], key), jmv.points_inside_sim(pts, jsims[1], key)
        )


def test_transform_halfspace_matches_jax():
    jsims, tsims = _both(**GRIDS["3d"])
    jp = [jsi.get_stack_properties_from_sim(s, transform_key=KEY) for s in jsims]
    tp = [tsi.get_stack_properties_from_sim(s, transform_key=KEY) for s in tsims]
    aff = jpu.random_affine(3, rotation_scale=0.3)
    _, jh = jmv.get_overlap_between_pair_of_stack_props(jp[0], jp[1])
    _, th = tmv.get_overlap_between_pair_of_stack_props(tp[0], tp[1])
    got, ref = tmv.transform_halfspace(th, aff), jmv.transform_halfspace(jh, aff)
    np.testing.assert_array_equal(got.halfspaces, ref.halfspaces)
    np.testing.assert_array_equal(got.interior_point, ref.interior_point)
    np.testing.assert_allclose(np.sort(got.intersections, axis=0),
                               np.sort(ref.intersections, axis=0), rtol=0, atol=1e-9)


@pytest.mark.parametrize("n_colors", [2, 3])
def test_greedy_colors_match_jax(n_colors):
    kw = dict(ndim=2, N_t=1, N_c=1, tile_size=16, tiles_x=3, tiles_y=3, overlap=4)
    jsims, tsims = _both(**kw)
    jf = [jsi.get_sim_field(s) for s in jsims]
    tf_ = [tsi.get_sim_field(s) for s in tsims]
    ref = jmv.get_greedy_colors(jf, n_colors=n_colors, transform_key=KEY)
    got = tmv.get_greedy_colors(tf_, n_colors=n_colors, transform_key=KEY)
    assert got == ref and list(got) == list(ref)


def test_graph_edge_and_node_helpers_match_jax():
    import networkx as nx

    jg, tg = nx.Graph(), tmv.Graph()
    for g, pu in ((jg, jpu), (tg, tpu)):
        g.add_node(0, stack_props={"a": 1})
        g.add_node(1)
        g.add_node(2, stack_props={"a": 3})
        g.add_edge(0, 1, transform=pu.XAffine(np.eye(3)), quality=0.5)
        g.add_edge(1, 2, transform=np.eye(3) * 2)
        g.add_edge(0, 2, quality=0.1)
    assert (tmv.get_nodes_dataset_from_graph(tg, "stack_props")
            == jmv.get_nodes_dataset_from_graph(jg, "stack_props"))
    got, ref = tmv.compute_graph_edges(tg), jmv.compute_graph_edges(jg)
    assert got is not tg and list(got.edges) == list(ref.edges)
    for e in ref.edges:
        assert set(got.edges[e]) == set(ref.edges[e])
        if "transform" in ref.edges[e]:
            g, r = got.edges[e]["transform"], ref.edges[e]["transform"]
            assert type(g).__name__ == type(r).__name__
            np.testing.assert_array_equal(getattr(g, "data", g), getattr(r, "data", r))


# ---------------------------------------------------------------------------
# registration, param_resolution
# ---------------------------------------------------------------------------


def test_link_quality_metric_matches_jax():
    rng = np.random.default_rng(6)
    a = rng.random((12, 14))
    b = a + 0.3 * rng.random((12, 14))
    b[2:4] = 0.5  # ties
    for x, y in ((a, b), (a, -b), (np.ones((4, 4)), a[:4, :4])):
        ref = jreg.link_quality_metric_func(x, y)
        got = treg.link_quality_metric_func(x, y, device="cpu")
        if np.isnan(ref):
            assert np.isnan(got)
        else:
            assert abs(got - ref) <= 1e-6, (got, ref)


def test_compute_pairwise_registrations_refuses_a_mesh():
    """Anything but a ``parallel.mesh.Mesh`` is refused (TypeError); a CPU
    mesh gives the unsharded pairs, within 1e-8."""
    with pytest.raises(TypeError, match="Mesh"):
        treg.compute_pairwise_registrations([], tmv.Graph(), mesh=object(), device="cpu")
    _, tsims = _both(**_SMALL)
    msims = [tmsi.get_msim_from_sim(s.isel({"c": 0, "t": 0}), scale_factors=[]) for s in tsims]
    g = tmv.build_view_adjacency_graph_from_msims(msims, transform_key=KEY)
    ref = treg.compute_pairwise_registrations(msims, g, transform_key=KEY, device="cpu")
    got = treg.compute_pairwise_registrations(
        msims, g, transform_key=KEY, mesh=Mesh([torch.device("cpu")] * 3)
    )
    for (a, b, e) in ref.edges(data=True):
        np.testing.assert_allclose(
            got.edges[a, b]["transform"].data, e["transform"].data, atol=1e-8
        )


def test_compute_edge_residuals_takes_ndim():
    from multiview_stitcher_torch.param_resolution import utils as tpr

    g = tmv.Graph()
    assert tpr.compute_edge_residuals(g, {}, ndim=3) == tpr.compute_edge_residuals(g, {}) == {}


# ---------------------------------------------------------------------------
# io.ngff_utils
# ---------------------------------------------------------------------------


def test_ngff_time_transform_helpers_match_jax():
    kw = dict(ndim=2, N_t=3, N_c=1, tile_size=16, tiles_x=1, tiles_y=1)
    jsims, tsims = _both(**kw)
    jm, tm = jmsi.get_msim_from_sim(jsims[0]), tmsi.get_msim_from_sim(tsims[0])
    tt = {"scale": 2.5, "translation": 1.0, "unit": "second"}
    for j, t in ((jsims[0], tsims[0]), (jm, tm)):
        assert tngff.get_ngff_time_transform(t) == jngff.get_ngff_time_transform(j)
        tngff.set_ngff_time_transform(t, tt)
        jngff.set_ngff_time_transform(j, tt)
        assert tngff.get_ngff_time_transform(t) == jngff.get_ngff_time_transform(j)
    targets = _both(**kw)
    tngff.copy_ngff_time_transform(tm, targets[1][0])
    jngff.copy_ngff_time_transform(jm, targets[0][0])
    assert targets[1][0].attrs == targets[0][0].attrs
    tngff.set_ngff_time_transform(tsims[0], None)
    assert "ngff_time_transform" not in tsims[0].attrs
    for m in tm.sims:
        assert m.attrs["ngff_time_transform"] == {**tt}


def test_mean_dtype_matches_jax():
    x = np.arange(24, dtype=np.uint16).reshape(4, 6) * 7
    for kwargs in ({}, {"axis": 0}, {"axis": (0, 1)}):
        got, ref = tngff.mean_dtype(x, **kwargs), jngff.mean_dtype(x, **kwargs)
        np.testing.assert_array_equal(got, ref)
        assert np.asarray(got).dtype == np.asarray(ref).dtype


def test_ngff_containers_match_jax():
    kw = dict(ndim=3, N_t=2, N_c=1, tile_size=40, tiles_x=1, tiles_y=1, tiles_z=1, zoom=4)
    jsims, tsims = _both(**kw)
    aff = jpu.affine_from_translation([1.0, -2.0, 0.5])
    for m, s in ((jsi, jsims[0]), (tsi, tsims[0])):
        m.set_sim_affine(s, aff, transform_key="moved")
    for key in (None, KEY, "moved"):
        got, ref = tngff.sim_to_ngff_image(tsims[0], key), jngff.sim_to_ngff_image(jsims[0], key)
        assert (got.dims, got.scale, got.translation, got.name) == (
            ref.dims, ref.scale, ref.translation, ref.name)
        np.testing.assert_array_equal(np.asarray(got.data), np.asarray(ref.data))
    jm = jmsi.get_msim_from_sim(jsims[0], scale_factors=[{"z": 1, "y": 2, "x": 2}])
    tm = tmsi.get_msim_from_sim(tsims[0], scale_factors=[{"z": 1, "y": 2, "x": 2}])
    for m in (jngff, tngff):
        m.set_ngff_time_transform(jm if m is jngff else tm, {"scale": 3.0})
    got = tngff.msim_to_ngff_multiscales(tm, "moved")
    ref = jngff.msim_to_ngff_multiscales(jm, "moved")
    assert got.metadata == ref.metadata and got.scale_factors == ref.scale_factors
    assert len(got.images) == len(ref.images)
    tback = tngff.ngff_multiscales_to_msim(got, transform_key="back")
    jback = jngff.ngff_multiscales_to_msim(ref, transform_key="back")
    for j, t in zip(jback.sims, tback.sims):
        _assert_sims_equal(j, t)
    replaced = [np.zeros(np.shape(im.data), np.uint16) for im in got.images]
    tback = tngff.ngff_multiscales_to_msim(got, "back", data_arrays=replaced)
    assert not tback.sims[1].to_numpy().any()
    _assert_sims_equal(jngff.ngff_image_to_sim(ref.images[1], "k"),
                       tngff.ngff_image_to_sim(got.images[1], "k"))


def test_ngff_store_metadata_matches_jax(tmp_path):
    kw = dict(ndim=2, N_t=1, N_c=2, tile_size=32, tiles_x=1, tiles_y=1)
    _, tsims = _both(**kw)
    url = str(tmp_path / "im.ome.zarr")
    tngff.write_sim_to_ome_zarr(tsims[0], url)
    got, ref = tngff.read_ngff_multiscales(url), jngff.read_ngff_multiscales(url)
    assert got.metadata == ref.metadata and len(got.images) == len(ref.images)
    for g, r in zip(got.images, ref.images):
        assert (g.dims, g.scale, g.translation) == (r.dims, r.scale, r.translation)
        np.testing.assert_array_equal(np.asarray(g.data), np.asarray(r.data))
        assert isinstance(g.data, tzb.LazyZarrArray)
    axes = got.metadata["axes"]
    datasets = got.metadata["datasets"]
    tngff.write_multiscales_metadata(tmp_path / "t", axes, datasets)
    jngff.write_multiscales_metadata(tmp_path / "j", axes, datasets)
    for f in (".zattrs", ".zgroup"):
        assert (json.loads((tmp_path / "t" / f).read_text())
                == json.loads((tmp_path / "j" / f).read_text()))
    # NGFF 0.5: the multiscales nested under ``ome`` in a zarr v3 group
    tngff.write_multiscales_metadata(tmp_path / "t5", axes, datasets, ngff_version="0.5")
    jngff.write_multiscales_metadata(tmp_path / "j5", axes, datasets, ngff_version="0.5")
    assert (json.loads((tmp_path / "t5" / "zarr.json").read_text())
            == json.loads((tmp_path / "j5" / "zarr.json").read_text()))
    assert tzb.read_group_metadata(str(tmp_path / "j5")) == jzb.read_group_metadata(
        str(tmp_path / "t5"))


# ---------------------------------------------------------------------------
# fusion: fuse()'s API, the deprecated stubs, block-wise fusion
# ---------------------------------------------------------------------------

_SMALL = dict(ndim=2, N_t=1, N_c=1, tile_size=40, tiles_x=2, tiles_y=1, overlap=10,
              zoom=6, drift_scale=0, shift_scale=0, dtype=np.uint16)


@pytest.mark.parametrize("bad", [
    {"sims": "both"}, {"neither": True}, {"backend": "cupy"}, {"backend": "tensorflow"},
])
def test_fuse_refuses_what_jax_refuses(bad):
    jsims, tsims = _both(**_SMALL)

    def call(fuse, sims, **extra):
        if "neither" in bad:
            return fuse(transform_key=KEY, **extra)
        if bad.get("sims") == "both":
            return fuse(sims, sims=sims, transform_key=KEY, **extra)
        return fuse(sims, transform_key=KEY, **bad, **extra)

    with pytest.raises((TypeError, ValueError)) as ref:
        call(jfusion.fuse, jsims)
    with pytest.raises(ref.type) as got:
        call(tfusion.fuse, tsims, device="cpu")
    if ref.type is TypeError:
        assert str(got.value) == str(ref.value)
    else:
        assert f"Unsupported backend {bad['backend']!r}" in str(got.value)


def test_fuse_backend_names_and_mesh():
    _, tsims = _both(**_SMALL)
    ref = tfusion.fuse(tsims, transform_key=KEY, device="cpu")
    for backend in ("numpy", "torch"):
        got = tfusion.fuse(tsims, transform_key=KEY, device="cpu", backend=backend)
        np.testing.assert_array_equal(got.data, ref.data)
    # the JAX package's own array library is not this package's
    with pytest.raises(ValueError, match="backend"):
        tfusion.fuse(tsims, transform_key=KEY, device="cpu", backend="jax")
    # a mesh is a parallel.mesh.Mesh; a CPU one gives the unsharded output
    with pytest.raises(TypeError, match="Mesh"):
        tfusion.fuse(tsims, transform_key=KEY, device="cpu", mesh=object())
    got = tfusion.fuse(tsims, transform_key=KEY, mesh=Mesh([torch.device("cpu")] * 3))
    np.testing.assert_array_equal(got.data, ref.data)


@pytest.mark.parametrize("stub", ["fuse_to_zarr", "fuse_to_multiscale_ome_zarr"])
def test_deprecated_fuse_stubs_match_jax(stub):
    messages = []
    for m in (jfusion, tfusion):
        with pytest.warns(DeprecationWarning) as w:
            with pytest.raises(RuntimeError) as e:
                getattr(m, stub)([], "x.zarr")
        messages.append((str(w[0].message), str(e.value)))
    assert messages[0] == messages[1]


def test_fuse_sims_alias_warns_and_equals_images():
    jsims, tsims = _both(**_SMALL)
    with pytest.warns(DeprecationWarning, match="deprecated"):
        got = tfusion.fuse(sims=tsims, transform_key=KEY, device="cpu", batch_options={"x": 1},
                           backend="numpy")
    ref = tfusion.fuse(tsims, transform_key=KEY, device="cpu")
    np.testing.assert_array_equal(got.data, ref.data)
    with pytest.warns(DeprecationWarning, match="deprecated"):
        jref = jfusion.fuse(sims=jsims, transform_key=KEY)
    assert np.abs(got.data.astype(np.int64) - np.asarray(jref.data).astype(np.int64)).max() <= 1


def _custom_fusion(transformed_views, blending_weights):
    return (transformed_views * blending_weights).sum(0) / blending_weights.sum(0).clamp_min(1e-6)


# each tier of fuse(): the device-resident output equals the host output bit
# for bit
TIERS = {
    "translation": {},
    "streamed": {},
    "tiles": {"fusion_func": tcore.max_fusion},
    "batched": {"rotate": True},
    "host": {"fusion_func": _custom_fusion},
}


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_fuse_output_on_backend_equals_the_host_output(tier, monkeypatch):
    # 4 x 4 tiles of 48^2 band into 3 bands when the streaming tier is forced
    kw = dict(ndim=2, N_t=1, N_c=2, tile_size=48, tiles_x=4, tiles_y=4, overlap=12,
              dtype=np.uint16)
    tsims = tsd.generate_tiled_dataset(**kw)
    opts = dict(TIERS[tier])
    if opts.pop("rotate", False):
        for s in tsims:
            tsi.set_sim_affine(s, tpu.affine_from_linear_affine([1, 0.02, -0.02, 1, 0.5, 0.3]),
                               transform_key="rot", base_transform_key=KEY)
        key = "rot"
    else:
        key = KEY
    if tier == "streamed":
        monkeypatch.setattr(tcore, "STREAM_BYTES", 0)
    calls = []
    for name in ("_execute_fusion_plan_translation", "_execute_fusion_plan_tiles",
                 "_execute_fusion_plan_batched", "_execute_fusion_plan_host"):
        orig = getattr(tcore, name)

        def spy(*a, _orig=orig, _name=name, **k):
            calls.append(_name)
            return _orig(*a, **k)

        monkeypatch.setattr(tcore, name, spy)
    host = tfusion.fuse(tsims, transform_key=key, output_chunksize=24, device="cpu", **opts)
    expect = {"translation": "_execute_fusion_plan_translation", "streamed": None,
              "tiles": "_execute_fusion_plan_tiles", "batched": "_execute_fusion_plan_batched",
              "host": "_execute_fusion_plan_host"}[tier]
    assert calls == ([expect] * 2 if expect else []), calls
    with pytest.warns(DeprecationWarning, match="sims"):
        dev = tfusion.fuse(sims=tsims, transform_key=key, output_chunksize=24, device="cpu",
                           output_on_backend=True, **opts)
    assert isinstance(dev.data, torch.Tensor) and dev.data.device.type == "cpu"
    assert dev.dims == host.dims and dev.spacing == host.spacing and dev.origin == host.origin
    np.testing.assert_array_equal(dev.to_numpy(), host.data)
    np.testing.assert_array_equal(dev.transforms[key].data, host.transforms[key].data)


def _read_blocks(url, zb=tzb):
    return np.asarray(zb.attach_zarr_array(url)[...]).astype(np.int64)


BLOCK_GRIDS = {
    "2d": (dict(_SMALL), 32),
    "3d": (dict(ndim=3, N_t=1, N_c=1, tile_size=16, tiles_x=2, tiles_y=2, overlap=4, zoom=4,
                drift_scale=0, shift_scale=0, dtype=np.uint16), 14),
}


@pytest.mark.parametrize("grid", sorted(BLOCK_GRIDS))
def test_prepare_block_fusion_matches_jax_and_direct_fuse(grid, tmp_path):
    kw, chunk = BLOCK_GRIDS[grid]
    jsims, tsims = _both(**kw)
    blocks = {}
    # the JAX package writes blosc, which the JAX reader reads back
    for name, fusion, sims, extra, zb in (("jax", jfusion, jsims, {}, jzb),
                                          ("port", tfusion, tsims, {"device": "cpu"}, tzb)):
        url = str(tmp_path / f"{name}.zarr")
        info = fusion.prepare_block_fusion(
            url, {"images": sims, "transform_key": KEY, "output_chunksize": chunk, **extra},
        )
        ids = list(itertools.product(*(range(n) for n in info["nblocks"])))
        assert [info["func"](b) for b in ids] == ids
        blocks[name] = (_read_blocks(url, zb), info)
    (jb, jinfo), (tb, tinfo) = blocks["jax"], blocks["port"]
    assert tinfo["nblocks"] == jinfo["nblocks"]
    assert tinfo["output_stack_properties"] == jinfo["output_stack_properties"]
    assert len(tinfo["nblocks"]) > 2 and np.prod(tinfo["nblocks"]) > 1
    direct = tfusion.fuse(tsims, transform_key=KEY, device="cpu")
    assert tb.shape == direct.data.shape == jb.shape
    assert np.abs(tb - jb).max() <= 1
    assert np.abs(tb - direct.data.astype(np.int64)).max() <= 1
    assert tb.max() > 0


def test_prepare_block_fusion_attach_mode_splits_blocks(tmp_path):
    kw, chunk = BLOCK_GRIDS["3d"]
    tsims = tsd.generate_tiled_dataset(**kw)
    url = str(tmp_path / "attach.zarr")
    kwargs = {"sims": tsims, "transform_key": KEY, "output_chunksize": chunk, "device": "cpu"}
    creator = tfusion.prepare_block_fusion(url, dict(kwargs))
    attacher = tfusion.prepare_block_fusion(url, dict(kwargs), create_output=False)
    assert attacher["nblocks"] == creator["nblocks"]
    ids = list(itertools.product(*(range(n) for n in creator["nblocks"])))
    for bid in ids[::2]:
        creator["func"](bid)
    for bid in ids[1::2]:
        attacher["func"](bid)
    split = _read_blocks(url)
    alone = str(tmp_path / "alone.zarr")
    one = tfusion.prepare_block_fusion(alone, dict(kwargs))
    for bid in ids:
        one["func"](bid)
    np.testing.assert_array_equal(split, _read_blocks(alone))
    with pytest.raises(ValueError, match="block_id"):
        creator["func"]((0, 0))
    with pytest.raises(ValueError, match="images"):
        tfusion.prepare_block_fusion(url, {"transform_key": KEY})
