"""Optional external registration backends: ANTsPy and ITK-Elastix.

The port of ``multiview_stitcher_tpu.registration_plugins``. Both are
physical-space pairwise functions (``register_pair_of_msims`` hands them the
overlap crops with their origins, spacings and ``initial_affine``) that
delegate to the C++ toolkits when their packages are installed and raise
``ImportError`` otherwise. The backend modules are imported at first use,
so that importing this package imports neither; ``ants`` and ``itk`` hold
them once imported (a test may put a stand-in there).
"""

from __future__ import annotations

import importlib

import numpy as np

from multiview_stitcher_torch import transforms

ants = None
itk = None


def _backend(name: str, message: str):
    """The module held in ``name`` (importing it at first use), or
    ``ImportError(message)`` where it is not installed."""
    mod = globals()[name]
    if mod is None:
        try:
            mod = importlib.import_module(name)
        except ImportError:
            raise ImportError(message) from None
        globals()[name] = mod
    return mod


def _as_float32(data) -> np.ndarray:
    return np.asarray(getattr(data, "data", data), dtype=np.float32)


def registration_ANTsPy(  # noqa: N802 (the reference's name)
    fixed_data,
    moving_data,
    *,
    fixed_origin,
    moving_origin,
    fixed_spacing,
    moving_spacing,
    initial_affine,
    transform_types=None,
    **ants_registration_kwargs,
):
    """Staged ANTs registration (by default Translation, Rigid, Similarity,
    each seeded with the last stage's transforms); needs ``antspyx``.
    Returns ``affine_matrix`` (fixed physical -> moving physical, fitted to
    the stack's corners mapped through the ANTs transforms) and quality
    NaN."""
    ants_mod = _backend(
        "ants",
        "Please install the antspyx package to use ANTsPy for registration "
        "(pip install antspyx).",
    )
    sdims = list(fixed_spacing.keys())
    ndim = len(sdims)
    if transform_types is None:
        transform_types = ["Translation", "Rigid", "Similarity"]
    fixed_np = _as_float32(fixed_data)
    moving_np = _as_float32(moving_data)
    fixed_img = ants_mod.from_numpy(
        np.nan_to_num(fixed_np),
        origin=[float(fixed_origin[d]) for d in sdims],
        spacing=[float(fixed_spacing[d]) for d in sdims],
    )
    moving_img = ants_mod.from_numpy(
        np.nan_to_num(moving_np),
        origin=[float(moving_origin[d]) for d in sdims],
        spacing=[float(moving_spacing[d]) for d in sdims],
    )
    result = None
    for ttype in transform_types:
        result = ants_mod.registration(
            fixed=fixed_img,
            moving=moving_img,
            type_of_transform=ttype,
            initial_transform=result["fwdtransforms"] if result is not None else None,
            **ants_registration_kwargs,
        )

    probe = np.array(list(np.ndindex((2,) * ndim)), dtype=float) * (np.asarray(fixed_np.shape) - 1)
    probe_phys = probe * np.array([fixed_spacing[d] for d in sdims]) + np.array(
        [fixed_origin[d] for d in sdims]
    )
    # ANTs maps points given as a pandas table: antspyx depends on pandas,
    # so it is there wherever ants is
    import pandas as pd

    pts_df = pd.DataFrame(probe_phys, columns=["x", "y", "z"][:ndim])
    mapped = ants_mod.apply_transforms_to_points(ndim, pts_df, result["fwdtransforms"]).values
    return {"affine_matrix": _affine_from_point_pairs(probe_phys, mapped), "quality": np.nan}


def registration_ITKElastix(  # noqa: N802 (the reference's name)
    fixed_data,
    moving_data,
    *,
    fixed_origin,
    moving_origin,
    fixed_spacing,
    moving_spacing,
    initial_affine,
    transform_types=None,
    **elastix_kwargs,
):
    """Staged elastix registration (by default translation, rigid, affine
    parameter maps); needs ``itk-elastix``. Returns ``affine_matrix`` (fixed
    physical -> moving physical, fitted to a 3^ndim grid of the stack mapped
    through transformix) and quality NaN."""
    itk_mod = _backend(
        "itk",
        "Please install the itk-elastix package to use ITKElastix for registration "
        "(pip install itk-elastix).",
    )
    if not hasattr(itk_mod, "ElastixRegistrationMethod"):
        raise ImportError(
            "Please install the itk-elastix package to use ITKElastix for registration "
            "(pip install itk-elastix)."
        )
    sdims = list(fixed_spacing.keys())
    ndim = len(sdims)
    if transform_types is None:
        transform_types = ["translation", "rigid", "affine"]
    fixed_np = np.nan_to_num(_as_float32(fixed_data))
    moving_np = np.nan_to_num(_as_float32(moving_data))

    fixed_img = itk_mod.image_from_array(fixed_np)
    fixed_img.SetSpacing([float(fixed_spacing[d]) for d in sdims[::-1]])
    fixed_img.SetOrigin([float(fixed_origin[d]) for d in sdims[::-1]])
    moving_img = itk_mod.image_from_array(moving_np)
    moving_img.SetSpacing([float(moving_spacing[d]) for d in sdims[::-1]])
    moving_img.SetOrigin([float(moving_origin[d]) for d in sdims[::-1]])

    parameter_object = itk_mod.ParameterObject.New()
    for ttype in transform_types:
        parameter_object.AddParameterMap(parameter_object.GetDefaultParameterMap(ttype))
    _registered, params = itk_mod.elastix_registration_method(
        fixed_img, moving_img, parameter_object=parameter_object, **elastix_kwargs
    )

    probe = np.array(list(np.ndindex((3,) * ndim)), dtype=float) / 2
    probe_phys = probe * (np.asarray(fixed_np.shape) - 1) * np.array(
        [fixed_spacing[d] for d in sdims]
    ) + np.array([fixed_origin[d] for d in sdims])
    mapped = _transformix_points(probe_phys[:, ::-1], params)[:, ::-1]
    return {"affine_matrix": _affine_from_point_pairs(probe_phys, mapped), "quality": np.nan}


def _transformix_points(points_xyz, parameter_object):
    return np.asarray(itk.transformix_pointset(points_xyz, parameter_object))


def _affine_from_point_pairs(src, dst) -> np.ndarray:
    """Least-squares homogeneous affine mapping ``src`` to ``dst``."""
    return transforms.estimate_affine(src, dst)
