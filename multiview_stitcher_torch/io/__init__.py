"""IO: zarr v2 / v3 and OME-Zarr (NGFF 0.4 and 0.5), TIFF, CZI, Imaris and
the everyday image formats, on numpy and the standard library.

The port of ``multiview_stitcher_tpu.io``. :func:`read_mosaic_into_sims`
dispatches on the file's suffix to the readers of this package:
``tif_utils`` (with the native codecs of ``codecs``), ``czi_utils`` (with
``jpeg``), ``imaris_utils`` (needs ``h5py``), ``ngff_utils`` and
``fallback`` (needs ``imageio``); any other format goes to the optional
``aicsimageio`` package, which raises a clear ``ImportError`` where it is
absent.
"""

from pathlib import Path

from multiview_stitcher_torch import si_utils as _si_utils

METADATA_TRANSFORM_KEY = _si_utils.DEFAULT_TRANSFORM_KEY


def read_mosaic_into_sims(filepath, scene_index: int = 0):
    """Read mosaic tiles into sims with stage positions from metadata.

    Dispatches on file suffix.
    """
    filepath = Path(filepath)
    if filepath.suffix == ".czi":
        from multiview_stitcher_torch.io import czi_utils

        return czi_utils.read_mosaic_into_sims_czifile(
            filepath, scene_index=scene_index
        )
    if filepath.suffix in (".tif", ".tiff"):
        from multiview_stitcher_torch.io import tif_utils

        return [tif_utils.read_tiff_into_sim(filepath)]
    if filepath.suffix == ".ims":
        from multiview_stitcher_torch.io import imaris_utils
        from multiview_stitcher_torch import msi_utils

        return [
            msi_utils.get_sim_from_msim(
                imaris_utils.read_imaris_into_msim(filepath)
            )
        ]
    if str(filepath).endswith((".zarr", ".ome.zarr")):
        from multiview_stitcher_torch.io import ngff_utils

        return [ngff_utils.read_sim_from_ome_zarr(filepath)]
    # catch-all 1/2: first-party imageio/PIL fallback for everyday image
    # formats (upstream multiview-stitcher needs aicsimageio here)
    from multiview_stitcher_torch.io import fallback

    if fallback.can_read(filepath):
        return fallback.read_image_into_sims(
            filepath, scene_index=scene_index
        )
    # catch-all 2/2: delegate any other bioformat to the optional
    # aicsimageio stack, as upstream does (a clear ImportError when the
    # package is absent)
    return read_mosaic_into_sims_aicsimageio(
        filepath, scene_index=scene_index
    )


def read_mosaic_into_sims_aicsimageio(filepath, scene_index: int = 0):
    """Fallback mosaic reader via the optional ``aicsimageio`` package:
    per-tile lazy arrays, physical pixel sizes,
    and mosaic stage positions mapped into sim translations."""
    try:
        from aicsimageio import AICSImage
    except ImportError as e:
        raise ImportError(
            "Having aicsimageio installed is required to read mosaic "
            f"files other than CZI/TIFF/Imaris/OME-Zarr (got "
            f"{Path(filepath).suffix!r}). pip install aicsimageio"
        ) from e

    aicsim = AICSImage(filepath, reconstruct_mosaic=False)
    aicsim.set_scene(scene_index)
    pixel_sizes = {"x": aicsim.physical_pixel_sizes.X or 1.0,
                   "y": aicsim.physical_pixel_sizes.Y or 1.0}
    data = aicsim.get_image_data()  # (T, C, Z, Y, X)
    if data.shape[2] > 1:
        pixel_sizes["z"] = aicsim.physical_pixel_sizes.Z or 1.0
    positions = aicsim.get_mosaic_tile_positions()
    sims = []
    for m, pos in enumerate(positions):
        tile = aicsim.get_image_data("TCZYX", M=m)
        if tile.shape[2] == 1:
            tile = tile[:, :, 0]
            dims = ("t", "c", "y", "x")
        else:
            dims = ("t", "c", "z", "y", "x")
        origin = {
            ax: float(pos[i]) * pixel_sizes[ax]
            for i, ax in enumerate(["y", "x"])
        }
        if "z" in pixel_sizes:
            origin["z"] = 0.0
        sims.append(
            _si_utils.get_sim_from_array(
                tile, dims=dims, scale=pixel_sizes, translation=origin,
                c_coords=list(aicsim.channel_names or range(tile.shape[1])),
            )
        )
    return sims


def save_sim_as_tif(path, sim):
    from multiview_stitcher_torch.io import tif_utils

    return tif_utils.save_sim_as_tif(path, sim)


def get_number_of_scenes_in_mosaic(filepath) -> int:
    """Number of scenes in a mosaic file."""
    filepath = Path(filepath)
    if filepath.suffix == ".czi":
        from multiview_stitcher_torch.io import czi_utils

        return czi_utils.get_czi_shape(filepath).get("S", 1)
    return 1


def read_mosaic_into_sims_czifile(filepath, scene_index: int = 0, lazy=True):
    """Re-export of the first-party CZI mosaic reader (upstream exposes it
    at module level)."""
    from multiview_stitcher_torch.io import czi_utils

    return czi_utils.read_mosaic_into_sims_czifile(
        filepath, scene_index=scene_index, lazy=lazy
    )


def read_mosaic_image_into_list_of_spatial_xarrays(
    filepath, scene_index: int = 0
):
    """Deprecated upstream alias for :func:`read_mosaic_into_sims` (kept
    with a DeprecationWarning, as upstream keeps it)."""
    import warnings

    warnings.warn(
        "read_mosaic_image_into_list_of_spatial_xarrays is deprecated; "
        "use read_mosaic_into_sims.",
        DeprecationWarning,
        stacklevel=2,
    )
    return read_mosaic_into_sims(filepath, scene_index=scene_index)


def read_tiff_into_spatial_xarray(filename, **kwargs):
    """Deprecated upstream alias for the TIFF sim reader."""
    import warnings

    from multiview_stitcher_torch.io import tif_utils

    warnings.warn(
        "read_tiff_into_spatial_xarray is deprecated; use "
        "tif_utils.read_tiff_into_sim.",
        DeprecationWarning,
        stacklevel=2,
    )
    return tif_utils.read_tiff_into_sim(filename, **kwargs)


def read_tif_into_msim(
    filename,
    dims=None,
    scale=None,
    translation=None,
    transform_key=METADATA_TRANSFORM_KEY,
    scale_factors=None,
):
    """Read a TIFF into a multiscale spatial image."""
    from multiview_stitcher_torch import msi_utils
    from multiview_stitcher_torch.io import tif_utils

    sim = tif_utils.read_tiff_into_sim(
        filename,
        dims=dims,
        scale=scale,
        translation=translation,
        transform_key=transform_key,
    )
    return msi_utils.get_msim_from_sim(sim, scale_factors=scale_factors)
