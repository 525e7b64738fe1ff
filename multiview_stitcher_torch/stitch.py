"""Register, resolve and fuse with the tiles uploaded once.

The port of ``multiview_stitcher_tpu.stitch``: :func:`stitch` registers the
views with ``device_tiles=True``, which uploads the tile stack into the
device tile cache and cuts the registration crops from it on the device;
``fuse`` then reads the same stack from the cache where its tier does (the
tiers that do not stream). The resolved transforms are written onto the
msims under ``new_transform_key``, as ``register(new_transform_key=...)``
does, and level 0 of the msims is fused. Msims with a pyramid or a ``t`` dim
are taken as ``register`` takes them: with ``t``, or at a level other than
level 0, the registration reads host crops, as the reference does, and
``fuse`` uploads level 0 itself.
"""

from __future__ import annotations

from typing import Optional, Sequence

from multiview_stitcher_torch import fusion, msi_utils, registration, si_utils
from multiview_stitcher_torch.msi_utils import Msim
from multiview_stitcher_torch.parallel import mesh as mesh_utils


def stitch(
    sims: Sequence,
    transform_key: str = si_utils.DEFAULT_TRANSFORM_KEY,
    new_transform_key: str = "registered",
    output_zarr_url: Optional[str] = None,
    mesh=None,
    register_kwargs: Optional[dict] = None,
    fuse_kwargs: Optional[dict] = None,
    device=None,
):
    """Register -> resolve -> fuse. ``register_kwargs`` and ``fuse_kwargs``
    go to the two phases (and may override the ``device_tiles`` and
    ``transform_key`` set here). Returns the fused sim, backed by zarr with
    ``output_zarr_url``. Runs on ``device``: the CUDA device by default (the
    first device of a ``mesh``), or the CPU with ``device="cpu"``. ``mesh``
    (a :class:`~.parallel.mesh.Mesh`) goes to both phases."""
    mesh, device = mesh_utils.resolve(mesh, device)
    msims = [
        m if isinstance(m, Msim) else msi_utils.get_msim_from_sim(m, scale_factors=[])
        for m in sims
    ]
    rkw = dict(register_kwargs or {})
    rkw.setdefault("device_tiles", True)
    rkw.setdefault("transform_key", transform_key)
    rkw.setdefault("new_transform_key", new_transform_key)
    rkw.setdefault("mesh", mesh)
    rkw.setdefault("device", device)
    registration.register(msims, **rkw)

    sims_reg = [msi_utils.get_sim_from_msim(m) for m in msims]
    fkw = dict(fuse_kwargs or {})
    fkw.setdefault("transform_key", rkw["new_transform_key"])
    fkw.setdefault("mesh", mesh)
    fkw.setdefault("device", device)
    if output_zarr_url is not None:
        fkw.setdefault("output_zarr_url", output_zarr_url)
    return fusion.fuse(sims_reg, **fkw)
