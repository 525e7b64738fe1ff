"""Carry a sim's state over from the JAX package.

This system has no learned weights: its state is the sims (pixel data,
physical metadata and named affine transforms). ``sim_from_numpy`` builds
this package's :class:`~.si_utils.Sim` from the fields of a
``multiview_stitcher_tpu`` Sim given as plain numpy values, so that both
packages compute the same thing from the same inputs.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import numpy as np

from multiview_stitcher_torch import param_utils
from multiview_stitcher_torch.si_utils import Sim


def sim_from_numpy(
    data: np.ndarray,
    dims: Sequence[str],
    spacing: Mapping[str, float],
    origin: Mapping[str, float],
    transforms: Mapping[str, np.ndarray],
    coords: Optional[Mapping[str, np.ndarray]] = None,
) -> Sim:
    """Sim from numpy fields.

    ``transforms`` maps each transform key to an ``(ndim+1, ndim+1)``
    matrix, or to ``(nt, ndim+1, ndim+1)`` matrices over the sim's ``t``
    coordinates. ``coords`` holds the coordinates of the non-spatial dims
    (default ``arange``).
    """
    coords = {k: np.asarray(v) for k, v in (coords or {}).items()}
    sim = Sim(
        data=np.asarray(data),
        dims=tuple(dims),
        spacing=dict(spacing),
        origin=dict(origin),
        coords=coords,
    )
    xforms: Dict[str, param_utils.XAffine] = {}
    for key, mat in transforms.items():
        mat = np.asarray(mat, dtype=float)
        t_coords = sim.coords.get("t") if mat.ndim == 3 else None
        xforms[key] = param_utils.XAffine(mat, t_coords=t_coords)
    sim.transforms = xforms
    return sim
