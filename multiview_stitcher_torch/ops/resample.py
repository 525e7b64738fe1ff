"""Host-side resampling parameters (numpy float64).

Copy of the host helpers of ``multiview_stitcher_tpu.ops.resample``: the
device-side resampling there is not part of this package yet.
"""

from __future__ import annotations

import numpy as np

from multiview_stitcher_torch.param_utils import transform_pts  # noqa: F401


def physical_to_pixel_params(
    p: np.ndarray,
    input_spacing: np.ndarray,
    input_origin: np.ndarray,
    output_spacing: np.ndarray,
    output_origin: np.ndarray,
):
    """Convert a physical-space affine into pixel-space (matrix, offset).

    ``p`` maps output physical coordinates -> input physical coordinates; the
    returned (matrix, offset) map output pixel indices -> input pixel indices.
    Rounds to 10 decimals and snaps near-integer offsets, so that float error
    in the physical parameters does not leave a translation a hair off the
    pixel grid.
    """
    p = np.asarray(p, dtype=float)
    ndim = p.shape[-1] - 1
    matrix = p[:ndim, :ndim]
    offset = p[:ndim, ndim]

    Sx = np.diag(np.asarray(output_spacing, dtype=float))
    Sy = np.asarray(input_spacing, dtype=float)
    Ox = np.asarray(output_origin, dtype=float)
    Oy = np.asarray(input_origin, dtype=float)

    matrix_prime = (matrix @ Sx) / Sy[:, None]
    local_input_origin = Oy - Ox
    local_offset = offset + (matrix - np.eye(ndim)) @ Ox
    offset_prime = (local_offset - local_input_origin) / Sy

    decimals = 10
    matrix_prime = np.around(matrix_prime, decimals=decimals)
    offset_prime = np.around(offset_prime, decimals=decimals)

    nearest_integer = np.round(offset_prime)
    near = np.isclose(offset_prime, nearest_integer, rtol=0, atol=1e-6)
    offset_prime[near] = nearest_integer[near]

    return matrix_prime, offset_prime
