"""Inputs of the multi-view cells, made from ``--seed``.

A multi-view configuration describes V views of one sample, each a stack of
``tile`` voxels (z, y, x) at the anisotropic ``spacing`` of a light-sheet
acquisition, view k turned about the y axis through the sample's centre by
``angle_step_deg * k`` degrees, as a multi-view microscope turns its sample
between views. Every view sits off its nominal place by a sub-pixel jitter,
and every view but the first carries a registration correction drawn from
the seed: a rigid rotation of ``correction_deg`` degrees (the range) about a
random axis through the centre and a translation of ``stage_error_px``
output pixels (the range) in a random direction. The views' affines are
those corrected ones, as ``register()`` leaves them, so the views agree in
their overlaps under the affines they carry.

The sample is one band-limited volume: white noise on a grid at the
output's spacing (``output_spacing``), under a gaussian of ``psf_sigma_px``
pixels, made on the device. Each view is that volume sampled at its own
voxel centres (trilinear between the volume's voxels), scaled to [0, 1000]
counts over all views and rounded. The views reach the port as host arrays.

Every seed gives the same sizes: the seed changes the volume, the jitter
and the corrections, never the number or the shape of the views.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from portbench import data

SPATIAL = ("z", "y", "x")
# view voxels sampled at a time
_SLAB_VOXELS = 1 << 24


@dataclass
class Views:
    """The views as the port receives them. ``views``: (V, *tile) host
    array in the configured dtype; ``affines``: (V, 4, 4) maps from a view's
    physical coordinates (origin 0, ``spacing``) to the world's, z first;
    ``spacing``: the views' pixel size; ``output_spacing``: the isotropic
    pixel size of the sample's volume and of the fused output."""

    views: np.ndarray
    affines: np.ndarray
    spacing: tuple
    output_spacing: float


def rotation(axis, angle: float) -> np.ndarray:
    """(3, 3) rotation by ``angle`` radians about the unit vector ``axis``
    (z, y, x components), right-handed in (z, y, x)."""
    a = np.asarray(axis, dtype=np.float64)
    a = a / np.linalg.norm(a)
    k = np.array([[0.0, -a[2], a[1]], [a[2], 0.0, -a[0]], [-a[1], a[0], 0.0]])
    return np.eye(3) + math.sin(angle) * k + (1 - math.cos(angle)) * (k @ k)


def about_y(angle: float) -> np.ndarray:
    """(3, 3) rotation by ``angle`` radians about the y axis, in (z, y, x)."""
    c, s = math.cos(angle), math.sin(angle)
    return np.array([[c, 0.0, -s], [0.0, 1.0, 0.0], [s, 0.0, c]])


def view_affines(config: dict, seed: int) -> np.ndarray:
    """(V, 4, 4) view-to-world affines of the configuration for ``seed``."""
    tile = np.array(config["tile"], dtype=np.float64)
    spacing = np.array(config["spacing"], dtype=np.float64)
    n = int(config["views"])
    rng = data._rng(seed)
    extent = (tile - 1) * spacing
    centre_view = extent / 2
    # the sample's centre: the views turn about y, so z and x span the
    # larger of the two extents
    zx = max(extent[0], extent[2]) / 2
    centre = np.array([zx, extent[1] / 2, zx])
    jitter = np.array(config["position_jitter_px"], dtype=np.float64) * float(
        config["output_spacing"])
    lo_deg, hi_deg = config["correction_deg"]
    lo_px, hi_px = config["stage_error_px"]
    out = np.zeros((n, 4, 4))
    for k in range(n):
        lin = about_y(math.radians(float(config["angle_step_deg"]) * k))
        shift = rng.uniform(-1, 1, 3) * jitter
        turn, move = np.eye(3), np.zeros(3)
        if k:
            axis = rng.normal(size=3)
            angle = math.radians(rng.uniform(lo_deg, hi_deg)) * rng.choice([-1.0, 1.0])
            turn = rotation(axis, angle)
            direction = rng.normal(size=3)
            move = (direction / np.linalg.norm(direction) * rng.uniform(lo_px, hi_px)
                    * float(config["output_spacing"]))
        # world = turn @ (lin @ (p - centre_view) + shift) + centre + move
        out[k, :3, :3] = turn @ lin
        out[k, :3, 3] = turn @ (shift - lin @ centre_view) + centre + move
        out[k, 3, 3] = 1.0
    return out


def _blur(noise: torch.Tensor, sigma: float) -> torch.Tensor:
    """``noise`` under a gaussian of ``sigma`` pixels, separably, without
    the radius at each border (the result is 2 r smaller on every axis)."""
    r = data.radius(sigma)
    q = np.arange(-r, r + 1, dtype=np.float64)
    taps = np.exp(-q * q / (2 * sigma**2))
    taps = (taps / taps.sum()).tolist()
    out = noise
    for axis in range(3):
        n = out.shape[axis] - 2 * r
        acc = out.narrow(axis, 0, n) * taps[0]
        for i in range(1, len(taps)):
            acc.add_(out.narrow(axis, i, n), alpha=taps[i])
        out = acc
    return out


def _trilinear(field: torch.Tensor, pos) -> torch.Tensor:
    """``field`` (Z, Y, X) at the fractional voxel positions ``pos`` (three
    broadcastable float64 tensors, z, y, x), trilinear."""
    shape = torch.broadcast_shapes(*(p.shape for p in pos))
    pos = [p.expand(shape) for p in pos]
    flat = field.reshape(-1)
    base = [torch.floor(p) for p in pos]
    frac = [(p - b).to(torch.float32) for p, b in zip(pos, base)]
    idx = [b.to(torch.int64) for b in base]
    Y, X = field.shape[1], field.shape[2]
    out = torch.zeros(shape, dtype=torch.float32, device=field.device)
    for dz in (0, 1):
        wz = frac[0] if dz else 1 - frac[0]
        for dy in (0, 1):
            wy = frac[1] if dy else 1 - frac[1]
            for dx in (0, 1):
                wx = frac[2] if dx else 1 - frac[2]
                i = ((idx[0] + dz) * Y + (idx[1] + dy)) * X + (idx[2] + dx)
                out.add_(wz * wy * wx * flat[i])
    return out


def make_views(config: dict, seed: int, device) -> Views:
    """The configuration's views for ``seed``.

    ``config`` keys: ``tile`` (one view's shape), ``views``,
    ``angle_step_deg``, ``spacing`` (the views' pixel size, z first),
    ``output_spacing``, ``position_jitter_px``, ``correction_deg`` and
    ``stage_error_px`` (ranges), ``psf_sigma_px`` and ``dtype`` (uint16)."""
    if config.get("dtype", "uint16") != "uint16":
        raise ValueError("the generator makes uint16 views")
    tile = [int(t) for t in config["tile"]]
    spacing = np.array(config["spacing"], dtype=np.float64)
    step = float(config["output_spacing"])
    sigma = float(config["psf_sigma_px"])
    affines = view_affines(config, seed)
    # the world box that every view voxel centre falls in, on the volume's grid
    corners = np.array(list(np.ndindex(2, 2, 2)), dtype=np.float64) * (np.array(tile) - 1) * spacing
    world = np.concatenate([corners @ a[:3, :3].T + a[:3, 3] for a in affines])
    lo = np.floor(world.min(axis=0) / step) - 1
    hi = np.ceil(world.max(axis=0) / step) + 2
    r = data.radius(sigma)
    gen = torch.Generator(device=device)
    gen.manual_seed(data._seed64(seed))
    noise = torch.rand([int(h - l) + 2 * r + 1 for l, h in zip(lo, hi)], generator=gen,
                       device=device)
    field = _blur(noise, sigma)
    del noise
    nz = max(1, _SLAB_VOXELS // (tile[1] * tile[2]))
    grids = [torch.arange(n, dtype=torch.float64, device=device) * float(s)
             for n, s in zip(tile, spacing)]
    values = torch.empty([len(affines)] + tile, dtype=torch.float32, device=device)
    for v, a in enumerate(affines):
        for z0 in range(0, tile[0], nz):
            z = grids[0][z0:z0 + nz].reshape(-1, 1, 1)
            y = grids[1].reshape(1, -1, 1)
            x = grids[2].reshape(1, 1, -1)
            # the volume's voxel position of each view voxel centre
            m = a.tolist()
            pos = [(((m[i][0] * z + m[i][1] * y) + m[i][2] * x) + m[i][3]) / step - float(lo[i])
                   for i in range(3)]
            values[v, z0:z0 + nz] = _trilinear(field, pos)
    del field
    low, high = values.min(), values.max()
    values.sub_(low).mul_(1000.0 / (high - low)).round_()
    views = values.to(torch.int32).to(torch.uint16).cpu().numpy()
    del values
    return Views(views=views, affines=affines, spacing=tuple(float(s) for s in spacing),
                 output_spacing=step)


def to_sims(views: Views, transform_key: str) -> list:
    """The views as the port's sims: origin 0, the views' spacing, each
    under its affine at ``transform_key``."""
    from multiview_stitcher_torch import si_utils

    return [
        si_utils.get_sim_from_array(
            views.views[v], dims=list(SPATIAL), scale=dict(zip(SPATIAL, views.spacing)),
            translation={d: 0.0 for d in SPATIAL}, affine=views.affines[v],
            transform_key=transform_key,
        )
        for v in range(len(views.views))
    ]
