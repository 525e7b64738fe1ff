#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and hold its kernels
against their plain PyTorch versions.

Run from the root of the repository, on a machine with a CUDA device:

    python3 chip_smoke.py

Phases, one printed line or block each:

1. the card, as ``nvidia-smi --query-gpu=name,power.limit`` gives it;
2. the build of every CUDA source of the port, timed (nvcc, sm_90a);
3. each kernel against its plain version on the card, on small layouts
   (unit scale, uniform and per-view scales, a banded ``origin``, uint16
   output, tile shapes that are and are not multiples of the kernel blocks);
4. the 3D main path through ``fusion.fuse``: 32 x 32 tiles of 64^3 uint16,
   overlap 12, output (64, 1676, 1676) uint16; a cold and a warm call, the
   warm one split into plan, upload, kernel and download; the whole output
   against the plain version, run on the card band by band through
   ``origin``;
5. the same for a 2D slide-scan mosaic: 32 x 32 tiles of 512^2 uint16,
   overlap 64;
6. a ``kernels`` JSON line: per kernel its launches in the main-path run,
   its time, the plain version's time, its bound and its error.

The last line is ``{"ok": true, "device": {...}}``. Any failure raises and
the script exits non-zero without that line; without a CUDA device it exits
non-zero at once. Tolerances: f32 outputs rtol 1e-4, atol 1e-3; uint16
outputs at most 1 count (truncation ties: a single-view pixel fuses to
w*a/w, which f32 may round just below a).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent
KEY = "affine_metadata"

# H100 SXM peaks (NVIDIA data sheet), at the card's full power limit
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# f32 operations per covered (output voxel, view) pair, with the per-column
# parts of the hat expansion amortized away: trilinear lerp 7 x 3, z weight
# contraction 5 hats x 3 + 5 x 2, taper and clip 6, accumulation 5
OPS_PER_VOXEL_VIEW_3D = 21 + 25 + 6 + 5
# bilinear lerp 3 x 3, y weight contraction 25, taper and clip 6, accumulation 5
OPS_PER_VOXEL_VIEW_2D = 9 + 25 + 6 + 5

F32_RTOL, F32_ATOL, UINT_COUNTS = 1e-4, 1e-3, 1


def log(msg):
    print(msg, flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def build_all(_build):
    """Build every CUDA source of the port at once, one nvcc each."""
    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as ex:
        paths = list(ex.map(_build.build, names))
    return names, paths, time.perf_counter() - t0


def max_err(got, ref, np):
    return float(np.abs(got.astype(np.float64) - ref.astype(np.float64)).max(initial=0.0))


def within_tol(got, ref, np) -> bool:
    if np.issubdtype(ref.dtype, np.integer):
        return max_err(got, ref, np) <= UINT_COUNTS
    return bool(np.all(np.abs(got - ref) <= F32_ATOL + F32_RTOL * np.abs(ref)))


def small_layout(np, tsi, tcore, ndim, case, rng):
    """Kernel tables of a small translation grid (a copy of the CPU tests'
    layouts): "unit", "scaled" (z scale 2 in 3D) or "per_view" (one view at
    another spacing; z scale 1.25 in 3D); one view has fractional offsets."""
    sdims = ["z", "y", "x"][-ndim:]
    if ndim == 2:
        tile, step, grid, frac = (24, 40), (18, 30), (2, 2), (0.3, 0.7)
    else:
        tile, step, grid, frac = (10, 16, 40), (8, 12, 32), (2, 1, 2), (0.4, 0.3, 0.7)
    sims = []
    for iv, idx in enumerate(np.ndindex(grid)):
        odd = case == "per_view" and iv % 2
        spacing = dict(zip(sdims, [0.8, 0.5, 0.5][-ndim:])) if odd else None
        shape = tuple(int(t * 1.5) for t in tile) if odd else tile
        sims.append(tsi.get_sim_from_array(
            (rng.random(shape) * 900).astype(np.float32), dims=sdims, scale=spacing,
            translation={
                d: float(idx[i] * step[i] + (frac[i] if iv == 1 else 0.0))
                for i, d in enumerate(sdims)
            },
        ))
    osp = tcore.process_output_stack_properties(
        sims, transform_key=KEY,
        output_spacing=dict(zip(sdims, [2.0, 1.5, 1.5][-ndim:])) if case == "scaled" else None,
    )
    osp = {k: {d: (int(v[d]) if k == "shape" else float(v[d])) for d in sdims}
           for k, v in osp.items()}
    scales = tcore._views_output_scales_per_view(sims, osp, sdims) if case == "per_view" else None
    scale_arr = scales if scales is not None else np.asarray(
        tcore._views_output_scale(sims, osp, sdims)
    )
    tables = tcore.translation_kernel_params(
        {"sparams": [np.eye(ndim + 1)] * len(sims)},
        [tsi.get_stack_properties_from_sim(s) for s in sims], osp, sdims, None, 0, scale_arr,
    )
    max_shape = tuple(max(s.data.shape[i] for s in sims) for i in range(ndim))
    tiles = np.stack([
        np.pad(s.data, [(0, m - n) for n, m in zip(s.data.shape, max_shape)], mode="edge")
        for s in sims
    ])
    scale = tuple(float(x) for x in np.max(np.atleast_2d(scale_arr), axis=0))
    if ndim == 3:
        scale = (int(np.ceil(scale[0])),) + scale[1:]
    return tiles, tables, tuple(osp["shape"][d] for d in sdims), scale_arr, scale, scales


def check_small_cases(np, torch, tsi, tcore, tf):
    """Phase 3: every kernel against its plain version on the card."""
    worst = {2: 0.0, 3: 0.0}
    rng = np.random.default_rng(0)
    tile_shapes = {
        2: [tf.TILE_SHAPE_2D, (32, 128), (20, 50)],
        3: [tf.TILE_SHAPE_3D, (8, 16, 128), (6, 12, 40)],
    }
    for ndim in (2, 3):
        fn = tf.fuse_translation_3d if ndim == 3 else tf.fuse_translation_2d
        plain = tf.fuse_translation_3d_plain if ndim == 3 else tf.fuse_translation_2d_plain
        for case in ("unit", "scaled", "per_view"):
            tiles, tables, out_shape, scale_arr, scale, scales = small_layout(
                np, tsi, tcore, ndim, case, rng
            )
            for tile_shape in tile_shapes[ndim]:
                view_idx = tcore.tile_view_lists(
                    tables[0], tables[1], np.asarray(scale_arr, np.float64), out_shape, tile_shape
                )
                variants = [("f32", torch.float32, None, out_shape, view_idx)]
                if case == "unit":
                    variants.append(("uint16", torch.uint16, None, out_shape, view_idx))
                    origin = np.zeros(ndim, np.int32)
                    origin[0] = tile_shape[0]
                    band_shape = (min(tile_shape[0], out_shape[0] - origin[0]),) + out_shape[1:]
                    variants.append(("origin", torch.float32, origin, band_shape, view_idx[1:2]))
                for label, out_dtype, origin, shape, vidx in variants:
                    args = (
                        torch.from_numpy(tiles).cuda(), vidx, *tables,
                    )
                    kw = dict(out_shape=shape, tile_shape=tile_shape, K=vidx.shape[-1],
                              out_dtype=out_dtype, origin=origin, scale=scale,
                              scales=None if scales is None else np.asarray(scales, np.float32))
                    got = fn(*args, **kw)
                    ref = plain(*args, **kw)
                    torch.cuda.synchronize()
                    assert got.device == args[0].device and tuple(got.shape) == tuple(shape), got.shape
                    g = got.cpu().numpy().astype(np.float64 if out_dtype == torch.float32 else np.int64)
                    r = ref.cpu().numpy().astype(g.dtype)
                    err = max_err(g, r, np)
                    ok = within_tol(g, r, np)
                    log(f"  {ndim}d {case:8s} {label:6s} tile={tile_shape}: "
                        f"max_abs_err={err:.3g} {'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise AssertionError(f"{ndim}d {case} {label} {tile_shape}: kernel != plain")
                    worst[ndim] = max(worst[ndim], err)
    return worst


def smooth_tile(np, rng, shape, scale=1000.0, sigma=1.5):
    """Microscopy-like synthetic content: band-limited noise as uint16."""
    from scipy.ndimage import gaussian_filter

    d = gaussian_filter(rng.random(shape), sigma)
    d -= d.min()
    return (d * (scale / max(d.max(), 1e-9))).astype(np.uint16)


def grid_sims(np, tsi, ndim, n, tile, overlap, seed):
    """n x n translation grid of uint16 tiles (rolled copies of one smooth
    tile), as the JAX package's bench builds its north-star grid."""
    rng = np.random.default_rng(seed)
    base = smooth_tile(np, rng, (tile,) * ndim)
    step = tile - overlap
    sdims = ["z", "y", "x"][-ndim:]
    sims = []
    for iy in range(n):
        for ix in range(n):
            data = np.ascontiguousarray(np.roll(base, (iy * 7 + ix * 3) % tile, axis=ndim - 1))
            translation = {"y": float(iy * step), "x": float(ix * step)}
            if ndim == 3:
                translation["z"] = 0.0
            sims.append(tsi.get_sim_from_array(data, dims=sdims, translation=translation))
    return sims


class StageTimer:
    """Splits one fuse() call into plan, upload, kernel and download by
    wrapping the stages that fusion._core calls; the kernel wrappers stay
    untouched, so their launch counts stay true."""

    def __init__(self, torch, tcore, tf):
        self.torch, self.tcore, self.tf = torch, tcore, tf
        self.events = {}
        self.t_upload_start = None
        self.kernel_call = None

    def _timed(self, name, fn, before=None):
        torch = self.torch

        def wrapped(*a, **k):
            if before:
                before(a, k)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*a, **k)
            e1.record()
            self.events[name] = (e0, e1)
            return out

        return wrapped

    def __enter__(self):
        tcore, tf = self.tcore, self.tf
        self._saved = (tcore._tiles_to_device, tcore._download, tcore.translation_fusion)

        def mark(a, k):
            self.t_upload_start = time.perf_counter()

        def keep(a, k):
            self.kernel_call = (a, k)

        tcore._tiles_to_device = self._timed("upload", tcore._tiles_to_device, mark)
        tcore._download = self._timed("download", tcore._download)
        tcore.translation_fusion = types.SimpleNamespace(
            TILE_SHAPE_2D=tf.TILE_SHAPE_2D,
            TILE_SHAPE_3D=tf.TILE_SHAPE_3D,
            fuse_translation_2d=self._timed("kernel", tf.fuse_translation_2d, keep),
            fuse_translation_3d=self._timed("kernel", tf.fuse_translation_3d, keep),
        )
        return self

    def __exit__(self, *exc):
        tcore = self.tcore
        tcore._tiles_to_device, tcore._download, tcore.translation_fusion = self._saved
        return False

    def split_ms(self, t_start):
        self.torch.cuda.synchronize()
        out = {"plan_ms": (self.t_upload_start - t_start) * 1e3}
        for name in ("upload", "kernel", "download"):
            e0, e1 = self.events[name]
            out[f"{name}_ms"] = e0.elapsed_time(e1)
        return out


def covered_voxel_views(np, offs, extents, scale_arr, out_shape):
    """(output voxel, view) pairs where a view is valid: this run's work."""
    scale_arr = np.broadcast_to(np.asarray(scale_arr, np.float64), offs.shape)
    total = 0
    for v in range(len(offs)):
        n = 1
        for d, O in enumerate(out_shape):
            o = np.arange(O, dtype=np.float64)
            c = scale_arr[v, d] * o + offs[v, d]
            n *= int(np.count_nonzero((c >= 0) & (c <= extents[v, d] - 1)))
        total += n
    return total


def time_kernel_ms(torch, fn, args, kw, reps):
    fn(*args, **kw)  # warm
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn(*args, **kw)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def main_path(np, torch, tsi, tcore, tf, fuse, ndim, n, tile, overlap, band_tiles):
    """Phases 4 and 5: one main path through fuse(), checked and timed."""
    label = f"{ndim}d main path"
    sims = grid_sims(np, tsi, ndim, n, tile, overlap, seed=ndim)
    step = tile - overlap
    expect = ((tile,) if ndim == 3 else ()) + ((n - 1) * step + tile,) * 2
    wrapper = tf.fuse_translation_3d if ndim == 3 else tf.fuse_translation_2d
    plain = tf.fuse_translation_3d_plain if ndim == 3 else tf.fuse_translation_2d_plain

    t0 = time.perf_counter()
    cold = fuse(sims, transform_key=KEY)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    del cold

    # the main path's run: counts set to 0 just before, read just after
    tf.fuse_translation_2d.launches = 0
    tf.fuse_translation_3d.launches = 0
    with StageTimer(torch, tcore, tf) as st:
        t0 = time.perf_counter()
        fused = fuse(sims, transform_key=KEY)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        split = st.split_ms(t0)
    launches = wrapper.launches
    other = tf.fuse_translation_2d if ndim == 3 else tf.fuse_translation_3d
    if launches < 1 or other.launches != 0:
        raise AssertionError(f"{label}: kernel launches {launches}, other kernel {other.launches}")

    out = fused.data
    if out.shape != expect or out.dtype != np.uint16:
        raise AssertionError(f"{label}: output {out.shape} {out.dtype}, expected {expect} uint16")
    # a window in the middle of tile (5, 5), away from every overlap and
    # border taper, holds that view alone at full weight: the output equals
    # the tile there, exactly
    c = tile // 2 - 8
    y0 = 5 * step + c
    win = (slice(y0, y0 + 16), slice(y0, y0 + 16))
    twin = (slice(c, c + 16), slice(c, c + 16))
    if ndim == 3:
        win, twin = (slice(16, 48),) + win, (slice(16, 48),) + twin
    if not np.array_equal(out[win], sims[5 * n + 5].data[twin]):
        raise AssertionError(f"{label}: interior of tile (5, 5) is not the tile")
    log(f"{label}: output {out.shape} {out.dtype}, cold fuse {cold_s:.3f} s, "
        f"warm fuse {warm_s:.3f} s, launches {launches}")
    log(f"{label}: warm split " + json.dumps({k: round(v, 3) for k, v in split.items()}))

    # the kernel's own call at the main-path shapes, tables already on the card
    args, kw = st.kernel_call
    tiles = args[0]
    dev_args = (tiles,) + tuple(torch.as_tensor(x).cuda() for x in args[1:])
    kernel_ms = time_kernel_ms(torch, wrapper, dev_args, kw, reps=10)

    # the whole output against the plain version on the card, band by band
    view_idx = np.asarray(args[1])
    T0 = kw["tile_shape"][0]
    n_bands = -(-view_idx.shape[0] // band_tiles)
    err, plain_ms = 0.0, 0.0
    for b in range(n_bands):
        origin = np.zeros(ndim, np.int32)
        origin[0] = b * band_tiles * T0
        shape = (min(band_tiles * T0, expect[0] - origin[0]),) + tuple(expect[1:])
        bkw = dict(kw, out_shape=shape, origin=origin)
        bargs = (tiles, dev_args[1][b * band_tiles:(b + 1) * band_tiles]) + dev_args[2:]
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        ref = plain(*bargs, **bkw)
        e1.record()
        torch.cuda.synchronize()
        plain_ms += e0.elapsed_time(e1)
        ref = ref.cpu().numpy()
        got = out[origin[0]:origin[0] + shape[0]]
        err = max(err, max_err(got, ref, np))
        if not within_tol(got.astype(np.int64), ref.astype(np.int64), np):
            raise AssertionError(f"{label}: band {b} differs from the plain version by {err}")
        del ref
    log(f"{label}: kernel {kernel_ms:.3f} ms, plain {plain_ms:.1f} ms over {n_bands} bands, "
        f"max_abs_err vs plain {err:g} counts")

    offs, extents = np.asarray(args[2]), np.asarray(args[3])
    scale_arr = np.asarray(kw["scale"], np.float64) if kw.get("scales") is None else kw["scales"]
    pairs = covered_voxel_views(np, offs, extents, scale_arr, expect)
    nbytes = (
        tiles.numel() * tiles.element_size() + int(np.prod(expect)) * 2
        + sum(int(np.asarray(a).nbytes) for a in args[1:])
    )
    ops = pairs * (OPS_PER_VOXEL_VIEW_3D if ndim == 3 else OPS_PER_VOXEL_VIEW_2D)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return {
        "launches": int(launches),
        "max_abs_err": err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
        "cold_fuse_s": cold_s,
        "warm_fuse_s": warm_s,
        **split,
        "bytes": nbytes,
        "voxel_views": pairs,
    }


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 1
    if not (REPO / "multiview_stitcher_torch").is_dir():
        print(f"chip_smoke: no multiview_stitcher_torch package beside {__file__}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from multiview_stitcher_torch import si_utils as tsi
    from multiview_stitcher_torch.fusion import _core as tcore
    from multiview_stitcher_torch.fusion import fuse
    from multiview_stitcher_torch.ops import _build
    from multiview_stitcher_torch.ops import translation_fusion as tf

    log(card_line())
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    names, paths, build_s = build_all(_build)
    log(f"build: {names} in {build_s:.1f} s")
    for p in paths:
        for line in p.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")

    log("kernels against their plain versions on small layouts:")
    small_err = check_small_cases(np, torch, tsi, tcore, tf)

    r3 = main_path(np, torch, tsi, tcore, tf, fuse, 3, n=32, tile=64, overlap=12, band_tiles=2)
    r2 = main_path(np, torch, tsi, tcore, tf, fuse, 2, n=32, tile=512, overlap=64, band_tiles=64)

    source = "multiview_stitcher_torch/csrc/translation_fusion.cu"
    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [
        {"name": "fuse_translation_3d", "route": "cuda", "source": source,
         "replaces": "multiview_stitcher_tpu/ops/pallas_fusion.py:399",
         **{k: r3[k] for k in keys}},
        {"name": "fuse_translation_2d", "route": "cuda", "source": source,
         "replaces": "multiview_stitcher_tpu/ops/pallas_fusion.py:100",
         **{k: r2[k] for k in keys}},
    ]
    for k, ndim in zip(kernels, (3, 2)):
        k["max_abs_err"] = max(k["max_abs_err"], small_err[ndim])
    detail = {"3d": r3, "2d": r2, "build_s": build_s}
    log("detail: " + json.dumps(detail))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
