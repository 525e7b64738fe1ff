#!/usr/bin/env python3
"""Run the port's sharded paths over every CUDA device of the machine.

Run from the root of the repository, on a machine with one or more CUDA
devices:

    python3 mesh_check.py

The mesh is ``parallel.mesh.get_mesh()`` (every card); on a machine with one
card it is the virtual mesh of ``chip_smoke.py``'s ``mesh:`` lines, four
entries on cuda:0. Every part of that phase runs over it at full size, each
held to its unsharded run on cuda:0 and timed beside it (warm, in turns):
``fuse(mesh=)`` of the 3D and the 2D translation grids (32 x 32 tiles of
64^3 and of 512^2 uint16; kernels 1 and 2, a band an entry), ``max_fusion``
of the 2D grid's 8 x 8 corner (the tiles tier), ``parallel.pipeline.
sharded_fuse_chunks_exact`` on the fullest batches of the three affine main
paths (kernels 3, 4 and 5), ``register(mesh=)`` of an 8 x 8 grid of 64^3
tiles (host crops and the resident stack) and ``multihost_fuse`` of a 4 x 4
zarr grid by one process a card (two on one card), byte-equal to one
process's. Each card line is printed as ``nvidia-smi --query-gpu=name,
power.limit --format=csv,noheader`` gives it. The last line is one JSON
object with every part's numbers; any failure raises.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("mesh_check: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from multiview_stitcher_torch import msi_utils as tmsi
    from multiview_stitcher_torch import registration as treg
    from multiview_stitcher_torch import si_utils as tsi
    from multiview_stitcher_torch import stitch as tstitch
    from multiview_stitcher_torch.fusion import _core as tcore
    from multiview_stitcher_torch.fusion import fuse
    from multiview_stitcher_torch.io import ngff_utils as tngff
    from multiview_stitcher_torch.ops import _build
    from multiview_stitcher_torch.ops import exact_affine as tea
    from multiview_stitcher_torch.ops import translation_fusion as tf
    from multiview_stitcher_torch.parallel import executors as texec
    from multiview_stitcher_torch.parallel import mesh as tmesh
    from multiview_stitcher_torch.parallel import multihost as tmh
    from multiview_stitcher_torch.utils import profiling as tprof

    t_start = time.perf_counter()
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    for line in cards:
        cs.log(f"card: {line}")
    names, _, build_s = cs.build_all(_build)
    cs.log(f"build: {names} in {build_s:.1f} s")
    found = tmesh.get_mesh()
    mesh = found if found.size > 1 else None
    ph = cs.MeshPhase(np, torch, tf, tea, mesh=mesh, processes=max(2, found.size))

    def monolithic(sims):
        # the unsharded reference: the monolithic tier on cuda:0
        saved = tcore.STREAM_BYTES
        tcore.STREAM_BYTES = 1 << 62
        try:
            return fuse(sims, transform_key=cs.KEY, device="cuda:0").data
        finally:
            tcore.STREAM_BYTES = saved

    def drop_caches():
        tcore.clear_device_tile_cache()
        torch.cuda.empty_cache()

    sims = cs.grid_sims(np, tsi, 3, 32, 64, 12, seed=3)
    ph.part("kernel_1", ph.translation, fuse, sims, monolithic(sims), 3)
    drop_caches()
    sims = cs.grid_sims(np, tsi, 2, 32, 512, 64, seed=2)
    ph.part("kernel_2", ph.translation, fuse, sims, monolithic(sims), 2)
    ph.part("tiles_tier", ph.tiles_tier, fuse, tcore, sims, 32)
    del sims
    drop_caches()

    def coupling(rng):
        return np.eye(3) + rng.uniform(0.005, 0.02, (3, 3)) * rng.choice([-1, 1], (3, 3))

    def rotate_and_scale(rng):
        return cs.rot2(np, np.deg2rad(rng.uniform(-0.5, 0.5)), 1 + rng.uniform(-0.005, 0.005))

    for kind, chunksize, make in (
        ("sepy", 128, lambda: cs.multiview_sims(np, tsi, (256, 512, 512), (0, 47, 92, 137),
                                                seed=4)),
        ("general", 128, lambda: cs.affine_grid_sims(np, tsi, 3, 4, 256, 32, 5, coupling)),
        ("2d", 1024, lambda: cs.affine_grid_sims(np, tsi, 2, 16, 1024, 64, 6,
                                                 rotate_and_scale)),
    ):
        sims = make()

        def exact_part():
            _, batch = cs.capture_fullest_batches(
                np, torch, tcore,
                lambda: fuse(sims, transform_key=cs.KEY, output_chunksize=chunksize,
                             device="cuda:0"),
                ph.mesh.size)
            return ph.exact(tcore, batch, kind)

        ph.part(f"exact_{kind}", exact_part)
        del sims
        drop_caches()
    ph.part("register", ph.register, tsi, tstitch, treg, tmsi, tprof)
    ph.part("multihost", ph.multihost, tsi, tngff, texec, tmh,
            REPO / ".bench_large" / "mesh_check_multihost")
    ph.say(f"phase {ph.out['phase_s']:.1f} s, mesh launches {ph.launches}")
    print(json.dumps({"ok": True, "cards": cards, "mesh": [str(d) for d in ph.mesh.devices],
                      "total_s": time.perf_counter() - t_start, "parts": ph.out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
