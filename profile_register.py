#!/usr/bin/env python3
"""Profile one warm ``register()`` of ``chip_smoke.py``'s stitch grid on the
card with ``torch.profiler``.

Run from the root of the repository, on a machine with a CUDA device:

    python3 profile_register.py

It builds the stitch phase's grid (32 x 32 tiles of 64^3 uint16, metadata
off by up to 3 px), registers it once to warm up, then once under the
profiler, and prints the registration's stage telemetry, the device time
summed over all kernels against the call's wall time, and the ops with the
most device time. The profiler slows the host, so the wall time printed is
not the call's unprofiled time (``chip_smoke.py`` gives that).
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent


def main() -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_register: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from multiview_stitcher_torch import registration as treg
    from multiview_stitcher_torch import si_utils as tsi

    print(cs.card_line(), flush=True)
    sims, _, _ = cs.stitch_grid_sims(np, tsi, 32, 64, 12, seed=11)
    kw = dict(transform_key=cs.KEY, device_tiles=True, overlap_tolerance=cs.STITCH_TOLERANCE)
    treg.register(sims, **kw)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        treg.register(sims, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print("telemetry " + json.dumps(treg.last_telemetry), flush=True)
    events = prof.key_averages()
    # the kernels themselves (device events), each counted once
    device_s = sum(
        getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
        for e in events
        if e.device_type == torch.autograd.DeviceType.CUDA
    ) / 1e6
    print(f"profiled register(): wall {wall:.2f} s, kernels {device_s:.2f} s of device time",
          flush=True)
    print(events.table(sort_by="cuda_time_total", row_limit=25), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
