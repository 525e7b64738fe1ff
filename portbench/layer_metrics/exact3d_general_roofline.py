"""exact3d_general_roofline: the general 3D exact-affine kernel's share of
its bandwidth bound: the traced jobs' counted bytes (every view read once,
the output written once) over 3.35 TB/s, over the kernel's device time in
their trace (its data and its weight launches), %."""

from portbench import roofline

KERNEL = "exact_affine_3d_general_kernel"


def read(run):
    if run.trace is None or not run.traced_jobs:
        return None
    return roofline.share_pct(sum(j["kernel_bytes"] for j in run.traced_jobs),
                              run.trace.device_s(KERNEL))
