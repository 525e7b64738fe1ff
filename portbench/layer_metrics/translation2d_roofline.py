"""translation2d_roofline: the 2D translation-fusion kernel's share of
its bandwidth bound: the traced jobs' counted bytes (every channel of the
tiles read once, of the output written once) over 3.35 TB/s, over the
kernel's device time in their trace, %."""

from portbench import roofline

KERNEL = "fuse_translation_2d_kernel"


def read(run):
    if run.trace is None or not run.traced_jobs:
        return None
    return roofline.share_pct(sum(j["kernel_bytes"] for j in run.traced_jobs),
                              run.trace.device_s(KERNEL))
