"""stitch_s: the mean wall of the window's stitch() calls, each from the
call to the synchronised fused result."""


def read(run):
    return sum(j["wall_s"] for j in run.jobs) / len(run.jobs)
