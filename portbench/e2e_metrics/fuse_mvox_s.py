"""fuse_mvox_s: output voxels of every job in the window over the sum of
those jobs' walls, in millions a second."""


def read(run):
    wall = sum(j["wall_s"] for j in run.jobs)
    return sum(j["out_voxels"] for j in run.jobs) / wall / 1e6
