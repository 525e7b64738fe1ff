"""zarr_job_s: the mean wall of the window's zarr-to-OME-Zarr jobs, each
from the call until the store, its pyramid and metadata are written."""


def read(run):
    return sum(j["wall_s"] for j in run.jobs) / len(run.jobs)
