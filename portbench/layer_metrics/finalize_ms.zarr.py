"""finalize_ms.zarr: what a zarr job spends outside the streamed pass
and the plan: the pyramid and metadata, derived as the job's wall less
the streamed pass and the fuse.plan stage, ms."""

from portbench.telemetry import mean_ms


def _rest(j):
    if j["stream"].get("elapsed_s") is None:
        return None
    return j["wall_s"] - j["stream"]["elapsed_s"] - j["stages"].get("fuse.plan", 0.0)


def read(run):
    return mean_ms(run.jobs, _rest)
