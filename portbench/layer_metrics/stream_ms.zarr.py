"""stream_ms.zarr: the streamed pass of a job, tile reads, uploads,
kernels, downloads and level-0 writes (the port's
_streaming.last_telemetry["elapsed_s"]), ms."""

from portbench.telemetry import mean_ms


def read(run):
    return mean_ms(run.jobs, lambda j: j["stream"].get("elapsed_s"))
