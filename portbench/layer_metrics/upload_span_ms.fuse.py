"""upload_span_ms.fuse: the upload stream's span (first to last CUDA
event of the uploads) of a job's last streamed pass, ms (the port's
_streaming.last_telemetry["up_ms"])."""

from portbench.telemetry import mean_ms


def read(run):
    return mean_ms(run.jobs, lambda j: None if j["stream"].get("up_ms") is None
                   else j["stream"]["up_ms"] / 1e3)
