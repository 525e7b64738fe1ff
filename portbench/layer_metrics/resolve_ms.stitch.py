"""resolve_ms.stitch: the global resolution a stitch() call
(registration.last_telemetry resolve_s), ms."""

from portbench.telemetry import mean_ms


def read(run):
    return mean_ms(run.jobs, lambda j: j["registration"].get("resolve_s"))
