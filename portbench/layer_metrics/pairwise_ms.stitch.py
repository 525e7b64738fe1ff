"""pairwise_ms.stitch: the pairwise registrations a stitch() call, crop
plan, uploads and phase correlation on the card (registration.last_telemetry
pairwise_s), ms."""

from portbench.telemetry import mean_ms


def read(run):
    return mean_ms(run.jobs, lambda j: j["registration"].get("pairwise_s"))
