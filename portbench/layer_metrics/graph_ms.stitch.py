"""graph_ms.stitch: the tile graph and its pruning a stitch() call
(registration.last_telemetry graph_s + prune_s), ms."""

from portbench.telemetry import mean_ms


def read(run):
    return mean_ms(run.jobs, lambda j: None if "graph_s" not in j["registration"]
                   else j["registration"]["graph_s"] + j["registration"]["prune_s"])
