"""The readers of the port's program spans (``portbench/spans.py``) on
synthetic traces: the idle time a span covers fully, partly or not at all,
the kernels counted inside the pairwise span only, and the stage means of
the window's jobs; None wherever there is nothing to read."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from portbench import spans
from portbench.telemetry import JOB, Trace

MAIN, WORKER = 1, 2
STAGES = {"tiles.upload": {"total_s": 1.0, "count": 1},
          spans.PAIRWISE: {"total_s": 1.0, "count": 1}}


@pytest.fixture(autouse=True)
def _stage_names(monkeypatch):
    from multiview_stitcher_torch.utils import profiling

    monkeypatch.setattr(profiling, "get_stage_times", lambda: dict(STAGES))


def _run(host=(), device=(), jobs=((0.0, 100.0),), traced_jobs=()):
    """A run whose trace has the jobs, host events (start, end, name[,
    thread]) and device events (start, end, name), in us."""
    events = [(a, b, JOB, False, True, MAIN) for a, b in jobs]
    events += [(h[0], h[1], h[2], False, True, h[3] if len(h) > 3 else MAIN) for h in host]
    events += [(a, b, name, True, False, 0) for a, b, name in device]
    return SimpleNamespace(trace=Trace(events), traced_jobs=list(traced_jobs), jobs=[])


# the card busy at both ends of the job: one idle gap, 10-90 us
BUSY = [(0.0, 10.0, "kernel_a"), (90.0, 100.0, "kernel_b")]


@pytest.mark.parametrize("host, want", [
    ([(5.0, 95.0, "tiles.upload")], 0.0),
    ([(10.0, 50.0, "tiles.upload")], 50.0),
    ([(10.0, 30.0, "tiles.upload"), (20.0, 50.0, "tiles.upload")], 50.0),
    ([(0.0, 5.0, "tiles.upload"), (20.0, 60.0, "aten::to")], 100.0),
    ([(0.0, 5.0, "tiles.upload"), (10.0, 90.0, "tiles.upload", WORKER)], 100.0),
], ids=["covering", "half", "overlapping_spans", "not_covering", "other_thread"])
def test_idle_unspanned_share(host, want):
    assert spans.idle_unspanned_pct(_run(host, BUSY)) == pytest.approx(want)


def test_idle_unspanned_share_over_several_gaps_and_jobs():
    device = [(0.0, 10.0, "k"), (40.0, 60.0, "k"), (200.0, 210.0, "k")]
    # gaps: 10-40 and 60-100 in the first job, 210-300 in the second: 160 us
    host = [(30.0, 70.0, "tiles.upload"), (250.0, 300.0, spans.PAIRWISE)]
    run = _run(host, device, jobs=((0.0, 100.0), (200.0, 300.0)))
    assert spans.idle_unspanned_pct(run) == pytest.approx(100.0 * (1 - 70.0 / 160.0))


def test_idle_unspanned_share_reads_nothing_without_spans_or_trace():
    assert spans.idle_unspanned_pct(_run([(10.0, 50.0, "aten::to")], BUSY)) is None
    assert spans.idle_unspanned_pct(SimpleNamespace(trace=None)) is None


def test_launches_are_counted_inside_the_pairwise_span_only():
    device = [(12.0, 13.0, "gather"), (20.0, 21.0, "where"), (55.0, 58.0, "fft"),
              (30.0, 31.0, "Memcpy HtoD (Pageable -> Device)"), (40.0, 41.0, "Memset (Device)"),
              (5.0, 6.0, "before"), (70.0, 71.0, "after"), (60.0, 61.0, "at_the_end")]
    host = [(10.0, 60.0, spans.PAIRWISE), (65.0, 80.0, "tiles.upload")]
    run = _run(host, device, traced_jobs=[{"registration": {"buckets": 3}}])
    assert spans.pairwise_launches(run) == pytest.approx(1.0)
    # two traced jobs: the kernels of both spans over both jobs' buckets
    run = _run(host + [(110.0, 160.0, spans.PAIRWISE)], device + [(120.0, 121.0, "k")],
               jobs=((0.0, 100.0), (100.0, 200.0)),
               traced_jobs=[{"registration": {"buckets": 3}}, {"registration": {"buckets": 1}}])
    assert spans.pairwise_launches(run) == pytest.approx(1.0)


@pytest.mark.parametrize("host, device, traced", [
    ([(10.0, 60.0, "tiles.upload")], BUSY, [{"registration": {"buckets": 3}}]),
    ([(10.0, 60.0, spans.PAIRWISE)], BUSY, [{"registration": {}}]),
    ([(10.0, 60.0, spans.PAIRWISE)], [], [{"registration": {"buckets": 3}}]),
], ids=["no_span", "no_buckets", "no_device"])
def test_launches_read_nothing_without_span_buckets_or_device(host, device, traced):
    assert spans.pairwise_launches(_run(host, device, traced_jobs=traced)) is None


def test_stage_ms_is_the_mean_over_the_window_and_none_where_a_job_lacks_it():
    read = spans.stage_ms("fuse.pyramid")
    run = SimpleNamespace(jobs=[{"stages": {"fuse.pyramid": 3.0}},
                                {"stages": {"fuse.pyramid": 4.0, "fuse.plan": 1.0}}])
    assert read(run) == pytest.approx(3500.0)
    run.jobs.append({"stages": {"fuse.plan": 1.0}})
    assert read(run) is None
