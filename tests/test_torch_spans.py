"""The port's spans (``utils.profiling.stage``): their records, their marks
in a ``torch.profiler`` trace, exact counts from many threads, and the stages
that ``fuse()`` and ``register()`` record on the CPU (a monolithic 2D fusion,
a streamed zarr to OME-Zarr fusion with its pyramid, a registration)."""

from __future__ import annotations

import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from multiview_stitcher_torch import registration as treg
from multiview_stitcher_torch import sample_data as tsd
from multiview_stitcher_torch import si_utils as tsi
from multiview_stitcher_torch.fusion import _core as tcore
from multiview_stitcher_torch.fusion import _streaming as tstream
from multiview_stitcher_torch.fusion import fuse as tfuse
from multiview_stitcher_torch.io import zarr_backend as tzb
from multiview_stitcher_torch.utils import profiling

KEY = tsi.DEFAULT_TRANSFORM_KEY
# the stages a thread may hold open around another's: registration's
NESTING = ("register.",)


@pytest.fixture(autouse=True)
def _fresh():
    profiling.reset_stage_times()
    tcore.clear_device_tile_cache()
    yield
    profiling.reset_stage_times()
    tcore.clear_device_tile_cache()


def _grid_sims(n=6, tile=48, overlap=12, seed=0, arrays=None):
    """An n x n grid of uint16 2D tiles; ``arrays`` replaces the host data
    (lazy zarr tiles)."""
    rng = np.random.default_rng(seed)
    step = tile - overlap
    sims = []
    for i, idx in enumerate(np.ndindex((n, n))):
        data = rng.integers(0, 3000, (tile, tile)).astype(np.uint16)
        sims.append(tsi.get_sim_from_array(
            data if arrays is None else arrays(i, data), dims=["y", "x"],
            translation={d: float(idx[k] * step) for k, d in enumerate("yx")},
            transform_key=KEY,
        ))
    return sims


def _zarr_sims(tmp_path, **kw):
    def write(i, data):
        url = str(tmp_path / "tiles" / f"tile_{i}.zarr")
        tzb.create_zarr_array(url, data.shape, data.shape, data.dtype)[...] = data
        return tzb.open_zarr_array(url)

    return _grid_sims(arrays=write, **kw)


def _stages():
    return {k: v["count"] for k, v in profiling.get_stage_times().items()}


def _host_ranges(prof, names):
    """(start_ns, end_ns, name, thread) of the trace's events named in ``names``."""
    raw = prof.profiler.kineto_results
    return [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name(), e.start_thread_id())
            for e in raw.events() if e.name() in names]


def test_stage_marks_the_trace_only_while_a_profiler_records(monkeypatch):
    calls = []
    orig = profiling.record_function

    def spy(name):
        calls.append(name)
        return orig(name)

    monkeypatch.setattr(profiling, "record_function", spy)
    with profiling.stage("spans.off"):
        torch.ones(4).sum()
    assert calls == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.stage("spans.on"):
            torch.ones(4).sum()
    assert calls == ["spans.on"]
    (got,) = _host_ranges(prof, {"spans.on", "spans.off"})
    assert got[2] == "spans.on" and got[1] > got[0]
    # the records are as they were: one call each, its wall time
    times = profiling.get_stage_times()
    assert {k: v["count"] for k, v in times.items()} == {"spans.off": 1, "spans.on": 1}
    assert all(v["total_s"] > 0 for v in times.values())


def test_stage_works_as_a_decorator_and_records_a_raising_call():
    @profiling.stage("spans.decorated")
    def fails():
        raise ValueError("inside")

    for _ in range(2):
        with pytest.raises(ValueError, match="inside"):
            fails()
    assert _stages() == {"spans.decorated": 2}


def test_stages_from_many_threads_count_exactly():
    n_threads, per_thread = 8, 1000
    start = threading.Barrier(n_threads)

    def work():
        start.wait(timeout=30)
        for _ in range(per_thread):
            with profiling.stage("spans.threads"):
                pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert _stages() == {"spans.threads": n_threads * per_thread}


def test_monolithic_fuse_records_the_upload_and_the_download():
    out = tfuse(_grid_sims(n=3), transform_key=KEY, device="cpu")
    assert np.asarray(out.data).any()
    assert _stages() == {"fuse.plan": 1, "tiles.upload": 1, "fuse.download": 1}


def test_streamed_zarr_fuse_records_the_pass_its_threads_seeding_and_pyramid(tmp_path):
    sims = _zarr_sims(tmp_path)
    url = str(tmp_path / "out.ome.zarr")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tfuse(sims, transform_key=KEY, device="cpu", output_chunksize=64, output_zarr_url=url)
    tele = tstream.last_telemetry
    got = _stages()
    assert got == {
        "fuse.plan": 1, "stream.pass": 1, "stream.read": tele["batches"],
        "stream.write": tele["bands_done"], "stream.seed_cache": 1, "fuse.pyramid": 1,
    }
    assert tele["bands_done"] >= 2 and len(tzb.read_group_metadata(url)[0]["multiscales"][0]
                                           ["datasets"]) == 2
    # the pass ends at its last elapsed_s stamp
    assert profiling.get_stage_times()["stream.pass"]["total_s"] >= tele["elapsed_s"]
    # on the caller's thread the stages follow one another; the workers'
    # stages are not marked in the caller's trace
    ranges = sorted(_host_ranges(prof, set(got)))
    assert {r[2] for r in ranges} == {"fuse.plan", "stream.pass", "stream.seed_cache",
                                      "fuse.pyramid"}
    assert len({r[3] for r in ranges}) == 1
    assert all(a[1] <= b[0] for a, b in zip(ranges, ranges[1:]))

    # a repeat finds the seeded stack: no read and no seeding
    profiling.reset_stage_times()
    tfuse(sims, transform_key=KEY, device="cpu", output_chunksize=64,
          output_zarr_url=str(tmp_path / "again.ome.zarr"))
    assert tstream.last_telemetry["up_batches_resident"] == tele["batches"]
    assert _stages() == {"stream.pass": 1, "stream.write": tele["bands_done"],
                         "fuse.pyramid": 1}


def _registration_sims():
    sims = tsd.generate_tiled_dataset(ndim=2, N_c=1, N_t=1, tile_size=30, tiles_x=2,
                                      tiles_y=2, overlap=8)
    return [s.isel({"c": 0, "t": 0}) for s in sims]


@pytest.mark.parametrize("device_tiles", [None, True], ids=["host_crops", "device_tiles"])
def test_register_records_its_stages_around_what_it_calls(device_tiles):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        treg.register(_registration_sims(), transform_key=KEY, new_transform_key="r",
                      device="cpu", device_tiles=device_tiles)
    got = _stages()
    want = {"register.adjacency_graph": 1, "register.pairwise_registrations": 1,
            "register.groupwise_resolution": 1}
    if device_tiles:
        # the resident stack is uploaded inside the pairwise stage
        want["tiles.upload"] = 1
    assert got == want
    ranges = sorted(_host_ranges(prof, set(got)))
    top = [r for r in ranges if r[2].startswith(NESTING)]
    assert all(a[1] <= b[0] for a, b in zip(top, top[1:]))
    pairwise = next(r for r in top if r[2] == "register.pairwise_registrations")
    assert all(pairwise[0] <= r[0] and r[1] <= pairwise[1]
               for r in ranges if not r[2].startswith(NESTING))
