"""Banded streaming execution of the translation tier: the port of
``multiview_stitcher_tpu.fusion._streaming``.

Large fusions (the north star: about 1000 tiles of a 3D grid read from zarr
and written to zarr) are bound by moving data: every input tile up to the
device and every output voxel down. The monolithic tier runs upload, kernel
and download one after the other; this tier cuts the output into bands
along one axis and overlaps them:

    read + upload view batch i+1  ||  kernel on band i  ||  download + write band i-1

Views stay on the device only while a band needs them (a sliding window of
upload batches), so the inputs need not fit on the device.

On a CUDA device the pipeline runs on three streams: uploads on one, the
kernel on the caller's compute stream, downloads on a third (the two side
streams are the same for every pass on a device), joined by
events (``stream.wait_event``). Reader threads read each batch of tiles into
a pinned host buffer and start its upload (``copy_(non_blocking=True)``); a
buffer is filled again only after the event of its last copy has completed.
Each band is downloaded into a pinned buffer of its own, which a writer
thread writes to the sink once the band's download event has completed and
then returns to the pool. Tensors made on one stream and read on another are
marked with ``record_stream`` so the caching allocator does not hand their
memory out while the other stream still reads it. On the CPU
(``device="cpu"``) the same band loop runs with plain copies and no streams.

The band plan is the reference's exactly (:func:`plan_bands`), and each band
is fused by one kernel call with an integer ``origin``, so a band is bitwise
what the monolithic call computes for its rows.

The views' residency and host copies are ``residency``'s: the device tile
cache, the lazy reads, the host buffers and the side streams.

Reuse across calls, as in the reference. When the device tile cache holds
the views' stack, each "upload" is a gather of the batch's rows on the
device (``up_batches_resident``), ordered like an upload on the upload
stream. Otherwise a pass whose tiles fit the cache's budget keeps every
upload batch; once it completes, :func:`_reorder_concat` puts the batches
back in view order and the stack seeds the cache (a failure warns and the
call goes on). A pass that fails or passes its deadline (``deadline_s``, else
:data:`STREAM_DEADLINE_S`) leaves its completed uploads in the upload-resume
stash, which serves the next pass over the same inputs and batch layout
(``up_batches_reused``) and is retired by a pass that seeds the cache; it
dies with the in-memory source arrays and with
``fusion._core.clear_device_tile_cache()``. An upload takes, in this order:
the resume stash, the resident stack, a read and a copy.

A pass records the ``utils.profiling`` stages ``stream.pass`` (its start to
its last ``elapsed_s`` stamp), ``stream.seed_cache`` (the seeding) and, from
the worker threads, ``stream.read`` (a batch's tile reads) and
``stream.write`` (a band's write to the sink).
"""

from __future__ import annotations

import contextlib
import functools
import json
import queue
import threading
import time
import warnings
import weakref
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from multiview_stitcher_torch import residency

# the wall-time bound of a pass that names none, in seconds (None: unbounded;
# the reference's MVS_TPU_STREAM_DEADLINE_S)
STREAM_DEADLINE_S = None

# upload batches of about this many bytes of tiles, all of one shape
_BATCH_BYTES = 8 << 20
# prefetch depth (view batches ahead of the kernel) and fused bands in flight
# (being downloaded or written); 2-3 keeps the pipe full without hoarding
# device or pinned memory
_PREFETCH_BATCHES = 3
_MAX_INFLIGHT_BANDS = 3
# threads that read and upload batches, and that write bands to the sink
_READER_THREADS = 2
_WRITER_THREADS = 3

# telemetry of the most recent execute_streaming call: bands, bytes moved
# each way, voxels written, wall time, abort state and, on a CUDA device, the
# busy time of each stream. It survives a deadline abort, so a partial run
# still reports its progress
last_telemetry: dict = {}

# the upload-resume stash, empty or one entry ``{"key", "batches"}``:
# "batches" maps a batch index to what an upload returned (the device batch
# and its event)
_upload_stash: dict = {}


def _drop_stash_entry(key) -> None:
    if _upload_stash.get("key") == key:
        _upload_stash.clear()


def _stash(key, batches, field_sims) -> None:
    """Keep ``batches`` as the stash's entry; the entry dies with any of the
    in-memory source arrays."""
    _upload_stash.clear()
    _upload_stash.update(key=key, batches=batches)
    for s in field_sims:
        if isinstance(s.data, np.ndarray):
            weakref.finalize(s.data, _drop_stash_entry, key)


@functools.cache
def _warm_vml_cos() -> None:
    """One ``torch.cos`` of one element, once a process, before the first
    pass starts its threads (fault F7). On the CPU the first ``torch.cos`` of
    a process (ATen's MKL vector-math route) gave, about once in ten runs,
    one or more of its OpenMP threads' chunks results one ulp off what every
    later call gives, when other threads ran torch ops (an int32 ``cumsum``
    does it) at the same time; the plain translation version's cosine taper
    then moved a band's output by up to 15 counts where every view's weight
    is near 0."""
    torch.cos(torch.zeros(1))


def _reorder_concat(batches: list, order, V: int) -> torch.Tensor:
    """The (V, *tile) stack in view order from a pass's upload batches
    (``order[i]`` is the view of sorted position i; U views a batch, the
    tail padded). The stack is allocated once and each batch's rows are
    copied into their views' slots, the batch dropped from ``batches`` as it
    goes, so that the peak holds one stack and the batches not yet copied."""
    U = batches[0].shape[0]
    stack = torch.empty((V,) + tuple(batches[0].shape[1:]), dtype=batches[0].dtype,
                        device=batches[0].device)
    bits = residency.signed_bits(stack)
    for bi in range(len(batches)):
        batch, batches[bi] = batches[bi], None
        n = min(U, V - bi * U)
        rows = torch.as_tensor(np.asarray(order[bi * U:bi * U + n], np.int64), device=stack.device)
        bits.index_copy_(0, rows, residency.signed_bits(batch)[:n])
        del batch
    return stack


class StreamingDeadlineError(RuntimeError):
    """Raised when a streaming run exceeds its deadline; ``.telemetry`` holds
    the partial run's telemetry (bands done, bytes moved, elapsed seconds)."""

    def __init__(self, message, telemetry):
        super().__init__(message)
        self.telemetry = telemetry


def plan_bands(offs, extents, out_shape_full, tile_shape, axis_chunk=None):
    """Choose a band axis and height; return the band table or None.

    ``offs``: (V, ndim) output-pixel -> view-pixel translations (so a view
    occupies output coords [-off, -off + extent) along each axis).
    ``axis_chunk``: optional per-axis output chunk size for write alignment
    (zarr sinks: bands must not share output chunks, or the shards of a
    sharded zarr v3 sink, across concurrent writers). Of the axes with uniform view extents, the one with the most
    bands (at least 3) whose band needs fewer than all views wins.
    """
    V, ndim = offs.shape
    best = None
    for a in range(ndim):
        E = float(extents[0, a])
        if not np.allclose(extents[:, a], E):
            continue  # uniform extents required along the band axis
        T = tile_shape[a]
        H = max(T, int(-(-int(E) // T)) * T)
        if axis_chunk is not None:
            c = int(axis_chunk[a])
            g = np.gcd(H, c)
            H = H * c // g  # lcm: band boundaries align to output chunks
        B = -(-out_shape_full[a] // H)
        if B < 3:
            continue
        m = -offs[:, a]
        order = np.argsort(m, kind="stable")
        ms = m[order]
        pad = 2.0  # interpolation + rounding margin (pixels)
        lo = np.searchsorted(ms, np.arange(B) * H - pad - E, side="right")
        hi = np.searchsorted(ms, (np.arange(B) + 1) * H + pad, side="left")
        NV = int(np.max(hi - lo))
        if NV <= 0 or NV >= V:
            continue
        if best is None or B > best["B"]:
            best = {
                "axis": a, "H": H, "B": B, "order": order,
                "lo": lo.astype(int), "hi": hi.astype(int), "NV": NV,
            }
    return best


def _band_view_lists(offs, extents, sorted_id, n_t, n_t_padded, tile_shape):
    """(*n_t_padded, K) int32 view lists over the kernel tiles of the whole
    output, holding sorted view ids (``sorted_id[v]`` for view v), -1 for
    empty slots; the grid is padded along the band axis to whole bands. View
    v is listed on the tiles that meet [-off - 1, -off + extent] (the
    reference's rule). A tile lists its views in ascending original order, so
    a band sums them in the order the monolithic call does and is bitwise
    its rows for every layout (the reference lists them in sorted order,
    which differs where the band axis is not the views' outer order)."""
    ndim = len(n_t)
    boxes = []
    for v in range(len(offs)):
        vlo = -offs[v] - 1
        vhi = -offs[v] + extents[v]
        box = []
        for d in range(ndim):
            a0 = max(0, int(np.floor(vlo[d] / tile_shape[d])))
            a1 = min(n_t[d] - 1, int(np.floor(vhi[d] / tile_shape[d])))
            if a0 > a1:
                box = None
                break
            box.append(slice(a0, a1 + 1))
        boxes.append(None if box is None else tuple(box))
    count = np.zeros(n_t_padded, dtype=np.int32)
    for box in boxes:
        if box is not None:
            count[box] += 1
    K = max(1, int(count.max(initial=0)))
    view_idx = np.full(tuple(n_t_padded) + (K,), -1, dtype=np.int32)
    fill = np.zeros(n_t_padded, dtype=np.int64)
    for v, box in enumerate(boxes):
        if box is None:
            continue
        np.put_along_axis(view_idx[box], fill[box][..., None], sorted_id[v], axis=-1)
        fill[box] += 1
    return view_idx


def _stream_tables(plan, field_sims, output_stack_properties, sdims, blending_widths,
                   shrink_distance, tile_shape, axis_chunk):
    """The band plan of a pass (:func:`plan_bands`) and its kernel tables, or
    None where the layout does not band: the per-view tables sorted along
    the band axis and padded by NV rows, so that every [lo_b, lo_b + NV)
    slice is in range (no list names a pad row), and the view lists of the
    whole output (:func:`_band_view_lists`)."""
    from multiview_stitcher_torch import si_utils
    from multiview_stitcher_torch.fusion import _core

    ndim = len(sdims)
    out_shape_full = tuple(int(output_stack_properties["shape"][d]) for d in sdims)
    views_bb = [si_utils.get_stack_properties_from_sim(s) for s in field_sims]
    # per-view kernel tables (original order; streaming runs at unit scale)
    offs, extents, wdiags, woffs, wgrids = _core.translation_kernel_params(
        plan, views_bb, output_stack_properties, sdims, blending_widths, shrink_distance,
    )
    bands = plan_bands(offs, extents, out_shape_full, tile_shape, axis_chunk)
    if bands is None:
        return None
    a, H, B, order, NV = bands["axis"], bands["H"], bands["B"], bands["order"], bands["NV"]

    def pad_rows(arr):
        return np.concatenate([arr, np.zeros((NV,) + arr.shape[1:], arr.dtype)])

    n_t = [-(-out_shape_full[d] // tile_shape[d]) for d in range(ndim)]
    n_t_padded = list(n_t)
    n_t_padded[a] = B * (H // tile_shape[a])
    V = len(field_sims)
    sorted_id = np.empty(V, dtype=np.int32)
    sorted_id[order] = np.arange(V, dtype=np.int32)
    return {
        "bands": bands,
        "sorted": tuple(pad_rows(t[order]) for t in (offs, extents, wdiags, woffs, wgrids)),
        "view_idx": _band_view_lists(offs, extents, sorted_id, n_t, n_t_padded, tile_shape),
    }


def execute_streaming(
    plan,
    field_sims,
    output_stack_properties,
    sdims,
    *,
    blending_widths,
    shrink_distance,
    out_dtype,
    device=None,
    out_sink=None,
    tile_shape=None,
    output_chunksize=None,
    is_zarr_sink=False,
    deadline_s=None,
):
    """Run the banded pipeline on ``device``; returns the output sink (or a
    new numpy array), or None when the layout does not band usefully (the
    caller then runs the monolithic tier).

    ``deadline_s`` bounds the wall time (None: :data:`STREAM_DEADLINE_S`,
    unbounded when that is None too): past it the band loop stops submitting
    work, drains the bands in flight and raises
    :class:`StreamingDeadlineError` with the partial telemetry. Any other
    failure raises as it is. Either leaves the completed uploads in the
    upload-resume stash.
    """
    from multiview_stitcher_torch.fusion import _core
    from multiview_stitcher_torch.ops import translation_fusion
    from multiview_stitcher_torch.utils import profiling

    device = torch.device("cpu" if device is None else device)
    cuda = device.type == "cuda"
    if cuda and device.index is None:
        # worker threads start on device 0: name the caller's device
        device = torch.device("cuda", torch.cuda.current_device())
    ndim = len(sdims)
    out_shape_full = tuple(int(output_stack_properties["shape"][d]) for d in sdims)
    if tile_shape is None:
        tile_shape = _core._kernel_tile_shape(ndim, out_shape_full)
    V = len(field_sims)

    axis_chunk = None
    shards = getattr(out_sink, "shards", None) if is_zarr_sink else None
    if shards is not None:
        # concurrent band writes must not share a shard file
        axis_chunk = [int(x) for x in shards[-ndim:]]
    elif is_zarr_sink and output_chunksize is not None:
        # concurrent band writes must not share an output chunk
        axis_chunk = [int(output_chunksize[d]) for d in sdims]
    # the tables are kept on the (cached) plan: a repeat call skips them
    prep_key = (
        "prep:stream", tuple(tile_shape), None if axis_chunk is None else tuple(axis_chunk),
        json.dumps(blending_widths, sort_keys=True, default=float),
        json.dumps(shrink_distance, sort_keys=True, default=float),
    )
    if prep_key not in plan:
        with profiling.stage("fuse.plan"):
            plan[prep_key] = _stream_tables(
                plan, field_sims, output_stack_properties, sdims, blending_widths,
                shrink_distance, tile_shape, axis_chunk,
            )
    tables = plan[prep_key]
    if tables is None:
        return None
    bands = tables["bands"]
    offs_s, extents_s, wdiags_s, woffs_s, wgrids_s = tables["sorted"]
    view_idx_g = tables["view_idx"]
    K = view_idx_g.shape[-1]

    if deadline_s is None:
        deadline_s = STREAM_DEADLINE_S
    _warm_vml_cos()
    with profiling.stage("stream.pass"):
        t_begin = time.perf_counter()

        def remaining():
            return None if deadline_s is None else max(
                1.0, deadline_s - (time.perf_counter() - t_begin)
            )

        a, H, B = bands["axis"], bands["H"], bands["B"]
        order, lo, NV = bands["order"], bands["lo"], bands["NV"]

        # upload batching: about _BATCH_BYTES of tiles a batch, every batch of U
        # views (the tail repeats its last tile, which no list references)
        tile = tuple(int(s) for s in field_sims[0].data.shape)
        dtype_in = np.dtype(field_sims[0].data.dtype)
        tile_bytes = int(np.prod(tile)) * dtype_in.itemsize
        U = max(1, -(-_BATCH_BYTES // tile_bytes))
        n_batches = -(-V // U)
        NB = -(-NV // U) + 1  # batches per assembly window
        order_hash = hash(np.ascontiguousarray(order).tobytes())

        # the device tile cache: a stack left by an earlier call serves every
        # batch by a gather on the device; else a pass that uploads every batch
        # and whose tiles fit the cache's budget keeps its batches to seed it,
        # and resumes from the batches an aborted pass over the same inputs and
        # layout left. Batches are submitted in order through the last band's
        # window and its prefetch: an output that ends before the last views
        # (a block, a window) never uploads them, and its pass seeds nothing
        cache_key = residency.device_tile_cache.key_for(field_sims, device)
        resident = residency.device_tile_cache.get(cache_key)
        uploads_all = int(lo[-1]) // U + NB - 1 + _PREFETCH_BATCHES >= n_batches - 1
        retain_batches = (
            resident is None and cache_key is not None and uploads_all
            and V * tile_bytes <= residency.device_tile_cache.budget()
        )
        stash_key = (cache_key, U, tile, n_batches, order_hash) if retain_batches else None
        stash_batches: dict = {}
        if stash_key is not None and _upload_stash.get("key") == stash_key:
            stash_batches = _upload_stash["batches"]

        tele_lock = threading.Lock()
        tele = {
            "bands_total": int(B), "bands_done": 0, "up_bytes": 0, "down_bytes": 0,
            "voxels_written": 0, "elapsed_s": 0.0, "aborted": False, "deadline_s": deadline_s,
            "band_axis": int(a), "band_height": int(H), "nv": int(NV),
            "batches": int(n_batches), "batch_views": int(U),
            "up_batches_reused": 0, "up_batches_resident": 0,
            "up_ms": None, "compute_ms": None, "down_ms": None,
        }
        global last_telemetry
        last_telemetry = tele

        sims_s = [field_sims[i] for i in order]
        tpb = H // tile_shape[a]  # kernel tiles per band along the band axis

        fuse_fn = (
            translation_fusion.fuse_translation_2d if ndim == 2
            else translation_fusion.fuse_translation_3d
        )
        tdtype_in = residency.torch_dtype(dtype_in)
        tdtype_out = residency.torch_dtype(out_dtype)
        out = out_sink if out_sink is not None else np.zeros(out_shape_full, dtype=out_dtype)
        band_out_shape = tuple(H if d == a else out_shape_full[d] for d in range(ndim))

        if cuda:
            compute = torch.cuda.current_stream(device)
            up_stream, dl_stream = residency.side_streams(device)
            if resident is not None:
                # the stack may still be written by the call that seeded it
                up_stream.wait_stream(compute)
                resident.record_stream(up_stream)
        busy = {"up": [], "compute": [], "down": []}

        def on(stream):
            return torch.cuda.stream(stream) if cuda else contextlib.nullcontext()

        def mark():
            """An event recorded on the current stream (None on the CPU)."""
            if not cuda:
                return None
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev

        up_bufs = residency.HostBuffers(_READER_THREADS + 2, (U,) + tile, tdtype_in, cuda)
        band_bufs = residency.HostBuffers(_MAX_INFLIGHT_BANDS, band_out_shape, tdtype_out, cuda)
        errors = []

        def upload_batch(bi):
            """(device batch, its event), from the first of the resume stash,
            the resident stack, and a read and an upload."""
            resumed = stash_batches.get(bi)
            if resumed is not None:
                with tele_lock:
                    tele["up_batches_reused"] += 1
                return resumed
            vs = range(bi * U, min((bi + 1) * U, V))
            if resident is not None:
                # the batch's views in sorted order, the tail repeating the last
                rows = np.full(U, order[vs[-1]], np.int64)
                rows[:len(vs)] = order[vs.start:vs.stop]
                with on(up_stream if cuda else None):
                    e0 = mark()
                    dev = residency.signed_bits(resident)[
                        torch.as_tensor(rows, device=device)].view(resident.dtype)
                    done = mark()
                with tele_lock:
                    tele["up_batches_resident"] += 1
                    if cuda:
                        busy["up"].append((e0, done))
                return dev, done
            slot = up_bufs.acquire()
            done = None  # the event of the copy out of the slot
            try:
                host = slot.array
                with profiling.stage("stream.read"):
                    residency.materialize_tiles([sims_s[v] for v in vs], out=host[: len(vs)])
                    if np.issubdtype(dtype_in, np.floating):
                        np.nan_to_num(host[: len(vs)], copy=False)
                    host[len(vs):] = host[len(vs) - 1]
                with on(up_stream if cuda else None):
                    dev = torch.empty((U,) + tile, dtype=tdtype_in, device=device)
                    e0 = mark()
                    dev.copy_(slot.tensor, non_blocking=cuda)
                    done = mark()
            finally:
                up_bufs.release(slot, done)
            with tele_lock:
                tele["up_bytes"] += host.nbytes
                if cuda:
                    busy["up"].append((e0, done))
            return dev, done

        def write_band(b, slot, done, h_true):
            """Write band ``b`` to the sink from its host slot once ``done``
            has completed."""
            try:
                rows = tuple(slice(0, h_true) if d == a else slice(None) for d in range(ndim))
                if done is not None:
                    done.synchronize()
                src = slot.array[rows]
                with profiling.stage("stream.write"):
                    out[tuple(
                        slice(b * H, b * H + h_true) if d == a else slice(None)
                        for d in range(ndim)
                    )] = src
                with tele_lock:
                    tele["down_bytes"] += src.nbytes
                    tele["voxels_written"] += src.size
                    tele["bands_done"] += 1
                    tele["elapsed_s"] = time.perf_counter() - t_begin
            except Exception as e:  # noqa: BLE001 - raised by the band loop
                errors.append(e)
            finally:
                band_bufs.release(slot)

        zero_batch = None  # made only when a window runs past the last batch
        futs = {}
        visible = set()  # batches the compute stream waits for already
        next_submit = 0
        with ThreadPoolExecutor(_READER_THREADS) as readers, \
                ThreadPoolExecutor(_WRITER_THREADS) as writers:

            def ensure_batches(through_bi):
                # monotone submission: consumed batches never resubmit
                nonlocal next_submit
                target = min(through_bi + _PREFETCH_BATCHES, n_batches - 1)
                while next_submit <= target:
                    futs[next_submit] = readers.submit(upload_batch, next_submit)
                    next_submit += 1

            write_futs = []
            for b in range(B):
                if deadline_s is not None and time.perf_counter() - t_begin > deadline_s:
                    tele["aborted"] = True
                    break
                lo_b = int(lo[b])
                bi0 = lo_b // U
                # the window always spans NB batches from bi0, not just the
                # band's own view span
                ensure_batches(min(n_batches - 1, bi0 + NB - 1))
                window = []
                try:
                    for bi in range(bi0, bi0 + NB):
                        if bi >= n_batches:
                            if zero_batch is None:
                                with on(compute if cuda else None):
                                    zero_batch = torch.zeros((U,) + tile, dtype=tdtype_in,
                                                             device=device)
                            window.append(zero_batch)
                            continue
                        dev, done = futs[bi].result(timeout=remaining())
                        if cuda and bi not in visible:
                            compute.wait_event(done)
                            dev.record_stream(compute)
                            visible.add(bi)
                        window.append(dev)
                    slot = band_bufs.acquire(timeout=remaining())
                except (TimeoutError, queue.Empty):
                    # a stalled upload or download: abort instead of blocking
                    tele["aborted"] = True
                    break
                if errors:
                    band_bufs.release(slot)
                    break

                # the band origin goes to the kernel as an integer shift, so the
                # per-pixel math is bitwise that of the monolithic call
                y0 = b * H
                origin = np.zeros((ndim,), np.int32)
                origin[a] = y0
                g_sl = tuple(
                    slice(b * tpb, (b + 1) * tpb) if d == a else slice(None) for d in range(ndim)
                )
                vi_g = view_idx_g[g_sl]
                vi_b = np.where((vi_g >= lo_b) & (vi_g < lo_b + NV), vi_g - lo_b,
                                -1).astype(np.int32)
                with on(compute if cuda else None):
                    c0 = mark()
                    start = lo_b - bi0 * U
                    band_tiles = torch.cat(window, dim=0)[start:start + NV]
                    fused = fuse_fn(
                        band_tiles, vi_b,
                        offs_s[lo_b:lo_b + NV], extents_s[lo_b:lo_b + NV],
                        wdiags_s[lo_b:lo_b + NV], woffs_s[lo_b:lo_b + NV],
                        wgrids_s[lo_b:lo_b + NV],
                        out_shape=band_out_shape, tile_shape=tuple(tile_shape), K=K,
                        out_dtype=tdtype_out, origin=origin,
                    )
                    c1 = mark()
                h_true = min(H, out_shape_full[a] - y0)
                with on(dl_stream if cuda else None):
                    if cuda:
                        dl_stream.wait_event(c1)
                        fused.record_stream(dl_stream)
                        busy["compute"].append((c0, c1))
                    d0 = mark()
                    slot.tensor.copy_(fused, non_blocking=cuda)
                    d1 = mark()
                    if cuda:
                        busy["down"].append((d0, d1))
                    write_futs.append(writers.submit(write_band, b, slot, d1, h_true))
                del fused, band_tiles, window

                # drop device batches no later band reaches, unless they seed
                # the tile cache
                if not retain_batches and b + 1 < B:
                    keep_from = int(lo[b + 1]) // U
                    for bi in [k for k in futs if k < keep_from]:
                        del futs[bi]

            for f in write_futs:
                f.result()

        # every upload the readers completed (the pool's exit waited for them,
        # those queued past an abort too) resumes or seeds
        if retain_batches:
            for bi, f in futs.items():
                if f.exception() is None:
                    stash_batches.setdefault(bi, f.result())
        futs.clear()

        if cuda:
            torch.cuda.synchronize(device)
            for stage, pairs in busy.items():
                tele[f"{stage}_ms"] = float(sum(e0.elapsed_time(e1) for e0, e1 in pairs))
        tele["elapsed_s"] = time.perf_counter() - t_begin
    if (errors or tele["aborted"]) and stash_batches:
        _stash(stash_key, stash_batches, field_sims)
    if errors:
        raise errors[0]
    if tele["aborted"]:
        raise StreamingDeadlineError(
            f"streaming fusion exceeded its {deadline_s:.0f}s deadline: "
            f"{tele['bands_done']}/{tele['bands_total']} bands, "
            f"{tele['up_bytes'] / 1e6:.0f} MB up / {tele['down_bytes'] / 1e6:.0f} MB down "
            f"in {tele['elapsed_s']:.1f}s",
            tele,
        )
    if retain_batches:
        with profiling.stage("stream.seed_cache"):
            try:
                batches = []
                for bi in range(n_batches):
                    dev, done = stash_batches.pop(bi)
                    if cuda:
                        # made on the upload stream, reordered on the compute stream
                        compute.wait_event(done)
                        dev.record_stream(compute)
                    batches.append(dev)
                del dev
                residency.device_tile_cache.put(cache_key, _reorder_concat(batches, order, V),
                                                field_sims)
            except Exception as e:  # noqa: BLE001 - the fused output stands
                warnings.warn(
                    f"device tile cache seeding failed ({type(e).__name__}: {e}); repeat "
                    "passes read and upload the tiles again.",
                    RuntimeWarning,
                    stacklevel=2,
                )
            _upload_stash.clear()
    return out
