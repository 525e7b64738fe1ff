"""Where the views live and how they cross between host and device.

A port-only module: the one place that decides how tiles reach the device
and how results come back, for ``fusion._core``, ``fusion._streaming`` and
``registration``. It holds

- the device tile cache (:data:`device_tile_cache`, within
  :data:`TILE_CACHE_BYTES`): tile stacks resident on a device, keyed on their
  source arrays, which ``fuse()`` and ``register()`` both read, so that a
  ``stitch()`` uploads each tile once;
- the lazy reads (:func:`materialize_tiles`, :func:`read_retrying`): zarr
  tiles read by a thread pool, a transient IO error retried;
- the host buffers (:class:`HostBuffers`): pools of host slots, pinned for a
  CUDA device, each refilled only after its last copy's event;
- each CUDA device's side streams (:func:`side_streams`, one for uploads,
  one for downloads) and pinned staging ring (``_staging_ring``), both kept
  across calls;
- the two copy routes each way: :func:`tiles_to_device` uploads a group of
  views directly or, staged, through the ring with no host stack;
  :func:`download` copies a result into a host array, a sink or a tensor
  directly or, staged, through the ring. ``_upload_route`` and
  ``_download_route`` decide; :data:`last_copy_telemetry` says which ran.

It imports no fusion module and not ``registration``.
"""

from __future__ import annotations

import collections
import logging
import os
import queue
import threading
import time
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from multiview_stitcher_torch import si_utils
from multiview_stitcher_torch.io import zarr_backend
from multiview_stitcher_torch.parallel import mesh as mesh_utils
from multiview_stitcher_torch.utils import profiling

logger = logging.getLogger(__name__)

# lazy tiles are read by this many threads, each read retried this many times
# on a transient IO error
READ_WORKERS = 16
_READ_RETRIES = 2
# the device tile cache holds at most this many bytes of tile stacks
TILE_CACHE_BYTES = 2 << 30
# host threads that copy each staged piece between its slot and the host
# arrays (numpy copies release the GIL), so that the first touch of a fresh
# output's pages, which sets the pace of one thread, is spread over the cores
_COPY_THREADS = max(1, min(8, os.cpu_count() or 1))

# bytes of tiles that tiles_to_device copied to a device, over the process
tile_upload_bytes = 0
# what the latest copies did, under "upload" (a tiles_to_device call that
# missed the tile cache) and "download" (a download): "route" ("staged"
# where any of it went through the device's pinned staging ring, else
# "direct"), "bytes" (of the host data), and the ring's "pieces" and "slots"
# (0 on the direct route)
last_copy_telemetry: dict = {}
# bytes that went through the staging rings over the process, each way
ring_bytes = {"upload": 0, "download": 0}

# unsigned dtypes whose copies run on their signed twins' bits (not every
# device copies them)
_SIGNED_TWIN = {torch.uint16: torch.int16, torch.uint32: torch.int32, torch.uint64: torch.int64}


def torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype=dtype)).dtype


def signed_bits(t: torch.Tensor) -> torch.Tensor:
    """``t`` viewed as its signed twin where it is unsigned: CUDA gathers
    and ``index_copy_`` take no uint16."""
    twin = _SIGNED_TWIN.get(t.dtype)
    return t if twin is None else t.view(twin)


def _edge_pad(view: torch.Tensor, shape) -> torch.Tensor:
    """Pad ``view`` at its far ends to ``shape`` by repeating its last
    row/column/plane (numpy's ``mode="edge"``), for any dtype."""
    out = view.new_empty(shape)
    out[tuple(slice(0, s) for s in view.shape)] = view
    for d, (s, m) in enumerate(zip(view.shape, shape)):
        if m > s:
            src = [slice(None)] * len(shape)
            dst = [slice(None)] * len(shape)
            src[d], dst[d] = slice(s - 1, s), slice(s, m)
            out[tuple(dst)] = out[tuple(src)]
    return out


def read_retrying(read, label):
    """``read()``, retried up to ``_READ_RETRIES`` times, after a short
    backoff, on a transient IO error; any other error surfaces at once."""
    for attempt in range(_READ_RETRIES + 1):
        try:
            return read()
        except (OSError, TimeoutError) as e:
            if attempt == _READ_RETRIES:
                raise
            logger.warning(
                "lazy %s read failed (%s: %s), retry %d/%d",
                label, type(e).__name__, e, attempt + 1, _READ_RETRIES,
            )
            time.sleep(0.2 * 2**attempt)


def materialize_tiles(field_sims, out=None) -> np.ndarray:
    """(V, *tile) array of equal-shape tiles (into ``out`` when given).
    Lazy tiles are read in parallel by a thread pool (file reads release the
    GIL; one at a time, 1000 small tiles pay each read's latency), each read
    through :func:`read_retrying`."""
    V = len(field_sims)
    if out is None:
        shape = tuple(field_sims[0].data.shape)
        out = np.empty((V,) + shape, dtype=np.dtype(field_sims[0].data.dtype))
    lazy = [si_utils._is_lazy(s.data) for s in field_sims]
    if not any(lazy):
        for i, s in enumerate(field_sims):
            out[i] = s.data
        return out

    def fetch(i):
        out[i] = read_retrying(lambda: np.asarray(field_sims[i].data), f"tile {i}")

    with ThreadPoolExecutor(max_workers=min(READ_WORKERS, V)) as ex:
        list(ex.map(fetch, range(V)))
    return out


class _DeviceTileCache:
    """LRU cache of tile stacks resident on a device, keyed on their source
    arrays, within :data:`TILE_CACHE_BYTES`.

    In-memory tiles are keyed by the identity of each source numpy array
    with its address, shape, dtype and a sample of its content (so that an
    array changed in place misses); lazy zarr tiles by their array's path
    and selection. An entry dies with any of its in-memory source arrays
    (the cache holds them weakly), so an id is never reused under a live
    entry and the cache keeps no tiles of sims that are gone."""

    def __init__(self):
        self._entries: dict = {}  # key -> (tiles, bytes), least recent first

    @staticmethod
    def _fingerprint(arr: np.ndarray) -> int:
        flat = arr.reshape(-1)
        step = max(1, flat.size // 4096)
        return hash(flat[::step].tobytes())

    @staticmethod
    def key_for(field_sims, device):
        """The cache key of these views' stack on ``device``; None where a
        source cannot be identified (it is then not cached)."""
        parts = [str(mesh_utils.indexed_device(device))]
        for s in field_sims:
            data = s.data
            if isinstance(data, np.ndarray):
                parts.append(("np", id(data), data.__array_interface__["data"][0],
                              data.shape, str(data.dtype), _DeviceTileCache._fingerprint(data)))
            elif isinstance(data, zarr_backend.LazyZarrArray):
                parts.append(("zarr", str(data._array.path), data._sel, str(data.dtype)))
            else:
                return None
        return tuple(parts)

    def budget(self) -> int:
        return TILE_CACHE_BYTES

    def get(self, key):
        if key is None or key not in self._entries:
            return None
        self._entries[key] = self._entries.pop(key)
        return self._entries[key][0]

    def put(self, key, tiles: torch.Tensor, field_sims) -> None:
        nbytes = tiles.numel() * tiles.element_size()
        if key is None or nbytes > self.budget():
            return
        while self._entries and sum(b for _, b in self._entries.values()) + nbytes > self.budget():
            self._entries.pop(next(iter(self._entries)))
        self._entries[key] = (tiles, nbytes)
        for s in field_sims:
            if isinstance(s.data, np.ndarray):
                weakref.finalize(s.data, self._entries.pop, key, None)

    def clear(self) -> None:
        self._entries.clear()


device_tile_cache = _DeviceTileCache()


# the upload and download streams of each CUDA device, kept across calls:
# the caching allocator hands a block freed on a stream out again only on
# that stream, so a pass on new streams could not reuse the memory of the
# last pass's batches and would grow the reserved memory by a stack a pass
_SIDE_STREAMS: dict = {}


def side_streams(device: torch.device) -> tuple:
    """The (upload, download) streams of ``device``, made at first use."""
    if device not in _SIDE_STREAMS:
        _SIDE_STREAMS[device] = (torch.cuda.Stream(device), torch.cuda.Stream(device))
    return _SIDE_STREAMS[device]


class _Slot:
    def __init__(self, tensor: torch.Tensor):
        self.tensor = tensor
        self.array = tensor.numpy()
        self.event = None  # the event of the last copy from or to it


class HostBuffers:
    """A pool of host buffers of one shape: pinned on a CUDA device. A slot is
    filled again only after the event of its last copy has completed."""

    def __init__(self, n, shape, dtype, pinned):
        self._free = queue.Queue()
        for _ in range(n):
            self._free.put(_Slot(torch.empty(shape, dtype=dtype, pin_memory=pinned)))

    def acquire(self, timeout=None) -> _Slot:
        slot = self._free.get(timeout=timeout)
        if slot.event is not None:
            slot.event.synchronize()
            slot.event = None
        return slot

    def release(self, slot: _Slot, event=None) -> None:
        slot.event = event
        self._free.put(slot)


# the pinned staging ring of each CUDA device, kept across calls like the
# side streams: _RING_SLOTS byte slots of _RING_SLOT_BYTES, through which
# the large uploads and downloads are staged (sizes from a sweep on an H100,
# PERF.md). It is staging memory, not a cache: no slot holds data from one
# copy to the next
_RING_SLOTS = 3
_RING_SLOT_BYTES = 64 << 20
_RINGS: dict = {}
_RINGS_LOCK = threading.Lock()


class _Ring(HostBuffers):
    """``n`` host slots of ``slot_bytes`` bytes. A staged copy holds
    ``lock`` from its first slot to its last: it keeps several slots in
    flight, and two copies sharing the slots could each wait for one that
    the other holds."""

    def __init__(self, n, slot_bytes, pinned):
        super().__init__(n, (slot_bytes,), torch.uint8, pinned)
        self.n, self.slot_bytes = n, slot_bytes
        self.lock = threading.Lock()


def _staging_ring(device: torch.device) -> _Ring:
    """The pinned staging ring of ``device``, made at first use."""
    with _RINGS_LOCK:
        if device not in _RINGS:
            _RINGS[device] = _Ring(_RING_SLOTS, _RING_SLOT_BYTES, pinned=True)
        return _RINGS[device]


def _host_parts(dst: np.ndarray, src: np.ndarray, n: int) -> list:
    """``(dst, src)`` cut into at most ``n`` pairs of blocks along their
    first axis, or their second where the first is shorter than ``n``."""
    axis = 1 if dst.ndim > 1 and dst.shape[0] < n else 0
    cuts = np.linspace(0, dst.shape[axis], min(n, dst.shape[axis]) + 1).astype(np.int64)
    at = (slice(None),) * axis
    return [(dst[at + (slice(a, b),)], src[at + (slice(a, b),)])
            for a, b in zip(cuts[:-1], cuts[1:]) if b > a]


def _copy_on(stream, dst: torch.Tensor, src: torch.Tensor):
    """``dst.copy_(src)``: queued on the CUDA side ``stream``, returning the
    event recorded after it, or at once where ``stream`` is None."""
    if stream is None:
        dst.copy_(src)
        return None
    with torch.cuda.stream(stream):
        dst.copy_(src, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
    return event


def _upload_route(sims, device: torch.device, slot_bytes: int) -> str:
    """``"staged"`` where a group of equal-shape views goes up through the
    staging ring: in-memory numpy views of more than one slot's bytes, a row
    (an index of their first axis) within a slot, bound for a CUDA device;
    else ``"direct"``."""
    data = [s.data for s in sims]
    if device.type != "cuda" or not all(isinstance(d, np.ndarray) and d.ndim for d in data):
        return "direct"
    row = np.dtype(data[0].dtype).itemsize * int(np.prod(data[0].shape[1:]))
    return "staged" if len(data) * data[0].shape[0] * row > slot_bytes >= row else "direct"


def _upload_staged(sims, device: torch.device, keep_nan: bool, ring) -> tuple:
    """The (V, *tile) stack of equal-shape in-memory views on ``device``,
    made there and filled through ``ring`` (a ``_Ring``): no host stack. A
    piece is a range of the stack's rows (an index of the views' first axis,
    the views one after another) of at most one slot; it is copied from the
    views into a slot on :data:`_COPY_THREADS` host threads, in the first
    view's dtype, given ``nan_to_num`` there where it is float and not
    ``keep_nan``, then copied into its place in the stack, on a CUDA device
    on the upload side stream with the slot's event recorded after it; a
    slot is filled again only after its event. The compute stream waits for
    the side stream before it reads the stack. Returns the stack and the
    number of pieces."""
    data = [s.data for s in sims]
    shape = tuple(int(x) for x in data[0].shape)
    dtype = np.dtype(data[0].dtype)
    Z = shape[0]
    row = dtype.itemsize * int(np.prod(shape[1:]))
    per = ring.slot_bytes // row
    rows = len(data) * Z
    nan = np.issubdtype(dtype, np.floating) and not keep_nan
    stack = torch.empty((len(data),) + shape, dtype=torch_dtype(dtype), device=device)
    flat = stack.view(-1).view(torch.uint8)
    side = None
    if device.type == "cuda":
        compute = torch.cuda.current_stream(device)
        side = side_streams(device)[0]
        # the stack's memory is free only in the compute stream's order
        side.wait_stream(compute)

    def fill(part):
        np.copyto(*part, casting="unsafe")
        if nan:
            np.nan_to_num(part[0], copy=False)

    pieces = 0
    with ring.lock, ThreadPoolExecutor(_COPY_THREADS) as pool:
        try:
            for r0 in range(0, rows, per):
                r1 = min(rows, r0 + per)
                nb = (r1 - r0) * row
                slot, event = ring.acquire(), None
                try:
                    host = slot.array[:nb].view(dtype).reshape((r1 - r0,) + shape[1:])
                    parts = []
                    for v in range(r0 // Z, -(-r1 // Z)):
                        a, b = max(r0, v * Z), min(r1, (v + 1) * Z)
                        parts += _host_parts(host[a - r0:b - r0], data[v][a - v * Z:b - v * Z],
                                             _COPY_THREADS)
                    list(pool.map(fill, parts))
                    event = _copy_on(side, flat[r0 * row:r1 * row], slot.tensor[:nb])
                finally:
                    ring.release(slot, event)
                pieces += 1
        finally:
            if side is not None:
                compute.wait_stream(side)
    ring_bytes["upload"] += rows * row
    return stack, pieces


def _download_route(fused: torch.Tensor, out, slot_bytes: int) -> str:
    """``"staged"`` where :func:`download` goes through the staging ring:
    a CUDA result of more than one slot's bytes, into a writable
    C-contiguous host array of its shape and dtype; else ``"direct"``."""
    staged = (
        fused.is_cuda and isinstance(out, np.ndarray)
        and out.flags.c_contiguous and out.flags.writeable
        and out.shape == tuple(fused.shape) and out.dtype == si_utils.numpy_dtype(fused.dtype)
        and fused.numel() * fused.element_size() > slot_bytes
    )
    return "staged" if staged else "direct"


def _download_staged(fused: torch.Tensor, out: np.ndarray, ring) -> int:
    """Copy ``fused`` into ``out``, a C-contiguous host array of its shape
    and dtype, through ``ring`` (a ``_Ring``), piece by piece of at most one
    slot's bytes: each piece into a slot, on a CUDA device on the download
    side stream after the compute stream's work, then, once that copy's
    event has completed, from the slot into its range of ``out`` on
    :data:`_COPY_THREADS` host threads while the next pieces cross. Returns,
    with the number of pieces, when ``out`` is complete."""
    src = fused.contiguous().view(-1).view(torch.uint8)
    dst = out.reshape(-1).view(np.uint8)
    side = None
    if fused.is_cuda:
        side = side_streams(mesh_utils.indexed_device(fused.device))[1]
        side.wait_stream(torch.cuda.current_stream(fused.device))
    inflight = collections.deque()  # (slot, event, first byte) in order
    pieces = 0
    with ring.lock, ThreadPoolExecutor(_COPY_THREADS) as pool:

        def land():
            slot, event, b0 = inflight.popleft()
            try:
                if event is not None:
                    event.synchronize()
                n = min(ring.slot_bytes, dst.size - b0)
                list(pool.map(lambda p: np.copyto(*p),
                              _host_parts(dst[b0:b0 + n], slot.array[:n], _COPY_THREADS)))
            finally:
                ring.release(slot, event)

        try:
            for b0 in range(0, dst.size, ring.slot_bytes):
                if len(inflight) == ring.n:
                    land()
                slot = ring.acquire()
                n = min(ring.slot_bytes, dst.size - b0)
                try:
                    event = _copy_on(side, slot.tensor[:n], src[b0:b0 + n])
                except BaseException:
                    ring.release(slot)
                    raise
                inflight.append((slot, event, b0))
                pieces += 1
            while inflight:
                land()
        finally:
            for slot, event, _ in inflight:
                ring.release(slot, event)
    ring_bytes["download"] += dst.size
    return pieces


@profiling.stage("tiles.upload")
def tiles_to_device(field_sims, device, keep_nan: bool = False) -> torch.Tensor:
    """(V, *tile) stack of the views on ``device`` in their native dtype,
    from the device tile cache when it holds them, else uploaded and cached.

    Lazy tiles are read first (:func:`materialize_tiles`); float tiles get
    ``nan_to_num`` before the upload, unless ``keep_nan`` (the gather tiers,
    where NaN marks invalid pixels; a float stack with NaN kept is cached
    apart, an integer stack is the same either way). Mixed tile shapes are
    uploaded as they are, one group per shape, and edge-padded on the device
    to the common maximum shape; the kernels mask each view by its true
    extents, the gather tiers read inside each view's own shape.

    The staged route: a group of in-memory numpy views bound for a CUDA
    device, of more than one slot of the device's pinned staging ring and a
    row (an index of the first axis) within one, is made on the device and
    filled through the ring (:func:`_upload_staged`), with no host stack and
    no copy from pageable memory (:func:`_upload_route` decides). Lazy views,
    CPU devices and groups of one slot or less take the direct route above.
    :data:`last_copy_telemetry` says which was taken."""
    global tile_upload_bytes
    key = device_tile_cache.key_for(field_sims, device)
    floating = any(np.issubdtype(np.dtype(s.data.dtype), np.floating) for s in field_sims)
    if key is not None and keep_nan and floating:
        # only float stacks differ with NaN kept; integer ones share the entry
        key = key + ("keep_nan",)
    hit = device_tile_cache.get(key)
    if hit is not None:
        return hit
    tele = {"route": "direct", "bytes": 0, "pieces": 0, "slots": 0}

    def put(sims):
        global tile_upload_bytes
        if _upload_route(sims, torch.device(device), _RING_SLOT_BYTES) == "staged":
            target = mesh_utils.indexed_device(device)
            ring = _staging_ring(target)
            dev, pieces = _upload_staged(sims, target, keep_nan, ring)
            nbytes = dev.numel() * dev.element_size()
            tile_upload_bytes += nbytes
            tele.update(route="staged", bytes=tele["bytes"] + nbytes,
                        pieces=tele["pieces"] + pieces,
                        slots=max(tele["slots"], min(pieces, ring.n)))
            return dev
        stack = materialize_tiles(sims)
        tele["bytes"] += stack.nbytes
        if np.issubdtype(stack.dtype, np.floating) and not keep_nan:
            stack = np.nan_to_num(stack)
        tile_upload_bytes += stack.nbytes
        return torch.from_numpy(stack).to(device)

    shapes = [tuple(int(x) for x in s.data.shape) for s in field_sims]
    if len(set(shapes)) == 1:
        tiles = put(field_sims)
    else:
        max_shape = tuple(max(s[i] for s in shapes) for i in range(len(shapes[0])))
        groups: dict = {}
        for i, shp in enumerate(shapes):
            groups.setdefault(shp, []).append(i)
        tiles = None
        for idxs in groups.values():
            dev = put([field_sims[i] for i in idxs])
            if tiles is None:
                tiles = torch.empty(
                    (len(field_sims),) + max_shape, dtype=dev.dtype, device=dev.device
                )
            for slot, i in enumerate(idxs):
                tiles[i] = _edge_pad(dev[slot], max_shape)
    device_tile_cache.put(key, tiles, field_sims)
    last_copy_telemetry["upload"] = tele
    return tiles


@profiling.stage("fuse.download")
def download(fused: torch.Tensor, out, row0: Optional[int] = None) -> None:
    """Copy the fused output into ``out``: a host array, a sink written by
    regions (any object that takes ``out[slices] = array``), or a tensor on
    a device (which takes a copy between devices, no download). With
    ``row0``, ``fused`` is the band of ``out`` from row ``row0`` on.

    The staged route: a CUDA result of more than one slot of the device's
    pinned staging ring, bound for a writable C-contiguous host array of its
    shape and dtype (a ``row0`` band of one too), comes down through the
    ring (:func:`_download_staged`): no copy into pageable memory, and the
    output's pages first touched on several host threads
    (:func:`_download_route` decides). Sinks, device tensors, other arrays
    and results of one slot or less take the direct route.
    :data:`last_copy_telemetry` says which was taken."""
    nbytes = fused.numel() * fused.element_size()
    last_copy_telemetry["download"] = {"route": "direct", "bytes": nbytes, "pieces": 0, "slots": 0}
    if row0 is not None:
        rows = slice(row0, row0 + fused.shape[0])
        if isinstance(out, (np.ndarray, torch.Tensor)):
            out = out[rows]
        else:
            out[(rows,) + (slice(None),) * (fused.dim() - 1)] = fused.cpu().numpy()
            return
    if _download_route(fused, out, _RING_SLOT_BYTES) == "staged":
        ring = _staging_ring(mesh_utils.indexed_device(fused.device))
        pieces = _download_staged(fused, out, ring)
        last_copy_telemetry["download"].update(
            route="staged", pieces=pieces, slots=min(pieces, ring.n))
    elif isinstance(out, torch.Tensor):
        out.copy_(fused)
    elif not isinstance(out, np.ndarray):
        out[(slice(None),) * fused.dim()] = fused.cpu().numpy()
    elif out.flags.c_contiguous:
        torch.from_numpy(out).copy_(fused)
    else:
        out[...] = fused.cpu().numpy()
