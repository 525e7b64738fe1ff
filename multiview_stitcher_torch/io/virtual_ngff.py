"""Virtual OME-Zarr serving.

The port of ``multiview_stitcher_tpu.io.virtual_ngff``: a read-only zarr v2 /
NGFF 0.4 hierarchy made on the fly from any sim or msim (no store is
written; a chunk is cut from the image when it is asked for), and a threaded
HTTP server over named stores, so that a viewer (neuroglancer) browses large
images with their transforms.

A chunk is cut from whatever the sim holds: a numpy array, a lazy array
(``io.zarr_backend.LazyZarrArray``, a reader's lazy tile), which reads only
that window, or a torch tensor on the device (``fuse(...,
output_on_backend=True)``), sliced there and downloaded one chunk at a time.
Chunks are served uncompressed (``compressor: null``): a chunk's bytes are
the C-order bytes of its window, zero-padded to the full chunk shape at the
array's edges, as zarr stores them. The bytes of every key equal the JAX
package's over the same data.

An unknown key is a 404. A chunk that cannot be made (a failed read) fails
its request with a 500 and is logged; it is never served as zeros.
"""

from __future__ import annotations

import http.server
import json
import logging
import socketserver
import threading
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from multiview_stitcher_torch import msi_utils, si_utils
from multiview_stitcher_torch.io import ngff_utils
from multiview_stitcher_torch.msi_utils import Msim
from multiview_stitcher_torch.si_utils import Sim

logger = logging.getLogger(__name__)


def _window(data, slices) -> np.ndarray:
    """The window ``slices`` of an array as numpy: a device tensor is sliced
    on its device and only the window is downloaded; a lazy array reads only
    the window."""
    block = data[slices]
    if isinstance(block, torch.Tensor):
        return block.cpu().numpy()
    return np.asarray(block)


class VirtualOMEZarr:
    """Read-only virtual NGFF 0.4 (zarr v2) image over an msim or sim.

    ``get(key)`` returns the bytes of a zarr store key, or None.
    """

    def __init__(
        self,
        image: Union[Sim, Msim],
        chunks: Optional[dict] = None,
        omero: Optional[dict] = None,
    ):
        self.msim = (
            image
            if isinstance(image, Msim)
            else msi_utils.get_msim_from_sim(image, scale_factors=[])
        )
        sim0 = self.msim.get_scale("scale0")
        self.dims = list(sim0.dims)
        self.sdims = si_utils.get_spatial_dims_from_sim(sim0)
        self.nsdims = [d for d in self.dims if d not in self.sdims]
        spatial_cs = si_utils.get_default_spatial_chunksizes(len(self.sdims))
        if chunks is None:
            chunks = {d: 1 if d in self.nsdims else spatial_cs[d] for d in self.dims}
        self.chunks = chunks

        # NGFF multiscales metadata from each level's stack properties
        base_spacing = si_utils.get_spacing_from_sim(sim0)
        abs_factors = []
        for sk in self.msim.scale_keys:
            sp = si_utils.get_spacing_from_sim(self.msim.get_scale(sk))
            abs_factors.append({d: sp[d] / base_spacing[d] for d in self.sdims})
        coordtfs, axes = ngff_utils.calc_ngff_coordinate_transformations_and_axes(
            {
                "spacing": base_spacing,
                "origin": si_utils.get_origin_from_sim(sim0),
                "shape": si_utils.get_shape_from_sim(sim0),
            },
            abs_factors,
            nsdims=self.nsdims,
            # the source's time calibration; none gives scale 1.0 and no
            # time unit in the axes
            time_transform=sim0.attrs.get("ngff_time_transform"),
        )
        self.attrs = {
            "multiscales": [
                {
                    "axes": axes,
                    "datasets": [
                        {"path": str(level), "coordinateTransformations": coordtfs[level]}
                        for level in range(len(self.msim.sims))
                    ],
                    "version": "0.4",
                }
            ]
        }
        if omero is not None:
            # the caller's display metadata, served as given
            self.attrs["omero"] = omero
        elif "c" in self.dims:
            self.attrs["omero"] = {
                "channels": [
                    {
                        "color": "ffffff",
                        "label": str(c),
                        "active": True,
                        "window": {"end": 65535, "max": 65535, "min": 0, "start": 0},
                    }
                    for c in np.asarray(sim0.coords.get("c", []))
                ]
            }

    def _zarray(self, level: int) -> dict:
        sim = self.msim.sims[level]
        shape = list(sim.shape)
        return {
            "zarr_format": 2,
            "shape": shape,
            "chunks": [min(self.chunks[d], s) for d, s in zip(self.dims, shape)],
            "dtype": si_utils.numpy_dtype(sim.dtype).str,
            "compressor": None,
            "fill_value": 0,
            "order": "C",
            "filters": None,
            "dimension_separator": ".",
        }

    def _chunk_bytes(self, level: int, chunk_idx: List[int]) -> bytes:
        sim = self.msim.sims[level]
        meta = self._zarray(level)
        chunks = meta["chunks"]
        slices = tuple(
            slice(ci * cs, min((ci + 1) * cs, s))
            for ci, cs, s in zip(chunk_idx, chunks, meta["shape"])
        )
        block = _window(sim.data, slices)
        # zarr edge chunks are padded to the full chunk shape
        if tuple(block.shape) != tuple(chunks):
            padded = np.zeros(chunks, dtype=block.dtype)
            padded[tuple(slice(0, s) for s in block.shape)] = block
            block = padded
        return np.ascontiguousarray(block, dtype=np.dtype(meta["dtype"])).tobytes()

    def get(self, key: str) -> Optional[bytes]:
        key = key.strip("/")
        if key == ".zattrs":
            return json.dumps(self.attrs).encode()
        if key == ".zgroup":
            return json.dumps({"zarr_format": 2}).encode()
        parts = key.split("/")
        if len(parts) != 2:
            return None
        level_str, sub = parts
        if not level_str.isdigit():
            return None
        level = int(level_str)
        if level >= len(self.msim.sims):
            return None
        if sub == ".zarray":
            return json.dumps(self._zarray(level)).encode()
        if sub == ".zattrs":
            return json.dumps({}).encode()
        # a chunk key, "0.1.2"
        try:
            chunk_idx = [int(p) for p in sub.split(".")]
        except ValueError:
            return None
        if len(chunk_idx) != len(self.dims):
            return None
        return self._chunk_bytes(level, chunk_idx)


class VirtualOMEZarrPlate:
    """Virtual HCS (plate) OME-Zarr over a dict of well -> image.

    ``wells`` maps "A/1"-style paths to sims or msims; each well holds one
    field of view at ``{row}/{col}/0``.
    """

    def __init__(self, wells: Dict[str, Union[Sim, Msim]]):
        self.wells = {k.strip("/"): VirtualOMEZarr(v) for k, v in wells.items()}
        rows = sorted({k.split("/")[0] for k in self.wells})
        cols = sorted({k.split("/")[1] for k in self.wells})
        self.attrs = {
            "plate": {
                "version": "0.4",
                "rows": [{"name": r} for r in rows],
                "columns": [{"name": c} for c in cols],
                "wells": [
                    {
                        "path": k,
                        "rowIndex": rows.index(k.split("/")[0]),
                        "columnIndex": cols.index(k.split("/")[1]),
                    }
                    for k in sorted(self.wells)
                ],
            }
        }

    def get(self, key: str) -> Optional[bytes]:
        key = key.strip("/")
        if key == ".zattrs":
            return json.dumps(self.attrs).encode()
        if key == ".zgroup":
            return json.dumps({"zarr_format": 2}).encode()
        parts = key.split("/")
        if len(parts) < 2:
            return None
        well = "/".join(parts[:2])
        if well not in self.wells:
            return None
        rest = "/".join(parts[2:])
        if rest in (".zgroup", ""):
            return json.dumps({"zarr_format": 2}).encode()
        if rest == ".zattrs":
            return json.dumps({"well": {"images": [{"path": "0"}], "version": "0.4"}}).encode()
        if rest.startswith("0"):
            sub = rest[1:].strip("/")
            return self.wells[well].get(sub or ".zattrs")
        return None


class _VirtualHandler(http.server.BaseHTTPRequestHandler):
    """GET ``/{route}/{key}`` from the store of ``stores[route]``: 404 for
    an unknown route or key, 500 (logged) when the store raises."""

    stores: Dict[str, VirtualOMEZarr] = {}

    def do_GET(self):  # noqa: N802
        path = self.path.split("?")[0].strip("/")
        parts = path.split("/", 1)
        store = self.stores.get(parts[0])
        try:
            data = (
                store.get(parts[1] if len(parts) > 1 else ".zattrs")
                if store is not None
                else None
            )
        except Exception:
            logger.exception("virtual OME-Zarr: GET %s failed", self.path)
            self.send_error(500)
            return
        if data is None:
            self.send_response(404)
            self.end_headers()
            return
        self.send_response(200)
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Content-Length", str(len(data)))
        self.send_header("Access-Control-Allow-Origin", "*")
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, *args):
        pass


def _start_server(handler_cls, port: int) -> socketserver.ThreadingTCPServer:
    """A threaded HTTP server on localhost at ``port`` (0: any free port),
    serving from a daemon thread."""
    server = socketserver.ThreadingTCPServer(("127.0.0.1", port), handler_cls)
    server.daemon_threads = True
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


class VirtualOMEZarrServer:
    """Threaded HTTP server over named virtual stores: ``stores`` maps route
    names to :class:`VirtualOMEZarr` instances; call :meth:`start`, then
    :meth:`shutdown` when done."""

    def __init__(self, stores: Dict[str, VirtualOMEZarr], port: int = 8000):
        handler_cls = type("Handler", (_VirtualHandler,), {"stores": dict(stores)})
        self.server = socketserver.ThreadingTCPServer(("127.0.0.1", port), handler_cls)
        self.server.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self.server.server_address[1]

    @property
    def base_url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def start(self) -> "VirtualOMEZarrServer":
        self._thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self._thread.start()
        return self

    def shutdown(self):
        self.server.shutdown()
        self.server.server_close()


def serve_virtual_ome_zarrs(
    images,
    port: int = 8000,
    transform_key: Optional[str] = None,
    names: Optional[List[str]] = None,
    omero_channels: Optional[List[dict]] = None,
):
    """Serve images as virtual OME-Zarrs at ``/{i}.ome.zarr`` (or at
    ``names``). ``omero_channels`` optionally carries one omero
    display-metadata dict per image, served as given in each store's root
    ``.zattrs``. ``transform_key`` is kept for the reference's signature:
    NGFF stores no affine.

    Returns the server; call ``server.shutdown()`` when done.
    """
    if names is None:
        names = [f"{i}.ome.zarr" for i in range(len(images))]
    if omero_channels is None:
        omero_channels = [None] * len(images)
    if len(names) != len(images) or len(omero_channels) != len(images):
        raise ValueError(
            f"names ({len(names)}) and omero_channels "
            f"({len(omero_channels)}) must match len(images) "
            f"({len(images)}); zip would silently drop stores."
        )
    stores = {
        name: VirtualOMEZarr(im, omero=om)
        for name, im, om in zip(names, images, omero_channels)
    }
    return _start_server(type("Handler", (_VirtualHandler,), {"stores": stores}), port)


def serve_virtual_plate(
    sims_by_well,
    port: int = 8000,
    name: str = "plate.ome.zarr",
):
    """Serve a dict of ``{"row/col": sim}`` as a virtual OME-Zarr HCS plate
    at ``/{name}``.

    Returns the server; call ``server.shutdown()`` when done.
    """
    stores = {name: VirtualOMEZarrPlate(sims_by_well)}
    return _start_server(type("PlateHandler", (_VirtualHandler,), {"stores": stores}), port)
