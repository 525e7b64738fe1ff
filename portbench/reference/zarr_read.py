"""A plain reader of the zarr v2 OME-Zarr stores the zarr job writes: the
group's multiscales metadata and whole arrays, chunk file by chunk file
(uncompressed or zlib; a missing chunk holds the fill value)."""

from __future__ import annotations

import itertools
import json
import os
import zlib

import numpy as np


def read_attrs(store: str) -> dict:
    with open(os.path.join(store, ".zattrs")) as f:
        return json.load(f)


def read_array(path: str) -> np.ndarray:
    with open(os.path.join(path, ".zarray")) as f:
        meta = json.load(f)
    if meta.get("zarr_format") != 2 or meta.get("filters"):
        raise ValueError(f"{path}: not a plain zarr v2 array")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zlib":
        raise ValueError(f"{path}: compressor {comp} is not read here")
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    dtype = np.dtype(meta["dtype"])
    sep = meta.get("dimension_separator", ".")
    fill = meta.get("fill_value") or 0
    out = np.full(shape, fill, dtype=dtype)
    grid = [range(-(-s // c)) for s, c in zip(shape, chunks)]
    for idx in itertools.product(*grid):
        name = os.path.join(path, sep.join(str(i) for i in idx) if idx else "0")
        if not os.path.exists(name):
            continue
        with open(name, "rb") as f:
            raw = f.read()
        if comp is not None:
            raw = zlib.decompress(raw)
        order = meta.get("order", "C")
        block = np.frombuffer(raw, dtype=dtype).reshape(chunks, order=order)
        sl = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        out[sl] = block[tuple(slice(0, x.stop - x.start) for x in sl)]
    return out
