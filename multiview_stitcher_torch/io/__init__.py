"""Zarr v2 and OME-Zarr (NGFF 0.4) input and output, on numpy and the
standard library."""
