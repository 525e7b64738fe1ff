"""pyramid_ms.zarr: the OME-Zarr pyramid a zarr job, every level above 0
built block by block (the port's fuse.pyramid stage), ms."""

from portbench.spans import stage_ms

read = stage_ms("fuse.pyramid")
