"""resample_ms.views: the batched tier's resample a fuse() job of the views:
each batch's exact-affine launches for the views' data and their blending
grids, with their host tables (the port's batched.resample stage), ms."""

from portbench.spans import stage_ms

read = stage_ms("batched.resample")
