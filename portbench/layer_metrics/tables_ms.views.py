"""tables_ms.views: the batched tier's kernel tables a fuse() job of the
views: per chunk and view the window, the pixel maps and the blending grid's
map, packed into batches (the port's batched.tables stage), ms."""

from portbench.spans import stage_ms

read = stage_ms("batched.tables")
