"""upload_ms.fuse: the tile stacks to the card a fuse() job: cache key,
the stack and the host-to-device copy, every channel (the port's
tiles.upload stage), ms."""

from portbench.spans import stage_ms

read = stage_ms("tiles.upload")
