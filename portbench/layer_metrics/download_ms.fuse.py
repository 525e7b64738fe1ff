"""download_ms.fuse: the fused outputs back to the host a fuse() job: the
wait for each and its copy into the host image, every channel (the port's
fuse.download stage), ms."""

from portbench.spans import stage_ms

read = stage_ms("fuse.download")
