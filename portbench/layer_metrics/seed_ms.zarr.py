"""seed_ms.zarr: the seeding of the device tile cache after a zarr job's
streamed pass, the upload batches put back in view order (the port's
stream.seed_cache stage), ms."""

from portbench.spans import stage_ms

read = stage_ms("stream.seed_cache")
