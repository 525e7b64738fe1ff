"""write_ms.zarr: the level-0 writes of a zarr job's streamed pass, each
band written to the store, summed over the writer threads (the port's
stream.write stage), ms."""

from portbench.spans import stage_ms

read = stage_ms("stream.write")
