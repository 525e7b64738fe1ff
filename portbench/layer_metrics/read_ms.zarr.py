"""read_ms.zarr: the tile reads of a zarr job's streamed pass, each batch
read from the zarr tiles into its host buffer, summed over the reader
threads (the port's stream.read stage), ms."""

from portbench.spans import stage_ms

read = stage_ms("stream.read")
