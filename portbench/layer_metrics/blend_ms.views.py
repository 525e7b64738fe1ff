"""blend_ms.views: the batched tier's blend a fuse() job of the views: each
batch's weighted average over its views, its cast, and the copy of its chunks
into the output on the card (the port's batched.blend stage), ms."""

from portbench.spans import stage_ms

read = stage_ms("batched.blend")
