"""Multi-device and multi-process execution: ``mesh`` (the device mesh),
``pipeline`` (sharded register and fuse batches), ``executors`` (JSON work
specs, block partitions) and ``multihost`` (``torch.distributed``)."""
