"""Stitching service runtime: stateful sessions and stateless JSON workers.

The port of ``multiview_stitcher_tpu.service``: a :class:`Session` owns the
views and their transforms, serves them to a viewer and dispatches its heavy
work in process or as JSON tasks over a :class:`Bridge` to
:class:`WorkerRuntime` workers (in process, or OS processes started by
``spawn``). Callables travel by name, image data never crosses a boundary:
workers reopen the sources a :class:`SessionSpec` describes. Sessions and
workers run on the CUDA device unless given ``device="cpu"``.
"""

from multiview_stitcher_torch.service.bridge import (
    Bridge,
    LocalBridge,
    ProcessPoolBridge,
)
from multiview_stitcher_torch.service.session import Session
from multiview_stitcher_torch.service.specs import (
    FusionOptions,
    RegistrationOptions,
    SessionSpec,
    resolve_fusion_func,
    resolve_pairwise_reg_func,
)
from multiview_stitcher_torch.service.worker import WorkerRuntime

__all__ = [
    "Bridge",
    "LocalBridge",
    "ProcessPoolBridge",
    "Session",
    "SessionSpec",
    "RegistrationOptions",
    "FusionOptions",
    "WorkerRuntime",
    "resolve_fusion_func",
    "resolve_pairwise_reg_func",
]
