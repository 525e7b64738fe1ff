"""JSON work vocabulary of the stitching service runtime.

The port of ``multiview_stitcher_tpu.service.specs``: every unit of work
that crosses a process boundary is a small JSON document; callables travel
by name through registries; image data never travels (workers reopen it
from the sources' URLs). A stateless worker rebuilds a read-only session
from a :class:`SessionSpec` and runs the ordinary library code paths. The
JSON of every document is the JAX package's, byte for byte, so clients and
workers of either package share it; the device a worker runs on is not part
of it.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional

from multiview_stitcher_torch.parallel.executors import SourceSpec

# ---------------------------------------------------------------------------
# name registries: the only way callables cross a worker boundary
# ---------------------------------------------------------------------------


def _pairwise_registration_funcs():
    from multiview_stitcher_torch import registration

    return {
        "phase_correlation": registration.phase_correlation_registration,
        "marker_based": registration.registration_marker_based,
    }


def _fusion_funcs():
    from multiview_stitcher_torch.fusion import (
        max_fusion,
        simple_average_fusion,
        weighted_average_fusion,
    )

    return {
        "weighted_average": weighted_average_fusion,
        "simple_average": simple_average_fusion,
        "max": max_fusion,
    }


GROUPWISE_RESOLUTION_METHODS = (
    "global_optimization",
    "linear_two_pass",
    "shortest_paths",
)
PRUNING_METHODS = (
    "alternating_pattern",
    "shortest_paths_overlap_weighted",
    "keep_axis_aligned",
    "otsu_threshold_on_overlap",
    None,
)


def resolve_pairwise_reg_func(name: str):
    funcs = _pairwise_registration_funcs()
    if name not in funcs:
        raise KeyError(
            f"unknown pairwise registration func {name!r}; "
            f"registered: {sorted(funcs)}"
        )
    return funcs[name]


def resolve_fusion_func(name: str):
    funcs = _fusion_funcs()
    if name not in funcs:
        raise KeyError(
            f"unknown fusion func {name!r}; registered: {sorted(funcs)}"
        )
    return funcs[name]


# ---------------------------------------------------------------------------
# option documents
# ---------------------------------------------------------------------------


@dataclass
class RegistrationOptions:
    """JSON mirror of ``registration.register`` kwargs."""

    transform_key: str = "affine_metadata"
    new_transform_key: str = "registered"
    reg_channel: Optional[str] = None
    registration_binning: Optional[Dict[str, int]] = None
    pairwise_reg_func: str = "phase_correlation"
    pairwise_reg_func_kwargs: dict = field(default_factory=dict)
    groupwise_resolution_method: str = "global_optimization"
    groupwise_resolution_kwargs: dict = field(default_factory=dict)
    pre_registration_pruning_method: Optional[str] = "alternating_pattern"
    post_registration_do_quality_filter: bool = False
    post_registration_quality_threshold: float = 0.2
    pairs: Optional[List[List[int]]] = None

    def __post_init__(self):
        resolve_pairwise_reg_func(self.pairwise_reg_func)  # fail fast
        if self.groupwise_resolution_method not in GROUPWISE_RESOLUTION_METHODS:
            raise KeyError(
                f"unknown groupwise resolution method "
                f"{self.groupwise_resolution_method!r}; registered: "
                f"{GROUPWISE_RESOLUTION_METHODS}"
            )
        if self.pre_registration_pruning_method not in PRUNING_METHODS:
            raise KeyError(
                f"unknown pruning method "
                f"{self.pre_registration_pruning_method!r}; registered: "
                f"{[m for m in PRUNING_METHODS if m]} or null"
            )

    def to_register_kwargs(self) -> dict:
        """Materialize callables; kwargs for ``registration.register``."""
        kwargs = dict(
            transform_key=self.transform_key,
            new_transform_key=self.new_transform_key,
            reg_channel=self.reg_channel,
            registration_binning=self.registration_binning,
            pairwise_reg_func=resolve_pairwise_reg_func(
                self.pairwise_reg_func
            ),
            pairwise_reg_func_kwargs=dict(self.pairwise_reg_func_kwargs),
            groupwise_resolution_method=self.groupwise_resolution_method,
            groupwise_resolution_kwargs=dict(
                self.groupwise_resolution_kwargs
            ),
            pre_registration_pruning_method=self.pre_registration_pruning_method,
            post_registration_do_quality_filter=self.post_registration_do_quality_filter,
            post_registration_quality_threshold=self.post_registration_quality_threshold,
        )
        if self.pairs is not None:
            kwargs["pairs"] = [tuple(p) for p in self.pairs]
        return kwargs

    def to_json(self) -> str:
        return json.dumps(asdict(self))

    @classmethod
    def from_json(cls, s) -> "RegistrationOptions":
        d = json.loads(s) if isinstance(s, str) else dict(s)
        return cls(**d)


@dataclass
class FusionOptions:
    """JSON mirror of the ``fusion.fuse`` kwargs the service exposes."""

    transform_key: str = "affine_metadata"
    fusion_func: str = "weighted_average"
    output_chunksize: Optional[int] = None
    output_spacing: Optional[Dict[str, float]] = None

    def __post_init__(self):
        resolve_fusion_func(self.fusion_func)  # fail fast

    def to_fuse_kwargs(self) -> dict:
        kwargs = dict(
            transform_key=self.transform_key,
            fusion_func=resolve_fusion_func(self.fusion_func),
        )
        if self.output_spacing is not None:
            kwargs["output_spacing"] = dict(self.output_spacing)
        return kwargs

    def to_json(self) -> str:
        return json.dumps(asdict(self))

    @classmethod
    def from_json(cls, s) -> "FusionOptions":
        d = json.loads(s) if isinstance(s, str) else dict(s)
        return cls(**d)


@dataclass
class SessionSpec:
    """Complete read-only description of a session's view state.

    Enough for a stateless worker to rebuild the session: per view a zarr
    URL plus every named transform as a plain matrix (t-aware matrices stay
    nested lists). The session travels once per dispatch; data is reopened
    at the worker.
    """

    sources: List[dict] = field(default_factory=list)  # SourceSpec dicts
    generation: int = 0

    def to_json(self) -> str:
        return json.dumps(asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, s) -> "SessionSpec":
        d = json.loads(s) if isinstance(s, str) else dict(s)
        return cls(
            sources=[dict(src) for src in d.get("sources", [])],
            generation=int(d.get("generation", 0)),
        )

    def source_specs(self) -> List[SourceSpec]:
        return [SourceSpec(**src) for src in self.sources]
