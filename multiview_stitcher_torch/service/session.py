"""Stateful stitching session: the service runtime's control plane.

The port of ``multiview_stitcher_tpu.service.session``: one long-lived
object owns the views, their transform-key state and a generation counter
that retires stale fused-preview routes. Heavy work (pairwise registration,
block fusion) runs in process on the session's device, or is shipped as JSON
tasks over a :class:`~.bridge.Bridge` to stateless workers that rebuild a
read-only session from a :class:`~.specs.SessionSpec`. The session serves
its views and its preview as virtual OME-Zarrs (``io.virtual_ngff``) on one
HTTP server whose routes follow its state, and describes them to
neuroglancer.

A session runs on ``device``: the CUDA device by default (it raises where
there is none), or the CPU with ``device="cpu"``. It passes that device to
``registration.register``, ``fusion.fuse`` and
``parallel.executors.fuse_block_subset``.
"""

from __future__ import annotations

import uuid
from typing import List, Optional, Sequence, Union

import numpy as np

from multiview_stitcher_torch import msi_utils, param_utils, si_utils
from multiview_stitcher_torch.parallel.executors import SourceSpec
from multiview_stitcher_torch.service.specs import (
    FusionOptions,
    RegistrationOptions,
    SessionSpec,
)
from multiview_stitcher_torch.utils import misc as misc_utils

# fused previews are capped to this many voxels; the preview fuse picks a
# coarser output spacing to fit
DEFAULT_PREVIEW_MAX_VOXELS = 64**3


def _coerce_source(src) -> SourceSpec:
    if isinstance(src, SourceSpec):
        return src
    if isinstance(src, str):
        return SourceSpec(url=src)
    if isinstance(src, dict):
        return SourceSpec(**src)
    raise TypeError(
        f"source must be a URL, SourceSpec or dict, got {type(src).__name__}"
    )


class Session:
    """Holds views + transform state; dispatches work locally or to workers."""

    def __init__(self, session_id: Optional[str] = None, device=None):
        self.device = misc_utils.resolve_device(device)
        self.session_id = session_id or uuid.uuid4().hex[:12]
        self.msims: List = []
        self.source_specs: List[Optional[SourceSpec]] = []
        self.generation = 0
        self._preview = None  # (route, VirtualOMEZarr)
        self._server = None  # (http server, live stores dict)

    # -- view management ----------------------------------------------------

    def load(self, sources: Sequence, replace: bool = True):
        if replace:
            self.clear()
        self.add(sources)
        return self.describe()

    def add(self, sources: Sequence):
        for src in sources:
            spec = _coerce_source(src)
            self.msims.append(spec.open_msim())
            self.source_specs.append(spec)
        self.bump_generation(views=True)

    def load_mosaic(self, path: str, scene_index: int = 0):
        """Load every view of a mosaic file (CZI/TIFF/...) as one source per
        view."""
        from multiview_stitcher_torch import io as msio

        n_views = len(
            msio.read_mosaic_into_sims(path, scene_index=scene_index)
        )
        self.add(
            [
                SourceSpec(
                    url=str(path), scene_index=scene_index, view_index=i
                )
                for i in range(n_views)
            ]
        )
        return self.describe()

    def add_msims(self, msims: Sequence):
        """Attach in-memory msims; such views cannot travel to workers
        (``spec()`` raises) but every in-process command works."""
        for msim in msims:
            self.msims.append(msim)
            self.source_specs.append(None)
        self.bump_generation(views=True)

    def remove(self, index: int):
        del self.msims[index]
        del self.source_specs[index]
        self.bump_generation(views=True)

    def clear(self):
        self.msims = []
        self.source_specs = []
        self.bump_generation(views=True)

    @property
    def is_empty(self) -> bool:
        return not self.msims

    def describe(self) -> List[dict]:
        out = []
        for i, msim in enumerate(self.msims):
            sim = msi_utils.get_sim_from_msim(msim)
            spec = self.source_specs[i]
            out.append(
                {
                    "index": i,
                    "url": spec.url if spec is not None else None,
                    "dims": list(sim.dims),
                    "shape": {d: int(sim.sizes[d]) for d in sim.dims},
                    "spacing": {
                        d: float(v)
                        for d, v in si_utils.get_spacing_from_sim(sim).items()
                    },
                    "origin": {
                        d: float(v)
                        for d, v in si_utils.get_origin_from_sim(sim).items()
                    },
                    "dtype": str(sim.dtype),
                    "transform_keys": sorted(msim.transforms),
                    "n_scales": len(msim.scale_keys),
                }
            )
        return out

    @property
    def transform_keys(self) -> List[str]:
        keys = set()
        for msim in self.msims:
            keys.update(msim.transforms)
        return sorted(keys)

    def default_transform_key(self) -> Optional[str]:
        """Most-derived key shared by all views: prefer a key every view
        has that is not the metadata default; else the metadata default."""
        if self.is_empty:
            return None
        shared = set(self.msims[0].transforms)
        for msim in self.msims[1:]:
            shared &= set(msim.transforms)
        derived = sorted(shared - {si_utils.DEFAULT_TRANSFORM_KEY})
        if derived:
            return derived[-1]
        return sorted(shared)[-1] if shared else None

    # -- spec round-trip ----------------------------------------------------

    def spec(self) -> SessionSpec:
        sources = []
        for i, (msim, spec) in enumerate(
            zip(self.msims, self.source_specs)
        ):
            if spec is None:
                raise ValueError(
                    f"view {i} was added in-memory and has no zarr URL; "
                    "it cannot be described to workers (write it to "
                    "OME-Zarr and load it by URL)"
                )
            affines = {
                key: np.asarray(xaff.squeeze()).tolist()
                for key, xaff in msim.transforms.items()
            }
            sources.append(
                {
                    "url": spec.url,
                    "transform_key": spec.transform_key,
                    "origin": spec.origin,
                    "affines": affines,
                    "scene_index": spec.scene_index,
                    "view_index": spec.view_index,
                }
            )
        return SessionSpec(sources=sources, generation=self.generation)

    @classmethod
    def from_spec(cls, spec: Union[SessionSpec, dict, str], session_id=None, device=None):
        if isinstance(spec, (dict, str)):
            spec = SessionSpec.from_json(spec)
        session = cls(session_id=session_id, device=device)
        session.load(spec.source_specs())
        session.generation = spec.generation
        return session

    # -- transform state ----------------------------------------------------

    def set_params(
        self,
        transform_key: str,
        params: Sequence,
        base_transform_key: Optional[str] = None,
    ):
        """Attach one affine per view under ``transform_key``."""
        if len(params) != len(self.msims):
            raise ValueError(
                f"{len(params)} params for {len(self.msims)} views"
            )
        for msim, mat in zip(self.msims, params):
            msi_utils.set_affine_transform(
                msim,
                param_utils.to_xaffine(np.asarray(mat, dtype=float)),
                transform_key=transform_key,
                base_transform_key=base_transform_key,
            )
        self.bump_generation()

    def copy_transform(self, source_transform_key: str, new_transform_key: str):
        for msim in self.msims:
            if source_transform_key not in msim.transforms:
                raise KeyError(
                    f"view lacks transform key {source_transform_key!r}"
                )
            msim.transforms[new_transform_key] = msim.transforms[
                source_transform_key
            ]
        self.bump_generation()

    def transforms_json(self) -> dict:
        """{transform_key: one matrix per view} for every shared key."""
        return {
            key: [
                np.asarray(msim.transforms[key].squeeze()).tolist()
                for msim in self.msims
            ]
            for key in self.transform_keys
            if all(key in msim.transforms for msim in self.msims)
        }

    # -- generations: retire stale preview routes ---------------------------

    def bump_generation(self, views: bool = False):
        self.generation += 1
        self._preview = None
        self._sync_server(views=views)
        return self.generation

    # -- integrated HTTP serving ---------------------------------------------

    def serve(self, port: int = 8000) -> dict:
        """Serve every view (and the current preview, when one exists) as
        virtual OME-Zarr routes on one HTTP server.

        Routes track session state live: view list changes and preview
        re-fuses update the served store set in place; stale preview
        routes 404. Returns route names; call ``stop_serving()`` to stop.
        """
        from multiview_stitcher_torch.io import virtual_ngff

        self.stop_serving()
        stores: dict = {}
        server = virtual_ngff._start_server(
            type("Handler", (virtual_ngff._VirtualHandler,), {"stores": stores}), port
        )
        self._server = (server, stores)
        self._sync_server(views=True)
        return {
            "base_url": f"http://127.0.0.1:{server.server_address[1]}",
            "routes": sorted(stores),
        }

    def stop_serving(self):
        if self._server is not None:
            self._server[0].shutdown()
            self._server[0].server_close()
            self._server = None

    def _sync_server(self, views: bool = False):
        """Refresh the live store dict behind the HTTP server."""
        if self._server is None:
            return
        from multiview_stitcher_torch.io.virtual_ngff import VirtualOMEZarr

        _, stores = self._server
        # retire stale fused routes; (re-)publish the current preview
        for route in [r for r in stores if r.startswith("fused-")]:
            del stores[route]
        if self._preview is not None:
            stores[self._preview[0]] = self._preview[1]
        if views:
            for route in [r for r in stores if not r.startswith("fused-")]:
                del stores[route]
            for i, msim in enumerate(self.msims):
                stores[f"{i}.ome.zarr"] = VirtualOMEZarr(msim)

    # -- registration -------------------------------------------------------

    def register(
        self,
        options: Union[RegistrationOptions, dict, None] = None,
        bridge=None,
        batch_size: int = 128,
        progress=None,
    ) -> dict:
        """Run the full register() flow; pairwise work optionally over a bridge.

        Returns a JSON-safe summary: the new transform key, per-view resolved
        params and per-edge qualities.
        """
        from multiview_stitcher_torch import registration

        if options is None:
            options = RegistrationOptions()
        elif isinstance(options, dict):
            options = RegistrationOptions(**options)

        kwargs = options.to_register_kwargs()
        # the service pre-selects the registration channel: the first
        # channel when views carry a channel dim and none was requested
        if kwargs.get("reg_channel") is None and any(
            "c" in msi_utils.get_sim_from_msim(m).dims for m in self.msims
        ):
            kwargs["reg_channel_index"] = 0
        if bridge is not None:
            kwargs["pairwise_executor"] = self._bridge_pairwise_executor(
                options, bridge, batch_size=batch_size, progress=progress
            )
        result = registration.register(
            self.msims, return_dict=True, device=self.device, **kwargs
        )
        self.bump_generation()
        qualities = result["pairwise_registration"]["metrics"]["qualities"]
        return {
            "transform_key": options.new_transform_key,
            "params": [
                np.asarray(p.squeeze()).tolist() for p in result["params"]
            ],
            "edges": [list(e) for e in qualities],
            "qualities": [
                None if q is None or np.any(np.isnan(q)) else float(np.mean(q))
                for q in qualities.values()
            ],
        }

    def _bridge_pairwise_executor(
        self, options, bridge, batch_size=128, progress=None
    ):
        """pairwise_executor hook that ships edges as JSON tasks.

        The session spec travels in each task; workers cache the rebuilt
        session by (spec, generation) so views are reopened once per
        generation, not per edge.
        """
        spec_json = self.spec().to_json()

        def pairwise_executor(msims, edges, register_kwargs):
            tasks = [
                {
                    "task": "register_pairs",
                    "session": spec_json,
                    "edges": [[int(i), int(j)]],
                    "options": options.to_json(),
                }
                for i, j in edges
            ]
            raw = bridge.dispatch(
                tasks, batch_size=batch_size, progress=progress
            )
            results = []
            for r in raw:
                (r0,) = r["results"]
                results.append(
                    {
                        "transform": param_utils.affine_to_xaffine(
                            np.asarray(r0["transform"])
                        ),
                        "quality": (
                            np.nan
                            if r0["quality"] is None
                            else float(r0["quality"])
                        ),
                        "bbox": np.asarray(r0["bbox"]),
                    }
                )
            return results

        return pairwise_executor

    # -- fusion -------------------------------------------------------------

    def _fusion_options(self, options) -> FusionOptions:
        if options is None:
            key = self.default_transform_key()
            return FusionOptions(transform_key=key)
        if isinstance(options, dict):
            return FusionOptions(**options)
        return options

    def fuse_preview(
        self,
        options: Union[FusionOptions, dict, None] = None,
        max_voxels: int = DEFAULT_PREVIEW_MAX_VOXELS,
    ) -> dict:
        """Fuse a coarse preview and expose it as a virtual OME-Zarr route.

        The route carries the generation, so any state change retires it;
        ``preview_store()`` serves the bytes.
        """
        from multiview_stitcher_torch import fusion
        from multiview_stitcher_torch.io.virtual_ngff import VirtualOMEZarr

        options = self._fusion_options(options)
        sims = [msi_utils.get_sim_from_msim(m) for m in self.msims]
        sdims = si_utils.get_spatial_dims_from_sim(sims[0])

        # coarsen output spacing until the fused volume fits the budget
        from multiview_stitcher_torch.fusion import _core

        osp = _core.process_output_stack_properties(
            [si_utils.get_sim_field(s) for s in sims],
            transform_key=options.transform_key,
        )
        spacing = {d: float(osp["spacing"][d]) for d in sdims}
        shape = {d: int(osp["shape"][d]) for d in sdims}
        while np.prod([shape[d] for d in sdims]) > max_voxels:
            # halve the finest-spaced dim, like registration binning
            d_fine = min(sdims, key=lambda d: spacing[d])
            spacing[d_fine] *= 2
            shape[d_fine] = max(1, shape[d_fine] // 2)

        fuse_kwargs = options.to_fuse_kwargs()
        fuse_kwargs["output_spacing"] = spacing
        fused = fusion.fuse(sims, device=self.device, **fuse_kwargs)
        route = f"fused-g{self.generation}.ome.zarr"
        self._preview = (route, VirtualOMEZarr(fused))
        self._sync_server()
        return {
            "route": route,
            "generation": self.generation,
            "shape": {d: int(fused.sizes[d]) for d in fused.dims},
            "spacing": spacing,
        }

    def preview_store(self, route: str):
        """The VirtualOMEZarr behind a preview route, or None if retired."""
        if self._preview is None or self._preview[0] != route:
            return None
        return self._preview[1]

    def fusion_plan(self, options=None, output_chunksize=None) -> dict:
        """Deterministic output geometry + block count, identical for every
        participant."""
        from multiview_stitcher_torch import mv_graph
        from multiview_stitcher_torch.fusion import _core

        options = self._fusion_options(options)
        sims = [msi_utils.get_sim_from_msim(m) for m in self.msims]
        sdims = si_utils.get_spatial_dims_from_sim(sims[0])
        if output_chunksize is None:
            output_chunksize = options.output_chunksize
        if output_chunksize is None:
            output_chunksize = si_utils.get_default_spatial_chunksizes(
                len(sdims)
            )
        elif not isinstance(output_chunksize, dict):
            output_chunksize = {d: int(output_chunksize) for d in sdims}
        osp = _core.process_output_stack_properties(
            [si_utils.get_sim_field(s) for s in sims],
            transform_key=options.transform_key,
            output_spacing=options.output_spacing,
        )
        chunk_bbs, _ = mv_graph.get_chunk_bbs(osp, output_chunksize)
        return {
            "n_blocks": len(chunk_bbs),
            "shape": {d: int(osp["shape"][d]) for d in sdims},
            "origin": {d: float(osp["origin"][d]) for d in sdims},
            "spacing": {d: float(osp["spacing"][d]) for d in sdims},
            "chunksize": {d: int(output_chunksize[d]) for d in sdims},
        }

    def fuse_to_zarr(
        self,
        output_zarr_url: str,
        options: Union[FusionOptions, dict, None] = None,
        bridge=None,
        n_workers: int = 1,
        batch_size: int = 8,
        progress=None,
    ) -> dict:
        """Block-partitioned fusion into a shared zarr store.

        Without a bridge, fuses block by block in process on the session's
        device. With one, block-id subsets are dispatched as JSON tasks; the
        session creates the output array first and every worker attaches.
        """
        from multiview_stitcher_torch.parallel import executors

        options = self._fusion_options(options)
        plan = self.fusion_plan(options)
        if bridge is None:
            n = executors.fuse_block_subset(
                self.spec().source_specs(),  # raises for in-memory views
                output_zarr_url,
                options.transform_key,
                worker_index=0,
                n_workers=1,
                output_chunksize=plan["chunksize"],
                create_output=True,
                device=self.device,
                fusion_func=options.to_fuse_kwargs()["fusion_func"],
            )
            return {"n_blocks": plan["n_blocks"], "written": int(n)}

        spec_json = self.spec().to_json()
        opt_json = options.to_json()
        # create the array up front so workers can attach concurrently
        executors.fuse_block_subset(
            self.spec().source_specs(),
            output_zarr_url,
            options.transform_key,
            worker_index=0,
            n_workers=1,
            output_chunksize=plan["chunksize"],
            create_output=True,
            create_only=True,
        )
        ids = list(range(plan["n_blocks"]))
        tasks = [
            {
                "task": "fuse_blocks",
                "session": spec_json,
                "options": opt_json,
                "output_zarr_url": output_zarr_url,
                "chunksize": plan["chunksize"],
                "ids": ids[lo : lo + batch_size],
            }
            for lo in range(0, len(ids), batch_size)
        ]
        raw = bridge.dispatch(tasks, batch_size=1, progress=progress)
        written = sum(int(r["written"]) for r in raw)
        if written != plan["n_blocks"]:
            raise RuntimeError(
                f"workers wrote {written} of {plan['n_blocks']} blocks"
            )
        return {"n_blocks": plan["n_blocks"], "written": written}

    # -- viewer state -------------------------------------------------------

    def neuroglancer_state(
        self,
        base_url: str = "http://127.0.0.1:8000",
        transform_key: Optional[str] = None,
    ) -> dict:
        """Neuroglancer JSON over the session's views served as virtual
        stores at ``{base_url}/{i}.ome.zarr`` (see io.virtual_ngff)."""
        from multiview_stitcher_torch import neuroglancer

        sims = [msi_utils.get_sim_from_msim(m) for m in self.msims]
        if transform_key is None:
            transform_key = self.default_transform_key()
        return neuroglancer.generate_neuroglancer_json(
            None,
            [f"{base_url}/{i}.ome.zarr" for i in range(len(sims))],
            sims=sims,
            transform_key=transform_key,
        )
