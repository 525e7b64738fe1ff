"""Stateless worker runtime: one JSON entry point for commands and tasks.

The port of ``multiview_stitcher_tpu.service.worker``: ``handle(command,
payload)`` drives a stateful session (one runtime per session worker), and
``run_task(task_json)`` runs stateless compute tasks. For a task the worker
rebuilds a read-only session from the spec inside it and caches it keyed by
the spec (which carries the generation) in a small LRU, so a batch of tasks
for one session generation reopens the views once. Every input and output is
JSON-safe, and equal to the JAX package's; image data never enters the
protocol. Commands and tasks run on the runtime's ``device``: the CUDA
device by default (it raises where there is none), or the CPU with
``device="cpu"``.
"""

from __future__ import annotations

import json
from collections import OrderedDict

import numpy as np

from multiview_stitcher_torch.service.session import Session
from multiview_stitcher_torch.service.specs import (
    FusionOptions,
    RegistrationOptions,
)

SESSION_CACHE_SIZE = 2


class WorkerRuntime:
    """Dispatches session commands and stateless compute tasks."""

    def __init__(self, device=None):
        self.session: Session = Session(device=device)
        self.device = self.session.device
        self._session_cache: OrderedDict = OrderedDict()

    # -- stateful command surface -------------------------------------------

    def handle(self, command: str, payload: dict = None) -> dict:
        payload = payload or {}
        handler = getattr(self, f"_cmd_{command}", None)
        if handler is None:
            raise KeyError(
                f"unknown command {command!r}; known: "
                f"{sorted(m[5:] for m in dir(self) if m.startswith('_cmd_'))}"
            )
        return handler(payload)

    def _cmd_info(self, payload):
        return {
            "session_id": self.session.session_id,
            "n_views": len(self.session.msims),
            "generation": self.session.generation,
            "transform_keys": self.session.transform_keys,
        }

    def _cmd_load(self, payload):
        return {
            "views": self.session.load(
                payload["sources"], replace=payload.get("replace", True)
            )
        }

    def _cmd_add(self, payload):
        self.session.add(payload["sources"])
        return {"views": self.session.describe()}

    def _cmd_load_mosaic(self, payload):
        return {
            "views": self.session.load_mosaic(
                payload["path"],
                scene_index=int(payload.get("scene_index", 0)),
            )
        }

    def _cmd_remove(self, payload):
        self.session.remove(int(payload["index"]))
        return {"views": self.session.describe()}

    def _cmd_clear(self, payload):
        self.session.clear()
        return {"views": []}

    def _cmd_describe(self, payload):
        return {"views": self.session.describe()}

    def _cmd_spec(self, payload):
        return {"spec": json.loads(self.session.spec().to_json())}

    def _cmd_transform_keys(self, payload):
        return {"transform_keys": self.session.transform_keys}

    def _cmd_transforms(self, payload):
        return {"transforms": self.session.transforms_json()}

    def _cmd_set_params(self, payload):
        self.session.set_params(
            payload["transform_key"],
            payload["params"],
            base_transform_key=payload.get("base_transform_key"),
        )
        return {"generation": self.session.generation}

    def _cmd_copy_transform(self, payload):
        self.session.copy_transform(
            payload["source_transform_key"], payload["new_transform_key"]
        )
        return {"generation": self.session.generation}

    def _cmd_register(self, payload):
        return self.session.register(payload.get("options"))

    def _cmd_fuse_preview(self, payload):
        return self.session.fuse_preview(payload.get("options"))

    def _cmd_fusion_plan(self, payload):
        return self.session.fusion_plan(payload.get("options"))

    def _cmd_fuse_to_zarr(self, payload):
        return self.session.fuse_to_zarr(
            payload["output_zarr_url"], options=payload.get("options")
        )

    def _cmd_neuroglancer_state(self, payload):
        return self.session.neuroglancer_state(
            base_url=payload.get("base_url", "http://127.0.0.1:8000"),
            transform_key=payload.get("transform_key"),
        )

    # -- session cache for stateless tasks ----------------------------------

    def session_for(self, spec_json: str) -> Session:
        key = spec_json
        if key in self._session_cache:
            self._session_cache.move_to_end(key)
            return self._session_cache[key]
        session = Session.from_spec(spec_json, device=self.device)
        self._session_cache[key] = session
        while len(self._session_cache) > SESSION_CACHE_SIZE:
            self._session_cache.popitem(last=False)
        return session

    def invalidate(self):
        self._session_cache.clear()

    # -- stateless compute tasks --------------------------------------------

    def run_task(self, task_json: str) -> str:
        task = json.loads(task_json)
        name = task["task"]
        handler = getattr(self, f"_task_{name}", None)
        if handler is None:
            raise KeyError(f"unknown task {name!r}")
        return json.dumps(handler(task))

    def _task_register_pairs(self, task) -> dict:
        from multiview_stitcher_torch import msi_utils, registration

        session = self.session_for(task["session"])
        options = RegistrationOptions.from_json(task["options"])
        kwargs = options.to_register_kwargs()

        def reg_view(msim):
            # mirror register()'s pre-selection (the rebuilt session holds
            # raw views): channel choice from the options, first by default
            sim = msi_utils.get_sim_from_msim(msim)
            sel = {}
            if "c" in sim.dims:
                sel["c"] = (
                    options.reg_channel
                    if options.reg_channel is not None
                    else np.asarray(sim.coords["c"])[0]
                )
            if "t" in sim.dims:
                if sim.sizes["t"] > 1:
                    raise NotImplementedError(
                        "register_pairs tasks are per-timepoint; split "
                        "multi-t sessions into per-t tasks"
                    )
                sel["t"] = np.asarray(sim.coords["t"])[0]
            return (
                msi_utils.multiscale_sel_coords(msim, sel) if sel else msim
            )

        results = []
        for i, j in task["edges"]:
            r = registration.register_pair_of_msims(
                reg_view(session.msims[int(i)]),
                reg_view(session.msims[int(j)]),
                transform_key=options.transform_key,
                registration_binning=kwargs["registration_binning"],
                pairwise_reg_func=kwargs["pairwise_reg_func"],
                pairwise_reg_func_kwargs=kwargs["pairwise_reg_func_kwargs"],
                device=self.device,
            )
            quality = np.asarray(r["quality"], dtype=float)
            results.append(
                {
                    "transform": np.asarray(
                        r["transform"].squeeze()
                    ).tolist(),
                    "quality": (
                        None
                        if np.all(np.isnan(quality))
                        else float(np.nanmean(quality))
                    ),
                    "bbox": np.asarray(r["bbox"]).tolist(),
                }
            )
        return {"results": results}

    def _task_fuse_blocks(self, task) -> dict:
        from multiview_stitcher_torch.parallel import executors
        from multiview_stitcher_torch.service.specs import SessionSpec

        spec = SessionSpec.from_json(task["session"])
        options = FusionOptions.from_json(task["options"])
        n = executors.fuse_block_subset(
            spec.source_specs(),
            task["output_zarr_url"],
            options.transform_key,
            worker_index=0,
            n_workers=1,
            output_chunksize=task.get("chunksize"),
            create_output=False,
            block_ids=[int(b) for b in task["ids"]],
            device=self.device,
            fusion_func=options.to_fuse_kwargs()["fusion_func"],
        )
        return {"written": int(n)}
