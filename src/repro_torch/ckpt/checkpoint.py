"""Checkpointing in the reference's on-disk layout, with an async save.
The port of `repro.ckpt.checkpoint`.

Layout: <dir>/step_<N>/proc_0.npz + meta.json (step, time, the sorted
keys). A state tree (dicts, lists, tensors or numpy arrays) is flattened
to `/`-joined paths, dict keys sorted (list items by index), each leaf
saved as a numpy array. A step is written under `.tmp_step_<N>` and
published by `os.replace`, so a crash leaves no half-written `step_<N>`;
all but the newest `keep` steps are then removed. The port runs one
process, so every leaf is whole in `proc_0.npz`; a checkpoint that the
reference's `Checkpointer` wrote on one process restores here (and the
reverse), since the layout is the same (its leaves named by the
reference's tree; `models/convert.from_reference_train_state` maps them
to the port's). A placed leaf (a `Placed` value: a tensor-parallel or
FSDP state's blocks, `models/sharding.place_model`) is gathered into its
whole leaf (`Placed.full`) as it is saved, so a checkpoint of a placed
state holds the arrays an unsharded save of the same state writes, and
restores onto any layout. `restore(..., shardings=)` places each
restored leaf on a mesh (`models/sharding.place`), as the reference's
`device_put`s it; `train_step.load_train_state` copies either into a
placed state block by block.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.models.sharding import Placed, place


def _host(x) -> np.ndarray:
    """A host copy of x (a copy even of a CPU tensor, which the next step
    overwrites while an async save may still be writing it); a Placed
    value's whole tensor."""
    if isinstance(x, Placed):
        return x.full("cpu").numpy()
    if torch.is_tensor(x):
        return x.detach().to("cpu", copy=True).numpy()
    return np.array(x)


def _flatten_with_paths(tree) -> Dict[str, Any]:
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(f"{prefix}/{k}" if prefix else k, node[k])
        elif isinstance(node, (list, tuple)):
            for i, x in enumerate(node):
                walk(f"{prefix}/{i}", x)
        else:
            flat[prefix] = node

    walk("", tree)
    return flat


def _unflatten_like(template, flat: Dict[str, Any]):
    def walk(prefix, node):
        if isinstance(node, dict):
            return {k: walk(f"{prefix}/{k}" if prefix else k, v)
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            out = [walk(f"{prefix}/{i}", x) for i, x in enumerate(node)]
            return type(node)(out) if isinstance(node, tuple) else out
        return flat[prefix]
    return walk("", template)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    # ---------------- save ----------------
    def save(self, step: int, state) -> None:
        """Copy `state` to the host now; write it (on a thread with
        async_save, after the previous save has finished)."""
        flat = {k: _host(v) for k, v in _flatten_with_paths(state).items()}
        if self.async_save:
            self.wait()
            self._thread = threading.Thread(
                target=self._write_catching, args=(step, flat), daemon=True)
            self._thread.start()
        else:
            self._write(step, flat)

    def wait(self) -> None:
        """Join the save in flight; re-raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write_catching(self, step: int, flat) -> None:
        try:
            self._write(step, flat)
        except BaseException as e:  # noqa: BLE001  (re-raised by wait)
            self._error = e

    def _write(self, step: int, flat: Dict[str, np.ndarray]) -> None:
        tmp = os.path.join(self.dir, f".tmp_step_{step}")
        final = os.path.join(self.dir, f"step_{step}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "proc_0.npz"), **flat)
        meta = dict(step=step, time=time.time(), keys=sorted(flat))
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)  # atomic publish
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # ---------------- restore ----------------
    def all_steps(self):
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_"):
                try:
                    out.append(int(d.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, template, shardings=None):
        """The saved tree of `step` in `template`'s structure (dicts,
        lists; its leaves only name the places), as host numpy arrays;
        with `shardings` (the same structure, a (mesh, P) pair at each
        leaf), each leaf placed on its mesh (a `Placed` value)."""
        path = os.path.join(self.dir, f"step_{step}")
        with np.load(os.path.join(path, "proc_0.npz")) as data:
            flat = {k: data[k] for k in data.files}
        host = _unflatten_like(template, flat)
        if shardings is None:
            return host
        def walk(node, sh):
            if isinstance(node, dict):
                return {k: walk(v, sh[k]) for k, v in node.items()}
            if isinstance(node, (list, tuple)):
                out = [walk(x, s) for x, s in zip(node, sh)]
                return type(node)(out) if isinstance(node, tuple) else out
            mesh, p = sh
            return place(node, mesh, p)

        return walk(host, shardings)
