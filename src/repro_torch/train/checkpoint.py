"""Checkpoint manager: atomic and resumable (the port of
``repro/train/checkpoint.py``, with its on-disk layout).

* Atomic: state is written to ``step_XXXXXXXX.tmp/`` then renamed — a crash
  mid-save never corrupts the latest checkpoint (rename is the commit point).
  Replacing an existing step first parks the old dir aside
  (``step_XXXXXXXX.old``), so a crash anywhere inside ``_write`` leaves at
  least one restorable copy of that step on disk.
* Content: flat ``{path: array}`` leaves in ``arrays.npz`` and a JSON
  ``manifest.json`` with the step, an ``extra`` dict and the tree structure.
  Trees may hold dataclasses (the serve layer's ``SessionState``): tensor
  fields land in the npz, scalar fields (``n_objects``) in the manifest's
  ``statics``, and the manifest records each subtree's class so ``restore``
  rebuilds the instances.  Only classes of ``repro_torch`` are rebuilt: a
  class path read from disk is never imported from anywhere else.
* Sidecar: ``save(..., sidecar={...})`` writes ``sidecar.json`` inside the
  step dir under the same commit point — the serve layer keeps its JSON
  state (ledgers, tickets) there.
* Devices: tensors are copied to the host (``.cpu()``); ``restore``
  returns torch tensors on the CPU, or on the ``device`` the caller names.
  bf16 leaves are stored as their raw ``uint16`` bits and recorded as
  ``"bfloat16"`` in the manifest, as the reference stores them.
* Async: ``save(..., background=True)`` hands the host copy to a writer
  thread.  A failed background write is never silent: the exception is
  re-raised from ``wait()`` or the next ``save`` / ``restore``.
* Mesh: a manager built with ``mesh=`` (a ``HostMesh``) is called by every
  rank alike.  ``save(..., shardings=...)`` gathers each leaf whole in
  every rank, in the calling thread (the writer thread runs no
  collective), and only rank 0 writes; ``wait()`` then meets the other
  ranks at a barrier, so every rank that reads the directory after it
  (``restore``, ``latest_step``) sees the same steps.
* Elastic: ``restore(shardings=...)`` loads on the host and cuts each
  rank's block under the shardings of the mesh it restores onto, whatever
  mesh wrote the directory (the reference's elastic path).
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike

_STATIC_TYPES = (bool, int, float, str, type(None))
_PACKAGE = "repro_torch."


def _class_name(obj: Any) -> str:
    cls = type(obj)
    return f"{cls.__module__}.{cls.__qualname__}"


def _resolve_class(name: str) -> type:
    """The dataclass a manifest names — only one of ``repro_torch``: a
    manifest written by the JAX package names its own classes, and
    importing those would load JAX inside the port."""
    if not name.startswith(_PACKAGE):
        raise ValueError(
            f"checkpoint names class {name!r}, outside repro_torch: a "
            "checkpoint written by another package cannot be restored here")
    mod, _, qual = name.rpartition(".")
    obj: Any = importlib.import_module(mod)
    for part in qual.split("."):
        obj = getattr(obj, part)
    return obj


def _flatten(tree: Any, prefix: str = "",
             statics: Optional[Dict[str, Any]] = None,
             classes: Optional[Dict[str, str]] = None) -> Dict[str, Any]:
    """Flatten nested dicts / dataclasses into ``{path: array}``.  Dataclass
    fields that are plain scalars go into ``statics``; the dataclass's
    import path goes into ``classes`` keyed by subtree."""
    out: Dict[str, Any] = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/", statics, classes))
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        if classes is not None:
            classes[prefix[:-1]] = _class_name(tree)
        for f in sorted(dataclasses.fields(tree), key=lambda f: f.name):
            v = getattr(tree, f.name)
            if isinstance(v, _STATIC_TYPES):
                if statics is not None:
                    statics[f"{prefix}{f.name}"] = v
            else:
                out.update(_flatten(v, f"{prefix}{f.name}/",
                                    statics, classes))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: Dict[str, Any],
               statics: Optional[Dict[str, Any]] = None,
               classes: Optional[Dict[str, str]] = None) -> Any:
    root: Dict[str, Any] = {}

    def _insert(path: str, v: Any) -> None:
        node = root
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    for path, v in flat.items():
        _insert(path, v)
    for path, v in (statics or {}).items():
        _insert(path, v)
    # materialise dataclasses deepest-first so nested instances exist
    # before their parents are constructed
    for path in sorted(classes or {}, key=lambda p: -p.count("/")):
        cls = _resolve_class((classes or {})[path])
        if path == "":
            return cls(**root)
        node = root
        parts = path.split("/")
        for p in parts[:-1]:
            node = node[p]
        node[parts[-1]] = cls(**node[parts[-1]])
    return root


def _to_host(v: Any) -> Tuple[np.ndarray, Optional[str]]:
    """A leaf as a host array, and ``"bfloat16"`` when it is stored as raw
    bits (npz has no bf16 type)."""
    if isinstance(v, torch.Tensor):
        # a copy even on the CPU: a background write must not see later
        # in-place updates
        t = v.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), None
    return np.asarray(v), None


def _from_host(a: np.ndarray, dtype: Optional[str]) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


class CheckpointManager:
    def __init__(self, directory: str | Path, keep: int = 3, mesh=None):
        self.dir = Path(directory)
        self.mesh = mesh
        if self._writer:
            self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._barrier()     # the directory exists before any rank reads it

    @property
    def _writer(self) -> bool:
        return self.mesh is None or self.mesh.rank == 0

    def _barrier(self) -> None:
        if self.mesh is not None:
            import torch.distributed as dist

            dist.barrier(group=self.mesh.group())

    # ---------------- save ----------------
    def save(self, step: int, state: Any, extra: Optional[dict] = None,
             background: bool = False,
             sidecar: Optional[dict] = None,
             shardings: Optional[Any] = None) -> Path:
        """Write ``state`` as ``step``.  ``shardings`` (a tree matching the
        state): its leaves are each rank's blocks, gathered whole here in
        every rank (collective) before rank 0 writes."""
        self.wait()  # joins a previous writer and re-raises its failure
        if shardings is not None:
            from .train_step import gather_state

            state = gather_state(state, shardings)
        if not self._writer:
            return self.dir / f"step_{step:08d}"
        statics: Dict[str, Any] = {}
        classes: Dict[str, str] = {}
        flat = _flatten(state, statics=statics, classes=classes)
        host = {}
        dtypes: Dict[str, str] = {}
        for k, v in flat.items():
            host[k], dtype = _to_host(v)
            if dtype is not None:
                dtypes[k] = dtype
        args = (step, host, extra or {}, dtypes, statics, classes, sidecar)
        if background:
            self._thread = threading.Thread(
                target=self._write_guarded, args=args, daemon=True)
            self._thread.start()
            return self.dir / f"step_{step:08d}"
        return self._write(*args)

    def _write_guarded(self, *args) -> None:
        try:
            self._write(*args)
        except BaseException as e:  # surfaced by wait() / the next save
            self._error = e

    def _write(self, step: int, host: Dict[str, np.ndarray], extra: dict,
               dtypes: Dict[str, str], statics: Dict[str, Any],
               classes: Dict[str, str],
               sidecar: Optional[dict] = None) -> Path:
        final = self.dir / f"step_{step:08d}"
        tmp = self.dir / f"step_{step:08d}.tmp"
        old = self.dir / f"step_{step:08d}.old"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / "arrays.npz", **host)
        if sidecar is not None:
            (tmp / "sidecar.json").write_text(json.dumps(sidecar))
        manifest = {
            "step": step,
            "keys": sorted(host),
            "dtypes": dtypes,
            "statics": statics,
            "classes": classes,
            "extra": extra,
            "time": time.time(),
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        # replace in place without a window where no valid copy of this
        # step exists: park the previous dir aside, commit, then drop it
        if old.exists():
            shutil.rmtree(old)
        if final.exists():
            os.rename(final, old)
        os.rename(tmp, final)          # commit point
        if old.exists():
            shutil.rmtree(old)
        self._gc()
        return final

    def wait(self):
        """Join the writer and re-raise its failure; on a mesh, every rank
        then meets the others at a barrier."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("background checkpoint save failed") from err

    def _gc(self):
        ckpts = self.all_steps()
        for s in ckpts[: max(0, len(ckpts) - self.keep)]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)
            shutil.rmtree(self.dir / f"step_{s:08d}.old", ignore_errors=True)

    # ---------------- restore ----------------
    @staticmethod
    def _valid(d: Path) -> bool:
        return (d / "manifest.json").exists()

    def all_steps(self) -> list:
        out = set()
        for p in self.dir.glob("step_*"):
            name = p.name
            if name.endswith(".tmp"):
                continue
            if name.endswith(".old"):
                # a parked dir only counts when the commit never landed
                s = int(name[len("step_"):-len(".old")])
                if self._valid(p) and \
                        not self._valid(self.dir / f"step_{s:08d}"):
                    out.add(s)
                continue
            if self._valid(p):
                out.add(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _step_dir(self, step: int) -> Path:
        final = self.dir / f"step_{step:08d}"
        if self._valid(final):
            return final
        old = self.dir / f"step_{step:08d}.old"
        if self._valid(old):
            return old
        raise FileNotFoundError(f"no restorable checkpoint for step {step} "
                                f"in {self.dir}")

    def sidecar(self, step: Optional[int] = None) -> Optional[dict]:
        """The JSON sidecar saved alongside ``step`` (latest by default),
        or None if that checkpoint has none."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        p = self._step_dir(step) / "sidecar.json"
        return json.loads(p.read_text()) if p.exists() else None

    def restore(self, step: Optional[int] = None,
                device: DeviceLike = None,
                shardings: Optional[Any] = None) -> Tuple[int, Any, dict]:
        """Returns (step, state, extra).  Every array leaf comes back as a
        torch tensor, on the CPU or on ``device``.  With ``shardings`` (a
        tree matching the state, on the mesh to restore onto) each leaf is
        the rank's block under its sharding, on the mesh's device: the
        elastic re-shard."""
        if shardings is not None:
            from .train_step import shard_state

            step, state, extra = self.restore(step)
            state = _to_device(shard_state(state, shardings),
                               _mesh_device(shardings))
            return step, state, extra
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self._step_dir(step)
        manifest = json.loads((d / "manifest.json").read_text())
        dtypes = manifest.get("dtypes", {})
        with np.load(d / "arrays.npz") as z:
            flat = {}
            for k in manifest["keys"]:
                t = _from_host(z[k], dtypes.get(k))
                flat[k] = t if device is None else t.to(device)
        state = _unflatten(flat, manifest.get("statics", {}),
                           manifest.get("classes", {}))
        return step, state, manifest.get("extra", {})


def _mesh_device(shardings: Any):
    node = shardings
    while isinstance(node, dict):
        node = node[sorted(node)[0]]
    return getattr(node.mesh, "device", None)


def _to_device(tree: Any, device) -> Any:
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree if device is None else tree.to(device)
