"""The (data, model) mesh of the port: ``torch.distributed`` ranks, one
process a rank (SPMD).

A port of the JAX package's ``launch/mesh.py``.  The reference is one
controller over a ``jax.sharding.Mesh`` that ``shard_map`` cuts into
per-device blocks.  Here every rank runs the same program on the same global
inputs, computes the block ``shard_map`` would give its device, and builds
the global outputs with explicit collectives, so that every rank then holds
them, as a ``shard_map`` result is a global array.

* :func:`make_host_mesh` wraps the initialized process group in a
  :class:`HostMesh`: a ``DeviceMesh`` with dims ``("data", "model")``, rank
  ``r`` at coordinate ``(r // model, r % model)`` (the order of the
  reference's ``P("data", "model", ...)`` out specs), plus the backend and
  the device the mesh was built with.  ``(1, 1)`` without a process group
  is ``None``: one device, as everywhere else in the port.
* :func:`make_production_mesh` is the reference's 16 x 16 (or 2 x 16 x 16)
  mesh, over as many ranks.
* :func:`spawn` starts ``data * model`` ranks on one host and runs a
  function on the mesh in each: the counterpart of the reference's
  ``XLA_FLAGS=--xla_force_host_platform_device_count=N``.

The backend is named when the mesh is built, never guessed after an error:
NCCL when every rank has a card of its own, gloo when ranks share a card or
run on the CPU (NCCL refuses two ranks of one communicator on one card).
The collectives below (the port's one collective helper) hand their tensors
to the backend as they are, on either backend: gloo takes CUDA tensors, the
16-bit floats included, in each collective used here (torch 2.11 on an
H100), and stages them through host memory itself.

The collectives are differentiable, under the SPMD reading of a replicated
value: every rank holds the same global output and computes the same loss
from it.  :func:`all_gather`'s backward then takes the rank's own slice of
the (replicated) gradient; :func:`shard`'s (a replicated value cut to the
rank's chunk) gathers the chunks' gradients back; :func:`all_to_all`'s is
the reverse exchange; :func:`all_reduce`'s passes the gradient through; and
:func:`replicate` (the identity on a replicated input that each rank uses
for its own part of the work) sums the ranks' gradients.
"""
from __future__ import annotations

import dataclasses
import math
import multiprocessing
import os
import pickle
import queue as queue_mod
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, pick_device

AXES = ("data", "model")


def choose_backend(device: torch.device, n_ranks: int,
                   backend: Optional[str] = None) -> str:
    """The backend for ``n_ranks`` ranks on ``device``'s type: NCCL when
    every rank has a card of its own, gloo when ranks share a card or run
    on the CPU.  An explicit ``backend`` is checked against that rule."""
    own_cards = device.type == "cuda" and \
        n_ranks <= torch.cuda.device_count()
    want = "nccl" if own_cards else "gloo"
    if backend is None:
        return want
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: use 'nccl' or 'gloo'")
    if backend == "nccl" and not own_cards:
        raise ValueError(
            f"backend 'nccl' needs a card a rank: {n_ranks} ranks on "
            f"{device.type} with {torch.cuda.device_count()} cards (NCCL "
            "refuses two ranks of one communicator on one card); use gloo")
    return backend


class HostMesh:
    """A mesh of SPMD ranks: ``torch.distributed``'s ``DeviceMesh``
    (:attr:`device_mesh`) with the backend and the rank's device that it was
    built with.  :meth:`group` is the process group of one of the rank's
    axes (``None``: the whole mesh)."""

    def __init__(self, device_mesh, backend: str, device: torch.device):
        self.device_mesh = device_mesh
        self.backend = backend
        self.device = device

    @property
    def mesh_dim_names(self) -> Tuple[str, ...]:
        return tuple(self.device_mesh.mesh_dim_names)

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.device_mesh.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def rank(self) -> int:
        return dist.get_rank()

    @property
    def coordinate(self) -> Tuple[int, ...]:
        """The rank's place on the mesh, one index an axis."""
        return tuple(self.device_mesh.get_coordinate())

    def extent(self, name: str) -> int:
        return dict(zip(self.mesh_dim_names, self.shape)).get(name, 1)

    def index(self, name: str) -> int:
        """The rank's index along axis ``name`` (0 where there is none)."""
        if name not in self.mesh_dim_names:
            return 0
        return self.coordinate[self.mesh_dim_names.index(name)]

    def group(self, name: Optional[str] = None):
        """The process group of the rank's axis ``name``, or of the whole
        mesh (which is the whole process group) for ``None``."""
        if name is None:
            return dist.group.WORLD
        return self.device_mesh.get_group(name)

    def group_index(self, name: Optional[str] = None) -> int:
        """The rank's place in :meth:`group`'s rank order."""
        return self.rank if name is None else self.index(name)

    def group_size(self, name: Optional[str] = None) -> int:
        return self.size if name is None else self.extent(name)

    def __repr__(self) -> str:
        dims = ", ".join(f"{k}={v}" for k, v in
                         zip(self.mesh_dim_names, self.shape))
        return (f"HostMesh({dims}, backend={self.backend!r}, "
                f"device='{self.device}', rank={self.rank})")


def as_mesh(mesh) -> Optional[HostMesh]:
    """A ``mesh`` argument of the port's entry points: ``None`` for one
    device (``None`` or the bare tuple ``(1, 1)``), the mesh itself
    otherwise; any other tuple of extents is a ``TypeError``."""
    if isinstance(mesh, tuple):
        if mesh == (1, 1):
            return None
        raise TypeError(
            f"mesh {mesh!r}: a multi-device mesh is a HostMesh from "
            "repro_torch.launch.mesh (make_host_mesh, or spawn's argument), "
            "not a tuple of extents")
    return mesh


def _build_mesh(shape: Tuple[int, ...], names: Tuple[str, ...],
                device: DeviceLike) -> HostMesh:
    from torch.distributed.device_mesh import DeviceMesh

    dev = pick_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    backend = choose_backend(dev, math.prod(shape), dist.get_backend())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    layout = torch.arange(math.prod(shape)).reshape(shape)
    mesh = DeviceMesh(dev.type, layout, mesh_dim_names=names)
    return HostMesh(mesh, backend, dev)


def make_host_mesh(data: int = 1, model: int = 1,
                   device: DeviceLike = None) -> Optional[HostMesh]:
    """The ``(data, model)`` mesh over the initialized process group, with
    the rank's ``device`` (the card unless ``"cpu"`` is asked for; a bare
    ``"cuda"`` is the current card).  ``(1, 1)`` without a process group is
    ``None``, the port's single device.  Raises ``RuntimeError`` when the
    world size is not ``data * model``, and ``ValueError`` when the process
    group's backend cannot serve the device (NCCL with ranks sharing a
    card, or on the CPU)."""
    if not dist.is_initialized():
        if (data, model) == (1, 1):
            return None
        raise RuntimeError(
            f"mesh ({data}, {model}) needs {data * model} ranks in an "
            "initialized process group: start them with "
            "repro_torch.launch.mesh.spawn")
    world = dist.get_world_size()
    if world != data * model:
        raise RuntimeError(
            f"mesh ({data}, {model}) needs {data * model} ranks but the "
            f"process group has {world}")
    return _build_mesh((data, model), AXES, device)


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None) -> HostMesh:
    """The reference's production mesh: 16 x 16 = 256 ranks a pod; the
    multi-pod mesh adds a leading ``pod`` axis (2 x 16 x 16 = 512)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else AXES
    ndev = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world < ndev:
        raise RuntimeError(
            f"mesh {shape} needs {ndev} devices but only {world} are visible "
            f"— start {ndev} ranks (repro_torch.launch.mesh.spawn, or one "
            "process a card under a cluster launcher) before building it")
    if world != ndev:
        raise RuntimeError(f"mesh {shape} needs exactly {ndev} ranks, the "
                           f"process group has {world}")
    return _build_mesh(shape, axes, device)


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _RankSpec:
    rank: int
    data: int
    model: int
    device: str
    backend: str
    store: str
    timeout: float
    call: str      # the pickled (fn, args) the launcher wrote


def _rank_main(spec: _RankSpec, results) -> None:
    """One rank: the process group, the mesh, ``fn(mesh, *args)``; its
    value or its traceback goes to ``results``."""
    n = spec.data * spec.model
    try:
        with open(spec.call, "rb") as f:   # written by spawn, this program
            fn, args = pickle.load(f)
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
        dev = torch.device(spec.device)
        if dev.type == "cuda":
            dev = torch.device("cuda", spec.rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        dist.init_process_group(
            spec.backend, store=dist.FileStore(spec.store, n),
            rank=spec.rank, world_size=n,
            timeout=timedelta(seconds=spec.timeout))
        try:
            mesh = make_host_mesh(spec.data, spec.model, dev)
            value = fn(mesh, *args)
            dist.barrier()
        finally:
            dist.destroy_process_group()
        results.put((spec.rank, True, value))
    except BaseException:
        results.put((spec.rank, False, traceback.format_exc()))
        raise


def spawn(fn: Callable[..., Any], data: int = 1, model: int = 1, *,
          device: DeviceLike, args: Sequence[Any] = (),
          timeout: float = 600.0) -> Any:
    """Run ``fn(mesh, *args)`` in each of ``data * model`` ranks started with
    the spawn start method on this host, and return rank 0's value.

    The ranks meet through a ``FileStore`` in a temporary directory (no
    port to clash over).  Rank ``r`` runs on ``cuda:{r % device_count}``
    for ``device="cuda"``, or on the CPU, with the backend of
    :func:`choose_backend` (printed in the mesh's repr) and ``cpu_count //
    (data * model)`` torch threads.  ``fn`` and ``args`` are pickled, so
    ``fn`` must be importable by name from a module that the ranks can
    import.  Raises ``RuntimeError`` carrying the rank's traceback when any
    rank raises or exits non-zero, and when the ranks outlive ``timeout``
    seconds; the other ranks are then stopped."""
    n = data * model
    dev = pick_device(device)
    backend = choose_backend(dev, n)
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    deadline = time.monotonic() + timeout
    procs = []
    with tempfile.TemporaryDirectory(prefix="repro_torch_mesh_") as tmp:
        # the call goes through a file: a rank that dies before reading its
        # start-up pipe would block the launcher's write of a large payload
        call = os.path.join(tmp, "call.pkl")
        with open(call, "wb") as f:
            pickle.dump((fn, tuple(args)), f)
        try:
            for rank in range(n):
                spec = _RankSpec(rank, data, model, dev.type, backend,
                                 os.path.join(tmp, "store"), timeout, call)
                p = ctx.Process(target=_rank_main, args=(spec, results),
                                name=f"repro_torch-rank{rank}")
                p.start()
                procs.append(p)
            values = _collect(procs, results, deadline, timeout)
            for rank, p in enumerate(procs):
                p.join(max(1.0, deadline - time.monotonic()))
                if p.exitcode != 0:
                    raise RuntimeError(f"rank {rank} returned its value but "
                                       f"did not exit cleanly ({p.exitcode})")
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(10.0)
                if p.is_alive():
                    p.kill()
                    p.join()
    return values[0]


def _collect(procs, results, deadline: float, timeout: float) -> dict:
    """Every rank's value; raises at the first failure: a traceback, a rank
    gone without one (after two seconds' grace for it to land), or the
    deadline."""
    values: dict = {}
    grace = None
    while len(values) < len(procs):
        try:
            rank, ok, payload = results.get(timeout=0.2)
        except queue_mod.Empty:
            now = time.monotonic()
            gone = [r for r, p in enumerate(procs)
                    if r not in values and p.exitcode not in (None, 0)]
            if gone and grace is None:
                grace = now + 2.0
            if gone and now > grace:
                raise RuntimeError(
                    f"rank {gone[0]} exited with {procs[gone[0]].exitcode} "
                    "and no traceback") from None
            if now > deadline:
                raise RuntimeError(
                    f"mesh ranks outlived the timeout of {timeout} s: ranks "
                    f"{sorted(set(range(len(procs))) - set(values))} "
                    "returned nothing") from None
            continue
        if not ok:
            raise RuntimeError(_failures(results, rank, payload))
        values[rank] = payload
    return values


def _failures(results, rank: int, payload: str) -> str:
    """The first failing rank's traceback, and those of the ranks that fail
    within a second after it (a collective's peers fail in turn: the rank
    at fault may not be the first to report)."""
    out = [f"rank {rank} raised:\n{payload}"]
    end = time.monotonic() + 1.0
    while time.monotonic() < end:
        try:
            r, ok, text = results.get(timeout=0.1)
        except queue_mod.Empty:
            continue
        if not ok:
            out.append(f"rank {r} raised:\n{text}")
    return "\n".join(out)


# ---------------------------------------------------------------------------
# Collectives (differentiable)
# ---------------------------------------------------------------------------
def _gather(x: torch.Tensor, mesh: HostMesh, axis: Optional[str]):
    parts = [torch.empty_like(x) for _ in range(mesh.group_size(axis))]
    dist.all_gather(parts, x, group=mesh.group(axis))
    return torch.stack(parts)


def _exchange(x: torch.Tensor, mesh: HostMesh, axis: Optional[str]):
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=mesh.group(axis))
    return out


def _reduce(x: torch.Tensor, mesh: HostMesh, axis: Optional[str]):
    w = x.detach().clone()
    dist.all_reduce(w, group=mesh.group(axis))
    return w


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _gather(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.mesh.group_index(ctx.axis)], None, None


class _Shard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        n, i = mesh.group_size(axis), mesh.group_index(axis)
        return x.reshape(n, x.shape[0] // n, *x.shape[1:])[i].clone()

    @staticmethod
    def backward(ctx, g):
        full = _gather(g.contiguous(), ctx.mesh, ctx.axis)
        return full.reshape(-1, *g.shape[1:]), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _exchange(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g.contiguous(), ctx.mesh, ctx.axis), None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Replicate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g.contiguous(), ctx.mesh, ctx.axis), None, None


def all_gather(x: torch.Tensor, mesh: HostMesh,
               axis: Optional[str] = None) -> torch.Tensor:
    """(n, *x.shape): every rank's ``x`` over axis ``axis`` (``None``: the
    whole mesh), in the axis's rank order, on every rank."""
    return _AllGather.apply(x.contiguous(), mesh, axis)


def shard(x: torch.Tensor, mesh: HostMesh,
          axis: Optional[str] = None) -> torch.Tensor:
    """The rank's chunk of a replicated ``x`` along dim 0 over ``axis``
    (``None``: the whole mesh, in rank order)."""
    n = mesh.group_size(axis)
    if x.shape[0] % n:
        raise ValueError(f"dim 0 of {tuple(x.shape)} does not split over "
                         f"{n} ranks")
    return _Shard.apply(x, mesh, axis)


def all_to_all(x: torch.Tensor, mesh: HostMesh,
               axis: Optional[str] = None) -> torch.Tensor:
    """x: (n, ...), block ``j`` for the axis's rank ``j``; returns (n, ...)
    whose block ``j`` came from rank ``j``."""
    if x.shape[0] != mesh.group_size(axis):
        raise ValueError(f"all_to_all over {mesh.group_size(axis)} ranks "
                         f"takes (n, ...) blocks, got {tuple(x.shape)}")
    return _AllToAll.apply(x.contiguous(), mesh, axis)


def all_reduce(x: torch.Tensor, mesh: HostMesh,
               axis: Optional[str] = None) -> torch.Tensor:
    """The sum of every rank's ``x`` over ``axis``, on every rank."""
    return _AllReduce.apply(x.contiguous(), mesh, axis)


def replicate(x: torch.Tensor, mesh: HostMesh,
              axis: Optional[str] = None) -> torch.Tensor:
    """The identity on a value every rank of ``axis`` holds alike; its
    gradient is summed over them."""
    return _Replicate.apply(x, mesh, axis)
