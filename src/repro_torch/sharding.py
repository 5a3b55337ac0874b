"""Logical-axis sharding rules of the port (DESIGN.md §6), a port of the JAX
package's ``sharding.py``.

Every parameter, activation and cache dimension carries a logical axis
name; a *rule set* maps logical names to mesh axes.  :func:`spec_for`
applies a rule set with the reference's divisibility fallback (a dim that
does not divide by its mesh axes' extent is replicated, and the fallback is
recorded as ``(name, shape, dim, extent)``), and returns a tuple that reads
like the reference's ``PartitionSpec``: one entry a tensor dim, ``None``,
a mesh axis name or a tuple of them.  :func:`placements_for` turns such a
spec into ``torch.distributed.tensor`` placements on the mesh.

The rules read only a mesh's axis names (``mesh_dim_names``) and extents
(``shape``): a :class:`~repro_torch.launch.mesh.HostMesh`, a ``DeviceMesh``
or an :class:`AbstractMesh` (a mesh without ranks, for accounting).

Baseline strategy (``"fsdp_tp"``): batch over (pod, data); parameters FSDP
over ``data`` plus tensor-parallel over ``model``; MoE experts
expert-parallel over ``model``.  The other rule sets are the reference's
hillclimb alternatives.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

# logical axis -> mesh axes (tuple = use several mesh axes for one dim)
RULE_SETS: Dict[str, Dict[str, Any]] = {
    "fsdp_tp": {
        "batch": ("pod", "data"),
        "seq": None,
        "vocab": "model",
        "embed": "data",
        "qheads": "model",
        "kvheads": "model",
        "mlp": "model",
        "expert": "model",
        "ssm_inner": "model",
        "ssm_heads": "model",
        "kv_cache_heads": "model",
        "kv_seq": None,
        "layers": None,
    },
    # pure data-parallel (params replicated) — ablation baseline
    "dp": {
        "batch": ("pod", "data", "model"),
        "seq": None, "vocab": None, "embed": None, "qheads": None,
        "kvheads": None, "mlp": None, "expert": None, "ssm_inner": None,
        "ssm_heads": None, "kv_cache_heads": None, "kv_seq": None,
        "layers": None,
    },
    # ZeRO/FSDP-only over BOTH mesh axes, no tensor parallelism: batch shards
    # over (pod, data, model) and parameters fully shard 2D.  For small dense
    # models at 1M-token batches the per-layer param all-gather (MBs) is far
    # cheaper than TP's per-layer activation all-reduces (GBs) — hillclimb 1.
    "fsdp2d": {
        "batch": ("pod", "data", "model"),
        "seq": None,
        "vocab": "model",
        "embed": "data",
        "qheads": "model",
        "kvheads": "model",
        "mlp": "model",
        "expert": "model",
        "ssm_inner": "model",
        "ssm_heads": "model",
        "kv_cache_heads": "model",
        "layers": None,
    },
    # decode variant: KV cache sharded over the SEQUENCE dim on the model
    # axis (the kv-head dim of GQA archs is too small for 16 ranks); the
    # sharded-softmax combine is a tiny stats all-reduce — hillclimb "extra"
    "fsdp_tp_kvseq": {
        "batch": ("pod", "data"),
        "seq": None,
        "vocab": "model",
        "embed": "data",
        "qheads": "model",
        "kvheads": None,
        "mlp": "model",
        "expert": "model",
        "ssm_inner": "model",
        "ssm_heads": "model",
        "kv_cache_heads": None,
        "kv_seq": "model",
        "layers": None,
    },
    # fsdp2d with the vocab dim replicated: embed/lm_head grads become one
    # all-reduce per step instead of cross-shard scatter exchanges (H2 iter 2)
    "fsdp2d_rv": {
        "batch": ("pod", "data", "model"),
        "seq": None,
        "vocab": None,
        "embed": "data",
        "qheads": "model",
        "kvheads": "model",
        "mlp": "model",
        "expert": "model",
        "ssm_inner": "model",
        "ssm_heads": "model",
        "kv_cache_heads": "model",
        "kv_seq": None,
        "layers": None,
    },
    # sequence-sharded activations for long prefill (hillclimb)
    "fsdp_tp_seq": {
        "batch": ("pod", "data"),
        "seq": "model",
        "vocab": "model",
        "embed": "data",
        "qheads": "model",
        "kvheads": "model",
        "mlp": "model",
        "expert": "model",
        "ssm_inner": "model",
        "ssm_heads": "model",
        "kv_cache_heads": "model",
        "layers": None,
    },
}

Spec = Tuple[Any, ...]


class AbstractMesh(NamedTuple):
    """A mesh's axis names and extents, without ranks (what the rules
    read).  It answers as rank 0 of such a mesh (its coordinate all
    zeros), so a rank's step runs on it with ``meta`` tensors and the
    collectives of ``repro_torch.launch.mesh`` return their shapes."""
    mesh_dim_names: Tuple[str, ...]
    shape: Tuple[int, ...]

    @classmethod
    def of(cls, shape: Tuple[int, ...]) -> "AbstractMesh":
        """``(data, model)``, or ``(pod, data, model)`` for three extents:
        the reference's mesh axes."""
        names = {2: ("data", "model"), 3: ("pod", "data", "model")}
        return cls(names[len(shape)], tuple(shape))

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def rank(self) -> int:
        return 0

    @property
    def coordinate(self) -> Tuple[int, ...]:
        return (0,) * len(self.shape)

    def extent(self, name: str) -> int:
        return _extents(self).get(name, 1)

    def index(self, name: str) -> int:
        return 0

    def group_size(self, name: Optional[str] = None) -> int:
        return self.size if name is None else self.extent(name)

    def group_index(self, name: Optional[str] = None) -> int:
        return 0


def _extents(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _mesh_extent(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    ext = _extents(mesh)
    n = 1
    for a in axes:
        n *= ext.get(a, 1)
    return n


def _present(mesh, axes):
    """Filter out mesh axes that don't exist in this mesh (e.g. 'pod' on the
    single-pod mesh)."""
    if axes is None:
        return None
    if isinstance(axes, str):
        axes = (axes,)
    have = [a for a in axes if a in mesh.mesh_dim_names]
    if not have:
        return None
    return tuple(have) if len(have) > 1 else have[0]


def spec_for(mesh, logical_axes: Tuple[Optional[str], ...],
             shape: Tuple[int, ...], rules: Dict[str, Any],
             fallbacks: Optional[list] = None) -> Spec:
    """The spec of an array of ``shape`` whose dims carry ``logical_axes``:
    each dim's mesh axes under ``rules``, ``None`` where the rule names no
    axis of this mesh, where an axis already shards an earlier dim, or where
    the dim does not divide by the axes' extent (recorded in
    ``fallbacks``)."""
    parts = []
    used: set = set()
    for dim, name in enumerate(logical_axes):
        target = _present(mesh, rules.get(name)) if name else None
        if target is None:
            parts.append(None)
            continue
        tgt_axes = (target,) if isinstance(target, str) else tuple(target)
        # a mesh axis can shard only one dim of a given array
        if any(a in used for a in tgt_axes):
            parts.append(None)
            continue
        ext = _mesh_extent(mesh, tgt_axes)
        if dim < len(shape) and shape[dim] % ext != 0:
            if fallbacks is not None:
                fallbacks.append((name, shape, dim, ext))
            parts.append(None)
            continue
        used.update(tgt_axes)
        parts.append(target)
    return tuple(parts)


def placements_for(mesh, spec: Spec) -> tuple:
    """The ``torch.distributed.tensor`` placements of ``spec`` on ``mesh``:
    ``Shard(dim)`` on each mesh axis that shards a dim, ``Replicate()`` on
    the others.  A dim sharded over several axes is split major-first in
    the mesh's axis order, as ``NamedSharding`` splits it; a spec that
    lists them in another order has no such layout and is a
    ``ValueError``."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for dim, target in enumerate(spec):
        if target is None:
            continue
        axes = (target,) if isinstance(target, str) else tuple(target)
        pos = [names.index(a) for a in axes]
        if pos != sorted(pos):
            raise ValueError(f"spec {spec}: dim {dim} lists mesh axes "
                             f"{axes} out of the mesh's order {names}")
        for p in pos:
            out[p] = Shard(dim)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh, as the reference's ``NamedSharding``."""
    mesh: Any
    spec: Spec

    @property
    def placements(self) -> tuple:
        return placements_for(self.mesh, self.spec)


def _tree_map(fn, axes_tree, shapes_tree):
    # sorted keys: the reference's jax.tree order, which orders the
    # fallbacks a tree records
    if isinstance(axes_tree, dict):
        return {k: _tree_map(fn, axes_tree[k], shapes_tree[k])
                for k in sorted(axes_tree)}
    return fn(axes_tree, shapes_tree)


def sharding_tree(mesh, axes_tree: Any, shapes_tree: Any,
                  rules_name: str = "fsdp_tp",
                  fallbacks: Optional[list] = None) -> Any:
    """Map a nested dict of logical-axes tuples and the matching dict of
    shapes (tuples, or tensors: meta tensors do) to :class:`NamedSharding`
    s."""
    rules = RULE_SETS[rules_name]

    def one(axes, shaped):
        shape = tuple(shaped.shape) if hasattr(shaped, "shape") \
            else tuple(shaped)
        return NamedSharding(mesh, spec_for(mesh, tuple(axes), shape, rules,
                                            fallbacks))

    return _tree_map(one, axes_tree, shapes_tree)


def batch_sharding(mesh, batch_specs: Dict[str, Any],
                   rules_name: str = "fsdp_tp") -> Dict[str, NamedSharding]:
    """Input batch: dim 0 is always the global batch dim."""
    rules = RULE_SETS[rules_name]
    out = {}
    for k, v in batch_specs.items():
        shape = tuple(v.shape)
        axes: Tuple[Optional[str], ...] = ("batch",) + (None,) * (
            len(shape) - 1)
        out[k] = NamedSharding(mesh, spec_for(mesh, axes, shape, rules))
    return out


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


# ---------------------------------------------------------------------------
# A leaf's block on a rank, and the inverse
# ---------------------------------------------------------------------------
def _axes_of(target) -> Tuple[str, ...]:
    if target is None:
        return ()
    return (target,) if isinstance(target, str) else tuple(target)


def sharding_axes(sharding: NamedSharding) -> Tuple[str, ...]:
    """The mesh axes that shard some dim of a leaf, in the mesh's order."""
    used = {a for t in sharding.spec for a in _axes_of(t)}
    return tuple(a for a in sharding.mesh.mesh_dim_names if a in used)


def block_slices(sharding: NamedSharding, shape: Tuple[int, ...],
                 coordinate: Optional[Tuple[int, ...]] = None
                 ) -> Tuple[slice, ...]:
    """The rank's block of a ``shape`` leaf: on each dim sharded over mesh
    axes ``(a1, a2, ...)`` the chunk at index ``((i1 * n2) + i2) ...`` of
    ``n1 * n2 ...`` equal chunks (major-first in the mesh's order, as
    :func:`placements_for` and the reference's ``NamedSharding`` split).
    ``coordinate`` defaults to the mesh's own rank's."""
    mesh = sharding.mesh
    names = tuple(mesh.mesh_dim_names)
    coord = dict(zip(names, coordinate if coordinate is not None
                     else mesh.coordinate))
    ext = _extents(mesh)
    out = []
    for d, size in enumerate(shape):
        axes = _axes_of(sharding.spec[d]) if d < len(sharding.spec) else ()
        n, i = 1, 0
        for a in axes:
            n, i = n * ext[a], i * ext[a] + coord[a]
        if size % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"over {axes} ({n} ranks)")
        step = size // n
        out.append(slice(i * step, (i + 1) * step))
    return tuple(out)


def local_block(x: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """The rank's block of the full tensor ``x`` under ``sharding``, as its
    own tensor: the counterpart of ``jax.device_put(x, s)`` for one device
    of the mesh.  Always a copy, outside autograd: a view (a slice along
    dim 0 is one) would keep the whole of ``x`` alive."""
    return x.detach()[block_slices(sharding, tuple(x.shape))].clone(
        memory_format=torch.contiguous_format)


def gather_full(block: torch.Tensor, sharding: NamedSharding
                ) -> torch.Tensor:
    """The full tensor on every rank from each rank's block (the
    counterpart of ``np.asarray`` of a sharded array): one all-gather over
    each axis that shards it, the minor axis first, each concatenating its
    blocks along their dim.  A replicated leaf moves nothing."""
    from repro_torch.launch.mesh import all_gather

    mesh = sharding.mesh
    out = block
    for a in reversed(sharding_axes(sharding)):
        dim = next(d for d, t in enumerate(sharding.spec)
                   if a in _axes_of(t))
        parts = all_gather(out, mesh, a)
        out = torch.cat(list(parts.unbind(0)), dim=dim)
    return out


# ---------------------------------------------------------------------------
# Current-mesh context: lets model code find the mesh without threading it
# through every call (set by the launchers; read by the all-to-all experts)
# ---------------------------------------------------------------------------
_CURRENT: dict = {"mesh": None, "rules": "fsdp_tp"}


def set_current_mesh(mesh, rules: str = "fsdp_tp") -> None:
    _CURRENT["mesh"] = mesh
    _CURRENT["rules"] = rules


def current_mesh():
    """The mesh :func:`set_current_mesh` set, or ``None``."""
    return _CURRENT["mesh"]


def current_rules() -> str:
    """The rule set :func:`set_current_mesh` set."""
    return _CURRENT["rules"]


def constrain(x, logical_axes: Tuple[Optional[str], ...]):
    """The reference's sharding constraint from logical axes.  The port's
    tensors are plain per-rank tensors that carry no sharding to constrain,
    so this is the identity, as the reference's is without a mesh."""
    return x
