"""Int8 error-feedback gradient compression (the port of
``repro/train/compress.py``).

Compressing gradients to int8 with per-tensor scales cuts a data-parallel
all-reduce's payload 4x (2x vs bf16); the quantization error is carried in
a local error-feedback buffer and re-added next step, which preserves SGD
convergence (Karimireddy et al., 2019) and empirically preserves AdamW
training (tests/test_train.py::test_compression_convergence).  On one card
there is no collective to shrink: the round trip runs so that a
compressed run's numbers are the reference's.  ``torch.round`` rounds
half to even, as ``jnp.round`` does.

On a mesh the leaves are each rank's blocks, and the per-tensor scale is
still the whole leaf's max |g + err| (the reference's): one all-reduce of
every leaf's block maximum over the mesh.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from .optim import tree_leaves, tree_map, tree_unflatten


def init_error_buffers(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compress(g: torch.Tensor, err: torch.Tensor, amax=None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (int8 values, f32 scale, new error buffer).  ``amax``: the
    whole leaf's max |g + err| when ``g`` is a block of it."""
    gf = g.to(torch.float32) + err
    if amax is None:
        amax = torch.amax(torch.abs(gf))
    scale = amax / 127.0 + 1e-12
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    deq = q.to(torch.float32) * scale
    return q, scale, gf - deq


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_tree(grads: Any, errors: Any, mesh=None):
    """Compress every leaf. Returns (q_tree, scale_tree, new_error_tree).
    ``mesh``: the leaves are blocks on it."""
    flat = list(zip(tree_leaves(grads), tree_leaves(errors)))
    amaxes = [None] * len(flat)
    if mesh is not None:
        from repro_torch.launch.mesh import all_reduce

        own = torch.stack([torch.amax(torch.abs(g.to(torch.float32) + e))
                           for (_, g), (_, e) in flat])
        amaxes = list(all_reduce(own, mesh, op="max").unbind(0))
    paths, qs, ss, es = [], [], [], []
    for ((path, g), (_, e)), amax in zip(flat, amaxes):
        q, s, ne = compress(g, e, amax)
        paths.append(path)
        qs.append(q)
        ss.append(s)
        es.append(ne)
    return (tree_unflatten(paths, qs), tree_unflatten(paths, ss),
            tree_unflatten(paths, es))


def decompress_tree(q_tree: Any, scale_tree: Any) -> Any:
    flat = tree_leaves(q_tree)
    return tree_unflatten(
        [p for p, _ in flat],
        [decompress(q, s) for (_, q), (_, s)
         in zip(flat, tree_leaves(scale_tree))])
