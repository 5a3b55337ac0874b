"""H100 accounting: the port's counterpart of the JAX package's dry-run
(``launch/dryrun.py``), for one NVIDIA H100.

For every (architecture x input shape) cell it records the work one step
does and the memory it needs, as the reference records its lowered cells:

  train_4k    -> train step  (forward, backward, AdamW)
  prefill_32k -> prefill     (cache build + last logits)
  decode_32k  -> decode step (one token over a 32k KV cache)
  long_500k   -> decode step (SSM / hybrid archs only)

The decomposition is the reference's, ``outer + n_layers x layer (x
layer_scale) + n_shared x shared + optimizer_flops_analytic + the kernels'
analytic costs``, but where the reference lowers each piece with XLA and
reads ``cost_analysis()``, the port runs each piece eagerly on tensors
that hold no data (``meta`` tensors: shapes and dtypes only) and counts as
it runs (:class:`Tally`):

* the FLOPs of every matrix product (``torch.utils.flop_counter``), plus
  one a result element for every elementwise op and one an input element
  for every reduction;
* the bytes of every op's inputs (each element a view reaches, once) and
  outputs.  That is what eager PyTorch moves, unfused, op by op; it is not
  XLA's post-fusion "bytes accessed".  Indexed reads and writes (gathers,
  ``index_copy_``, ``index_put_``, scatters) count the rows they touch,
  and a copy or fill its destination once.

So a full-width config at the reference's own shapes traces in seconds on
the CPU, without a card.  The reference's special cases stay: RWKV's time
scan runs at ``min(S, 256)`` tokens and is scaled by ``S / 256``; zamba2's
shared block is accounted at full S, ``n_shared_attn`` times; AdamW is
``14 * n_params`` FLOPs.

Attention is always the kernels': the flash op has no meta path, so every
cell runs ``attn_impl="kernel_stub"`` (the reference's stand-in, which
keeps the projections and skips the inner attention) and adds
:func:`flash_kernel_costs`, as the reference does under ``--flash``; there
is no ``--flash`` flag.  The decode op has no meta path either: the
model's decode attention returns an empty output on meta tensors, and
:func:`decode_kernel_costs` adds what the decode kernel reads and computes
(the reference counts that work inside its HLO).
:func:`attn_score_hbm_bytes` stays in the record as the reference's figure
for its jnp stand-in, which the port does not run.  The reference's
attention chunks of 2048 at S >= 32768 only kept its unrolled HLO small and
have no counterpart here.

The memory record (:func:`mem_summary`) is counted exactly from the specs:
``argument_bytes`` (parameters; AdamW's moments and step for train; the
cache for decode; the inputs), ``output_bytes`` (the new parameters and
moments for train, the cache prefill returns, the decode cache; the logits
or the loss) and ``alias_bytes`` (what is updated in place: the train
state, the decode cache), as XLA's memory analysis counts donated
buffers.  ``fits_one_card`` holds ``argument + output - alias`` against
the card's memory (``torch.cuda``'s ``total_memory`` where a card is
present, else 80 GiB; the record says which).  XLA's ``temp_bytes`` (its
buffer assignment's peak) has no eager counterpart and is left out; a card
run reads the peak with ``torch.cuda.max_memory_allocated``.

On one card every collective term is 0.  On a mesh (``--mesh 16x16``,
``--multi-pod`` for the reference's (2, 16, 16) ``("pod", "data",
"model")`` mesh) the record is one rank's, as the reference's records are
per device, traced on an ``AbstractMesh`` (rank 0's view, no process
group): the pieces run at the rows the rank computes
(``train_step.rank_rows``: the whole global batch for a config with
experts, whose expert layers route every row's tokens at once, and the
train step's batch gather with it), ``memory`` counts the rank's blocks
under the rule set, ``sharding_fallbacks`` lists the dims the rules left
replicated (the reference's ``name:dim{d}%{e}``), and
``full_collectives`` counts the bytes by kind that one step moves from
the rank, from the collective counters of ``repro_torch.launch.mesh``:
for train the port's own mesh step (``jit_train_step``) run on ``meta``
blocks, the counters the ranks' own in a real step; for prefill and
decode the gather of every parameter whole and the layers' own
collectives (the all-to-all experts' under ``--moe-a2a``, which sets
``moe_impl="a2a"``).  As in the reference,
the multi-pod record has no per-layer accounting.  Run on the CPU:
``python -m repro_torch.launch.dryrun`` writes one JSON record a cell
under ``--out``, tagged by mesh (``h100x1``, ``h100x16x16``,
``h100x2x16x16``); ``python -m repro_torch.launch.roofline`` prints the
H100 table from them.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import types
from pathlib import Path
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import checkpoint
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCHS, get
from repro_torch.configs.shapes import (SHAPES, Shape, decode_input_specs,
                                        prefill_input_specs,
                                        shape_applicable, train_input_specs)
from repro_torch.launch.mesh import collective_bytes
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import (AbstractMesh, batch_sharding,
                                  block_slices, current_mesh, current_rules,
                                  local_block, set_current_mesh,
                                  sharding_tree)

MESH = "h100x1"
# the accounting's card when it runs without one: an H100 80GB
CARD_BYTES_NO_CARD = 80 * 2 ** 30
# the RWKV time scan's traced length (the reference's)
RWKV_S_ACC = 256

_aten = torch.ops.aten
# ops that move no data: allocation, views and their metadata
_NO_DATA = {_aten._unsafe_view.default, _aten._reshape_alias.default,
            _aten.empty.memory_format, _aten.empty_strided.default,
            _aten.empty_like.default, _aten.new_empty.default,
            _aten.new_empty_strided.default, _aten.lift_fresh.default}
# ops that write their first argument without reading it
_WRITE_ONLY = {"copy_", "fill_", "zero_", "normal_", "uniform_", "random_"}
_REDUCTION = getattr(torch.Tag, "reduction", None)


def _nbytes(t: torch.Tensor) -> int:
    """The bytes of the elements a tensor (or view) reaches, each once: a
    broadcast (stride 0) dimension counts one element."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0 or size == 0:
            n *= size
    return n * t.element_size()


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


def _op_bytes(func, args, kwargs, out) -> int:
    """What one eager op moves: each input element read once, each output
    element written once; indexed ops the rows they touch."""
    name = func.overloadpacket.__name__
    if name in ("index_copy_", "index_copy"):         # (self, dim, index, src)
        return 2 * _nbytes(args[3]) + _nbytes(args[2])
    if name in ("index_put_", "_index_put_impl_", "index_put"):
        self, indices, values = args[0], args[1], args[2]
        idx = [i for i in indices if i is not None]
        rows = math.prod(torch.broadcast_shapes(*(i.shape for i in idx)))
        region = rows * math.prod(self.shape[len(indices):]) \
            * self.element_size()
        accumulate = (args[3] if len(args) > 3
                      else kwargs.get("accumulate", False))
        return sum(_nbytes(i) for i in idx) + _nbytes(values) \
            + region * (2 if accumulate else 1)
    if name in ("index_add_", "index_add"):          # read-modify-write rows
        return _nbytes(args[2]) + 3 * _nbytes(args[3])
    if name in ("scatter_", "scatter", "scatter_add_", "scatter_add",
                "scatter_reduce_", "scatter_reduce"):
        idx = args[2]
        return _nbytes(idx) + 3 * idx.numel() * args[0].element_size()
    if name in ("index", "embedding", "index_select", "gather"):
        gathered = sum(_nbytes(t) for t in _tensors(out))
        indices = args[1] if name in ("index", "embedding") else args[2]
        return sum(_nbytes(t) for t in _tensors(indices)) + 2 * gathered
    ins = list(_tensors(args)) + list(_tensors(list(kwargs.values())))
    outs = list(_tensors(out))
    if name in _WRITE_ONLY:
        ins = ins[1:]
    return sum(_nbytes(t) for t in ins) + sum(t.numel() * t.element_size()
                                              for t in outs)


class Tally(TorchDispatchMode):
    """Counts what every op dispatched under it moves (``bytes``) and its
    elementwise and reduction FLOPs (``other_flops``); the matrix products'
    FLOPs come from a ``FlopCounterMode`` beside it (:func:`count`)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.other_flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func in _NO_DATA or func.is_view:
            return out
        outs = list(_tensors(out))
        if not outs and not func.overloadpacket.__name__.endswith("_"):
            return out          # size queries and the like
        self.bytes += _op_bytes(func, args, kwargs, out)
        if torch.Tag.pointwise in func.tags:
            self.other_flops += sum(t.numel() for t in outs)
        elif _REDUCTION is not None and _REDUCTION in func.tags:
            self.other_flops += max((t.numel() for t in _tensors(args)),
                                    default=0)
        return out


class collectives:
    """``with collectives() as c: ...`` — ``c.result()`` is the bytes by
    kind (and ``count``, ``total``) that the collectives run inside moved
    from this rank (the counters of ``repro_torch.launch.mesh``)."""

    def __enter__(self):
        self._before = collective_bytes()
        return self

    def __exit__(self, *exc):
        self._after = collective_bytes()
        return False

    def result(self) -> dict:
        return {k: v - self._before[k] for k, v in self._after.items()}


class count:
    """``with count() as c: ...`` — ``c.result()`` is the reference's cost
    record of what ran inside: ``flops`` (matrix products plus elementwise
    and reductions), ``matmul_flops``, ``bytes``, and ``collectives`` (the
    bytes by kind of :class:`collectives`; 0 on one card)."""

    def __enter__(self):
        self._flops = FlopCounterMode(display=False)
        self._tally = Tally()
        self._coll = collectives()
        self._coll.__enter__()
        self._flops.__enter__()
        self._tally.__enter__()
        return self

    def __exit__(self, *exc):
        self._tally.__exit__(*exc)
        self._flops.__exit__(*exc)
        self._coll.__exit__(*exc)
        return False

    def result(self) -> dict:
        mm = float(self._flops.get_total_flops())
        return {"flops": mm + float(self._tally.other_flops),
                "matmul_flops": mm, "bytes": float(self._tally.bytes),
                "collectives": self._coll.result()}


# ---------------------------------------------------------------------------
# Meta stand-ins for the parameters, the cache and the inputs
# ---------------------------------------------------------------------------
def _meta(shape, dtype, grad: bool = False) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta", requires_grad=grad)


def _meta_tree(specs, grad: bool = False):
    return M._nest({k: _meta(v.shape, v.dtype, grad)
                    for k, v in specs.items()})


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def _shared_specs(cfg: ModelConfig):
    return {k[len("shared/"):]: v for k, v in M.model_specs(cfg).items()
            if k.startswith("shared/")}


def _positions(cfg: ModelConfig, B: int, S: int) -> torch.Tensor:
    return _meta((B, S, 3) if cfg.mrope else (B, S), torch.int32)


def _grad(loss, inputs) -> None:
    torch.autograd.grad(loss, [t for t in inputs if t.requires_grad],
                        allow_unused=True)


# ---------------------------------------------------------------------------
# Per-layer accounting
# ---------------------------------------------------------------------------
def cell_shape(shape_name: str, batch: int = 0, seq: int = 0) -> Shape:
    """The shape of a cell, its global batch or sequence cut where asked."""
    shape = SHAPES[shape_name]
    return dataclasses.replace(shape, global_batch=batch or
                               shape.global_batch,
                               seq_len=seq or shape.seq_len)


def cell_inputs(cfg: ModelConfig, shape: Shape) -> Dict[str, torch.Tensor]:
    fn = {"train": train_input_specs, "prefill": prefill_input_specs,
          "decode": decode_input_specs}[shape.kind]
    return fn(cfg, shape)


def mesh_of(shape) -> Optional[AbstractMesh]:
    """``None`` (one card) for ``1`` or ``(1,)``, else the reference's axes
    over ``shape`` (``"16x16"`` and ``"2x16x16"`` too)."""
    if isinstance(shape, str):
        shape = tuple(int(n) for n in shape.split("x"))
    shape = tuple(shape) if isinstance(shape, (tuple, list)) else (shape,)
    return None if math.prod(shape) == 1 else AbstractMesh.of(shape)


def mesh_tag(mesh) -> str:
    return MESH if mesh is None else "h100x" + "x".join(
        str(n) for n in mesh.shape)


def account_cell(cfg: ModelConfig, shape_name: str, mesh=None,
                 batch: int = 0, rules: str = "fsdp_tp",
                 seq: int = 0) -> dict:
    """The reference's decomposition, ``outer + n_layers x layer (+ zamba2's
    shared block)``, each piece traced on meta tensors and counted
    (:class:`count`), at the shape's global batch or ``batch`` (and its
    sequence or ``seq``); attention under ``kernel_stub`` with the kernels'
    analytic costs added.  ``mesh``: an ``AbstractMesh`` (``None``: one
    card); the pieces then run at the rows rank 0 computes, under the mesh
    as the current one, and ``collectives`` holds one step's bytes by kind
    from the rank (:func:`step_collectives`)."""
    shape = cell_shape(shape_name, batch, seq)
    cfg = cfg.replace(attn_impl="kernel_stub")
    if mesh is None:
        return _account(cfg, shape, shape.global_batch)
    saved = (current_mesh(), current_rules())
    set_current_mesh(mesh, rules)
    try:
        rows = _rank_rows(cfg, shape, mesh, rules, cell_inputs(cfg, shape))
        out = _account(cfg, shape, rows)
        out["rows"] = rows
        out["collectives"] = step_collectives(cfg, shape, mesh, rules, out)
        if shape.kind == "train":
            out["optimizer_flops_analytic"] = 14.0 * _block_elements(
                cfg, mesh, rules)
    finally:
        set_current_mesh(*saved)
    return out


def _rank_rows(cfg, shape, mesh, rules, specs) -> int:
    from repro_torch.train.train_step import rank_rows

    b_shard = batch_sharding(mesh, specs, rules)
    return rank_rows(cfg, mesh, b_shard["tokens"], shape.global_batch)[1]


def _param_shardings(cfg, mesh, rules, fallbacks=None):
    return sharding_tree(mesh, M.param_axes(cfg), M.abstract_params(cfg),
                         rules, fallbacks)


def _block_elements(cfg, mesh, rules) -> int:
    """The parameter elements a rank holds."""
    from repro_torch.train.optim import tree_leaves

    specs = M.model_specs(cfg)
    return sum(_block_numel(sh, specs[path].shape) for path, sh
               in tree_leaves(_param_shardings(cfg, mesh, rules)))


def _block_numel(sharding, shape) -> int:
    return math.prod(s.stop - s.start for s in block_slices(sharding, shape))


def step_collectives(cfg: ModelConfig, shape: Shape, mesh,
                     rules: str = "fsdp_tp", acc: Optional[dict] = None
                     ) -> dict:
    """The bytes by kind one step moves from a rank of ``mesh`` (an
    ``AbstractMesh``), counted by the collectives as they run on ``meta``
    blocks: for train the port's mesh step (``jit_train_step`` with
    AdamW's defaults, one microbatch, no compression), whose counters a
    rank's real step of the same shapes equals; for prefill and decode the
    gather of every parameter whole, then the model's layers on the rows
    the rank computes (their own collectives: the all-to-all experts', from
    the pieces of ``acc``, the rank's accounting, traced here if not
    given)."""
    from repro_torch.train.optim import AdamWConfig
    from repro_torch.train.train_step import (abstract_state, jit_train_step,
                                              shard_state)

    cfg = cfg.replace(attn_impl="kernel_stub")
    specs = cell_inputs(cfg, shape)
    saved = (current_mesh(), current_rules())
    set_current_mesh(mesh, rules)
    try:
        if shape.kind == "train":
            full = abstract_state(cfg)
            step, s_shard, b_shard = jit_train_step(
                cfg, AdamWConfig(), mesh, full, specs, rules)
            state = shard_state(full, s_shard)
            batch = {k: local_block(v, b_shard[k]) for k, v in specs.items()}
            with collectives() as c:
                step(state, batch)
            return c.result()
        return _serve_collectives(cfg, shape, mesh, rules, specs, acc)
    finally:
        set_current_mesh(*saved)


def _serve_collectives(cfg, shape, mesh, rules, specs, acc) -> dict:
    from repro_torch.sharding import gather_full
    from repro_torch.train.optim import tree_leaves

    specs_by_path = M.model_specs(cfg)
    p_shard = tree_leaves(_param_shardings(cfg, mesh, rules))
    blocks = [local_block(_meta(specs_by_path[path].shape,
                                specs_by_path[path].dtype), sh)
              for path, sh in p_shard]
    with collectives() as c:
        for x, (_, sh) in zip(blocks, p_shard):
            gather_full(x, sh)
    out = c.result()
    if acc is None:
        acc = _account(cfg, shape, _rank_rows(cfg, shape, mesh, rules,
                                              specs))
    parts = [(acc["layer"], cfg.n_layers * acc["layer_scale"]),
             (acc["outer"], 1)]
    if "shared" in acc:
        parts.append((acc["shared"], acc["n_shared"]))
    for piece, times in parts:
        for k, v in piece["collectives"].items():
            out[k] += v * times
    return out


def _account(cfg: ModelConfig, shape: Shape, B: int) -> dict:
    """The pieces at ``B`` rows of ``shape``, and one card's analytic
    optimizer FLOPs."""
    S = shape.seq_len
    out: dict = {"n_layers": cfg.n_layers}
    d = cfg.d_model
    if shape.kind in ("train", "prefill"):
        train = shape.kind == "train"
        # RWKV's time scan is traced at a reduced S and scaled (all ops
        # linear in S)
        s_acc, scale = S, 1.0
        if cfg.rwkv:
            s_acc = min(S, RWKV_S_ACC)
            scale = S / s_acc
        lp = _meta_tree(M.layer_specs(cfg), grad=train)
        x = _meta((B, s_acc, d), torch.bfloat16, grad=train)
        pos = _positions(cfg, B, s_acc)

        def layer_fwd(h):
            return M.layer_step(lp, h, pos, cfg)[0]

        with count() as c, torch.set_grad_enabled(train):
            if train:
                f = layer_fwd
                if cfg.remat == "block":
                    def f(h):
                        return checkpoint(layer_fwd, h, use_reentrant=False)
                # bf16 sum: the real inter-layer cotangent is the bf16
                # residual stream
                _grad(f(x).sum(), [x, *_leaves(lp)])
            else:
                layer_fwd(x)
        out["layer"] = c.result()
        out["layer_scale"] = scale

        # zamba2: the shared attention(+MLP) block runs n_shared times and
        # is not inside the per-layer cost, accounted at full S
        if cfg.attn_every:
            sp = _meta_tree(_shared_specs(cfg), grad=train)
            xf = _meta((B, S, d), torch.bfloat16, grad=train)
            pf = _meta((B, S), torch.int32)
            with count() as c, torch.set_grad_enabled(train):
                y = M._shared_block(sp, xf, xf, pf, cfg)[0]
                if train:
                    _grad(y.sum(), [xf, *_leaves(sp)])
            out["shared"] = c.result()
            out["n_shared"] = cfg.n_shared_attn

        # outer: embedding + head + loss (train) / head only (prefill)
        prm = _outer_params(cfg, grad=train)
        specs = cell_inputs(cfg, dataclasses.replace(shape, global_batch=B))
        with count() as c, torch.set_grad_enabled(train):
            xe, _ = M._embed_inputs(prm, specs)
            logits = M._logits(prm, xe)
            if train:
                targets = specs["targets"].to(torch.int64)
                mask = (targets >= 0).to(torch.float32)
                t = targets.clamp(min=0)
                logz = torch.logsumexp(logits, dim=-1)
                gold = torch.gather(logits, -1, t[..., None])[..., 0]
                loss = ((logz - gold) * mask).sum() \
                    / torch.clamp(mask.sum(), min=1.0)
                _grad(loss, list(_leaves(prm.params)))
            else:
                torch.sum(logits[:, -1].to(torch.float32))
        out["outer"] = c.result()

        # AdamW update flops (train): elementwise over params — analytic
        if train:
            out["optimizer_flops_analytic"] = 14.0 * M.n_params(cfg)
        out["flash_kernel"] = flash_kernel_costs(cfg, shape, 1, B)
        return out

    # ---- decode accounting ----
    cache = _meta_cache(cfg, B, S)
    lp = _meta_tree(M.layer_specs(cfg))
    x = _meta((B, 1, d), torch.bfloat16)
    length = _meta((), torch.int32)
    pos = _positions(cfg, B, 1)
    names = ("ssm", "conv") if cfg.family == "hybrid" else \
        [n for n in M._LAYER_ENTRIES if n in cache]
    layer_cache = {n: cache[n][0] for n in names}
    with count() as c, torch.no_grad():
        M.decode_layer_step(lp, x, cfg, layer_cache, length, pos)
    out["layer"] = c.result()
    out["layer_scale"] = 1.0
    if cfg.family == "hybrid":
        # shared attention decode over the full cache
        sp = _meta_tree(_shared_specs(cfg))
        with count() as c, torch.no_grad():
            M._shared_decode(sp, x, x, pos, cache["k"][0], cache["v"][0],
                             length, cfg)
        out["shared"] = c.result()
        out["n_shared"] = cfg.n_shared_attn

    # outer decode: embed row + head matmul
    prm = _outer_params(cfg)
    toks = _meta((B, 1), torch.int32)
    with count() as c, torch.no_grad():
        xe = prm.params["embed"]["table"][toks.to(torch.int64)]
        M._logits(prm, xe)
    out["outer"] = c.result()
    out["decode_kernel"] = decode_kernel_costs(cfg, shape, 1, B)
    return out


def _outer_params(cfg: ModelConfig, grad: bool = False):
    """The embedding, the final norm and the head as a model's ``params``
    (what ``_embed_inputs`` and ``_logits`` read)."""
    p = {"embed": {"table": _meta((cfg.vocab, cfg.d_model), torch.bfloat16,
                                  grad)},
         "final_norm": {"scale": _meta((cfg.d_model,), torch.bfloat16,
                                       grad)},
         "lm_head": {"w": _meta((cfg.d_model, cfg.vocab), torch.bfloat16,
                                grad)}}
    return types.SimpleNamespace(cfg=cfg, params=p)


def _meta_cache(cfg: ModelConfig, B: int, S: int) -> Dict[str, torch.Tensor]:
    """``make_cache``'s entries at (B, S) as meta tensors."""
    return {n: _meta(shape, dtype)
            for n, (shape, dtype) in M.cache_specs(cfg, B, S).items()}


# ---------------------------------------------------------------------------
# Analytic reference (MODEL_FLOPS) and the kernels' costs
# ---------------------------------------------------------------------------
def _shape(shape) -> Shape:
    """A shape's name, or a :class:`Shape` (a cut cell's)."""
    return SHAPES[shape] if isinstance(shape, str) else shape


def flash_kernel_costs(cfg: ModelConfig, shape_name: str, n_dev: int,
                       batch: int = 0) -> dict:
    """Analytic per-device cost of the flash-attention kernel for one step:
    FLOPs = 2 matmuls over the causal triangle (x3.5 for train: fwd + bwd
    incl. recompute); HBM bytes = q/k/v read + o written (x2.5 train).
    Scores and probabilities stay on chip (that is the point of the
    kernel).  ``batch`` (default the shape's) for a cut batch."""
    shape = _shape(shape_name)
    if shape.kind == "decode" or cfg.n_heads == 0:
        return {"flops": 0.0, "bytes": 0.0}
    S, B = shape.seq_len, batch or shape.global_batch
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    n_attn = cfg.n_shared_attn if cfg.family == "hybrid" else cfg.n_layers
    flops = 2 * 2 * B * H * hd * (S * S / 2.0)          # QK^T + PV, causal
    bytes_ = 2 * B * S * hd * (2 * H + 2 * K)           # q,o (H) + k,v (K) bf16
    mult_f = 3.5 if shape.kind == "train" else 1.0
    mult_b = 2.5 if shape.kind == "train" else 1.0
    return {"flops": flops * n_attn * mult_f / n_dev,
            "bytes": bytes_ * n_attn * mult_b / n_dev}


def decode_kernel_costs(cfg: ModelConfig, shape_name: str, n_dev: int,
                        batch: int = 0) -> dict:
    """Analytic per-device cost of the decode-attention kernel for one
    decode step, in :func:`flash_kernel_costs`' style: FLOPs = Q.K^T and
    P.V over the valid length (the cache's S positions, the new token's
    included); bytes = q read and o written in bf16, the K and V caches read
    once in their dtype (int8 and their bf16 scales under ``kv_quant``).
    Zero outside decode shapes and for attention-free configs."""
    shape = _shape(shape_name)
    if shape.kind != "decode" or cfg.n_heads == 0:
        return {"flops": 0.0, "bytes": 0.0}
    S, B = shape.seq_len, batch or shape.global_batch
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    n_attn = cfg.n_shared_attn if cfg.family == "hybrid" else cfg.n_layers
    flops = 2 * 2 * B * H * hd * S                      # QK^T + PV
    per_pos = hd * (1 if cfg.kv_quant else 2) + (2 if cfg.kv_quant else 0)
    bytes_ = 2 * B * H * hd * 2 + 2 * B * S * K * per_pos
    return {"flops": float(flops * n_attn / n_dev),
            "bytes": float(bytes_ * n_attn / n_dev)}


def attn_score_hbm_bytes(cfg: ModelConfig, shape_name: str, n_dev: int,
                         batch: int = 0) -> float:
    """Per-device HBM bytes the reference's jnp chunked-attention stand-in
    spends on the (cq x ck) score/probability blocks per step (the flash
    kernel keeps these on chip; the port never runs the stand-in).
    Counted as ~3 f32 traversals (scores out, exp in/out) of the triangular
    S^2/2 block area per layer, q-heads wide."""
    shape = _shape(shape_name)
    if shape.kind == "decode" or cfg.n_heads == 0:
        return 0.0
    S, B = shape.seq_len, batch or shape.global_batch
    per_layer = 3.0 * 4.0 * B * cfg.n_heads * (S * S / 2.0)
    n_attn_layers = cfg.n_shared_attn if cfg.family == "hybrid" else cfg.n_layers
    mult = 3.0 if shape.kind == "train" else 1.0   # fwd + bwd recompute
    return per_layer * n_attn_layers * mult / n_dev


def model_flops(cfg: ModelConfig, shape_name: str, batch: int = 0) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE) for train; 2*N*D for inference
    fwd; decode D = batch tokens (1 per seq)."""
    shape = SHAPES[shape_name]
    B = batch or shape.global_batch
    n_active = M.n_active_params(cfg)
    if shape.kind == "train":
        return 6.0 * n_active * B * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * B * shape.seq_len
    return 2.0 * n_active * B


# ---------------------------------------------------------------------------
# Memory
# ---------------------------------------------------------------------------
def _bytes_of(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def card_bytes() -> tuple:
    """(the card's memory, where the figure comes from): ``torch.cuda``'s
    ``total_memory`` of device 0 where a card is present, else 80 GiB."""
    if torch.cuda.is_available():
        props = torch.cuda.get_device_properties(0)
        return int(props.total_memory), f"torch.cuda ({props.name})"
    return CARD_BYTES_NO_CARD, "80 GiB (no card: an H100 80GB assumed)"


def cache_bytes(cfg: ModelConfig, batch: int, max_len: int) -> int:
    """``make_cache``'s bytes at (batch, max_len), ``length`` included."""
    return _bytes_of(_meta_cache(cfg, batch, max_len).values())


def mem_summary(cfg: ModelConfig, shape_name: str, batch: int = 0,
                mesh=None, rules: str = "fsdp_tp") -> dict:
    """Exact bytes of one step's arguments, outputs and in-place updates
    (see the module docstring), and whether they fit one card.  On a
    ``mesh``: a rank's, each leaf's block under the rule set (the
    parameters, AdamW's moments, the inputs, the cache; the logits'
    rows)."""
    shape = SHAPES[shape_name]
    B, S = batch or shape.global_batch, shape.seq_len
    cell = cell_shape(shape_name, B)
    if mesh is None:
        params = _bytes_of(_meta(s.shape, s.dtype)
                           for s in M.model_specs(cfg).values())
        n_params = M.n_params(cfg)
        inputs = _bytes_of(cell_inputs(cfg, cell).values())
        cache = cache_bytes(cfg, B, S)
        rows = B
    else:
        from repro_torch.train.optim import tree_leaves

        specs = M.model_specs(cfg)
        p_shard = tree_leaves(_param_shardings(cfg, mesh, rules))
        params = sum(_block_numel(sh, specs[p].shape) * specs[p].dtype.itemsize
                     for p, sh in p_shard)
        n_params = sum(_block_numel(sh, specs[p].shape) for p, sh in p_shard)
        ins = cell_inputs(cfg, cell)
        b_shard = batch_sharding(mesh, ins, rules)
        inputs = sum(_block_numel(b_shard[k], tuple(v.shape))
                     * v.element_size() for k, v in ins.items())
        caches = _meta_cache(cfg, B, S)
        c_shard = sharding_tree(mesh, M.cache_axes(cfg), caches, rules)
        cache = sum(_block_numel(c_shard[k], tuple(v.shape))
                    * v.element_size() for k, v in caches.items())
        rows = block_slices(b_shard["tokens"], (B,))[0]
        rows = rows.stop - rows.start
    if shape.kind == "train":
        opt = 2 * 4 * n_params + 4                    # f32 m and v, step
        arg, alias = params + opt + inputs, params + opt
        out = params + opt + 4                        # new state, f32 loss
    elif shape.kind == "prefill":
        arg, alias = params + inputs, 0
        out = cache + rows * cfg.vocab * 4
    else:
        arg, alias = params + cache + inputs, cache
        out = cache + rows * cfg.vocab * 4
    total, source = card_bytes()
    return {"argument_bytes": arg, "output_bytes": out, "alias_bytes": alias,
            "parameter_bytes": params, "card_bytes": total,
            "card_bytes_from": source,
            "fits_one_card": arg + out - alias <= total}


def sharding_fallbacks(cfg: ModelConfig, shape_name: str, mesh,
                       rules: str = "fsdp_tp") -> list:
    """The dims the rules leave replicated, as the reference's dry-run
    records them (``name:dim{d}%{e}``): the parameters', then, for prefill
    and decode, the cache's at the shape's global batch and length."""
    fallbacks: list = []
    _param_shardings(cfg, mesh, rules, fallbacks)
    shape = SHAPES[shape_name]
    if shape.kind != "train":
        sharding_tree(mesh, M.cache_axes(cfg), _meta_cache(
            cfg, shape.global_batch, shape.seq_len), rules, fallbacks)
    return [f"{n}:dim{d}%{e}" for n, _, d, e in fallbacks]


# ---------------------------------------------------------------------------
# Cells and the command line
# ---------------------------------------------------------------------------
def run_cell(arch: str, shape_name: str, kv_quant: bool = False,
             batch: int = 0, mesh=None, rules: str = "fsdp_tp",
             moe_a2a: bool = False, skip_accounting: bool = False) -> dict:
    """One cell's record: the reference's keys where they mean the same,
    tagged by mesh (``h100x1`` for one card); ``batch`` cuts the shape's
    global batch.  On a ``mesh`` (an ``AbstractMesh``) the record is one
    rank's: the fallbacks, the memory of its blocks and one step's
    ``full_collectives``, with the per-layer ``accounting`` unless
    ``skip_accounting`` (the reference skips it on the multi-pod mesh)."""
    cfg = get(arch)
    if kv_quant:
        cfg = cfg.replace(kv_quant=True)
    if moe_a2a:
        cfg = cfg.replace(moe_impl="a2a")
    skip = shape_applicable(cfg, shape_name)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_tag(mesh),
           "rules": "none" if mesh is None else rules, "ts": time.time()}
    if skip:
        rec["status"] = skip
        return rec
    B = batch or SHAPES[shape_name].global_batch
    n_dev = 1 if mesh is None else mesh.size
    t0 = time.time()
    rec.update(
        status="ok",
        n_devices=n_dev,
        global_batch=B,
        kv_quant=kv_quant,
        memory=mem_summary(cfg, shape_name, B, mesh, rules),
        model_flops=model_flops(cfg, shape_name, B),
        attn_score_hbm_bytes=attn_score_hbm_bytes(cfg, shape_name, n_dev,
                                                  B),
        n_params=M.n_params(cfg),
        n_active_params=M.n_active_params(cfg),
        cache_bytes=cache_bytes(cfg, B, SHAPES[shape_name].seq_len),
    )
    if mesh is None:
        rec["collectives_note"] = "one card: no collective"
    else:
        rec["moe_impl"] = cfg.moe_impl
        rec["sharding_fallbacks"] = sharding_fallbacks(cfg, shape_name, mesh,
                                                       rules)
    if not skip_accounting:
        rec["accounting"] = account_cell(cfg, shape_name, mesh, B, rules)
    if mesh is not None:
        rec["full_collectives"] = rec["accounting"]["collectives"] \
            if not skip_accounting else step_collectives(
                cfg, cell_shape(shape_name, B), mesh, rules)
    rec["trace_seconds"] = time.time() - t0
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--out", default="build/dryrun_h100")
    ap.add_argument("--kv-quant", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--mesh", default="1",
                    help="1 (one card), or a mesh such as 16x16")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the (2, 16, 16) (pod, data, model) mesh")
    ap.add_argument("--rules", default="fsdp_tp")
    ap.add_argument("--moe-a2a", action="store_true",
                    help="moe_impl='a2a' (on the 16x16 mesh unless another "
                         "is named)")
    ap.add_argument("--skip-accounting", action="store_true")
    args = ap.parse_args(argv)
    mesh = mesh_of((2, 16, 16) if args.multi_pod else args.mesh)
    if mesh is None and args.moe_a2a:
        mesh = mesh_of((16, 16))    # the all-to-all experts need a mesh
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    archs = [args.arch] if args.arch else [a for a in ARCHS
                                           if a != "paper-scorer"]
    shapes = [args.shape] if args.shape else list(SHAPES)
    name = mesh_tag(mesh)
    rules = "" if mesh is None else f"__{args.rules}"
    for arch in archs:
        for shape in shapes:
            tag = f"{arch}__{shape}__{name}{rules}{args.tag}"
            path = out_dir / f"{tag}.json"
            if path.exists():
                print(f"[skip cached] {tag}")
                continue
            t0 = time.time()
            try:
                rec = run_cell(arch, shape, kv_quant=args.kv_quant,
                               mesh=mesh, rules=args.rules,
                               moe_a2a=args.moe_a2a,
                               skip_accounting=args.skip_accounting
                               or args.multi_pod)
            except Exception as e:  # noqa: BLE001 — record the failure
                import traceback
                rec = {"arch": arch, "shape": shape, "mesh": name,
                       "status": f"FAILED: {type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-2000:]}
            rec["wall_seconds"] = time.time() - t0
            path.write_text(json.dumps(rec, indent=1))
            print(f"[{rec.get('status', '?')[:60]:60s}] {tag} "
                  f"({rec['wall_seconds']:.1f}s)")


if __name__ == "__main__":
    main()
