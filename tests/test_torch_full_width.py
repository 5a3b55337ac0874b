"""The port's dense model against the JAX package's at the full widths of
the two configs the card serves and trains at full width, on the CPU.

``granite-3-2b`` (d_model 2048, 32 query heads over 8 kv heads of 64,
d_ff 8192) and ``phi3-medium-14b`` (d_model 5120, 40 query heads over 10
kv heads of 128) are cut only in depth (one layer) and vocab (512), and
phi3's d_ff to 1024 (its projections at 17920 would only make the file
slower: the head layout and d_model are what the port has not met
before).  The JAX parameters come from ``init_params(PRNGKey(0))`` and
cross over with ``convert.model_params_from_numpy``; tokens come from a
numpy seed.  Each check runs under f32 (both sides' parameters cast) and
bf16 (as the model ships):

* the backbone's hidden states, prefill's last logits and one
  ``decode_step`` from the reference's prefill cache: within 1e-4 of the
  largest magnitude in f32 and 5e-2 in bf16, ``tests/test_torch_model.py``'s
  bars (its docstring says why: the libraries sum in other orders, the
  reference's bf16 attention rounds its scores and probabilities to bf16,
  the port's keeps them in f32).  The decode step runs over the
  reference's cache cast to f32 under f32, as that file does;
* ``loss_fn`` and its gradients, and one train step against the
  reference's jitted ``make_train_step`` from the reference's
  ``init_state``: ``tests/test_torch_train.py``'s bars (its docstring
  derives them): f32 loss within 1e-5 relative, every gradient leaf and
  the stepped matrices within 1e-4 in ||delta|| / ||ref||; bf16 loss
  within 1e-3 (the step's within 2e-3), gradient leaves within 2**-5, the
  stepped matrices within 2**-7.  The step's first moments are held at the
  gradients' bars and its second moments (squares) at twice them.
  The norm scales start at zero, so after one step each element is
  ``lr g / (|g| + eps)``: about +-lr whatever the size of its gradient, and
  ||ref|| is about lr sqrt(n).  An element whose gradient is near zero
  then moves on the arithmetic's noise (granite's ``final_norm`` gradient
  holds an element of 5.7e-8, 9% apart in f32, and bf16 gradients part in
  sign near zero), the mechanism ``tests/test_torch_mesh_train_moe.py``'s
  docstring describes.  So the stepped scales are held within 1e-3 in
  f32 (that file's bar for it; measured 4.1e-4) and 2**-2 in bf16 (about
  one element in 60 of a scale flipping its sign; measured 0.136,
  granite's ``layers/ln1``), their moments at the bars above.  One step:
  over five the wide matrices drift past the bars too (measured 2.5e-4 in
  f32 and 1.2e-2 in bf16 at the fifth), as each near-zero gradient
  element's noise accumulates.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jax_get
from repro.models import model as JM
from repro.train import optim as jax_optim
from repro.train import train_step as jax_train_step
from repro_torch.configs import get
from repro_torch.convert import (model_params_from_numpy,
                                 train_state_from_numpy,
                                 train_state_to_numpy)
from repro_torch.models import model as M
from repro_torch.train import optim
from repro_torch.train.train_step import make_train_step

# each config at its own widths, cut in depth and vocab (phi3 in d_ff too)
CUTS = {"granite-3-2b": dict(n_layers=1, vocab=512),
        "phi3-medium-14b": dict(n_layers=1, d_ff=1024, vocab=512)}
# the widths this file holds, as configs/ gives them
WIDTHS = {"granite-3-2b": (2048, 32, 8, 64, 8192),
          "phi3-medium-14b": (5120, 40, 10, 128, 17920)}
TOL = {"f32": 1e-4, "bf16": 5e-2}
LOSS_TOL = {"f32": (1e-5, 1e-4), "bf16": (1e-3, 2.0 ** -5)}
# one step's parameters: (matrices, the norm scales that start at zero)
STEP_TOL = {"f32": (1e-4, 1e-3), "bf16": (2.0 ** -7, 2.0 ** -2)}
OCFG = dict(lr=1e-3, total_steps=30, warmup_steps=2)
B, S, MAX_LEN = 2, 48, 64
PARAMS = [(a, d) for a in CUTS for d in ("f32", "bf16")]


def _np32(x):
    return np.asarray(x, np.float32)


def _t(x):
    return x.detach().to(torch.float32).numpy()


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def _close(got, ref, tol):
    scale = max(float(np.abs(ref).max()), 1.0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * scale)


def _jflat(tree):
    return {"/".join(k.key for k in kp): v
            for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _configs(arch):
    return jax_get(arch).replace(**CUTS[arch]), get(arch).replace(**CUTS[arch])


@functools.lru_cache(maxsize=None)
def _jax_state(arch):
    """The reference's ``init_state(PRNGKey(0))`` (its parameters are
    ``init_params(PRNGKey(0))``'s), drawn once a config."""
    return jax_train_step.init_state(_configs(arch)[0], jax.random.PRNGKey(0))


def _batch(cfg, seed):
    """Tokens (B, S + 1) and the next-token batch of the first S."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(2, cfg.vocab, size=(B, S + 1)).astype(np.int32)
    tgt = toks[:, 1:].copy()
    tgt[rng.random((B, S)) < 0.1] = -1
    return toks, {"tokens": toks[:, :S], "targets": tgt}


@pytest.mark.parametrize("arch", sorted(CUTS))
def test_cut_configs_keep_their_widths(arch):
    """Only depth and vocab (and phi3's d_ff) are cut: d_model, the head
    layout and head dim are the configs' own, on both sides."""
    jcfg, cfg = _configs(arch)
    d, H, K, hd, d_ff = WIDTHS[arch]
    full = get(arch)
    assert (full.d_model, full.n_heads, full.n_kv_heads, full.hd,
            full.d_ff) == (d, H, K, hd, d_ff)
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd) == (d, H, K, hd)
    assert (jcfg.d_model, jcfg.n_heads, jcfg.n_kv_heads, jcfg.d_model
            // jcfg.n_heads) == (d, H, K, hd)
    assert cfg.n_layers == jcfg.n_layers == 1


@pytest.fixture(scope="module", params=PARAMS, ids=lambda p: f"{p[0]}-{p[1]}")
def pair(request):
    """Both sides' outputs for one (arch, dtype)."""
    arch, dtype = request.param
    jcfg, cfg = _configs(arch)
    params = _jax_state(arch)["params"]
    model = model_params_from_numpy(cfg, jax.tree.map(_np32, params), "cpu")
    if dtype == "f32":
        params = jax.tree.map(lambda x: x.astype(jnp.float32), params)
        model = model.float()
    toks, batch = _batch(cfg, 1)
    jb = {"tokens": jnp.asarray(toks[:, :S])}
    tb = {"tokens": torch.from_numpy(toks[:, :S])}
    out = {"arch": arch, "dtype": dtype, "cfg": cfg}

    x, pos = JM._embed_inputs(params, jb, jcfg)
    out["j_hidden"] = _np32(JM.backbone(params, x, pos, jcfg)[0])
    with torch.no_grad():
        x, pos = M._embed_inputs(model, tb)
        out["t_hidden"] = _t(M.backbone(model, x, pos))

    jcache, jlog = JM.prefill(params, jb, jcfg, MAX_LEN)
    with torch.no_grad():
        _, tlog = M.prefill(model, tb, MAX_LEN)
    out.update(j_logits=_np32(jlog), t_logits=_t(tlog))

    nxt = toks[:, S:S + 1]
    if dtype == "f32":
        jcache = dict(jcache, k=jcache["k"].astype(jnp.float32),
                      v=jcache["v"].astype(jnp.float32))
    kv_dtype = torch.float32 if dtype == "f32" else torch.bfloat16
    tcache = {"length": torch.tensor(S, dtype=torch.int32),
              **{n: torch.tensor(_np32(jcache[n])).to(kv_dtype)
                 for n in ("k", "v")}}
    jl2, jc2 = JM.decode_step(params, jcache, {"tokens": jnp.asarray(nxt)},
                              jcfg)
    with torch.no_grad():
        tl2, tc2 = M.decode_step(model, tcache,
                                 {"tokens": torch.from_numpy(nxt)})
    out.update(j_decode=_np32(jl2), t_decode=_t(tl2),
               j_len=int(jc2["length"]), t_len=int(tc2["length"]))

    loss_ref, g_ref = jax.value_and_grad(JM.loss_fn)(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    model.requires_grad_(True)
    loss = M.loss_fn(model, {k: torch.from_numpy(v)
                             for k, v in batch.items()})
    paths, leaves = zip(*model.named_leaves())
    grads = torch.autograd.grad(loss, leaves)
    out.update(j_loss=float(loss_ref), t_loss=float(loss.detach()),
               j_grads={p: _np32(g) for p, g in _jflat(g_ref).items()},
               t_grads={p: (g.dtype, _t(g)) for p, g in zip(paths, grads)},
               dtypes={p: x.dtype for p, x in zip(paths, leaves)})
    return out


def test_backbone_hidden_states(pair):
    assert pair["t_hidden"].shape == (B, S, pair["cfg"].d_model)
    _close(pair["t_hidden"], pair["j_hidden"], TOL[pair["dtype"]])


def test_prefill_last_logits(pair):
    assert pair["t_logits"].shape == (B, 1, pair["cfg"].vocab)
    _close(pair["t_logits"], pair["j_logits"], TOL[pair["dtype"]])


def test_decode_step_logits(pair):
    assert pair["j_len"] == pair["t_len"] == S + 1
    _close(pair["t_decode"], pair["j_decode"], TOL[pair["dtype"]])


def test_loss_and_gradients(pair):
    loss_tol, leaf_tol = LOSS_TOL[pair["dtype"]]
    assert abs(pair["t_loss"] - pair["j_loss"]) <= loss_tol * pair["j_loss"]
    assert sorted(pair["j_grads"]) == sorted(pair["t_grads"])
    for path, (dtype, g) in pair["t_grads"].items():
        assert dtype == pair["dtypes"][path], path
        assert _rel(g, pair["j_grads"][path]) < leaf_tol, path


@pytest.mark.parametrize("arch,dtype", PARAMS,
                         ids=[f"{a}-{d}" for a, d in PARAMS])
def test_train_step_matches_reference(arch, dtype):
    """One step of the port's ``make_train_step`` from the reference's
    ``init_state`` against the reference's jitted step: the loss, every
    parameter and the step count."""
    jcfg, cfg = _configs(arch)
    _, batch = _batch(cfg, 2)
    jstate = dict(_jax_state(arch))
    state = train_state_from_numpy(cfg, jax.tree.map(
        lambda x: np.asarray(x, np.float32 if x.dtype == jnp.bfloat16
                             else x.dtype), jstate), "cpu")
    if dtype == "f32":
        jstate["params"] = jax.tree.map(lambda x: x.astype(jnp.float32),
                                        jstate["params"])
        state["params"] = state["params"].float()
    jstep = jax.jit(jax_train_step.make_train_step(
        jcfg, jax_optim.AdamWConfig(**OCFG)))
    jstate, jmet = jstep(jstate, {k: jnp.asarray(v) for k, v in
                                  batch.items()})
    state, met = make_train_step(cfg, optim.AdamWConfig(**OCFG))(state,
                                                                 batch)
    loss_tol = 1e-5 if dtype == "f32" else 2e-3
    assert abs(float(met["loss"]) - float(jmet["loss"])) \
        <= loss_tol * float(jmet["loss"])
    got = train_state_to_numpy(state)
    ref = _jflat(jax.tree.map(_np32, jstate["params"]))
    assert sorted(_flat(got["params"])) == sorted(ref)
    matrix_tol, scale_tol = STEP_TOL[dtype]
    for path, arr in _flat(got["params"]).items():
        tol = scale_tol if path.endswith("scale") else matrix_tol
        assert _rel(arr, ref[path]) < tol, path
    grad_tol = LOSS_TOL[dtype][1]
    for name, tol in (("m", grad_tol), ("v", 2 * grad_tol)):
        want = _jflat(jax.tree.map(_np32, jstate["opt"][name]))
        for path, arr in _flat(got["opt"][name]).items():
            assert _rel(arr, want[path]) < tol, (name, path)
    assert int(got["opt"]["step"]) == int(jstate["opt"]["step"]) == 1
