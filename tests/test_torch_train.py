"""The port's training path (``repro_torch.train``, ``loss_fn``, the token
pipeline, ``launch/train.py``) against the JAX package's, on the CPU.

Inputs come from numpy under a seed, or from the JAX package's own
``init_params(PRNGKey(0))`` / ``init_state`` carried across with
``convert.model_params_from_numpy`` / ``train_state_from_numpy``; the
model is the reduced ``paper-scorer`` (2 layers, width 128, 4 query heads
over 2 kv heads of 32) on the paper dataset's record corpus at seq 128.

Tolerances and where they come from:

* f32 (both sides' parameters cast to f32): the two libraries sum matrix
  products, softmaxes and norms in other orders, each sum good to a few
  f32 ulps (2**-24 ~ 6e-8) times its length.  The loss agrees within 1e-5
  relative and every gradient leaf within 1e-4 in ||delta|| / ||ref||
  (measured: 4e-7 and below 7e-7).
* bf16, as the model ships: every bf16 rounding may land one ulp (2**-8
  relative) apart, and the reference's attention rounds the probabilities
  to bf16 before P.V (``layers.py:210``) where the port's stays in f32.
  The loss within 1e-3 relative, each gradient leaf within 2**-5 (8 bf16
  ulps) in ||delta|| / ||ref|| (measured: 2e-5 and below 8e-3).
* ``rmsnorm``: f32 within 1e-6 of the largest magnitude; bf16 outputs and
  cotangents element by element within one bf16 ulp (2**-7 |ref|, plus
  1e-6): both sides compute in f32 and round once.
* AdamW on identical f32 gradients: moments within 1e-6 relative; new bf16
  parameters equal or one bf16 ulp apart (the f32 update rounds once to
  bf16, and the two f32 values may straddle a rounding boundary).
* Compression: int8 values equal except at exact .5 ties (none here), the
  scale within one f32 ulp, the reference's error bound (scale / 2 an
  element) and its error buffer.
* The train step over 5 steps (f32): losses within 1e-5 relative, final
  parameters within 1e-4 in ||delta|| / ||ref|| (measured: 3e-7 and 2e-6,
  4e-5 with compression, where an element near a rounding boundary of
  the int8 grid moves one step).  bf16: losses within 2e-3 relative
  (measured 1e-4); the matrices within 2**-7 (measured 1.3e-3); the norm
  scales within 2**-4 (measured 2.3e-2): they start at zero, so they hold
  only five updates, and AdamW's first updates are about +-lr whatever
  the gradient's size, so a near-zero gradient whose sign differs moves an
  element by 2 lr.  The runner against the reference's (bf16, 10 steps):
  losses within 2e-3 relative.
* The token pipeline, the fault logic and the input specs: exact.
"""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jax_get
from repro.configs import shapes as jax_shapes
from repro.data import tokens as jax_tokens
from repro.data.entities import make_paper_dataset as jax_paper_dataset
from repro.launch.mesh import make_host_mesh
from repro.models import layers as JL
from repro.models import model as JM
from repro.train import compress as jax_compress
from repro.train import fault as jax_fault
from repro.train import optim as jax_optim
from repro.train import train_step as jax_train_step
from repro.train.runner import Runner as JaxRunner
from repro.train.runner import RunnerConfig as JaxRunnerConfig
from repro_torch.configs import ARCHS, get
from repro_torch.configs import shapes
from repro_torch.convert import (model_params_from_numpy,
                                 train_state_from_numpy,
                                 train_state_to_numpy)
from repro_torch.data import tokens
from repro_torch.data.entities import make_paper_dataset
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.train import compress, fault, optim
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.runner import Runner, RunnerConfig
from repro_torch.train.train_step import (init_state, make_train_step,
                                          state_axes, state_tree)

ROOT = Path(__file__).resolve().parent.parent
ARCH = "paper-scorer"
JCFG = jax_get(ARCH).reduced()
CFG = get(ARCH).reduced()
SEQ = 128


def _np(tree):
    """A JAX tree as numpy (bf16 leaves as f32, which is exact)."""
    return jax.tree.map(lambda x: np.asarray(
        x, np.float32 if x.dtype == jnp.bfloat16 else x.dtype), tree)


def _rel(got, ref) -> float:
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def _t(x: torch.Tensor) -> np.ndarray:
    return x.detach().to(torch.float32).numpy()


def _flat(tree, prefix=""):
    """A nested dict as {path: leaf}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _jflat(tree):
    return {"/".join(k.key for k in kp): v
            for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def corpus():
    recs = make_paper_dataset().records
    assert recs == jax_paper_dataset().records
    return tokens.corpus_from_records(recs, CFG.vocab, SEQ)


@pytest.fixture(scope="module")
def jparams():
    return JM.init_params(JCFG, jax.random.PRNGKey(0))


# --------------------------------------------------------------------------
# rmsnorm's custom VJP
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rmsnorm_forward_and_vjp_match_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 17, 64)).astype(np.float32) * 2.0
    scale = rng.normal(size=(64,)).astype(np.float32) * 0.1
    g = rng.normal(size=x.shape).astype(np.float32)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    jx, js, jg = (jnp.asarray(a, jdt) for a in (x, scale, g))
    y_ref, vjp = jax.vjp(lambda a, b: JL.rmsnorm(a, b, 1e-5), jx, js)
    dx_ref, ds_ref = vjp(jg)

    tx = torch.tensor(x, dtype=tdt).requires_grad_()
    ts = torch.tensor(scale, dtype=tdt).requires_grad_()
    y = L.rmsnorm(tx, ts, 1e-5)
    dx, ds = torch.autograd.grad(y, (tx, ts), torch.tensor(g, dtype=tdt))
    assert y.dtype == dx.dtype == ds.dtype == tdt
    for got, ref in ((y, y_ref), (dx, dx_ref), (ds, ds_ref)):
        ref = np.asarray(ref, np.float32)
        if dtype == "f32":
            np.testing.assert_allclose(_t(got), ref, rtol=0,
                                       atol=1e-6 * np.abs(ref).max())
        else:
            err = np.abs(_t(got) - ref)
            assert (err <= 2.0 ** -7 * np.abs(ref) + 1e-6).all(), err.max()
    # without a gradient the forward is the same function
    with torch.no_grad():
        assert torch.equal(L.rmsnorm(tx, ts, 1e-5), y.detach())


# --------------------------------------------------------------------------
# attention's gradient (FlashAttentionFn: the op forward, a chunked f32
# recompute backward) against the reference's chunked attention under VJP
# --------------------------------------------------------------------------
@pytest.mark.parametrize("chunk", [16, 64, 512])
def test_flash_attention_fn_gradients_match_reference(chunk):
    rng = np.random.default_rng(1)
    B, S, H, K, d = 2, 48, 4, 2, 32
    q, k, v, g = (rng.normal(size=s).astype(np.float32) for s in
                  ((B, S, H, d), (B, S, K, d), (B, S, K, d), (B, S, H, d)))
    jcfg = JCFG.replace(attn_chunk_q=16, attn_chunk_k=16)
    o_ref, vjp = jax.vjp(
        lambda a, b, c: JL.chunked_causal_attention(a, b, c, jcfg),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    refs = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.tensor(a).requires_grad_() for a in (q, k, v))
    o = L.causal_attention(tq, tk, tv, CFG.replace(attn_chunk_q=chunk))
    assert o.grad_fn is not None
    grads = torch.autograd.grad(o, (tq, tk, tv), torch.tensor(g))
    np.testing.assert_allclose(_t(o), np.asarray(o_ref), rtol=0, atol=1e-5)
    for got, ref in zip(grads, refs):
        assert _rel(_t(got), ref) < 1e-5


def test_flash_attention_fn_on_a_non_cpu_tensor_goes_to_the_kernel():
    """Under autograd too, a tensor off the CPU never takes the plain
    version: the forward is the kernel's, which refuses what it cannot
    take (here a meta tensor) rather than compute."""
    meta = torch.device("meta")
    q = torch.empty(2, 64, 4, 32, device=meta, requires_grad=True)
    kv = torch.empty(2, 64, 2, 32, device=meta, requires_grad=True)
    with pytest.raises(ValueError, match="CUDA"):
        L.causal_attention(q, kv, kv, CFG)


# --------------------------------------------------------------------------
# loss_fn and its gradients
# --------------------------------------------------------------------------
LOSS_TOL = {"f32": (1e-5, 1e-4), "bf16": (1e-3, 2.0 ** -5)}
JAX_LOSS = {"f32": 6.770, "bf16": 6.771}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_loss_and_gradients_match_reference(dtype, corpus, jparams):
    batch = tokens.TokenPipeline(corpus, 8).batch_at(0)
    params = jparams if dtype == "bf16" else jax.tree.map(
        lambda x: x.astype(jnp.float32), jparams)
    loss_ref, g_ref = jax.value_and_grad(JM.loss_fn)(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, JCFG)
    assert round(float(loss_ref), 3) == JAX_LOSS[dtype]

    model = model_params_from_numpy(CFG, _np(jparams), "cpu")
    if dtype == "f32":
        model = model.float()
    model.requires_grad_(True)
    loss = M.loss_fn(model, {k: torch.from_numpy(v)
                             for k, v in batch.items()})
    paths, leaves = zip(*model.named_leaves())
    grads = torch.autograd.grad(loss, leaves)
    loss_tol, leaf_tol = LOSS_TOL[dtype]
    loss = float(loss.detach())
    assert abs(loss - float(loss_ref)) <= loss_tol * float(loss_ref)
    g_ref = _jflat(g_ref)
    assert sorted(g_ref) == list(paths)
    for path, g, p in zip(paths, grads, leaves):
        assert g.dtype == p.dtype, path
        assert _rel(_t(g), np.asarray(g_ref[path], np.float32)) < leaf_tol, \
            path


def test_loss_masks_negative_targets(corpus, jparams):
    """Targets < 0 drop out of the mean, on both sides; all masked gives
    a zero loss (the sum over max(count, 1))."""
    batch = tokens.TokenPipeline(corpus, 4).batch_at(3)
    batch["targets"][:, 64:] = -1
    model = model_params_from_numpy(CFG, _np(jparams), "cpu").float()
    params = jax.tree.map(lambda x: x.astype(jnp.float32), jparams)
    ref = JM.loss_fn(params, {k: jnp.asarray(v) for k, v in batch.items()},
                     JCFG)
    got = M.loss_fn(model, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(got) - float(ref)) <= 1e-5 * float(ref)
    batch["targets"][:] = -1
    assert float(M.loss_fn(model, {k: torch.from_numpy(v)
                                   for k, v in batch.items()})) == 0.0


def test_model_bookkeeping_matches_reference():
    for arch in ("paper-scorer", "granite-3-2b", "deepseek-67b"):
        jcfg, cfg = jax_get(arch), get(arch)
        assert M.n_active_params(cfg) == JM.n_active_params(jcfg) \
            == M.n_params(cfg)
        assert _flat(M.param_axes(cfg)) == _flat(JM.param_axes(jcfg))
        abstract = optim.tree_leaves(M.abstract_params(cfg))
        ref = _jflat(JM.abstract_params(jcfg))
        assert [p for p, _ in abstract] == sorted(ref)
        for path, t in abstract:
            assert t.device.type == "meta"
            assert tuple(t.shape) == ref[path].shape
            assert str(t.dtype).split(".")[-1] == str(ref[path].dtype)
    assert M.n_params(get(ARCH)) == 163_597_056
    axes = state_axes(CFG, compress_grads=True)
    ref = jax_train_step.state_axes(JCFG, compress_grads=True)
    assert _flat(axes) == _flat(ref)


def test_model_is_inference_only_until_asked(jparams):
    """A model from ``init_params`` carries no gradient; after
    ``requires_grad_()`` the loss reaches every parameter, and the views
    bound at construction (what serving reads) see the optimizer's
    in-place updates."""
    model = model_params_from_numpy(CFG, _np(jparams), "cpu")
    assert not model.trainable
    toks = np.random.default_rng(2).integers(2, CFG.vocab, (2, 16))
    batch = {"tokens": torch.tensor(toks, dtype=torch.int32),
             "targets": torch.tensor(toks, dtype=torch.int32)}
    assert M.loss_fn(model, batch).grad_fn is None
    model.requires_grad_(True)
    paths, leaves = zip(*model.named_leaves())
    grads = torch.autograd.grad(M.loss_fn(model, batch), leaves)
    assert all(g.abs().sum() > 0 for g in grads)
    view = model.layer_params[1]["attn"]["wq"]
    with torch.no_grad():
        model.params["layers"]["attn"]["wq"].add_(1.0)
    assert torch.equal(view, model.params["layers"]["attn"]["wq"][1])


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------
def test_lr_schedule_and_global_norm_match_reference():
    ocfg = dict(lr=1e-3, warmup_steps=7, total_steps=50, min_lr_frac=0.1)
    steps = np.arange(0, 60, dtype=np.int32)
    ref = np.asarray(jax_optim.lr_at(jax_optim.AdamWConfig(**ocfg),
                                     jnp.asarray(steps)))
    got = optim.lr_at(optim.AdamWConfig(**ocfg), torch.tensor(steps))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=0)
    rng = np.random.default_rng(3)
    tree = {"a": rng.normal(size=(40, 30)).astype(np.float32),
            "b": {"c": rng.normal(size=(7,)).astype(np.float32),
                  "d": rng.normal(size=(3, 3, 3)).astype(np.float32)}}
    ref = float(jax_optim.global_norm(jax.tree.map(jnp.asarray, tree)))
    got = float(optim.global_norm(optim.tree_map(torch.tensor, tree)))
    assert abs(got - ref) <= 1e-6 * ref


@pytest.mark.parametrize("clip", [1.0, 1e3], ids=["clipped", "unclipped"])
def test_adamw_update_matches_reference(clip, jparams):
    """One update from moments part way through training (step 6), on
    identical f32 gradients, bf16 parameters."""
    rng = np.random.default_rng(4)
    params = _np(jparams)
    grads = jax.tree.map(lambda p: rng.normal(size=p.shape).astype(
        np.float32) * 0.05, params)
    m = jax.tree.map(lambda p: rng.normal(size=p.shape).astype(
        np.float32) * 0.01, params)
    v = jax.tree.map(lambda p: rng.random(size=p.shape).astype(
        np.float32) * 1e-3, params)
    opt = {"m": m, "v": v, "step": np.asarray(6, np.int32)}
    ocfg = dict(lr=1e-3, warmup_steps=3, total_steps=40, clip_norm=clip)
    p_ref, o_ref, met_ref = jax_optim.adamw_update(
        jax.tree.map(jnp.asarray, grads), jparams,
        jax.tree.map(jnp.asarray, opt), jax_optim.AdamWConfig(**ocfg))

    state = train_state_from_numpy(CFG, {"params": params, "opt": opt},
                                   "cpu")
    model = state["params"]
    before = model.layer_params[0]["mlp"]["wo"]
    _, o, met = optim.adamw_update(optim.tree_map(torch.tensor, grads),
                                   model, state["opt"],
                                   optim.AdamWConfig(**ocfg))
    assert int(o["step"]) == int(o_ref["step"]) == 7
    for key in ("grad_norm", "lr"):
        assert abs(float(met[key]) - float(met_ref[key])) <= \
            1e-6 * abs(float(met_ref[key]))
    for tag in ("m", "v"):
        ref = _jflat(o_ref[tag])
        for path, t in optim.tree_leaves(o[tag]):
            assert t.dtype == torch.float32
            np.testing.assert_allclose(t.numpy(), np.asarray(ref[path]),
                                       rtol=1e-6, atol=1e-12)
    ref = _jflat(p_ref)
    for path, t in model.named_leaves():
        assert t.dtype == torch.bfloat16
        a = t.detach().view(torch.int16).numpy().astype(np.int64)
        b = np.asarray(ref[path]).view(np.int16).astype(np.int64)
        assert np.abs(a - b).max() <= 1, path     # bf16 bits: 1 ulp apart
    # the view bound at construction reads the updated parameter
    assert torch.equal(before, model.params["layers"]["mlp"]["wo"][0])


# --------------------------------------------------------------------------
# int8 error-feedback compression
# --------------------------------------------------------------------------
def test_compress_matches_reference():
    rng = np.random.default_rng(5)
    g = rng.normal(size=(64, 64)).astype(np.float32)
    err = (rng.normal(size=(64, 64)) * 0.003).astype(np.float32)
    q_ref, s_ref, e_ref = jax_compress.compress(jnp.asarray(g),
                                                jnp.asarray(err))
    q, s, e = compress.compress(torch.tensor(g), torch.tensor(err))
    assert q.dtype == torch.int8 and s.dtype == e.dtype == torch.float32
    s_ref = np.float32(s_ref)
    assert abs(float(s) - s_ref) <= np.spacing(s_ref)
    ratio = (g + err) / s_ref
    ties = np.abs(np.abs(ratio - np.trunc(ratio)) - 0.5) < 1e-6
    assert not ties.any()          # no exact .5 tie in these draws
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_allclose(e.numpy(), np.asarray(e_ref), rtol=0,
                               atol=1e-7)
    deq = compress.decompress(q, s).numpy()
    assert np.abs(deq - (g + err)).max() <= float(s) * 0.51 + 1e-9
    # round half to even, as jnp.round
    half = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5]) * (127.0 / 2.5)
    q, s, _ = compress.compress(half, torch.zeros(5))
    qr, _, _ = jax_compress.compress(jnp.asarray(half.numpy()),
                                     jnp.zeros(5, jnp.float32))
    np.testing.assert_array_equal(q.numpy(), np.asarray(qr))


def test_compress_tree_roundtrip_error_bound():
    """``tests/test_train.py::test_compress_roundtrip_error_bound`` on the
    port's tree forms."""
    g = {"w": torch.tensor(np.random.default_rng(0).normal(size=(64, 64)),
                           dtype=torch.float32)}
    err = compress.init_error_buffers(g)
    q, s, new_err = compress.compress_tree(g, err)
    deq = compress.decompress_tree(q, s)
    scale = float(g["w"].abs().max()) / 127.0
    assert float((deq["w"] - g["w"]).abs().max()) <= scale * 0.51 + 1e-9
    np.testing.assert_allclose(new_err["w"].numpy(),
                               (g["w"] - deq["w"]).numpy(), atol=1e-7)


# --------------------------------------------------------------------------
# the token pipeline
# --------------------------------------------------------------------------
def test_token_pipeline_matches_reference_bit_for_bit(corpus):
    recs = make_paper_dataset().records
    ref_rows = jax_tokens.corpus_from_records(recs, CFG.vocab, SEQ)
    assert corpus.dtype == ref_rows.dtype == np.int32
    np.testing.assert_array_equal(corpus, ref_rows)
    assert corpus.shape == (181, 128)   # the --full example's 181 rows
    docs = [np.arange(i, i + 5 + i % 7, dtype=np.int32) for i in range(40)]
    for seq in (3, 16, 100):
        np.testing.assert_array_equal(tokens.pack_documents(docs, seq),
                                      jax_tokens.pack_documents(docs, seq))
    for batch, shards, seed in ((8, 1, 0), (8, 2, 3), (12, 4, 1)):
        for idx in range(shards):
            got = tokens.TokenPipeline(corpus, batch, idx, shards, seed)
            ref = jax_tokens.TokenPipeline(ref_rows, batch, idx, shards,
                                           seed)
            assert got.steps_per_epoch == ref.steps_per_epoch
            for step in (0, 1, 21, 22, 23, 50):    # across epoch ends
                a, b = got.batch_at(step), ref.batch_at(step)
                for key in ("tokens", "targets"):
                    assert a[key].dtype == b[key].dtype
                    np.testing.assert_array_equal(a[key], b[key])
    assert (tokens.TokenPipeline(corpus, 8).batch_at(0)["targets"][:, -1]
            == -1).all()
    with pytest.raises(ValueError):
        tokens.TokenPipeline(corpus, 6, shard_count=4)


# --------------------------------------------------------------------------
# fault logic, case for case (tests/test_train.py:129-140)
# --------------------------------------------------------------------------
def test_fault_logic_matches_reference():
    for mod in (fault, jax_fault):
        g = mod.StepGuard(deadline_s=1.0, patience=2)
        assert [g.observe(t) for t in (0.5, 2.0, 2.0, 2.0, 0.1, 3.0)] == \
            ["ok", "straggler", "remesh", "straggler", "ok", "straggler"]
        assert g.total_stragglers == 4
        inj = mod.FailureInjector(fail_at_steps=(3, 5))
        fired = []
        for step in (0, 3, 3, 4, 5, 5):
            try:
                inj.check(step)
            except mod.SimulatedFailure:
                fired.append(step)
        assert fired == [3, 5]
    for n in range(1, 17):
        for prefer in (1, 2, 3, 4, 8):
            assert fault.elastic_plan(n, prefer) == \
                jax_fault.elastic_plan(n, prefer)
    assert fault.elastic_plan(8, prefer_model=2) == (4, 2)
    assert fault.elastic_plan(6, prefer_model=4) == (2, 3)
    assert fault.elastic_plan(7, prefer_model=2) == (7, 1)


# --------------------------------------------------------------------------
# the train step over 5 steps from the reference's init_state
# --------------------------------------------------------------------------
OCFG = dict(lr=1e-3, total_steps=30, warmup_steps=2)


def _steps(state, step_fn, pipe, n=5):
    losses = []
    for i in range(n):
        state, met = step_fn(state, pipe.batch_at(i))
        losses.append(float(met["loss"]))
    return state, losses


@pytest.mark.parametrize("dtype,mb,comp", [
    ("f32", 1, False), ("f32", 2, False), ("f32", 1, True),
    ("f32", 2, True), ("bf16", 1, False), ("bf16", 2, True)])
def test_train_step_matches_reference(dtype, mb, comp, corpus):
    pipe = tokens.TokenPipeline(corpus, 8)
    jstate = jax_train_step.init_state(JCFG, jax.random.PRNGKey(0), comp)
    state = train_state_from_numpy(CFG, _np(jstate), "cpu")
    if dtype == "f32":
        jstate["params"] = jax.tree.map(lambda x: x.astype(jnp.float32),
                                        jstate["params"])
        state["params"] = state["params"].float()
    jstep = jax.jit(jax_train_step.make_train_step(
        JCFG, jax_optim.AdamWConfig(**OCFG), mb, comp))
    ref_losses = []
    for i in range(5):
        jstate, met = jstep(jstate, {k: jnp.asarray(v) for k, v in
                                     pipe.batch_at(i).items()})
        ref_losses.append(float(met["loss"]))
    step_fn = make_train_step(CFG, optim.AdamWConfig(**OCFG), mb, comp)
    state, losses = _steps(state, step_fn, pipe)

    loss_tol = 1e-5 if dtype == "f32" else 2e-3
    np.testing.assert_allclose(losses, ref_losses, rtol=loss_tol, atol=0)
    assert losses[-1] < losses[0]
    got = train_state_to_numpy(state)
    assert sorted(got) == sorted(jstate)
    ref = _jflat(_np(jstate["params"]))
    for path, arr in _flat(got["params"]).items():
        tol = 1e-4 if dtype == "f32" else \
            2.0 ** -4 if path.endswith("scale") else 2.0 ** -7
        assert _rel(arr, ref[path]) < tol, path
    assert int(got["opt"]["step"]) == int(jstate["opt"]["step"]) == 5
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    assert all(p.dtype == dt for _, p in state["params"].named_leaves())


def test_microbatches_sum_gradients_in_f32(corpus, monkeypatch):
    """With microbatches the gradient sum is f32 (then AdamW sees f32
    gradients); with one microbatch it is the parameters' bf16."""
    seen = []
    real = optim.adamw_update

    def spy(grads, *args):
        seen.append({t.dtype for _, t in optim.tree_leaves(grads)})
        return real(grads, *args)

    from repro_torch.train import train_step

    monkeypatch.setattr(train_step, "adamw_update", spy)
    pipe = tokens.TokenPipeline(corpus, 8)
    for mb in (1, 2):
        state = init_state(CFG, torch.Generator().manual_seed(0),
                           device="cpu")
        make_train_step(CFG, optim.AdamWConfig(**OCFG), mb)(
            state, pipe.batch_at(0))
    assert seen == [{torch.bfloat16}, {torch.float32}]
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(CFG, optim.AdamWConfig(**OCFG), 3)(
            state, pipe.batch_at(0))


# --------------------------------------------------------------------------
# the runner
# --------------------------------------------------------------------------
def _runner(ckpt_dir, total, fail_at=(), pipe=None, every=3):
    return Runner(CFG, optim.AdamWConfig(total_steps=20, warmup_steps=2),
                  RunnerConfig(total_steps=total, checkpoint_every=every,
                               checkpoint_dir=str(ckpt_dir), log_every=100),
                  "cpu", pipe, injector=fault.FailureInjector(
                      fail_at_steps=fail_at), log=lambda s: None)


def test_resume_is_bitexact(tmp_path, corpus):
    """10 straight steps == 6 steps + crash/restore + 4 steps, every
    parameter and moment bit for bit (the reference checks the last loss);
    the crash at step 7 restarts from step 6's checkpoint."""
    pipe = tokens.TokenPipeline(corpus, 8)
    out_a = _runner(tmp_path / "a", 10, pipe=pipe).run()
    log = []
    r = _runner(tmp_path / "b", 10, fail_at=(7,), pipe=pipe)
    r.log = log.append
    out_b = r.run()
    assert any("injected node failure at step 7" in s for s in log)
    loss_b = {h["step"]: h["loss"] for h in out_b["history"]}
    assert out_a["history"][-1]["loss"] == loss_b[10]
    assert len(out_b["history"]) == 11           # step 7 ran twice
    for a, b in zip(_leaves(out_a["state"]), _leaves(out_b["state"])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # a new runner on a finished directory restores and stops
    out_c = _runner(tmp_path / "b", 10, pipe=pipe).run()
    assert out_c["final_step"] == 10 and out_c["history"] == []
    for a, b in zip(_leaves(out_a["state"]), _leaves(out_c["state"])):
        assert torch.equal(a, b)


def _leaves(state):
    return [t.detach() for _, t in optim.tree_leaves(state_tree(state))]


def test_runner_matches_reference_runner(tmp_path, corpus):
    """Both runners from the reference's step-0 state: the JAX runner's
    own init, and the same state saved into the port's checkpoint
    directory, which the port's runner restores."""
    pipe = tokens.TokenPipeline(corpus, 8)
    jax_out = JaxRunner(
        JCFG, jax_optim.AdamWConfig(total_steps=20, warmup_steps=2),
        JaxRunnerConfig(total_steps=10, checkpoint_every=3,
                        checkpoint_dir=str(tmp_path / "jax"), log_every=100),
        make_host_mesh(1, 1), jax_tokens.TokenPipeline(corpus, 8),
        log=lambda s: None).run()
    jstate = jax_train_step.init_state(JCFG, jax.random.PRNGKey(0))
    state = train_state_from_numpy(CFG, _np(jstate), "cpu")
    CheckpointManager(tmp_path / "port").save(0, state_tree(state))
    r = _runner(tmp_path / "port", 10, pipe=pipe)
    out = r.run()
    ref = [h["loss"] for h in jax_out["history"]]
    got = [h["loss"] for h in out["history"]]
    assert len(got) == len(ref) == 10
    assert [h["step"] for h in out["history"]] == \
        [h["step"] for h in jax_out["history"]]
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=0)
    from repro.train.checkpoint import CheckpointManager as JaxManager
    assert r.ckpt.all_steps() == JaxManager(tmp_path / "jax").all_steps() \
        == [6, 9, 10]


def test_trained_model_still_serves(tmp_path, corpus):
    """After training, prefill and decode_step run on the trained model
    (with its parameters still requiring a gradient), through the views
    bound at construction, and decode == prefill(n + 1)."""
    out = _runner(tmp_path, 3, pipe=tokens.TokenPipeline(corpus, 8)).run()
    model = out["state"]["params"]
    assert model.trainable
    toks = torch.tensor(corpus[:2, :17], dtype=torch.int32)
    cache, logits = M.prefill(model, {"tokens": toks[:, :16]}, 32)
    assert logits.grad_fn is None and torch.isfinite(logits).all()
    step_logits, cache = M.decode_step(model, cache,
                                       {"tokens": toks[:, 16:17]})
    _, full = M.prefill(model, {"tokens": toks}, 32)
    scale = float(full.abs().max())
    assert float((step_logits - full).abs().max()) <= 5e-2 * scale
    assert int(cache["length"]) == 17
    fresh = M.init_params(CFG, torch.Generator().manual_seed(0), "cpu")
    assert not torch.equal(fresh.params["lm_head"]["w"],
                           model.params["lm_head"]["w"])


# --------------------------------------------------------------------------
# shapes, the launcher, the default device
# --------------------------------------------------------------------------
def test_input_specs_match_reference():
    for arch in ARCHS:
        jcfg, cfg = jax_get(arch), get(arch)
        for name in jax_shapes.SHAPES:
            assert shapes.shape_applicable(cfg, name) == \
                jax_shapes.shape_applicable(jcfg, name)
            for override in (0, 4):
                ref = jax_shapes.input_specs(jcfg, name, override)
                got = shapes.input_specs(cfg, name, override)
                assert sorted(got) == sorted(ref), (arch, name)
                for k, t in got.items():
                    assert t.device.type == "meta"
                    assert tuple(t.shape) == ref[k].shape, (arch, name, k)
                    assert str(t.dtype).split(".")[-1] == str(ref[k].dtype)
    assert {k: dataclass_tuple(v) for k, v in shapes.SHAPES.items()} == \
        {k: dataclass_tuple(v) for k, v in jax_shapes.SHAPES.items()}


def dataclass_tuple(s):
    return (s.name, s.seq_len, s.global_batch, s.kind)


@pytest.mark.parametrize("arch", ["paper-scorer", "qwen2-vl-2b",
                                  "musicgen-medium"])
def test_dummy_batch_layout_matches_reference(arch):
    jcfg, cfg = jax_get(arch).reduced(), get(arch).reduced()
    for kind in ("train", "prefill", "decode"):
        ref = jax_shapes.dummy_batch(jcfg, 32, 2, kind)
        got = shapes.dummy_batch(cfg, 32, 2, kind,
                                 torch.Generator().manual_seed(0))
        assert sorted(got) == sorted(ref)
        for k, t in got.items():
            assert tuple(t.shape) == ref[k].shape
            assert str(t.dtype).split(".")[-1] == str(ref[k].dtype)
        if "positions3" in got:
            np.testing.assert_array_equal(got["positions3"].numpy(),
                                          np.asarray(ref["positions3"]))
        if kind == "train":
            n = cfg.n_patch_tokens + cfg.n_cond_tokens
            assert (got["targets"][:, :n] == -1).all()
            assert (got["targets"][:, n:] >= 0).all()


def test_train_launcher_smoke_on_cpu(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--steps", "3", "--checkpoint-dir", str(tmp_path / "ck")],
        capture_output=True, text=True, cwd=tmp_path, timeout=300,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "HOME": str(tmp_path)})
    assert proc.returncode == 0, proc.stderr
    assert "[train] done: 3 steps, loss" in proc.stdout
    assert CheckpointManager(tmp_path / "ck").all_steps() == [3]


def test_training_entry_points_default_to_the_card(monkeypatch, tmp_path,
                                                   corpus):
    from repro_torch.launch.train import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_state(CFG, torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Runner(CFG, optim.AdamWConfig(), RunnerConfig(
            checkpoint_dir=str(tmp_path)), None,
            tokens.TokenPipeline(corpus, 8))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--checkpoint-dir", str(tmp_path)])
    # the production mesh is built over the process group's ranks: one
    # process is too few, named by make_production_mesh
    with pytest.raises(RuntimeError, match="needs 256 devices but only 1"):
        main(["--production-mesh", "--device", "cpu"])
