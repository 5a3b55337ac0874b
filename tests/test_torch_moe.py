"""The port's expert layer (``repro_torch.models.moe``) and the MoE configs
against the JAX package's, on the CPU.

* ``moe_block`` on seeded bf16 inputs and weights (the reduced
  ``olmoe-1b-7b``: 4 experts, top 2, width 128): the expert picks equal the
  reference's ``jax.lax.top_k`` (captured as the reference computes them),
  and each assignment's position within its expert and its keep mask equal
  the reference's dispatch rule (the count of earlier assignments, in
  token order, to the same expert, kept below the reference's capacity),
  exactly.  At ``capacity_factor`` 1.0 assignments drop: the drop count is
  the reference's.  Outputs within one bf16 ulp of their scale plus one of
  each element (2**-7 |ref| + 2**-7 max |ref|): both sides round the
  expert products, the gate multiply and the sum over the k picks to bf16,
  in sums of other orders.  The aux loss within 1e-6 relative (f32 means
  of 96 and 192 terms in other orders).
* ``olmoe-1b-7b`` and ``moonshot-v1-16b-a3b`` reduced, from the
  reference's ``init_params(PRNGKey(0))`` carried across: the last
  logits of ``prefill`` within ``tests/test_torch_model.py``'s
  tolerances, 1e-4 of their scale in f32 and 5e-2 in bf16; ``loss_fn``
  (its ``0.01 * aux`` term included) in f32 within
  ``tests/test_torch_train.py``'s 1e-5 relative.  The loss is not held
  in bf16: there the reference's attention rounds its probabilities to
  bf16 where the port's keeps f32, the hidden states part by bf16 ulps,
  and a token whose top two router probabilities sit that close picks
  another expert (2 of 96 tokens in the second layer of
  ``olmoe-1b-7b``), a discrete change that no rounding bound covers.
* ``n_active_params``, ``n_params`` and the parameters' axes equal the
  reference's for every config the port builds.
* Two train steps of ``olmoe-1b-7b`` reduced through the port's
  ``make_train_step`` against the reference's jitted ``train_step`` in
  f32: losses within 1e-5 relative (``tests/test_torch_train.py``).
* The port's own ``decode == prefill(n + 1)`` at ``capacity_factor`` 8
  (no drops), the reference's ``tests/test_models.py:88-101`` (1e-2).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get as jax_get
from repro.models import model as JM
from repro.models import moe as JMOE
from repro.train import optim as jax_optim
from repro.train import train_step as jax_train_step
from repro_torch.configs import ARCHS, get
from repro_torch.convert import model_params_from_numpy, \
    train_state_from_numpy
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.train import optim
from repro_torch.train.train_step import make_train_step

TOL = {"f32": 1e-4, "bf16": 5e-2}
B, S, MAX_LEN = 2, 48, 64


def _np(tree):
    return jax.tree.map(lambda x: np.asarray(
        x, np.float32 if x.dtype == jnp.bfloat16 else x.dtype), tree)


def _t(x):
    return x.detach().to(torch.float32).numpy()


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _block_inputs(cfg, seed):
    """Seeded bf16 expert weights and activations for both sides."""
    rng = np.random.default_rng(seed)
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    raw = {"router": rng.normal(size=(d, E)) / np.sqrt(d),
           "wi_gate": rng.normal(size=(E, d, f)) / np.sqrt(d),
           "wi_up": rng.normal(size=(E, d, f)) / np.sqrt(d),
           "wo": rng.normal(size=(E, f, d)) / np.sqrt(f)}
    x = rng.normal(size=(B, S, d))
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in raw.items()}
    tp = {k: torch.from_numpy(np.asarray(v, np.float32)).to(torch.bfloat16)
          for k, v in jp.items()}
    jx = jnp.asarray(x, jnp.bfloat16)
    return jp, jx, tp, torch.from_numpy(np.asarray(jx, np.float32)).to(
        torch.bfloat16)


def _reference_dispatch(expert: np.ndarray, C: int):
    """The reference's positions and keep mask from its picks: each
    assignment's rank among the earlier ones (token-major) to its expert."""
    flat = expert.reshape(-1)
    pos = np.zeros(flat.shape, np.int64)
    seen: dict = {}
    for i, e in enumerate(flat):
        pos[i] = seen.get(int(e), 0)
        seen[int(e)] = pos[i] + 1
    return pos, pos < C


@pytest.mark.parametrize("cf,seed", [(1.25, 0), (1.25, 1), (1.0, 0),
                                     (1.0, 2)])
def test_moe_block_matches_reference(monkeypatch, cf, seed):
    jcfg = jax_get("olmoe-1b-7b").reduced().replace(capacity_factor=cf)
    cfg = get("olmoe-1b-7b").reduced().replace(capacity_factor=cf)
    jp, jx, tp, tx = _block_inputs(cfg, seed)
    seen = {}
    top_k = jax.lax.top_k

    def spy(a, k):
        out = top_k(a, k)
        seen["idx"] = np.asarray(out[1])
        return out

    monkeypatch.setattr(jax.lax, "top_k", spy)
    jy, jaux = JMOE.moe_block(jx, jp, jcfg)
    monkeypatch.setattr(jax.lax, "top_k", top_k)
    ty, taux = moe.moe_block(tx, tp, cfg)
    r = moe.route(tx.reshape(B * S, -1), tp["router"], cfg)

    T = B * S
    assert r.C == moe.capacity(cfg, T) == JMOE.capacity(jcfg, T)
    np.testing.assert_array_equal(r.expert.numpy(), seen["idx"])
    pos, keep = _reference_dispatch(seen["idx"], r.C)
    np.testing.assert_array_equal(r.pos.numpy(), pos)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    drops = int((~keep).sum())
    assert int((~r.keep).sum()) == drops
    if cf == 1.0:
        assert drops > 0       # the tight case does drop
    ref = np.asarray(jy, np.float32)
    got = _t(ty)
    assert ty.dtype == torch.bfloat16 and got.shape == ref.shape
    tol = 2.0 ** -7 * (np.abs(ref) + np.abs(ref).max())
    assert (np.abs(got - ref) <= tol).all()
    assert abs(float(taux) - float(jaux)) <= 1e-6 * abs(float(jaux))


def test_moe_picks_break_ties_to_the_lower_expert():
    """Equal router probabilities pick the lower expert index first, as
    ``jax.lax.top_k`` does."""
    cfg = get("olmoe-1b-7b").reduced()
    xt = torch.ones((3, cfg.d_model))
    router = torch.zeros((cfg.d_model, cfg.n_experts))
    r = moe.route(xt, router, cfg)
    assert r.expert.tolist() == [[0, 1]] * 3
    np.testing.assert_array_equal(
        r.expert.numpy(),
        np.asarray(jax.lax.top_k(jnp.full((3, cfg.n_experts), 0.25), 2)[1]))


@functools.lru_cache(maxsize=None)
def _run(arch, dtype):
    """Both sides' last prefill logits and loss for one (arch, dtype)."""
    jcfg, cfg = jax_get(arch).reduced(), get(arch).reduced()
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    model = model_params_from_numpy(cfg, _np(params), "cpu")
    if dtype == "f32":
        params = jax.tree.map(lambda x: x.astype(jnp.float32), params)
        model = model.float()
    rng = np.random.default_rng(5)
    toks = rng.integers(2, cfg.vocab, size=(B, S)).astype(np.int32)
    tgts = np.roll(toks, -1, axis=1)
    tgts[:, -1] = -1
    _, jlog = JM.prefill(params, {"tokens": jnp.asarray(toks)}, jcfg,
                         MAX_LEN)
    _, tlog = M.prefill(model, {"tokens": torch.from_numpy(toks)}, MAX_LEN)
    jloss = JM.loss_fn(params, {"tokens": jnp.asarray(toks),
                                "targets": jnp.asarray(tgts)}, jcfg)
    tloss = M.loss_fn(model, {"tokens": torch.from_numpy(toks),
                              "targets": torch.from_numpy(tgts)})
    return dict(j_logits=np.asarray(jlog, np.float32), t_logits=_t(tlog),
                j_loss=float(jloss), t_loss=float(tloss))


MOE_ARCHS = ("olmoe-1b-7b", "moonshot-v1-16b-a3b")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_prefill_logits_match_reference(arch, dtype):
    run = _run(arch, dtype)
    ref = run["j_logits"]
    scale = max(float(np.abs(ref).max()), 1.0)
    np.testing.assert_allclose(run["t_logits"], ref, rtol=0,
                               atol=TOL[dtype] * scale)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_loss_with_aux_matches_reference(arch):
    run = _run(arch, "f32")
    assert abs(run["t_loss"] - run["j_loss"]) <= 1e-5 * abs(run["j_loss"])


def test_model_bookkeeping_matches_reference_for_every_built_config():
    built = [a for a in sorted(ARCHS) if get(a).family in M.FAMILIES]
    assert built == sorted(ARCHS) == sorted(JAX_ARCHS)
    assert len(built) == 11
    for arch in built:
        jcfg, cfg = jax_get(arch), get(arch)
        assert M.n_active_params(cfg) == JM.n_active_params(jcfg), arch
        assert M.n_params(cfg) == JM.n_params(jcfg), arch
        assert _flat(M.param_axes(cfg)) == _flat(JM.param_axes(jcfg)), arch
        assert M.cache_axes(cfg) == JM.cache_axes(jcfg), arch
        if cfg.family == "hybrid":
            # the reference cannot decode the hybrid under kv_quant (R7)
            with pytest.raises(ValueError, match="R7"):
                M.cache_axes(cfg.replace(kv_quant=True))
            continue
        assert M.cache_axes(cfg.replace(kv_quant=True)) \
            == JM.cache_axes(jcfg.replace(kv_quant=True)), arch
    cfg = get("olmoe-1b-7b")
    assert M.n_active_params(cfg) < M.n_params(cfg) * 0.35


def test_moe_train_steps_match_reference():
    arch = "olmoe-1b-7b"
    jcfg, cfg = jax_get(arch).reduced(), get(arch).reduced()
    jstate = jax_train_step.init_state(jcfg, jax.random.PRNGKey(0), False)
    state = train_state_from_numpy(cfg, _np(jstate), "cpu")
    jstate["params"] = jax.tree.map(lambda x: x.astype(jnp.float32),
                                    jstate["params"])
    state["params"] = state["params"].float()
    ocfg = dict(lr=1e-3, total_steps=30, warmup_steps=2)
    jstep = jax.jit(jax_train_step.make_train_step(
        jcfg, jax_optim.AdamWConfig(**ocfg), 1, False))
    step = make_train_step(cfg, optim.AdamWConfig(**ocfg), 1, False)
    rng = np.random.default_rng(9)
    ref, got = [], []
    for _ in range(2):
        toks = rng.integers(2, cfg.vocab, size=(4, 32)).astype(np.int32)
        tgts = np.roll(toks, -1, axis=1)
        tgts[:, -1] = -1
        batch = {"tokens": toks, "targets": tgts}
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        state, m = step(state, batch)
        ref.append(float(jm["loss"]))
        got.append(float(m["loss"]))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=0)
    assert got[1] != got[0]


def test_moe_decode_matches_prefill_on_the_port():
    cfg = get("olmoe-1b-7b").reduced().replace(capacity_factor=8.0)
    params = JM.init_params(jax_get("olmoe-1b-7b").reduced(),
                            jax.random.PRNGKey(0))
    model = model_params_from_numpy(cfg, _np(params), "cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        2, cfg.vocab, size=(B, S + 1)).astype(np.int32))
    cache, _ = M.prefill(model, {"tokens": toks[:, :S]}, MAX_LEN)
    l2, _ = M.decode_step(model, cache, {"tokens": toks[:, S:S + 1]})
    _, l3 = M.prefill(model, {"tokens": toks}, MAX_LEN)
    assert float((l2 - l3).abs().max()) < 1e-2
