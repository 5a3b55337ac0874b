"""The port's dense model (``repro_torch.models``) against the JAX package's,
on the CPU, from the same parameters.

Two reduced GQA configs (4 query heads over 2 kv heads, head dim 32):
``paper-scorer`` and ``granite-3-2b``.  The JAX parameters come from
``init_params(PRNGKey(0))`` and cross over with
``convert.model_params_from_numpy``; tokens come from numpy.  Each check
runs twice:

* **f32**: both sides' parameters cast to f32.  Hidden states and logits
  agree within 1e-4 of their largest magnitude: the two libraries sum
  matrix products and softmaxes in other orders, and the port's attention
  scales q after the dot where the reference's chunked attention scales
  the product.  The prefill caches are bf16 on both sides, as
  ``make_cache`` fixes, so a key or value that sits on a bf16 rounding
  boundary may round the other way: they are held to one bf16 ulp beyond
  the f32 tolerance.  The
  reference cannot write an f32 key into its bf16 cache
  (``lax.dynamic_update_slice`` refuses mixed dtypes), so ``decode_step``
  runs on both sides over the reference's prefill cache cast to f32.
* **bf16**, as the model ships: within 5e-2 of the logits' scale.  The JAX
  model's bf16 einsums round the scores and the probabilities to bf16
  (``layers.py:251``); the port's attention keeps them in f32.
  ``decode_step`` runs on both sides over the reference's bf16 prefill
  cache.

The port's own ``decode == prefill(n+1)`` identity (the reference's
``tests/test_models.py:61-86``) is checked on its own bf16 cache, with the
tolerances its test states.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jax_get
from repro.models import model as JM
from repro_torch.configs import get
from repro_torch.convert import model_params_from_numpy
from repro_torch.models import model as M

ARCHS = ["paper-scorer", "granite-3-2b"]
TOL = {"f32": 1e-4, "bf16": 5e-2}
B, S, MAX_LEN = 2, 48, 64


def _np32(x):
    return np.asarray(x, np.float32)


def _t(x):
    return x.to(torch.float32).numpy()


@pytest.fixture(scope="module", params=[(a, d) for a in ARCHS
                                        for d in ("f32", "bf16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def pair(request):
    """Both sides' outputs for one (arch, dtype)."""
    arch, dtype = request.param
    jcfg = jax_get(arch).reduced()
    cfg = get(arch).reduced()
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    model = model_params_from_numpy(cfg, jax.tree.map(_np32, params), "cpu")
    if dtype == "f32":
        params = jax.tree.map(lambda x: x.astype(jnp.float32), params)
        model = model.float()
    rng = np.random.default_rng(1)
    toks = rng.integers(2, cfg.vocab, size=(B, S + 1)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks[:, :S])}
    tb = {"tokens": torch.from_numpy(toks[:, :S])}
    out = {"arch": arch, "dtype": dtype, "model": model, "toks": toks}

    x, pos = JM._embed_inputs(params, jb, jcfg)
    out["j_hidden"] = _np32(JM.backbone(params, x, pos, jcfg)[0])
    x, pos = M._embed_inputs(model, tb)
    out["t_hidden"] = _t(M.backbone(model, x, pos))

    jcache, jlog = JM.prefill(params, jb, jcfg, MAX_LEN)
    tcache, tlog = M.prefill(model, tb, MAX_LEN)
    out.update(j_cache=jcache, t_cache={k: v.clone() for k, v in
                                        tcache.items()},
               j_logits=_np32(jlog), t_logits=_t(tlog))

    # decode_step on both sides from the reference's prefill cache (the
    # prefill caches are compared on their own above)
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
    tl2, tc2 = M.decode_step(model, tcache, {"tokens": torch.from_numpy(nxt)})
    out.update(j_decode=_np32(jl2), t_decode=_t(tl2),
               j_len=int(jc2["length"]), t_len=int(tc2["length"]))
    return out


def _close(got, ref, tol):
    scale = max(float(np.abs(ref).max()), 1.0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * scale)


def test_backbone_hidden_states(pair):
    assert pair["t_hidden"].shape == (B, S, pair["model"].cfg.d_model)
    _close(pair["t_hidden"], pair["j_hidden"], TOL[pair["dtype"]])


def test_prefill_cache(pair):
    jc, tc = pair["j_cache"], pair["t_cache"]
    assert int(jc["length"]) == int(tc["length"]) == S
    assert tc["k"].dtype == tc["v"].dtype == torch.bfloat16
    for name in ("k", "v"):
        ref, got = _np32(jc[name]), _t(tc[name])
        assert got.shape == ref.shape
        assert not got[:, :, S:].any()
        # f32: the f32 tolerance of the values' scale, plus one bf16 ulp of
        # each value (at most 2**-7 of it) for the rounding that may follow
        # the other way
        tol = TOL[pair["dtype"]] * np.abs(ref).max()
        if pair["dtype"] == "f32":
            tol = tol + 2.0 ** -7 * np.abs(ref)
        assert (np.abs(got - ref) <= tol).all(), name


def test_prefill_last_logits(pair):
    assert pair["t_logits"].shape == (B, 1, pair["model"].cfg.vocab)
    _close(pair["t_logits"], pair["j_logits"], TOL[pair["dtype"]])


def test_decode_step_logits(pair):
    assert pair["j_len"] == pair["t_len"] == S + 1
    _close(pair["t_decode"], pair["j_decode"], TOL[pair["dtype"]])


def test_decode_matches_prefill_on_the_port(pair):
    """prefill(n) + decode_step == prefill(n + 1), on the port alone.  In
    bf16 the decode step reads the very keys and values prefill attended
    over: held to the reference's own 1e-3.  Under f32 parameters prefill
    attends over f32 keys and values and the decode step over their bf16
    copies in the cache (up to 2**-8 relative each): held to 1e-2."""
    model, toks = pair["model"], torch.from_numpy(pair["toks"])
    cache, _ = M.prefill(model, {"tokens": toks[:, :S]}, MAX_LEN)
    l2, _ = M.decode_step(model, cache, {"tokens": toks[:, S:S + 1]})
    _, l3 = M.prefill(model, {"tokens": toks}, MAX_LEN)
    _close(_t(l2), _t(l3), 1e-2 if pair["dtype"] == "f32" else 1e-3)


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "zamba2-1.2b",
                                  "rwkv6-3b", "qwen2-vl-2b",
                                  "musicgen-medium"])
def test_unported_families_raise(arch):
    with pytest.raises(NotImplementedError, match="A12"):
        M.init_params(get(arch).reduced(), torch.Generator(), "cpu")


def test_converted_leaf_is_checked():
    cfg = get("paper-scorer").reduced()
    params = jax.tree.map(_np32, JM.init_params(jax_get(cfg.name).reduced(),
                                                jax.random.PRNGKey(0)))
    del params["lm_head"]
    with pytest.raises(ValueError, match="missing"):
        model_params_from_numpy(cfg, params, "cpu")
    params["lm_head"] = {"w": np.zeros((cfg.d_model, cfg.vocab + 1),
                                       np.float32)}
    with pytest.raises(ValueError, match="shape"):
        model_params_from_numpy(cfg, params, "cpu")


def test_naive_attention_is_refused():
    """Attention runs through the ``flash_attention`` op only: a config
    asking for plain PyTorch attention raises rather than running it in
    place of the kernel on the card."""
    from repro_torch.models import layers

    cfg = get("paper-scorer").reduced().replace(attn_impl="naive")
    q = torch.zeros((1, 4, cfg.n_heads, cfg.hd))
    k = torch.zeros((1, 4, cfg.n_kv_heads, cfg.hd))
    with pytest.raises(ValueError, match="naive"):
        layers.causal_attention(q, k, k, cfg)
