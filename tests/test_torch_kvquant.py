"""The port's int8 KV cache (``kv_quant``) against the JAX package's, on
the CPU.

* ``quantize_kv``: the int8 values and bf16 scales equal the reference's
  bit for bit, from the same bf16 (prefill) and f32 (decode under f32
  parameters) inputs: both take the max in f32, divide by 127 and add
  1e-8 in f32, divide, round half to even and clip.
* The dequantized cache (the int8 value cast to bf16 times its bf16
  scale, one rounding of an exact product): bit for bit.
* ``decode_attention`` over an int8 cache with its scales (the op's plain
  version, which dequantizes first) against the reference's
  ``decode_attention`` kernel in interpret mode over the reference's
  dequantized caches, within the decode tolerances of
  ``tests/test_torch_attention.py``: 1e-5 for an f32 query, 3e-2 for a
  bf16 one.
* ``internlm2-1.8b`` reduced under ``kv_quant``, from the reference's
  ``init_params(PRNGKey(0))`` carried across.  With f32 parameters the
  prefill cache's int8 values and scales equal the reference's bit for bit
  (both quantize the bf16 copies of keys and values that agree to f32
  rounding, and round to the same bf16 numbers here).  With bf16
  parameters the keys and values themselves part by bf16 ulps (matrix
  products summed in other orders), so the dequantized caches are held to
  ``tests/test_torch_model.py``'s bf16 prefill-cache tolerance, 5e-2 of
  the values' scale.
* One decode step over the reference's int8 prefill cache: logits within
  5e-2 of their scale, ``tests/test_torch_model.py``'s bf16 tolerance,
  under f32 parameters too: the reference's dequantized caches are bf16,
  so its attention rounds the probabilities and its output to bf16
  (``layers.py:250-251``) whatever the query's type, where the port's
  stays f32.  The reference's ``decode_layer_step`` under ``kv_quant``
  keeps the decoded token's scales but drops its int8 values (ROADMAP
  R5), so its later steps attend over zeros there: the port's multi-step
  decode is held to its own ``prefill(n + k)`` instead, within the
  reference test's 0.08 of the logits' scale
  (``tests/test_models.py:160-176``), and its int8 decode to its bf16
  cache's decode within the same 0.08.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jax_get
from repro.kernels.decode_attention.ops import \
    decode_attention as jax_decode_attention
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.configs import get
from repro_torch.convert import model_params_from_numpy
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.models import layers as L
from repro_torch.models import model as M

ARCH = "internlm2-1.8b"
TOL = {"f32": 1e-4, "bf16": 5e-2}
B, S, MAX_LEN = 2, 48, 64


def _np(tree):
    return jax.tree.map(lambda x: np.asarray(
        x, np.float32 if x.dtype == jnp.bfloat16 else x.dtype), tree)


def _t(x):
    return x.detach().to(torch.float32).numpy()


def _inputs(seed, shape, dtype, scale=1.0):
    """The same values for both sides: bf16 or f32, a few rows of zeros."""
    x = np.random.default_rng(seed).normal(size=shape) * scale
    x[0, 0, 0] = 0.0                    # an all-zero row: scale 1e-8
    j = jnp.asarray(x, dtype)
    t = torch.from_numpy(np.array(j, np.float32))
    return j, t.to(torch.bfloat16 if dtype == jnp.bfloat16 else
                   torch.float32)


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("seed,scale", [(0, 1.0), (1, 30.0), (2, 1e-3)])
def test_quantize_kv_bit_for_bit(seed, scale, dtype):
    jx, tx = _inputs(seed, (2, 33, 3, 64), dtype, scale)
    jq, js = JL.quantize_kv(jx)
    tq, ts = L.quantize_kv(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.view(torch.int16).numpy(),
                                  np.asarray(js).view(np.int16))
    # the dequantized values, bit for bit
    jd = jq.astype(jnp.bfloat16) * js[..., None]
    td = L.dequantize_kv(tq, ts)
    assert td.dtype == torch.bfloat16
    np.testing.assert_array_equal(td.view(torch.int16).numpy(),
                                  np.asarray(jd).view(np.int16))


@pytest.mark.parametrize("q_dtype,tol", [(jnp.float32, 1e-5),
                                         (jnp.bfloat16, 3e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("H,K,d,length", [(8, 2, 64, 300), (6, 2, 128, 1),
                                          (4, 4, 32, 512)])
def test_decode_attention_over_int8_cache(H, K, d, length, q_dtype, tol):
    rng = np.random.default_rng(H + d + length)
    Bq, Sc = 2, 512
    q = rng.normal(size=(Bq, H, d))
    jq = jnp.asarray(q, q_dtype)
    tq = torch.from_numpy(np.asarray(jq, np.float32)).to(
        torch.float32 if q_dtype == jnp.float32 else torch.bfloat16)
    caches = []
    for i in range(2):
        x = jnp.asarray(rng.normal(size=(Bq, Sc, K, d)), jnp.bfloat16)
        jv, js = JL.quantize_kv(x)
        caches.append((jv, js, torch.from_numpy(np.asarray(jv)),
                       torch.from_numpy(np.asarray(js, np.float32)).to(
                           torch.bfloat16)))
    (jk, jks, tk, tks), (jv, jvs, tv, tvs) = caches
    kd = jk.astype(jnp.bfloat16) * jks[..., None]
    vd = jv.astype(jnp.bfloat16) * jvs[..., None]
    ref = jax_decode_attention(jq, kd, vd, jnp.int32(length),
                               impl="interpret")
    got = decode_attention(tq, tk, tv, torch.tensor(length,
                                                    dtype=torch.int32),
                           tks, tvs)
    assert got.dtype == tq.dtype and got.shape == (Bq, H, d)
    np.testing.assert_allclose(_t(got), np.asarray(ref, np.float32),
                               atol=tol, rtol=0)


def test_decode_attention_takes_both_scales_or_neither():
    q, kc = torch.zeros(1, 2, 32), torch.zeros(1, 8, 2, 32, dtype=torch.int8)
    s = torch.ones(1, 8, 2, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="both scales"):
        decode_attention(q, kc, kc, 3, s, None)


@pytest.fixture(scope="module", params=["f32", "bf16"])
def quant(request):
    dtype = request.param
    jcfg = jax_get(ARCH).reduced().replace(kv_quant=True)
    cfg = get(ARCH).reduced().replace(kv_quant=True)
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    model = model_params_from_numpy(cfg, _np(params), "cpu")
    if dtype == "f32":
        params = jax.tree.map(lambda x: x.astype(jnp.float32), params)
        model = model.float()
    toks = np.random.default_rng(2).integers(
        2, cfg.vocab, size=(B, S + 3)).astype(np.int32)
    jcache, jlog = JM.prefill(params, {"tokens": jnp.asarray(toks[:, :S])},
                              jcfg, MAX_LEN)
    tcache, tlog = M.prefill(model, {"tokens": torch.from_numpy(
        toks[:, :S])}, MAX_LEN)
    return dict(dtype=dtype, jcfg=jcfg, cfg=cfg, params=params, model=model,
                toks=toks, jcache=jcache, tcache=tcache)


def test_prefill_int8_cache(quant):
    jc, tc = quant["jcache"], quant["tcache"]
    assert sorted(tc) == sorted(jc)
    assert int(tc["length"]) == int(jc["length"]) == S
    assert tc["k"].dtype == tc["v"].dtype == torch.int8
    assert tc["k_scale"].dtype == tc["v_scale"].dtype == torch.bfloat16
    for name in ("k", "v"):
        assert not tc[name][:, :, S:].any()
        if quant["dtype"] == "f32":
            np.testing.assert_array_equal(tc[name].numpy(),
                                          np.asarray(jc[name]))
            np.testing.assert_array_equal(
                tc[f"{name}_scale"].view(torch.int16).numpy(),
                np.asarray(jc[f"{name}_scale"]).view(np.int16))
        else:
            ref = np.asarray(jc[name].astype(jnp.bfloat16)
                             * jc[f"{name}_scale"][..., None], np.float32)
            got = _t(L.dequantize_kv(tc[name], tc[f"{name}_scale"]))
            np.testing.assert_allclose(got, ref, rtol=0,
                                       atol=TOL["bf16"] * np.abs(ref).max())


def test_one_decode_step_over_the_reference_cache(quant):
    jc, toks = quant["jcache"], quant["toks"]
    tcache = {"length": torch.tensor(S, dtype=torch.int32),
              "k": torch.from_numpy(np.array(jc["k"])),
              "v": torch.from_numpy(np.array(jc["v"]))}
    for name in ("k_scale", "v_scale"):
        tcache[name] = torch.from_numpy(np.asarray(
            jc[name], np.float32)).to(torch.bfloat16)
    nxt = toks[:, S:S + 1]
    jl, jc2 = JM.decode_step(quant["params"], jc,
                             {"tokens": jnp.asarray(nxt)}, quant["jcfg"])
    tl, tc2 = M.decode_step(quant["model"], tcache,
                            {"tokens": torch.from_numpy(nxt)})
    assert int(jc2["length"]) == int(tc2["length"]) == S + 1
    ref = np.asarray(jl, np.float32)
    scale = max(float(np.abs(ref).max()), 1.0)
    np.testing.assert_allclose(_t(tl), ref, rtol=0, atol=TOL["bf16"] * scale)
    assert tc2["k"][:, :, S].any()       # the port wrote the token's values


def test_multi_step_decode_matches_own_prefill(quant):
    model, toks = quant["model"], torch.from_numpy(quant["toks"])
    cache, _ = M.prefill(model, {"tokens": toks[:, :S]}, MAX_LEN)
    for i in range(3):
        logits, cache = M.decode_step(model, cache,
                                      {"tokens": toks[:, S + i:S + i + 1]})
    assert int(cache["length"]) == S + 3
    _, ref = M.prefill(model, {"tokens": toks[:, :S + 3]}, MAX_LEN)
    scale = max(float(ref.abs().max()), 1.0)
    assert float((logits - ref).abs().max()) < 0.08 * scale
    # against the bf16 cache's decode step (the reference's own check)
    bf = model_params_from_numpy(quant["cfg"].replace(kv_quant=False), {
        k: v for k, v in _np(JM.init_params(
            quant["jcfg"].replace(kv_quant=False),
            jax.random.PRNGKey(0))).items()}, "cpu")
    if quant["dtype"] == "f32":
        bf = bf.float()
    c_bf, _ = M.prefill(bf, {"tokens": toks[:, :S]}, MAX_LEN)
    l_bf, _ = M.decode_step(bf, c_bf, {"tokens": toks[:, S:S + 1]})
    c_q, _ = M.prefill(model, {"tokens": toks[:, :S]}, MAX_LEN)
    l_q, _ = M.decode_step(model, c_q, {"tokens": toks[:, S:S + 1]})
    scale = max(float(l_bf.abs().max()), 1e-6)
    assert float((l_q - l_bf).abs().max()) < 0.08 * scale
