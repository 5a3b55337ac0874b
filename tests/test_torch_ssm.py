"""The port's SSM and hybrid families (``repro_torch.models.ssm`` and the
``ssm`` / ``hybrid`` branches of ``models/model.py``) against the JAX
package's, on the CPU, from the same parameters.

Reduced configs: ``rwkv6-3b`` (2 layers, width 128, 2 WKV heads of 64,
decay rank 8) and ``zamba2-1.2b`` (4 layers, width 128, 8 Mamba2 heads of
32, state 16, chunk 32, the shared block every 2 layers: 4 query heads
over 2 kv heads of 32).  The parameters are the reference's
``init_params(PRNGKey(0))`` carried across with
``convert.model_params_from_numpy``; inputs come from numpy under a seed.
The reference runs as its own tests run it (eagerly, its decode steps
jitted as its engine jits them), its attention the jnp
``chunked_causal_attention`` and ``decode_attention``; the port's flash
and decode ops take their plain versions on the CPU.

Tolerances and where they come from:

* f32 (both sides' parameters and inputs f32): the two libraries sum
  matrix products, cumulative sums and norms in other orders, each good to
  a few f32 ulps (2**-24 ~ 6e-8) times its length.  The blocks' outputs
  and states within 1e-5 of their largest magnitude, the models' logits,
  hidden states and cache entries within 1e-4 (``tests/
  test_torch_model.py``'s), the loss within 1e-5 relative and every
  gradient leaf within 1e-4 in ||delta|| / ||ref||
  (``tests/test_torch_train.py``'s).  A bf16 cache entry (RWKV's token
  shifts, the conv state, the shared block's K/V) may round the other way
  from an f32 value on a bf16 rounding boundary: one bf16 ulp of the value
  (2**-7 of it) on top.
* bf16, as the model ships: every bf16 rounding may land one ulp (2**-8
  relative) apart.  ``mamba2_ssd`` on bf16 inputs (its diagonal blocks
  multiply in bf16, its output rounds to bf16) within 2**-6 of the output's
  scale, two bf16 ulps; the models' logits within 5e-2 of their scale
  (``tests/test_torch_model.py``'s), the loss within 1e-3 relative.
* The decode steps start on both sides from the reference's prefill
  cache, f32 under f32 parameters (the reference cannot write an f32 state
  into its bf16 entries, ROADMAP R6), and read the same tokens; every
  state after them within the tolerances above.
* Greedy tokens: equal under f32 parameters and caches.  The reference
  engine keeps RWKV's states (ROADMAP R5 is the attention families'), so
  RWKV's tokens are held to it; the hybrid's to the reference's forward
  over the wave's tokens so far (its prefill oracle).
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jax_get
from repro.models import model as JM
from repro.models import ssm as JS
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import get
from repro_torch.convert import model_params_from_numpy
from repro_torch.models import model as M
from repro_torch.models import ssm as S
from repro_torch.serve.engine import Request, ServeEngine

ARCHS = ("rwkv6-3b", "zamba2-1.2b")
TOL = {"f32": 1e-4, "bf16": 5e-2}
BLOCK_TOL = 1e-5
BF16_ULP = 2.0 ** -7          # one bf16 ulp, relative, at most
B, SEQ, MAX_LEN, STEPS = 2, 37, 48, 4


def _np32(x):
    return np.asarray(x, np.float32)


def _t(x: torch.Tensor) -> np.ndarray:
    return x.detach().to(torch.float32).numpy()


def _rel(got, ref) -> float:
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def _close(got, ref, tol, ulp=False):
    """Within ``tol`` of ref's largest magnitude (and, for a bf16 entry,
    one bf16 ulp of each value on top)."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    bound = tol * max(float(np.abs(ref).max()), 1e-30)
    if ulp:
        bound = bound + BF16_ULP * np.abs(ref)
    assert (np.abs(got - ref) <= bound).all(), \
        float((np.abs(got - ref) / np.maximum(bound, 1e-30)).max())


def _jflat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_jflat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _cfgs(arch):
    return jax_get(arch).reduced(), get(arch).reduced()


@functools.lru_cache(maxsize=None)
def _jinit(arch):
    """The reference's ``init_params(PRNGKey(0))`` (immutable arrays)."""
    return JM.init_params(_cfgs(arch)[0], jax.random.PRNGKey(0))


def _jparams(arch, dtype="bf16"):
    params = _jinit(arch)
    if dtype == "f32":
        params = jax.tree.map(lambda x: x.astype(jnp.float32), params)
    return params


def _model(arch, dtype="bf16"):
    _, cfg = _cfgs(arch)
    model = model_params_from_numpy(
        cfg, jax.tree.map(_np32, _jparams(arch)), "cpu")
    return model.float() if dtype == "f32" else model


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _tensors(arrays, dtype):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _jarrays(arrays, dtype):
    return [jnp.asarray(a).astype(dtype) for a in arrays]


# --------------------------------------------------------------------------
# Mamba2
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("seq", [64, 37], ids=["chunked", "prime"])
def test_mamba2_ssd_matches_reference(seq, dtype):
    """At S = 64 the chunk is 32 (two chunks); at the prime S = 37 it is 1
    (37 chunks), the reference's rule either way."""
    _, cfg = _cfgs("zamba2-1.2b")
    H, P, N = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    assert S.ssd_chunk(seq, cfg.ssm_chunk) == (32 if seq == 64 else 1)
    rng = np.random.default_rng(seq)
    x, Bm, Cm = (_rand(rng, (B, seq, H, P)), _rand(rng, (B, seq, N), 0.5),
                 _rand(rng, (B, seq, N), 0.5))
    dt = np.log1p(np.exp(_rand(rng, (B, seq, H)) - 2.0)).astype(np.float32)
    A = -np.exp(rng.uniform(0.0, math.log(16.0), H)).astype(np.float32)
    D = _rand(rng, (H,))
    tdt, jdt = (torch.float32, jnp.float32) if dtype == "f32" \
        else (torch.bfloat16, jnp.bfloat16)
    tx, tB, tC = _tensors((x, Bm, Cm), tdt)
    jx, jB, jC = _jarrays((x, Bm, Cm), jdt)
    y, st = S.mamba2_ssd(tx, torch.from_numpy(dt), torch.from_numpy(A), tB,
                         tC, torch.from_numpy(D), cfg)
    jy, jst = JS.mamba2_ssd(jx, jnp.asarray(dt), jnp.asarray(A), jB, jC,
                            jnp.asarray(D), jax_get("zamba2-1.2b").reduced())
    assert y.dtype == tdt and st.dtype == torch.float32
    tol = BLOCK_TOL if dtype == "f32" else 2.0 ** -6
    _close(_t(y), _np32(jy), tol)
    _close(_t(st), _np32(jst), tol)


@pytest.fixture(scope="module")
def mamba():
    """Layer 0's Mamba2 parameters on both sides, f32."""
    jp = _jparams("zamba2-1.2b", "f32")
    model = _model("zamba2-1.2b", "f32")
    return (jax.tree.map(lambda a: a[0], jp["layers"]["mamba"]),
            model.layer_params[0]["mamba"])


@pytest.mark.parametrize("seq", [64, 37], ids=["chunked", "prime"])
def test_mamba2_block_with_state_matches_reference(mamba, seq):
    jcfg, cfg = _cfgs("zamba2-1.2b")
    jp, tp = mamba
    x = _rand(np.random.default_rng(seq + 1), (B, seq, cfg.d_model))
    out, (ssm, conv) = S.mamba2_block(torch.from_numpy(x), tp, cfg,
                                      return_state=True)
    jout, (jssm, jconv) = JS.mamba2_block(jnp.asarray(x), jp, jcfg,
                                          return_state=True)
    assert tuple(conv.shape) == (B, cfg.ssm_conv - 1,
                                 cfg.d_inner + 2 * cfg.ssm_state)
    assert ssm.dtype == torch.float32
    for got, ref in ((out, jout), (ssm, jssm), (conv, jconv)):
        _close(_t(got), _np32(ref), BLOCK_TOL)
    # without the states, the same output
    _close(_t(S.mamba2_block(torch.from_numpy(x), tp, cfg)), _np32(jout),
           BLOCK_TOL)


def test_mamba2_decode_steps_match_reference(mamba):
    """Three steps from the states of a 37-token block: the outputs and
    both states after every step; the states given are not written."""
    jcfg, cfg = _cfgs("zamba2-1.2b")
    jp, tp = mamba
    rng = np.random.default_rng(5)
    x = _rand(rng, (B, 37, cfg.d_model))
    _, (ssm, conv) = S.mamba2_block(torch.from_numpy(x), tp, cfg,
                                    return_state=True)
    jssm, jconv = jnp.asarray(_t(ssm)), jnp.asarray(_t(conv))
    for step in range(3):
        xt = _rand(rng, (B, 1, cfg.d_model))
        before = ssm.clone()
        y, ssm2, conv2 = S.mamba2_decode_step(torch.from_numpy(xt), tp, cfg,
                                              ssm, conv)
        assert torch.equal(ssm, before)
        jy, jssm, jconv = JS.mamba2_decode_step(jnp.asarray(xt), jp, jcfg,
                                                jssm, jconv)
        for got, ref in ((y, jy), (ssm2, jssm), (conv2, jconv)):
            _close(_t(got), _np32(ref), BLOCK_TOL)
        ssm, conv = ssm2, conv2


# --------------------------------------------------------------------------
# RWKV6
# --------------------------------------------------------------------------
def test_rwkv_wkv_scan_with_a_nonzero_state_matches_reference():
    rng = np.random.default_rng(7)
    Bs, Ss, H, hd = 2, 19, 2, 16
    r, k, v = (_rand(rng, (Bs, Ss, H, hd)) for _ in range(3))
    w = rng.uniform(0.5, 1.0, (Bs, Ss, H, hd)).astype(np.float32)
    u = _rand(rng, (H, hd), 0.1)
    st0 = _rand(rng, (Bs, H, hd, hd))
    y, st = S._rwkv_wkv_scan(*_tensors((r, k, v, w, u, st0), torch.float32))
    jy, jst = JS._rwkv_wkv_scan(*(jnp.asarray(a)
                                  for a in (r, k, v, w, u, st0)))
    _close(_t(y), _np32(jy), BLOCK_TOL)
    _close(_t(st), _np32(jst), BLOCK_TOL)


def test_groupnorm_heads_matches_reference():
    """The population variance (``jnp.var``; torch's default would be the
    unbiased one) and the ``1 + scale`` factor."""
    rng = np.random.default_rng(8)
    y, scale = _rand(rng, (2, 5, 4, 16), 3.0), _rand(rng, (64,))
    got = S._groupnorm_heads(torch.from_numpy(y), torch.from_numpy(scale),
                             4, 1e-5)
    ref = JS._groupnorm_heads(jnp.asarray(y), jnp.asarray(scale), 4, 1e-5)
    _close(_t(got), _np32(ref), BLOCK_TOL)


@pytest.fixture(scope="module")
def rwkv():
    """Layer 0's RWKV parameters on both sides, f32, with the mixing
    coefficients, decay base, bonus and norm scale drawn away from their
    constant init."""
    jp = {n: _np32(a[0]) for n, a in
          _jparams("rwkv6-3b", "f32")["layers"].items()
          if not isinstance(a, dict)}
    rng = np.random.default_rng(9)
    for name in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g", "mu_ck", "mu_cr"):
        jp[name] = rng.uniform(0.0, 1.0, jp[name].shape).astype(np.float32)
    jp["w0"] = rng.uniform(-6.0, -1.0, jp["w0"].shape).astype(np.float32)
    jp["ln_x"] = _rand(rng, jp["ln_x"].shape, 0.1)
    jp["bonus_u"] = _rand(rng, jp["bonus_u"].shape, 0.3)
    return ({n: jnp.asarray(a) for n, a in jp.items()},
            {n: torch.from_numpy(a) for n, a in jp.items()})


def test_rwkv6_time_mix_with_shift_and_state_matches_reference(rwkv):
    jcfg, cfg = _cfgs("rwkv6-3b")
    jp, tp = rwkv
    H, hd = cfg.d_model // cfg.ssm_head_dim, cfg.ssm_head_dim
    rng = np.random.default_rng(10)
    x = _rand(rng, (B, 23, cfg.d_model))
    shift = _rand(rng, (B, 1, cfg.d_model))
    st0 = _rand(rng, (B, H, hd, hd), 0.5)
    out, st, last = S.rwkv6_time_mix(
        *_tensors((x, shift), torch.float32), tp, cfg,
        state0=torch.from_numpy(st0))
    jout, jst, jlast = JS.rwkv6_time_mix(jnp.asarray(x), jnp.asarray(shift),
                                         jp, jcfg, state0=jnp.asarray(st0))
    for got, ref in ((out, jout), (st, jst), (last, jlast)):
        _close(_t(got), _np32(ref), BLOCK_TOL)


def test_rwkv6_channel_mix_with_shift_matches_reference(rwkv):
    jcfg, cfg = _cfgs("rwkv6-3b")
    jp, tp = rwkv
    rng = np.random.default_rng(11)
    x = _rand(rng, (B, 23, cfg.d_model))
    shift = _rand(rng, (B, 1, cfg.d_model))
    out, last = S.rwkv6_channel_mix(*_tensors((x, shift), torch.float32), tp,
                                    cfg)
    jout, jlast = JS.rwkv6_channel_mix(jnp.asarray(x), jnp.asarray(shift),
                                       jp, jcfg)
    _close(_t(out), _np32(jout), BLOCK_TOL)
    _close(_t(last), _np32(jlast), 0.0)


# --------------------------------------------------------------------------
# The two families' models
# --------------------------------------------------------------------------
def _tokens(cfg, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(2, cfg.vocab, size=(B, SEQ + STEPS)).astype(np.int32)


@pytest.fixture(scope="module", params=[(a, d) for a in ARCHS
                                        for d in ("f32", "bf16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def run(request):
    """Both sides' hidden states, prefill caches and logits, and STEPS
    decode steps from the reference's prefill cache, for one (arch,
    dtype)."""
    arch, dtype = request.param
    jcfg, cfg = _cfgs(arch)
    params, model = _jparams(arch, dtype), _model(arch, dtype)
    toks = _tokens(cfg)
    out = {"arch": arch, "dtype": dtype, "cfg": cfg}
    jb = {"tokens": jnp.asarray(toks[:, :SEQ])}
    tb = {"tokens": torch.from_numpy(toks[:, :SEQ])}

    x, pos = JM._embed_inputs(params, jb, jcfg)
    out["j_hidden"] = _np32(JM.backbone(params, x, pos, jcfg)[0])
    x, pos = M._embed_inputs(model, tb)
    out["t_hidden"] = _t(M.backbone(model, x, pos))

    jcache, jlog = JM.prefill(params, jb, jcfg, MAX_LEN)
    tcache, tlog = M.prefill(model, tb, MAX_LEN)
    out.update(j_cache={n: _np32(t) for n, t in jcache.items()},
               t_cache={n: t.clone() for n, t in tcache.items()},
               j_logits=_np32(jlog), t_logits=_t(tlog))

    # decode from the reference's prefill cache on both sides: f32 entries
    # under f32 parameters (R6), the reference's dtypes under bf16
    if dtype == "f32":
        jcache = {n: t if n == "length" else t.astype(jnp.float32)
                  for n, t in jcache.items()}
    tcache = {n: torch.tensor(_np32(t)).to(
        torch.int32 if n == "length" else
        torch.float32 if dtype == "f32" else tcache[n].dtype)
        for n, t in jcache.items()}
    jl, tl = [], []
    jdecode = jax.jit(lambda p, c, b: JM.decode_step(p, c, b, jcfg))
    for i in range(STEPS):
        nxt = toks[:, SEQ + i:SEQ + i + 1]
        l1, jcache = jdecode(params, jcache, {"tokens": jnp.asarray(nxt)})
        l2, tcache = M.decode_step(model, tcache,
                                   {"tokens": torch.from_numpy(nxt)})
        jl.append(_np32(l1))
        tl.append(_t(l2))
    out.update(j_decode=jl, t_decode=tl,
               j_state={n: _np32(t) for n, t in jcache.items()},
               t_state=tcache)
    return out


def test_backbone_hidden_states(run):
    _close(run["t_hidden"], run["j_hidden"], TOL[run["dtype"]])


def test_prefill_last_logits(run):
    assert run["t_logits"].shape == (B, 1, run["cfg"].vocab)
    _close(run["t_logits"], run["j_logits"], TOL[run["dtype"]])


def test_prefill_cache_entries(run):
    """Every entry of the reference's cache, in its dtype and shape; the
    K/V past the prompt zero."""
    jc, tc = run["j_cache"], run["t_cache"]
    assert sorted(jc) == sorted(tc)
    assert int(tc["length"]) == int(jc["length"]) == SEQ
    ref_dtypes = {n: str(t.dtype) for n, t in JM.make_cache(
        jax_get(run["arch"]).reduced(), B, MAX_LEN).items()}
    for name, got in tc.items():
        assert str(got.dtype).split(".")[-1] == ref_dtypes[name], name
        if name == "length":
            continue
        if name in ("k", "v"):
            assert not got[:, :, SEQ:].any()
        bf16 = got.dtype == torch.bfloat16
        _close(_t(got), jc[name], TOL[run["dtype"]],
               ulp=bf16 and run["dtype"] == "f32")


def test_decode_steps_logits(run):
    for got, ref in zip(run["t_decode"], run["j_decode"]):
        _close(got, ref, TOL[run["dtype"]])


def test_decode_steps_states(run):
    js, ts = run["j_state"], run["t_state"]
    assert sorted(js) == sorted(ts)
    assert int(ts["length"]) == int(js["length"]) == SEQ + STEPS
    for name, got in ts.items():
        if name != "length":
            _close(_t(got), js[name], TOL[run["dtype"]])


LOSS_TOL = {"f32": (1e-5, 1e-4), "bf16": (1e-3, None)}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch, dtype):
    """The train forward shares ``layer_step`` with prefill; under f32 every
    gradient leaf, under bf16 the loss."""
    jcfg, cfg = _cfgs(arch)
    params, model = _jparams(arch, dtype), _model(arch, dtype)
    toks = _tokens(cfg, 3)
    tgt = np.roll(toks, -1, axis=1)
    tgt[:, -3:] = -1
    batch = {"tokens": toks, "targets": tgt}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    loss_tol, leaf_tol = LOSS_TOL[dtype]
    if leaf_tol is None:
        loss_ref = JM.loss_fn(params, jbatch, jcfg)
        loss = M.loss_fn(model, {k: torch.from_numpy(v)
                                 for k, v in batch.items()})
    else:
        loss_ref, g_ref = jax.value_and_grad(JM.loss_fn)(params, jbatch,
                                                         jcfg)
        model.requires_grad_(True)
        loss = M.loss_fn(model, {k: torch.from_numpy(v)
                                 for k, v in batch.items()})
        paths, leaves = zip(*model.named_leaves())
        grads = torch.autograd.grad(loss, leaves)
        g_ref = _jflat(g_ref)
        assert sorted(g_ref) == list(paths)
        for path, g in zip(paths, grads):
            assert _rel(_t(g), _np32(g_ref[path])) < leaf_tol, path
    assert abs(float(loss.detach()) - float(loss_ref)) \
        <= loss_tol * float(loss_ref)


# --------------------------------------------------------------------------
# Serving
# --------------------------------------------------------------------------
def _requests(cfg, cls, n=5, new=6):
    rng = np.random.default_rng(4)
    return [cls(i, rng.integers(2, cfg.vocab, size=int(rng.integers(
                4, 30))).astype(np.int32), max_new_tokens=new)
            for i in range(n)]


def _f32_cache(monkeypatch):
    """The port's caches f32 (the f32 parameters' values kept)."""
    make_cache = M.make_cache
    monkeypatch.setattr(M, "make_cache", lambda *a, **k: {
        n: t if n == "length" else t.float()
        for n, t in make_cache(*a, **k).items()})


def test_rwkv_engine_matches_reference_engine(monkeypatch):
    """f32 parameters, f32 caches on both sides (the reference's prefill
    cache cast to f32, R6): every greedy token the reference engine's."""
    arch = "rwkv6-3b"
    jcfg, cfg = _cfgs(arch)
    params = _jparams(arch, "f32")
    prefill = JM.prefill

    def prefill_f32_cache(*args, **kwargs):
        cache, logits = prefill(*args, **kwargs)
        return {n: t if n == "length" else t.astype(jnp.float32)
                for n, t in cache.items()}, logits

    monkeypatch.setattr(JM, "prefill", prefill_f32_cache)
    ref = JServeEngine(jcfg, params, batch_lanes=2, max_len=64).generate(
        _requests(cfg, JRequest))
    monkeypatch.setattr(JM, "prefill", prefill)
    _f32_cache(monkeypatch)
    got = ServeEngine(cfg, _model(arch, "f32"), batch_lanes=2,
                      max_len=64).generate(_requests(cfg, Request))
    assert got == ref
    assert all(len(t) == 6 for t in got.values())


def test_hybrid_engine_matches_reference_prefill_oracle(monkeypatch):
    """f32 parameters and caches: each greedy token is the argmax of the
    reference's forward over the wave's tokens before it."""
    arch = "zamba2-1.2b"
    jcfg, cfg = _cfgs(arch)
    params = _jparams(arch, "f32")
    _f32_cache(monkeypatch)
    reqs = _requests(cfg, Request)
    got = ServeEngine(cfg, _model(arch, "f32"), batch_lanes=2,
                      max_len=64).generate(reqs)
    for w in range(0, len(reqs), 2):
        wave = reqs[w:w + 2]
        Sw = max(len(r.prompt) for r in wave)
        seq = np.zeros((len(wave), Sw + 6), np.int32)
        for j, r in enumerate(wave):
            seq[j, Sw - len(r.prompt):Sw] = r.prompt
            seq[j, Sw:] = got[r.rid]
        x, pos = JM._embed_inputs(params, {"tokens": jnp.asarray(seq)}, jcfg)
        logits = np.asarray(JM._logits(params, JM.backbone(
            params, x, pos, jcfg)[0], jcfg))[:, Sw - 1:Sw + 5]
        for j, r in enumerate(wave):
            assert logits[j].argmax(-1).tolist() == got[r.rid], r.rid


def test_rwkv_engine_serves_past_max_len():
    """RWKV's cache has no positions: a wave longer than ``max_len`` serves
    (the reference's does too); the hybrid's K/V must fit it."""
    for arch, ok in (("rwkv6-3b", True), ("zamba2-1.2b", False)):
        cfg = get(arch).reduced()
        engine = ServeEngine(cfg, _model(arch), batch_lanes=1, max_len=8)
        req = [Request(0, np.arange(2, 12, dtype=np.int32), 3)]
        if ok:
            assert len(engine.generate(req)[0]) == 3
        else:
            with pytest.raises(ValueError, match="max_len"):
                engine.generate(req)


# --------------------------------------------------------------------------
# Init, caches and refusals
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_special_leaves_follow_the_reference_rules(arch):
    jcfg, cfg = _cfgs(arch)
    model = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ref = {p: _np32(a) for p, a in _jflat(_jinit(arch)).items()}
    got = {p: _t(t) for p, t in model.named_leaves()}
    assert sorted(got) == sorted(ref)
    seen = set()
    for path, a in got.items():
        leaf = path.split("/")[-1]
        assert a.shape == ref[path].shape, path
        if leaf == "A_log":
            # log U[1, 16], rounded to bf16
            assert (a >= 0).all() and (a <= math.log(16) * 1.004).all()
            assert a.std() > 0.1
        elif leaf == "dt_bias":
            dt = np.log1p(np.exp(a))      # the softplus of it
            assert (dt >= 1e-3 * 0.99).all() and (dt <= 1e-1 * 1.01).all()
        elif leaf == "bonus_u":
            assert 0.06 < a.std() < 0.14 and abs(a.mean()) < 0.03
        elif leaf in ("D", "w0") or leaf.startswith("mu_") \
                or (a == 0).all():
            # the constant leaves and the zeros are the reference's exactly
            np.testing.assert_array_equal(a, ref[path], err_msg=path)
        else:
            assert a.std() > 0, path
            continue
        seen.add(leaf)
    want = {"rwkv6-3b": {"w0", "bonus_u", "mu_r", "mu_ck"},
            "zamba2-1.2b": {"A_log", "dt_bias", "D"}}[arch]
    assert want <= seen


@pytest.mark.parametrize("arch", ARCHS)
def test_make_cache_matches_reference(arch):
    jcfg, cfg = _cfgs(arch)
    for batch, max_len in ((1, 16), (3, 64)):
        ref = {n: (tuple(t.shape), str(t.dtype))
               for n, t in JM.make_cache(jcfg, batch, max_len).items()}
        got = {n: (tuple(t.shape), str(t.dtype).split(".")[-1])
               for n, t in M.make_cache(cfg, batch, max_len, "cpu").items()}
        assert got == ref
        assert all(not t.any() for t in
                   M.make_cache(cfg, batch, max_len, "cpu").values())
    assert M.cache_axes(cfg) == JM.cache_axes(jcfg)


def test_rwkv_cache_bytes_do_not_depend_on_max_len():
    cfg = get("rwkv6-3b")

    def nbytes(max_len):
        c = M.make_cache(cfg.reduced(), 2, max_len, "cpu")
        return sum(t.numel() * t.element_size() for t in c.values())

    assert nbytes(16) == nbytes(524288)


def test_hybrid_under_kv_quant_is_refused():
    """R7: the reference builds a hybrid cache without scales and decodes
    it through the int8 attention without them, which fails; the port
    refuses the config."""
    cfg = get("zamba2-1.2b").reduced().replace(kv_quant=True)
    for call in (lambda: M.init_params(cfg, torch.Generator(), "cpu"),
                 lambda: M.make_cache(cfg, 1, 8, "cpu"),
                 lambda: M.cache_axes(cfg)):
        with pytest.raises(ValueError, match="R7"):
            call()
    # RWKV ignores kv_quant, as in the reference
    rcfg = get("rwkv6-3b").reduced().replace(kv_quant=True)
    assert sorted(M.make_cache(rcfg, 1, 8, "cpu")) == \
        sorted(JM.make_cache(jax_get("rwkv6-3b").reduced().replace(
            kv_quant=True), 1, 8))


def test_hybrid_prompt_shorter_than_the_conv_state_is_refused():
    """R7: under ``ssm_conv - 1`` tokens the reference's conv state is
    short and its decode fails; the port's prefill raises."""
    jcfg, cfg = _cfgs("zamba2-1.2b")
    toks = np.array([[5, 6]], np.int32)
    with pytest.raises(ValueError, match="R7"):
        M.prefill(_model("zamba2-1.2b"), {"tokens": torch.from_numpy(toks)},
                  8)
    params = _jparams("zamba2-1.2b")
    jcache, _ = JM.prefill(params, {"tokens": jnp.asarray(toks)}, jcfg, 8)
    assert jcache["conv"].shape[2] == 2 < cfg.ssm_conv - 1
    with pytest.raises(Exception):
        JM.decode_step(params, jcache, {"tokens": jnp.asarray(toks[:, :1])},
                       jcfg)
    # at ssm_conv - 1 tokens the port serves
    cache, _ = M.prefill(_model("zamba2-1.2b"),
                         {"tokens": torch.tensor([[5, 6, 7]])}, 8)
    assert int(cache["length"]) == 3
