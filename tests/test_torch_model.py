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


# (arch, config overrides, what the backbone's refusal names): the
# all-to-all expert layer builds, and its backbone without a mesh is a
# ValueError naming the mesh; the dry-run's attention stand-in builds (None)
# and is held to the reference's forward
REFUSED = {"moonshot-v1-16b-a3b": ({"moe_impl": "a2a"}, "mesh"),
           "zamba2-1.2b": ({"attn_impl": "kernel_stub"}, None),
           "qwen2-vl-2b": ({"attn_impl": "kernel_stub"}, None),
           "musicgen-medium": ({"attn_impl": "kernel_stub"}, None)}


def _stub_batches(jcfg, seed=1):
    """The reference's ``dummy_batch`` for a prefill of S positions (prefix
    included), as JAX and as torch inputs."""
    from repro.configs.shapes import dummy_batch as jax_dummy_batch

    jb = jax_dummy_batch(jcfg, S, B, "prefill", seed=seed)
    jb = {k: v for k, v in jb.items() if k != "targets"}
    tb = {}
    for k, v in jb.items():
        a = np.array(v, np.float32 if v.dtype == jnp.bfloat16 else v.dtype)
        tb[k] = torch.from_numpy(a).to(torch.bfloat16) \
            if v.dtype == jnp.bfloat16 else torch.from_numpy(a)
    return jb, tb


@pytest.mark.parametrize("arch", sorted(REFUSED))
def test_unported_families_raise(arch):
    """The all-to-all expert layer (``moe_impl="a2a"``) builds, its cache
    too; its backbone without a current mesh is a ``ValueError`` (its
    parity on the mesh is tests/test_torch_sharded.py's), and its prefill
    runs the experts on one device, as the reference's does: the logits
    agree with the reference's prefill.  The dry-run's
    ``attn_impl="kernel_stub"`` builds, and its backbone's logits under f32
    parameters carried over from the reference agree with the reference's
    own ``kernel_stub`` backbone within the f32 tolerance (the stand-in is
    elementwise; the products sum in another order).  Its prefill runs the
    attention, as the reference's does whatever ``attn_impl`` says."""
    from repro_torch.sharding import set_current_mesh

    overrides, item = REFUSED[arch]
    cfg = get(arch).reduced().replace(**overrides)
    jcfg = jax_get(arch).reduced().replace(**overrides)
    params = jax.tree.map(
        lambda x: np.asarray(x, np.float32),
        JM.init_params(jcfg, jax.random.PRNGKey(0)))
    jparams = jax.tree.map(jnp.asarray, params)
    model = model_params_from_numpy(cfg, params, "cpu").float()
    jb, tb = _stub_batches(jcfg)
    x, pos = M._embed_inputs(model, tb)
    if item is not None:
        set_current_mesh(None)
        M.make_cache(cfg, 1, 8, "cpu")
        with pytest.raises(ValueError, match=item):
            M.backbone(model, x, pos)
    else:
        jx, jpos = JM._embed_inputs(jparams, jb, jcfg)
        ref = JM._logits(jparams, JM.backbone(jparams, jx, jpos, jcfg)[0],
                         jcfg)
        got = M._logits(model, M.backbone(model, x, pos))
        assert got.shape == (B, S, cfg.vocab)
        _close(_t(got), np.asarray(ref, np.float32), TOL["f32"])
    _, jlog = JM.prefill(jparams, jb, jcfg, MAX_LEN)
    _, tlog = M.prefill(model, tb, MAX_LEN)
    _close(_t(tlog), np.asarray(jlog, np.float32), TOL["f32"])


def test_kernel_stub_attention_block_is_bitwise():
    """The port's attention block under ``kernel_stub`` against the
    reference's, bit for bit in f32: identity projections and positions 0
    (RoPE's angles 0) leave only the stand-in's arithmetic, which both
    sides do in the same order."""
    from repro.models import layers as JL
    from repro_torch.models import layers as L

    cfg = get("granite-3-2b").reduced().replace(attn_impl="kernel_stub")
    jcfg = jax_get("granite-3-2b").reduced().replace(attn_impl="kernel_stub")
    H, K, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_model
    eye = np.eye(d, dtype=np.float32)
    p = {"wq": eye[:, :H * hd], "wk": eye[:, :K * hd],
         "wv": eye[:, K * hd:2 * K * hd], "wo": eye[:H * hd]}
    x = np.random.default_rng(5).normal(size=(B, S, d)).astype(np.float32)
    pos = np.zeros((B, S), np.int32)
    ref = JL.attention_block(jnp.asarray(x), {k: jnp.asarray(v)
                                              for k, v in p.items()},
                             jcfg, jnp.asarray(pos))
    got, _, _ = L.attention_block(torch.from_numpy(x), {
        k: torch.from_numpy(v) for k, v in p.items()}, cfg,
        torch.from_numpy(pos))
    assert np.array_equal(_t(got).view(np.int32),
                          np.asarray(ref, np.float32).view(np.int32))


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


# configs drawn at full width on the card before the sliced draw
CARD_DRAWN = ("paper-scorer", "internlm2-1.8b", "qwen2-vl-2b",
              "musicgen-medium", "olmoe-1b-7b", "rwkv6-3b", "zamba2-1.2b")


def _whole_draw(cfg, generator):
    """``init_params``' draw as it was before leaves could be sliced: each
    leaf one f32 draw, scaled, cast."""
    import math

    flat = {}
    for path, spec in sorted(M.model_specs(cfg).items()):
        special = M._special_init(path, spec, generator)
        if special is not None:
            flat[path] = special.to(spec.dtype)
        elif spec.fan_in == 0:
            flat[path] = torch.zeros(spec.shape, dtype=spec.dtype)
        else:
            w = torch.randn(spec.shape, generator=generator,
                            dtype=torch.float32)
            w *= 1.0 / math.sqrt(max(spec.fan_in, 1))
            flat[path] = w.to(spec.dtype)
    return flat


def test_sliced_draw_is_the_whole_draw_on_a_cpu_generator(monkeypatch):
    """On a CPU generator ``torch.randn`` fills its uniforms in order and
    transforms them in blocks of 16, so slices of a multiple of 16 elements
    give the whole draw bit for bit, and leave the generator where the
    whole draw does."""
    from repro_torch.models.layers import ParamSpec

    spec = ParamSpec((3, 4, 32, 48), (None,) * 4, fan_in=32)
    whole_gen = torch.Generator().manual_seed(7)
    whole = M._normal_leaf(spec, whole_gen, torch.device("cpu"), 0)
    monkeypatch.setattr(M, "_device_bytes", lambda device: 0)
    sliced_gen = torch.Generator().manual_seed(7)
    sliced = M._normal_leaf(spec, sliced_gen, torch.device("cpu"), 0)
    assert torch.equal(whole.view(torch.int16), sliced.view(torch.int16))
    assert torch.equal(torch.randn(5, generator=whole_gen),
                       torch.randn(5, generator=sliced_gen))


def test_reduced_moonshot_draw_is_unchanged_by_slicing(monkeypatch):
    """Every leaf of a reduced ``moonshot-v1-16b-a3b`` drawn a slice at a
    time equals the whole draw of before, leaf for leaf."""
    cfg = get("moonshot-v1-16b-a3b").reduced()
    before = _whole_draw(cfg, torch.Generator().manual_seed(3))
    monkeypatch.setattr(M, "_device_bytes", lambda device: 0)
    model = M.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    for path, leaf in model.named_leaves():
        assert torch.equal(leaf.view(torch.int16),
                           before[path].view(torch.int16)), path


def test_only_moonshots_experts_are_sliced_on_an_80_gb_card():
    """At full width ``moonshot-v1-16b-a3b`` has 28057995264 parameters
    (56.1 GB in bf16); each expert leaf (48, 64, 2048, 1408) is 35.4 GB as
    one f32 draw, which does not fit beside them on an 80 GB card, so those
    three leaves are drawn a layer at a time (738 MB of f32 a slice).  No
    leaf of a config the card drew before is sliced, so their draws stay
    what they were."""
    card = 80 * 2 ** 30
    cfg = get("moonshot-v1-16b-a3b")
    assert M.n_params(cfg) == 28057995264
    specs = M.model_specs(cfg)
    params = sum(2 * np.prod(s.shape) for s in specs.values())
    sliced = sorted(p for p, s in specs.items()
                    if M._drawn_in_slices(s, params, card))
    assert sliced == ["layers/moe/wi_gate", "layers/moe/wi_up",
                      "layers/moe/wo"]
    assert 4 * np.prod(specs["layers/moe/wi_gate"].shape) == 35433480192
    for arch in CARD_DRAWN:
        specs = M.model_specs(get(arch))
        params = sum(s.dtype.itemsize * np.prod(s.shape)
                     for s in specs.values())
        assert not any(M._drawn_in_slices(s, params, card)
                       for s in specs.values()), arch
