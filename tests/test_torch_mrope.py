"""The port's M-RoPE and the VLM / audio prefix embeddings against the JAX
package's, on the CPU.

* ``apply_rope`` and ``apply_mrope`` on seeded f32 inputs (head dims 32 and
  128, the reduced and full ``mrope_sections``, positions up to 4096):
  within 1e-6 of the inputs' largest magnitude.  Both rotate in f32; the
  two libraries' f32 ``cos`` and ``sin`` agree to a few ulps (2**-24
  relative) at these angles, and each output sums two products of them.
  In bf16 the outputs round once to bf16 on both sides: within one bf16
  ulp (2**-7 |ref|) plus the same 1e-6.
* ``qwen2-vl-2b`` (M-RoPE over ``positions3``, patch embeddings) and
  ``musicgen-medium`` (conditioning frames) reduced, from the reference's
  ``init_params(PRNGKey(0))`` carried across, on the reference's own
  ``dummy_batch`` (its vision stub's image-grid positions): the prefill
  caches, the last prefill logits and one ``decode_step``'s logits within
  ``tests/test_torch_model.py``'s tolerances (f32 1e-4 of the scale, the
  caches plus one bf16 ulp of each value; bf16 5e-2).  The reference cannot
  decode f32 parameters over its bf16 cache (ROADMAP R6): under f32 both
  sides decode over the reference's prefill cache cast to f32.
* The port's own ``decode == prefill(n + 1)`` with the prefix: in bf16 at
  the reference test's tolerances (``tests/test_models.py:61-86``: 5e-2
  for ``qwen2-vl-2b``, 1e-3 for ``musicgen-medium``); under f32
  parameters prefill attends over f32 keys and values and the decode step
  over their bf16 copies, so at ``tests/test_torch_model.py``'s 1e-2 (or
  the reference test's, where larger).
* The serving engine passes tokens only, as the reference's: an M-RoPE
  config raises naming the model-level path, an audio config serves
  without its frames.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jax_get
from repro.configs.shapes import dummy_batch as jax_dummy_batch
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.configs import get
from repro_torch.convert import model_params_from_numpy
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.serve.engine import Request, ServeEngine

TOL = {"f32": 1e-4, "bf16": 5e-2}
OWN_TOL = {"qwen2-vl-2b": 5e-2, "musicgen-medium": 1e-3}
B, S, MAX_LEN = 2, 48, 64


def _np(tree):
    return jax.tree.map(lambda x: np.asarray(
        x, np.float32 if x.dtype == jnp.bfloat16 else x.dtype), tree)


def _t(x):
    return x.detach().to(torch.float32).numpy()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("hd,sections", [(32, (8, 4, 4)),
                                         (128, (32, 16, 16)),
                                         (128, None)])
def test_rope_and_mrope_match_reference(hd, sections, dtype):
    rng = np.random.default_rng(hd)
    x = rng.normal(size=(2, 40, 3, hd)).astype(np.float32)
    jd, td = (jnp.float32, torch.float32) if dtype == "f32" else \
        (jnp.bfloat16, torch.bfloat16)
    jx = jnp.asarray(x, jd)
    tx = torch.from_numpy(np.array(jx, np.float32)).to(td)
    if sections is None:
        pos = rng.integers(0, 4096, size=(2, 40)).astype(np.int32)
        ref = JL.apply_rope(jx, jnp.asarray(pos), 1e6)
        got = L.apply_rope(tx, torch.from_numpy(pos), 1e6)
    else:
        pos = rng.integers(0, 4096, size=(2, 40, 3)).astype(np.int32)
        ref = JL.apply_mrope(jx, jnp.asarray(pos), 1e6, sections)
        got = L.apply_mrope(tx, torch.from_numpy(pos), 1e6, sections)
    ref = np.asarray(ref, np.float32)
    assert got.dtype == td
    tol = 1e-6 * np.abs(x).max()
    if dtype == "bf16":
        tol = tol + 2.0 ** -7 * np.abs(ref)
    assert (np.abs(_t(got) - ref) <= tol).all()


def test_mrope_sections_must_cover_half_the_head():
    with pytest.raises(ValueError, match="mrope_sections"):
        L.apply_mrope(torch.zeros(1, 2, 1, 32), torch.zeros(1, 2, 3),
                      1e6, (8, 4, 2))


def _batch(jb, n_text=None, n_prefix=0):
    """A slice of the reference's batch, as numpy: the first ``n_text``
    tokens and their positions (after the prefix)."""
    out = {"tokens": np.array(jb["tokens"])[:, :n_text]}
    if "prefix_embeds" in jb:
        out["prefix_embeds"] = np.array(jb["prefix_embeds"], np.float32)
    if "positions3" in jb:
        end = None if n_text is None else n_text + n_prefix
        out["positions3"] = np.array(jb["positions3"])[:, :end]
    return out


def _torch_batch(b, dtype=torch.bfloat16):
    out = {"tokens": torch.from_numpy(b["tokens"])}
    if "prefix_embeds" in b:
        out["prefix_embeds"] = torch.from_numpy(b["prefix_embeds"]).to(dtype)
    if "positions3" in b:
        out["positions3"] = torch.from_numpy(b["positions3"])
    return out


def _jax_batch(b):
    out = {"tokens": jnp.asarray(b["tokens"])}
    if "prefix_embeds" in b:
        out["prefix_embeds"] = jnp.asarray(b["prefix_embeds"], jnp.bfloat16)
    if "positions3" in b:
        out["positions3"] = jnp.asarray(b["positions3"])
    return out


@pytest.fixture(scope="module", params=[
    (a, d) for a in ("qwen2-vl-2b", "musicgen-medium")
    for d in ("f32", "bf16")], ids=lambda p: f"{p[0]}-{p[1]}")
def pair(request):
    arch, dtype = request.param
    jcfg, cfg = jax_get(arch).reduced(), get(arch).reduced()
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    model = model_params_from_numpy(cfg, _np(params), "cpu")
    if dtype == "f32":
        params = jax.tree.map(lambda x: x.astype(jnp.float32), params)
        model = model.float()
    n_prefix = cfg.n_patch_tokens + cfg.n_cond_tokens
    jb = jax_dummy_batch(jcfg, S + 1, B, "prefill", seed=1)
    nt = S - n_prefix
    full = _batch(jb)
    pre = _batch(jb, nt, n_prefix)
    jcache, jlog = JM.prefill(params, _jax_batch(pre), jcfg, MAX_LEN)
    tcache, tlog = M.prefill(model, _torch_batch(pre), MAX_LEN)
    out = dict(arch=arch, dtype=dtype, model=model, cfg=cfg, full=full,
               pre=pre, nt=nt, n_prefix=n_prefix, j_cache=jcache,
               t_cache={k: v.clone() for k, v in tcache.items()},
               j_logits=np.asarray(jlog, np.float32), t_logits=_t(tlog))
    nxt = {"tokens": full["tokens"][:, nt:nt + 1]}
    if cfg.mrope:
        nxt["positions3"] = full["positions3"][:, S:S + 1]
    if dtype == "f32":
        jcache = dict(jcache, k=jcache["k"].astype(jnp.float32),
                      v=jcache["v"].astype(jnp.float32))
    kv = torch.float32 if dtype == "f32" else torch.bfloat16
    tc = {"length": torch.tensor(S, dtype=torch.int32),
          **{n: torch.from_numpy(np.asarray(jcache[n], np.float32)).to(kv)
             for n in ("k", "v")}}
    jl2, jc2 = JM.decode_step(params, jcache, {
        k: jnp.asarray(v) for k, v in nxt.items()}, jcfg)
    tl2, tc2 = M.decode_step(model, tc, {k: torch.from_numpy(v)
                                         for k, v in nxt.items()})
    out.update(j_decode=np.asarray(jl2, np.float32), t_decode=_t(tl2),
               j_len=int(jc2["length"]), t_len=int(tc2["length"]), nxt=nxt)
    return out


def _close(got, ref, tol):
    scale = max(float(np.abs(ref).max()), 1.0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * scale)


def test_prefix_prefill_cache(pair):
    jc, tc = pair["j_cache"], pair["t_cache"]
    assert int(jc["length"]) == int(tc["length"]) == S
    for name in ("k", "v"):
        ref, got = np.asarray(jc[name], np.float32), _t(tc[name])
        assert got.shape == ref.shape
        assert not got[:, :, S:].any()
        tol = TOL[pair["dtype"]] * np.abs(ref).max()
        if pair["dtype"] == "f32":
            tol = tol + 2.0 ** -7 * np.abs(ref)
        assert (np.abs(got - ref) <= tol).all(), name


def test_prefix_prefill_logits(pair):
    assert pair["t_logits"].shape == (B, 1, pair["cfg"].vocab)
    _close(pair["t_logits"], pair["j_logits"], TOL[pair["dtype"]])


def test_prefix_decode_step_logits(pair):
    assert pair["j_len"] == pair["t_len"] == S + 1
    _close(pair["t_decode"], pair["j_decode"], TOL[pair["dtype"]])


def test_prefix_decode_matches_prefill_on_the_port(pair):
    model, nt = pair["model"], pair["nt"]
    cache, _ = M.prefill(model, _torch_batch(pair["pre"]), MAX_LEN)
    l2, _ = M.decode_step(model, cache, {k: torch.from_numpy(v)
                                         for k, v in pair["nxt"].items()})
    longer = _batch({k: v for k, v in pair["full"].items()}, nt + 1,
                    pair["n_prefix"])
    _, l3 = M.prefill(model, _torch_batch(longer), MAX_LEN)
    tol = OWN_TOL[pair["arch"]]
    _close(_t(l2), _t(l3), max(tol, 1e-2) if pair["dtype"] == "f32" else tol)


def test_mrope_decode_defaults_to_length_positions():
    """Without ``positions3`` a decode step rotates every stream by the
    cache length, as the reference's ``decode_step`` does."""
    cfg = get("qwen2-vl-2b").reduced()
    model = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    jb = jax_dummy_batch(jax_get("qwen2-vl-2b").reduced(), 24, 1, "prefill")
    pre = _torch_batch(_batch(jb))
    outs = []
    for pos in (None, torch.full((1, 1, 3), 24, dtype=torch.int32)):
        cache, _ = M.prefill(model, pre, 32)
        batch = {"tokens": torch.tensor([[5]], dtype=torch.int32)}
        if pos is not None:
            batch["positions3"] = pos
        outs.append(M.decode_step(model, cache, batch)[0])
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


def test_engine_passes_tokens_only():
    reqs = [Request(0, np.arange(2, 9, dtype=np.int32), max_new_tokens=3)]
    cfg = get("qwen2-vl-2b").reduced()
    model = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="prefill and decode_step"):
        ServeEngine(cfg, model, batch_lanes=1, max_len=16).generate(reqs)
    cfg = get("musicgen-medium").reduced()
    model = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    out = ServeEngine(cfg, model, batch_lanes=1, max_len=16).generate(reqs)
    assert len(out[0]) == 3
