"""Every head dim the Pallas attention kernels take, on the port's CPU side.

The Pallas kernels (``repro/kernels/flash_attention/kernel.py:95-100``,
``repro/kernels/decode_attention/kernel.py:84-88``) block q, k and v with
the whole head dim, so they take any ``d``.  The port's card kernels take
the same domain: up to 256 at the compiled width at or above ``d``, past
256 in column chunks of 256 (``kernels/flash_attention/kernel.py``), bf16
flash from a zero-padded copy of head dim ``8 ceil(d / 8)`` where TMA
cannot read the inputs in place.  Here, on the CPU:

* the plain versions (``mha_causal_ref``, ``decode_attention_ref``)
  against the Pallas kernels in interpret mode at ``d`` in {1, 3, 12, 100,
  264, 320}, with the tolerances of ``tests/test_torch_attention.py``
  (the reference's own for its kernels: flash 2e-5 in f32 and 3e-2 in
  bf16, decode 1e-5 and 3e-2);
* the wrappers' domain: ``width``, ``chunks``, ``f32_plan``, the decode
  ``lane_layout`` and the bf16 staging rule for those ``d``;
* the port's two-layer model at ``head_dim`` 100 and 320 against the
  reference's, from converted parameters: prefill's last logits and one
  decode step over the reference's prefill cache, within 1e-4 of the
  logits' scale under f32 parameters (``tests/test_torch_model.py``'s bar:
  the libraries sum in other orders).

The kernels themselves run only on the card: ``tests/test_torch_cuda.py``
holds them against these plain versions at the same ``d``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jax_get
from repro.kernels.decode_attention.ops import \
    decode_attention as jax_decode_attention
from repro.kernels.flash_attention.ops import \
    flash_attention as jax_flash_attention
from repro.models import model as JM
from repro_torch.configs import get
from repro_torch.convert import model_params_from_numpy
from repro_torch.kernels.decode_attention.kernel import lane_layout
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import model as M

HEAD_DIMS = (1, 3, 12, 100, 264, 320)
DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2, 3e-2)}
MODEL_TOL = 1e-4


def _pair(rng, shape, dtype):
    x = rng.normal(size=shape).astype(np.float32)
    jd, td = DTYPES[dtype][:2]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_plain_matches_pallas_interpret(d, dtype):
    """GQA 2:1 at S = 128, one Pallas block of 64 rows a side past the
    first."""
    B, S, H, K = 1, 128, 4, 2
    rng = np.random.default_rng(d)
    jq, tq = _pair(rng, (B, S, H, d), dtype)
    jk, tk = _pair(rng, (B, S, K, d), dtype)
    jv, tv = _pair(rng, (B, S, K, d), dtype)
    ref = jax_flash_attention(jq, jk, jv, impl="interpret", bq=64, bk=64)
    got = flash_attention(tq, tk, tv)
    assert got.dtype == tq.dtype and got.shape == (B, S, H, d)
    np.testing.assert_allclose(_np(got), _np(ref), atol=DTYPES[dtype][2],
                               rtol=0)


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decode_plain_matches_pallas_interpret(d, dtype):
    """Four query heads over two kv heads, a cache of 128 positions in two
    Pallas blocks of 64, 97 of them valid (garbage past them)."""
    B, S, H, K, length = 2, 128, 4, 2, 97
    rng = np.random.default_rng(1000 + d)
    jq, tq = _pair(rng, (B, H, d), dtype)
    jk, tk = _pair(rng, (B, S, K, d), dtype)
    jv, tv = _pair(rng, (B, S, K, d), dtype)
    ref = jax_decode_attention(jq, jk, jv, jnp.int32(length),
                               impl="interpret", bs=64)
    got = decode_attention(tq, tk, tv, torch.tensor(length,
                                                    dtype=torch.int32))
    assert got.dtype == tq.dtype and got.shape == (B, H, d)
    np.testing.assert_allclose(_np(got), _np(ref), atol=DTYPES[dtype][3],
                               rtol=0)


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_wrapper_domain(d):
    """Up to 256 the least compiled width at or above d, one chunk; past
    it width 256 in ceil(d / 256) chunks, the f32 plan of width 256 with
    the chunks on its grid; no refusal in either route."""
    n = -(-d // 256)
    want = min(w for w in fa_kernel.WIDTHS if w >= d) if d <= 256 else 256
    assert fa_kernel.width(d) == want and fa_kernel.chunks(d) == n
    p = fa_kernel.f32_plan(2, 100, 4, d)
    assert p.width == want and p.chunks == n
    assert p.grid == p.q_tiles * 2 * 4 * n
    assert p.smem_bytes <= fa_kernel.SMEM_LIMIT
    # the grid's blocks cover every (q tile, head, chunk) once
    blocks = np.arange(p.grid)
    qi, head = fa_kernel.f32_block_tile(p, blocks, 8)
    cc = fa_kernel.f32_block_chunk(p, blocks)
    keys = (qi.astype(np.int64) * 8 + head) * n + cc
    assert len(np.unique(keys)) == p.grid and cc.max() == n - 1
    for dt in fa_kernel.DTYPES:
        assert fa_kernel.refusal(dt, 2, 100, 4, 2, d) is None


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16,
                                      torch.int8])
def test_decode_lane_layout_covers_d(d, kv_dtype):
    """The decode kernel's row layout covers each chunk's columns exactly:
    the last chunk's active lanes hold its columns, the last of them any
    part of its share (loaded element by element)."""
    got = lane_layout(kv_dtype, d)
    n = got["chunks"]
    assert n == -(-d // 256)
    rest = d - (n - 1) * 256
    assert (got["active"] - 1) * got["elements"] + got["last"] == rest
    assert 1 <= got["last"] <= got["elements"]
    assert got["active"] <= got["lanes"] <= 32
    assert got["width"] == got["lanes"] * got["elements"] >= rest


@pytest.mark.parametrize("d,view,why", [
    (64, "contiguous", None),
    (12, "contiguous", "multiple of 8"),
    (100, "contiguous", "multiple of 8"),
    (320, "contiguous", None),
    (64, "base", "base address"),
    (64, "stride", "stride of 136 bytes"),
])
def test_bf16_staging_rule(d, view, why):
    """The bf16 kernel reads q, k and v in place when TMA can (a head dim
    of whole 16-byte groups, 16-byte bases and strides), and a staged copy
    of head dim 8 ceil(d / 8) otherwise; the wrapper says why."""
    if view == "contiguous":
        x = torch.zeros(1, 8, 2, d, dtype=torch.bfloat16)
    elif view == "base":
        x = torch.zeros(1, 8, 2, 72, dtype=torch.bfloat16)[..., 1:65]
    else:
        x = torch.zeros(1, 8, 2, 68, dtype=torch.bfloat16)[..., :64]
    got = fa_kernel.bf16_staging(x, x, x)
    assert got == why if why is None else why in got


@pytest.fixture(scope="module", params=[100, 320], ids=lambda d: f"d{d}")
def model_pair(request):
    """The reduced ``paper-scorer`` at ``head_dim`` d (two layers, 4 query
    heads over 2 kv heads), f32, on both sides: prefill's last logits and
    one decode step over the reference's prefill cache."""
    d = request.param
    jcfg = jax_get("paper-scorer").reduced().replace(head_dim=d)
    cfg = get("paper-scorer").reduced().replace(head_dim=d)
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = jax.tree.map(lambda x: x.astype(jnp.float32), params)
    model = model_params_from_numpy(
        cfg, jax.tree.map(lambda x: np.asarray(x, np.float32), params),
        "cpu").float()
    B, S, max_len = 2, 40, 48
    toks = np.random.default_rng(d).integers(2, cfg.vocab, size=(B, S + 1)
                                             ).astype(np.int32)
    jcache, jlog = JM.prefill(params, {"tokens": jnp.asarray(toks[:, :S])},
                              jcfg, max_len)
    _, tlog = M.prefill(model, {"tokens": torch.from_numpy(toks[:, :S])},
                        max_len)
    jcache = dict(jcache, k=jcache["k"].astype(jnp.float32),
                  v=jcache["v"].astype(jnp.float32))
    tcache = {"length": torch.tensor(S, dtype=torch.int32),
              **{n: torch.tensor(_np(jcache[n])) for n in ("k", "v")}}
    nxt = toks[:, S:S + 1]
    jl2, _ = JM.decode_step(params, jcache, {"tokens": jnp.asarray(nxt)},
                            jcfg)
    tl2, _ = M.decode_step(model, tcache, {"tokens": torch.from_numpy(nxt)})
    assert tcache["k"].shape[-1] == d
    return {"prefill": (_np(tlog), _np(jlog)),
            "decode": (_np(tl2), _np(jl2))}


@pytest.mark.parametrize("what", ["prefill", "decode"])
def test_model_at_head_dim_matches_reference(model_pair, what):
    got, ref = model_pair[what]
    assert got.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1.0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=MODEL_TOL * scale)
