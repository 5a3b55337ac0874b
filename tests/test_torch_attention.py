"""The port's attention kernels' plain versions
(``repro_torch.kernels.{flash,decode}_attention``) against the JAX package's
Pallas kernels run in interpret mode, on the CPU.

Inputs are made with numpy from a seed and cast to each side's dtype (the
same f32 values rounded to bf16 alike on both sides).  Tolerances are the
reference's own for its kernels against their oracles
(``tests/test_kernels.py``): flash attention 2e-5 in f32 and 3e-2 in bf16
(the port's plain version scales q after the dot, the Pallas kernel before
it, and the two sum in other orders; in bf16 the outputs round to bf16, an
ulp of 2**-7 relative); decode attention 1e-5 in f32 and 3e-2 in bf16.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import \
    decode_attention as jax_decode_attention
from repro.kernels.flash_attention.ops import \
    flash_attention as jax_flash_attention
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.kernel import tma_misalignment
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import mha_causal_ref

DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2, 3e-2)}


def _pair(rng, shape, dtype):
    x = rng.normal(size=shape).astype(np.float32)
    jd, td = DTYPES[dtype][:2]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


# the reference's sweep, tests/test_kernels.py:172-176, then head dims
# between the card kernels' compiled widths and a multi-query group
@pytest.mark.parametrize("B,S,H,K,d", [
    (2, 256, 4, 4, 64),     # MHA
    (1, 512, 8, 2, 128),    # GQA 4:1, d=128
    (2, 384, 6, 3, 64),     # GQA 2:1, non-pow2 S
    (1, 128, 2, 1, 128),    # MQA
    (1, 256, 4, 4, 80),     # phi-2's head dim
    (1, 256, 4, 2, 96),     # Phi-3-mini's
    (1, 256, 2, 1, 256),    # Gemma's
    (1, 128, 48, 1, 32),    # StarCoder's group: 48 query heads a kv head
])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_attention_matches_pallas_interpret(B, S, H, K, d, dtype):
    rng = np.random.default_rng(B * 1000 + S + H + d)
    jq, tq = _pair(rng, (B, S, H, d), dtype)
    jk, tk = _pair(rng, (B, S, K, d), dtype)
    jv, tv = _pair(rng, (B, S, K, d), dtype)
    ref = jax_flash_attention(jq, jk, jv, impl="interpret")
    got = flash_attention(tq, tk, tv)
    assert got.dtype == tq.dtype and got.shape == (B, S, H, d)
    np.testing.assert_allclose(_np(got), _np(ref), atol=DTYPES[dtype][2],
                               rtol=0)


@pytest.mark.parametrize("S", [1, 200, 333])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_attention_ragged_matches_oracle(S, dtype):
    """S not a multiple of any tile (the Pallas kernel asserts S % bq == 0;
    the engine prefills at the wave's longest prompt): against the
    reference's oracle ``impl="ref"``."""
    rng = np.random.default_rng(S)
    jq, tq = _pair(rng, (2, S, 6, 64), dtype)
    jk, tk = _pair(rng, (2, S, 2, 64), dtype)
    jv, tv = _pair(rng, (2, S, 2, 64), dtype)
    ref = jax_flash_attention(jq, jk, jv, impl="ref")
    np.testing.assert_allclose(_np(flash_attention(tq, tk, tv)), _np(ref),
                               atol=DTYPES[dtype][2], rtol=0)


def test_flash_attention_is_causal():
    """Changing the future never changes the past."""
    rng = np.random.default_rng(7)
    _, q = _pair(rng, (1, 200, 4, 32), "f32")
    _, k = _pair(rng, (1, 200, 2, 32), "f32")
    _, v = _pair(rng, (1, 200, 2, 32), "f32")
    o1 = flash_attention(q, k, v)
    k2, v2 = k.clone(), v.clone()
    k2[:, 120:] = 1e4
    v2[:, 120:] = -1e4
    o2 = flash_attention(q, k2, v2)
    torch.testing.assert_close(o1[:, :120], o2[:, :120], rtol=0, atol=0)
    torch.testing.assert_close(mha_causal_ref(q, k, v), o1, rtol=0, atol=0)


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("make,why", [
    (lambda: _bf16(2, 8, 4, 64), None),
    (lambda: _bf16(2, 8, 8, 64)[:, :, 4:6], None),   # a head slice of qkv
    (lambda: _bf16(1, 8, 2, 72)[..., 1:65], "base address"),
    (lambda: _bf16(1, 8, 2, 68)[..., :64], "stride of 136 bytes"),
], ids=["contiguous", "head-slice", "base-off-by-one", "stride-136"])
def test_flash_kernel_tma_alignment_rule(make, why):
    """The bf16 kernel's TMA maps need 16-byte bases and batch, sequence and
    head strides; the wrapper names what breaks the rule before launching
    (on the card it raises ValueError with this reason)."""
    got = tma_misalignment(make())
    assert got == why if why is None else why in got


# the reference's sweep, tests/test_kernels.py:202-207, then head dims
# between the card kernel's compiled widths and multi-query groups
@pytest.mark.parametrize("B,S,H,K,d,length", [
    (2, 1024, 8, 2, 64, 700),
    (1, 2048, 4, 4, 128, 2048),
    (3, 512, 6, 2, 64, 1),
    (2, 512, 8, 8, 64, 311),
    (2, 512, 4, 4, 80, 300),
    (1, 512, 8, 2, 96, 512),
    (2, 512, 2, 1, 256, 200),
    (2, 512, 48, 1, 64, 311),     # StarCoder's group
    (1, 512, 71, 1, 40, 123),     # falcon-7b's group
])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decode_attention_matches_pallas_interpret(B, S, H, K, d, length,
                                                   dtype):
    rng = np.random.default_rng(B * 1000 + S + length)
    jq, tq = _pair(rng, (B, H, d), dtype)
    jk, tk = _pair(rng, (B, S, K, d), dtype)
    jv, tv = _pair(rng, (B, S, K, d), dtype)
    ref = jax_decode_attention(jq, jk, jv, jnp.int32(length),
                               impl="interpret")
    got = decode_attention(tq, tk, tv, torch.tensor(length,
                                                    dtype=torch.int32))
    assert got.dtype == tq.dtype and got.shape == (B, H, d)
    np.testing.assert_allclose(_np(got), _np(ref), atol=DTYPES[dtype][3],
                               rtol=0)


@pytest.mark.parametrize("dtype,d,want", [
    # (width, elements a lane, lanes a row, active lanes, last lane's share)
    (torch.bfloat16, 96, (128, 8, 16, 12, 8)),   # 4 of 16 lanes off
    (torch.float32, 96, (128, 4, 32, 24, 4)),
    (torch.int8, 96, (128, 16, 8, 6, 16)),
    (torch.float32, 256, (256, 8, 32, 32, 8)),   # two 16-byte loads a lane
    (torch.bfloat16, 256, (256, 8, 32, 32, 8)),
    (torch.int8, 256, (256, 16, 16, 16, 16)),
    (torch.int8, 40, (64, 16, 4, 3, 8)),         # a lane half below d
    (torch.float32, 8, (32, 4, 8, 2, 4)),
    (torch.bfloat16, 64, (64, 8, 8, 8, 8)),      # the served width as before
])
def test_decode_lane_layout(dtype, d, want):
    """The decode kernel's row layout, mirrored on the CPU: a row group is
    a power of two of at most 32 lanes (the xor butterfly's), its active
    lanes cover d exactly, and a lane past d loads nothing."""
    from repro_torch.kernels.decode_attention.kernel import lane_layout

    got = lane_layout(dtype, d)
    assert tuple(got[k] for k in ("width", "elements", "lanes", "active",
                                  "last")) == want
    lanes = got["lanes"]
    assert lanes <= 32 and lanes & (lanes - 1) == 0
    assert (got["active"] - 1) * got["elements"] + got["last"] == d
    assert got["width"] == got["lanes"] * got["elements"]


def test_decode_attention_ignores_tail_garbage():
    """Entries past ``length`` must not affect the result
    (tests/test_kernels.py:220-230)."""
    rng = np.random.default_rng(0)
    _, q = _pair(rng, (1, 4, 64), "f32")
    _, kc = _pair(rng, (1, 512, 2, 64), "f32")
    _, vc = _pair(rng, (1, 512, 2, 64), "f32")
    o1 = decode_attention(q, kc, vc, 100)
    kc2, vc2 = kc.clone(), vc.clone()
    kc2[:, 100:] = 1e9
    vc2[:, 100:] = -1e9
    o2 = decode_attention(q, kc2, vc2, 100)
    np.testing.assert_allclose(o1.numpy(), o2.numpy(), atol=1e-6)


def test_decode_attention_f32_query_over_bf16_cache():
    """The model's caches stay bf16 under f32 parameters: the plain version
    reads them as f32, as the Pallas kernel does."""
    rng = np.random.default_rng(3)
    _, q = _pair(rng, (2, 6, 32), "f32")
    _, kc = _pair(rng, (2, 64, 3, 32), "bf16")
    _, vc = _pair(rng, (2, 64, 3, 32), "bf16")
    got = decode_attention(q, kc, vc, 40)
    ref = jax_decode_attention(jnp.asarray(q.numpy()),
                               jnp.asarray(kc.float().numpy()),
                               jnp.asarray(vc.float().numpy()),
                               jnp.int32(40), impl="interpret")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _np(ref), atol=1e-5, rtol=0)


@pytest.mark.parametrize("length", [0, -3, torch.tensor(0)])
def test_decode_attention_rejects_empty_prefix(length):
    """With no valid position the reference gives NaN; the port raises."""
    q = torch.zeros(1, 2, 32)
    kc = torch.zeros(1, 8, 2, 32)
    with pytest.raises(ValueError, match="length >= 1"):
        decode_attention(q, kc, kc, length)
