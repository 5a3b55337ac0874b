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
  ``lane_layout`` and the bf16 staging rule for those ``d``; past 256 the
  f32 kernel's cluster layout (slab width, cluster size, each slab's
  columns, shared memory, grid) and its slab loop past 8 slabs of 256,
  and the decode kernel's vectors a lane (every column below d held
  once), register cut-offs and ring, its chunked route past 1024;
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
from repro_torch.kernels.decode_attention import kernel as da_kernel
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
    it the f32 plan is a cluster of ``f32_slabs(d)`` slabs (128 or 256
    columns each) on its grid, bf16 and decode chunks of 256; no refusal
    in either route."""
    n = -(-d // 256)
    want = min(w for w in fa_kernel.WIDTHS if w >= d) if d <= 256 else 256
    assert fa_kernel.width(d) == want and fa_kernel.chunks(d) == n
    p = fa_kernel.f32_plan(2, 100, 4, d)
    if d <= 256:
        assert p.width == want and p.chunks == p.cluster == 1
    else:
        assert (p.width, p.chunks) == fa_kernel.f32_slabs(d)
        assert p.cluster == p.chunks > 1
    assert p.grid == p.q_tiles * 2 * 4 * p.chunks
    assert p.smem_bytes <= fa_kernel.SMEM_LIMIT
    # the grid's blocks cover every (q tile, head, slab) once, a cluster's
    # blocks side by side
    blocks = np.arange(p.grid)
    qi, head = fa_kernel.f32_block_tile(p, blocks, 8)
    cc = fa_kernel.f32_block_chunk(p, blocks)
    keys = (qi.astype(np.int64) * 8 + head) * p.chunks + cc
    assert len(np.unique(keys)) == p.grid and cc.max() == p.chunks - 1
    assert np.array_equal(cc, blocks % p.cluster)
    for dt in fa_kernel.DTYPES:
        assert fa_kernel.refusal(dt, 2, 100, 4, 2, d) is None


def _covers_d_once(got: dict, d: int) -> None:
    """Every column below d held by exactly one (vector or chunk, lane,
    element) of the layout, as the kernels map them: lane j's elements of
    vector (or chunk) v at v 256 + j EPL, at j EPL up to 256."""
    n = max(got["vectors"], got["chunks"])
    assert got["width"] == got["lanes"] * got["elements"]
    cols = (np.arange(n)[:, None, None] * got["width"]
            + np.arange(got["lanes"])[None, :, None] * got["elements"]
            + np.arange(got["elements"])[None, None, :]).ravel()
    below = cols[cols < d]
    assert len(below) == d and np.array_equal(np.sort(below), np.arange(d))
    # the last vector's active lanes hold its columns below d, the last of
    # them any part of its share
    rest = d - (n - 1) * got["width"]
    assert (got["active"] - 1) * got["elements"] + got["last"] == rest
    assert 1 <= got["last"] <= got["elements"]
    assert got["active"] <= got["lanes"] <= 32


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16,
                                      torch.int8])
def test_decode_lane_layout_covers_d(d, kv_dtype):
    """The decode kernel's row layout covers every column below d exactly
    once: up to 256 one vector a lane, past it ceil(d / 256) vectors a
    lane and no column chunk on the grid (up to ``MAX_VECTORS``)."""
    got = lane_layout(kv_dtype, d)
    assert (got["vectors"], got["chunks"]) == (-(-d // 256), 1)
    _covers_d_once(got, d)


@pytest.mark.parametrize("d", [257, 512, 600, 1000, 1024, 1025, 2048])
@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16,
                                      torch.int8])
def test_decode_wide_layout(d, kv_dtype):
    """Past 256 up to ``MAX_VECTORS`` vectors a lane: the register cut-off
    (query heads a block, halved while q and the accumulators pass
    ``REG_BUDGET`` registers a thread), the ring's stages and its rows a
    stage; past them the chunked kernel, one vector a lane and a grid index
    a chunk of 256."""
    got = lane_layout(kv_dtype, d)
    n = -(-d // 256)
    _covers_d_once(got, d)
    if n > da_kernel.MAX_VECTORS:
        assert (got["vectors"], got["chunks"]) == (1, n)
        assert "heads" not in got
        return
    assert (got["vectors"], got["chunks"]) == (n, 1)
    size = torch.empty((), dtype=kv_dtype).element_size()
    narrow = da_kernel.NARROW_HEADS[size]
    head = 2 * n * got["elements"]      # q and acc of a head, registers
    assert got["heads"] in (narrow, narrow // 2, 1)
    assert got["heads"] * head <= da_kernel.REG_BUDGET or got["heads"] == 1
    assert got["heads"] == narrow \
        or 2 * got["heads"] * head > da_kernel.REG_BUDGET
    assert got["stages"] == da_kernel.STAGES and got["unroll"] >= 1
    # a stage's rows within about STAGE_BYTES (twice over int8)
    vecs = got["elements"] * size // 16
    stage = 16 * (128 // got["lanes"]) * got["unroll"] * 2 * n * vecs \
        * got["lanes"]
    assert stage <= da_kernel.STAGE_BYTES * (2 if size == 1 else 1) \
        or got["unroll"] == 1


# past 256: slabs of 128 where they pad less (264, 320, 640), of 256
# otherwise (512, 1000, 2048), the slab loop past 8 slabs of 256 (2049,
# 4096)
CLUSTER_DIMS = {264: (128, 3), 320: (128, 3), 512: (256, 2),
                640: (128, 5), 1000: (256, 4), 2048: (256, 8),
                2049: (256, 9), 4096: (256, 16)}


@pytest.mark.parametrize("d", sorted(CLUSTER_DIMS))
def test_f32_cluster_plan(d):
    """The f32 kernel past 256 (``flash_attention.cu``'s
    ``launch_cluster``): a cluster of ceil(d / width) blocks a (q tile,
    head) within the portable 8, each block's slab of width columns (the
    last the rest of d), Tile<width>'s shared memory plus the partial
    scores it shares (BQ x BK f32); past 8 slabs of 256 one block a
    cluster, the slab loop's chunks of 256 and no partial scores; the grid
    within ``MAX_GRID_X`` or refused."""
    B, S, H = 2, 1000, 8
    p = fa_kernel.f32_plan(B, S, H, d)
    width, n = CLUSTER_DIMS[d]
    assert (p.width, p.chunks) == (width, n) == fa_kernel.f32_slabs(d)
    threads, bk = fa_kernel.F32_PLANS[width]
    assert (p.threads, p.kv_rows) == (threads, bk)
    assert p.q_rows == 8 * threads // (width // 8)
    assert sum(p.slabs) == d and len(p.slabs) == n
    assert all(w == width for w in p.slabs[:-1]) and 1 <= p.slabs[-1] <= width
    tile = 4 * (width * p.q_rows + bk * (width + 4) + width * bk + bk * width
                + bk * p.q_rows)
    if n <= fa_kernel.MAX_CLUSTER:
        assert p.cluster == n and p.smem_bytes == tile + 4 * bk * p.q_rows
    else:
        assert p.cluster == 1 and p.smem_bytes == tile and width == 256
    assert p.smem_bytes <= fa_kernel.SMEM_LIMIT and p.blocks_per_sm == 1
    assert p.grid == -(-S // p.q_rows) * B * H * n <= fa_kernel.MAX_GRID_X
    # a grid past the one-dimensional limit counts every slab's block
    big = fa_kernel.f32_plan(2 ** 8, 2 ** 20, 2 ** 11, d)
    assert big.grid == big.q_tiles * 2 ** 19 * n > fa_kernel.MAX_GRID_X
    why = fa_kernel.refusal(torch.float32, 2 ** 8, 2 ** 20, 2 ** 11, 2 ** 11,
                            d)
    assert why is not None and "grid" in why


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
