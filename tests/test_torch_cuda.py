"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device: it carries the ``cuda`` marker and
skips (inside its fixture) where there is none, as on a CPU-only machine.
On the card: ``python -m pytest -m cuda tests/test_torch_cuda.py``.  These
tests import neither jax nor the JAX package, so they run where only the
port is installed.

Tolerances: ``pair_scores`` within 1e-5 of ``a @ b.T`` (cuBLAS) — f32 sums of
up to 384 unit-bounded products in another order — with candidate sets
allowed to differ only within 1e-5 of the threshold; bf16 inputs within
2e-2.  ``union_deduce`` and the service: bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.cluster_graph import NEG, POS
from repro_torch.core.crowd import PerfectCrowd
from repro_torch.core.graph import KEY_SENTINEL, _union_impl
from repro_torch.core.pairs import PairSet
from repro_torch.kernels.pair_scores import ops as ps_ops
from repro_torch.kernels.pair_scores.ref import pair_scores_ref
from repro_torch.kernels.union_deduce import kernel as ud_kernel
from repro_torch.kernels.union_deduce.ref import union_deduce_ref
from repro_torch.serve.join_service import JoinService

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("N,M,D", [(4096, 4096, 384), (300, 200, 96),
                                   (128, 128, 32), (1, 129, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pair_scores_kernel_matches_plain(dev, N, M, D, dtype):
    gen = torch.Generator(device="cpu").manual_seed(N + M + D)
    a = torch.randn(N, D, generator=gen).to(dev, dtype)
    b = torch.randn(M, D, generator=gen).to(dev, dtype)
    b[: min(N, M) // 2] = a[: min(N, M) // 2] + 0.3 * b[: min(N, M) // 2]
    launches = ps_ops.pair_scores.launches
    s, c = ps_ops.pair_scores(a, b, 0.5)
    assert ps_ops.pair_scores.launches == launches + 1
    an, bn = ps_ops.l2_normalize(a), ps_ops.l2_normalize(b)
    s_ref, c_ref = pair_scores_ref(an, bn, 0.5)
    torch.cuda.synchronize()
    flips = (s != 0) != (s_ref != 0)
    near = ((an.float() @ bn.float().T) - 0.5).abs() <= 1e-5
    assert not (flips & ~near).any()
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(s[~flips], s_ref[~flips], rtol=0, atol=tol)
    if not flips.any():
        torch.testing.assert_close(c[:, 0], c_ref, rtol=0, atol=0)


def _lanes(dev, n, p, lanes, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(lanes):
        u = torch.from_numpy(rng.integers(0, n, p).astype(np.int32)).to(dev)
        v = torch.from_numpy(rng.integers(0, n, p).astype(np.int32)).to(dev)
        cluster = torch.from_numpy(rng.integers(0, max(2, n // 3), n)).to(dev)
        truth = cluster[u.long()] == cluster[v.long()]
        stage = torch.from_numpy(rng.integers(0, 3, p)).to(dev)
        parent0 = _union_impl(torch.arange(n, dtype=torch.int32, device=dev),
                              u, v, (stage == 0) & truth, n)
        ru, rv = parent0[u.long()], parent0[v.long()]
        keys = torch.minimum(ru, rv) * n + torch.maximum(ru, rv)
        negk = torch.where((stage == 0) & ~truth & (ru != rv), keys,
                           KEY_SENTINEL).sort().values
        noise = torch.from_numpy(rng.random(p) < 0.01).to(dev)
        pos = (stage == 2) & (truth | noise)
        out.append((parent0, u, v, pos, negk))
    return [torch.stack(x) for x in zip(*out)]


@pytest.mark.parametrize("n,p,lanes", [(8192, 131072, 4), (64, 200, 7),
                                       (46340, 4096, 2)])
def test_union_deduce_kernel_matches_plain(dev, n, p, lanes):
    args = _lanes(dev, n, p, lanes, seed=n + p)
    got = ud_kernel.union_deduce(*args, n)
    exp = union_deduce_ref(*args, n)
    for name, g, e in zip(("roots", "deduced", "conflict"), got, exp):
        assert torch.equal(g, e), name
    assert (got[1] == NEG).any() and (got[1] == POS).any()


@pytest.mark.parametrize("n", [8192, 46340])
def test_union_deduce_kernel_path_graph(dev, n):
    u = torch.arange(n - 1, dtype=torch.int32, device=dev)[None]
    args = (torch.arange(n, dtype=torch.int32, device=dev)[None], u, u + 1,
            torch.ones_like(u, dtype=torch.bool),
            torch.full_like(u, KEY_SENTINEL), n)
    roots, ded, conflict = ud_kernel.union_deduce(*args)
    assert not roots.any() and (ded == POS).all() and not conflict.any()


def test_union_deduce_kernel_refuses_oversized_forest(dev):
    n = ud_kernel.MAX_OBJECTS + 1
    z = torch.zeros(1, 4, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="at most"):
        ud_kernel.union_deduce(torch.zeros(1, n, dtype=torch.int32,
                                           device=dev), z, z, z.bool(), z, n)


def test_service_on_card_matches_cpu(dev):
    rng = np.random.default_rng(0)
    sessions = []
    for _ in range(5):
        n, p = int(rng.integers(20, 60)), int(rng.integers(40, 300))
        u = rng.integers(0, n, p)
        v = (u + 1 + rng.integers(0, n - 1, p)) % n
        ent = rng.integers(0, n // 4, n)
        truth = ent[u] == ent[v]
        lik = np.clip(np.where(truth, 0.8, 0.3)
                      + 0.2 * rng.standard_normal(p), 0, 1)
        sessions.append(PairSet(u, v, lik, truth, n))
    results = []
    for device in (dev, "cpu"):
        svc = JoinService(lanes=2, order="adaptive", device=device)
        rids = [svc.submit(ps, PerfectCrowd()) for ps in sessions]
        res = svc.run()
        results.append([res[r] for r in rids])
    for card, cpu in zip(*results):
        np.testing.assert_array_equal(card.labels, cpu.labels)
        np.testing.assert_array_equal(card.crowdsourced, cpu.crowdsourced)
        assert card.round_sizes == cpu.round_sizes
        assert (card.fold_rounds, card.n_spent_cents, card.quality) == \
            (cpu.fold_rounds, cpu.n_spent_cents, cpu.quality)
