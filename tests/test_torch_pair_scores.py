"""The port's pair-score path (``repro_torch.kernels.pair_scores``) against
the JAX package's Pallas kernel run in interpret mode, on the CPU.

Tolerances.  A cosine of unit vectors is a sum of D products whose partial
sums stay within [-1, 1], so evaluating it in another order (PyTorch's CPU
matrix product against XLA's CPU dot) moves it on the scale of an ulp of
1.0, not of an ulp of the score itself, which for a small score is several
ulp of s.  Scores from identical normalized inputs are therefore held to 2
ulp of 1.0 (2**-22); with each side normalizing its own inputs, the norms
(summed in different orders too) differ in their last bits as well, and
scores are held to 4 ulp of 1.0.  Counts and candidate sets must be
identical.  bf16 inputs are held to 2e-2, as ``tests/test_kernels.py`` holds
the reference.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.pair_scores.ops import l2_normalize as jax_l2_normalize
from repro.kernels.pair_scores.ops import pair_scores as jax_pair_scores
from repro.kernels.pair_scores.sharded import \
    sharded_candidates as jax_sharded_candidates
from repro.launch.mesh import make_host_mesh
from repro_torch.kernels.pair_scores.ops import l2_normalize, pair_scores
from repro_torch.kernels.pair_scores.ref import candidates_ref
from repro_torch.kernels.pair_scores.sharded import sharded_candidates

ULP_ONE = 2.0 ** -23   # ulp of 1.0 in f32


def _unit_rows(rng, n, d):
    x = rng.normal(size=(n, d))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("N,M,D", [(256, 256, 128), (512, 384, 64),
                                   (300, 200, 96), (128, 128, 32)])
@pytest.mark.parametrize("normalize", [False, True])
def test_pair_scores_matches_interpret(N, M, D, normalize):
    rng = np.random.default_rng(N + M + D)
    a = rng.normal(size=(N, D)).astype(np.float32)
    b = rng.normal(size=(M, D)).astype(np.float32)
    if not normalize:
        a = np.asarray(jax_l2_normalize(jnp.asarray(a)))
        b = np.asarray(jax_l2_normalize(jnp.asarray(b)))
    s_ref, c_ref = jax_pair_scores(jnp.asarray(a), jnp.asarray(b), 0.2,
                                   normalize=normalize, impl="interpret")
    s, c = pair_scores(_t(a), _t(b), 0.2, normalize=normalize)
    s_ref, c_ref = np.asarray(s_ref), np.asarray(c_ref)
    assert s.dtype == torch.float32 and c.dtype == torch.int32
    np.testing.assert_array_equal(c.numpy(), c_ref)
    np.testing.assert_array_equal(s.numpy() != 0, s_ref != 0)
    tol = (4 if normalize else 2) * ULP_ONE
    np.testing.assert_allclose(s.numpy(), s_ref, rtol=0, atol=tol)


@pytest.mark.parametrize("N,M,D", [(256, 256, 128), (300, 200, 96)])
def test_pair_scores_bf16_matches_interpret(N, M, D):
    rng = np.random.default_rng(7)
    a = rng.normal(size=(N, D)).astype(np.float32)
    b = rng.normal(size=(M, D)).astype(np.float32)
    s_ref, _ = jax_pair_scores(jnp.asarray(a, jnp.bfloat16),
                               jnp.asarray(b, jnp.bfloat16), 0.2,
                               impl="interpret")
    s, _ = pair_scores(_t(a).to(torch.bfloat16), _t(b).to(torch.bfloat16),
                       0.2)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), atol=2e-2)


def _entity_corpus(seed, n_a=40, n_b=35, d=16, n_ent=12):
    rng = np.random.default_rng(seed)
    cents = rng.normal(size=(n_ent, d))
    ia = rng.integers(0, n_ent, n_a)
    ib = rng.integers(0, n_ent, n_b)
    a = (cents[ia] + 0.15 * rng.normal(size=(n_a, d))).astype(np.float32)
    b = (cents[ib] + 0.15 * rng.normal(size=(n_b, d))).astype(np.float32)
    return a, b


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("capacity", [None, 50])
def test_sharded_candidates_matches_reference(seed, capacity):
    a, b = _entity_corpus(seed)
    ref = jax_sharded_candidates(jnp.asarray(a), jnp.asarray(b), 0.8,
                                 make_host_mesh(1, 1), capacity=capacity,
                                 impl="interpret")
    got = sharded_candidates(_t(a), _t(b), 0.8, mesh=(1, 1),
                             capacity=capacity)
    np.testing.assert_array_equal(got.rows, ref.rows)
    np.testing.assert_array_equal(got.cols, ref.cols)
    np.testing.assert_allclose(got.scores, ref.scores, rtol=0,
                               atol=4 * ULP_ONE)
    assert (got.n_dropped, got.capacity, got.suggested_capacity) == \
        (ref.n_dropped, ref.capacity, ref.suggested_capacity)
    assert got.rows.dtype == np.int32 and got.scores.dtype == np.float32


def test_candidates_ref_is_the_dense_candidate_list():
    rng = np.random.default_rng(1)
    a, b = _unit_rows(rng, 33, 16), _unit_rows(rng, 21, 16)
    rows, cols, scores = candidates_ref(_t(a), _t(b), 0.3)
    s, _ = pair_scores(_t(a), _t(b), 0.3, normalize=False)
    r2, c2 = np.nonzero(s.numpy())
    np.testing.assert_array_equal(rows.numpy(), r2)
    np.testing.assert_array_equal(cols.numpy(), c2)
    np.testing.assert_array_equal(scores.numpy(), s.numpy()[r2, c2])


def test_sharded_candidates_rejects_bad_threshold_and_mesh():
    a = torch.ones(4, 8)
    with pytest.raises(ValueError, match="threshold > 0"):
        sharded_candidates(a, a, 0.0)
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        sharded_candidates(a, a, 0.5, mesh=(2, 1))


U32 = 2.0 ** -24       # unit roundoff of f32


def gamma(n: int) -> float:
    """gamma_n = n u / (1 - n u): a length-n f32 dot product, products and
    sums rounded in any order, is within gamma_n * sum |x_i y_i| of exact."""
    return n * U32 / (1 - n * U32)


def _clustered(seed, n_a=200, n_b=150, d=384, n_ent=12):
    """Near-duplicate records of 12 entities, as the join-service tests
    build them, at the main path's width."""
    rng = np.random.default_rng(seed)
    cents = rng.normal(size=(n_ent, d))
    ia = rng.integers(0, n_ent, n_a)
    ib = rng.integers(0, n_ent, n_b)
    a = (cents[ia] + 0.15 * rng.normal(size=(n_a, d))).astype(np.float32)
    b = (cents[ib] + 0.15 * rng.normal(size=(n_b, d))).astype(np.float32)
    return a, b


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("normalize", [False, True])
def test_scores_at_width_384_within_derived_bound(seed, normalize):
    """ROADMAP C7: the port's ``candidates_ref`` and ``sharded_candidates``
    against the reference's ``pair_scores(..., impl="interpret")`` at the
    join cells' width D = 384, on clustered f32 embeddings (200 x 150 rows,
    tau 0.8).  Candidate sets and counts must be identical.

    The score bound is derived from D, not fitted to the data.  With u =
    2**-24 and gamma_D = D u / (1 - D u), each side's f32 dot of the same
    normalized rows a, b is within gamma_D * sum |a_i b_i| of the exact
    value, and sum |a_i b_i| <= |a| |b| <= (1 + eta)**2 (Cauchy-Schwarz), so
    from identical normalized inputs the two sides differ by at most
    2 gamma_D (1 + eta)**2.  Where each side normalizes for itself, a
    component of its unit row is off by a relative eta = gamma_D / 2 + 3u
    (the sum of squares by gamma_D, halved by the square root; the root and
    the division or reciprocal-multiply rounding once or twice each), which
    moves the exact cosine by at most 2 eta + eta**2; each side is then
    within gamma_D (1 + eta)**2 + 2 eta + eta**2 of the exact cosine, and
    the two sides within twice that.  At D = 384: 4.6e-5 (about 384 ulp of
    1.0) and 9.2e-5."""
    D, tau = 384, 0.8
    a, b = _clustered(seed, d=D)
    if not normalize:
        a = np.asarray(jax_l2_normalize(jnp.asarray(a)))
        b = np.asarray(jax_l2_normalize(jnp.asarray(b)))
    s_ref, c_ref = jax_pair_scores(jnp.asarray(a), jnp.asarray(b), tau,
                                   normalize=normalize, impl="interpret")
    s_ref, c_ref = np.asarray(s_ref), np.asarray(c_ref)[:, 0]
    r_ref, k_ref = np.nonzero(s_ref)
    assert len(r_ref) > 0
    g, eta = gamma(D), gamma(D) / 2 + 3 * U32
    bound = 2 * g * (1 + eta) ** 2
    if normalize:
        bound += 2 * (2 * eta + eta ** 2)
    ta, tb = _t(a), _t(b)
    an, bn = (l2_normalize(ta), l2_normalize(tb)) if normalize else (ta, tb)
    rows, cols, scores = candidates_ref(an, bn, tau)
    np.testing.assert_array_equal(rows.numpy(), r_ref)
    np.testing.assert_array_equal(cols.numpy(), k_ref)
    np.testing.assert_array_equal(np.bincount(rows.numpy(), minlength=200),
                                  c_ref)
    np.testing.assert_allclose(scores.numpy(), s_ref[r_ref, k_ref], rtol=0,
                               atol=bound)
    got = sharded_candidates(ta, tb, tau, mesh=(1, 1), normalize=normalize)
    np.testing.assert_array_equal(got.rows, r_ref)
    np.testing.assert_array_equal(got.cols, k_ref)
    np.testing.assert_allclose(got.scores, s_ref[r_ref, k_ref], rtol=0,
                               atol=bound)
    assert got.n_dropped == 0
    gap = np.abs(got.scores.astype(np.float64) - s_ref[r_ref, k_ref]).max()
    print(f"C7 cpu seed {seed} normalize {normalize}: {len(r_ref)} "
          f"candidates, max |d| {gap:.3e} ({gap / ULP_ONE:.1f} ulp of 1.0, "
          f"{gap / bound:.4f} of the bound {bound:.3e})")
