"""The port's LM serving path (``repro_torch.serve.engine``) and the data it
reads against the JAX package's, on the CPU.

* ``ServeEngine.generate`` on the reduced ``paper-scorer`` with f32
  parameters, 5 requests over 2 lanes, 8 new tokens each.  The reference
  engine's multi-step decode is wrong: its ``decode_layer_step``
  (``models/model.py:341-369``) drops the keys and values that
  ``attention_decode_block`` wrote, so from the second decode step on it
  attends over zeros where the decoded tokens should be (ROADMAP queue C).
  The port writes them.  So every request's tokens are held to the
  reference model's own oracle for decoding, greedy over a full forward of
  the whole left-padded wave so far (``tests/test_models.py:61-86`` holds
  ``decode == prefill(n+1)``), and to the reference engine itself on the
  two tokens before its fault can show (the prefill's and the first decode
  step's).  To keep the bf16 cache's rounding out of a token-for-token
  comparison, the port's cache is f32 here (``make_cache`` patched), and
  the reference engine's prefill cache reaches its decode loop as f32 (it
  cannot decode f32 parameters over a bf16 cache:
  ``lax.dynamic_update_slice`` refuses mixed dtypes).  Logits then agree
  within about 1e-5, so a token could differ only where the top two logits
  sit closer than that; should that happen, the test names the step and its
  margin instead of loosening anything.
* ``score_pairs_with_lm`` on 40 x 37 product records: the likelihood matrix
  within 1e-5 in f32 (a cosine of mean-pooled states summed in other
  orders) and 2e-2 in bf16 (the JAX model's bf16 einsums round where the
  port's attention does not).
* ``make_product_dataset`` and ``hash_tokenize``: identical output.
* ``pair_scores`` at tau <= 0: the port's row counts are the oracle's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jax_get
from repro.data.entities import make_product_dataset as jax_product_dataset
from repro.data.tokens import hash_tokenize as jax_hash_tokenize
from repro.kernels.pair_scores.ops import pair_scores as jax_pair_scores
from repro.models import model as JM
from repro.serve import engine as jax_engine
from repro_torch.configs import get
from repro_torch.convert import model_params_from_numpy
from repro_torch.data.entities import make_product_dataset
from repro_torch.data.tokens import hash_tokenize
from repro_torch.kernels.pair_scores.ops import pair_scores
from repro_torch.models import model as M
from repro_torch.serve import engine

ARCH = "paper-scorer"


def _np32(x):
    return np.asarray(x, np.float32)


@pytest.fixture(scope="module")
def jax_params():
    return JM.init_params(jax_get(ARCH).reduced(), jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def dataset():
    return make_product_dataset()


def _requests(module, cfg):
    rng = np.random.default_rng(0)
    return [module.Request(rid=i, prompt=rng.integers(
                2, cfg.vocab, size=rng.integers(4, 21)).astype(np.int32),
                max_new_tokens=8)
            for i in range(5)]


def test_generate_matches_reference_model(monkeypatch, jax_params):
    jcfg, cfg = jax_get(ARCH).reduced(), get(ARCH).reduced()
    p32 = jax.tree.map(lambda x: x.astype(jnp.float32), jax_params)
    model = model_params_from_numpy(cfg, jax.tree.map(_np32, jax_params),
                                    "cpu").float()
    make_cache = M.make_cache
    monkeypatch.setattr(M, "make_cache", lambda *a, **k: {
        n: t if n == "length" else t.float()
        for n, t in make_cache(*a, **k).items()})
    got = engine.ServeEngine(cfg, model, batch_lanes=2, max_len=64
                             ).generate(_requests(engine, cfg))

    prefill = JM.prefill

    def prefill_f32_cache(*args, **kwargs):
        cache, logits = prefill(*args, **kwargs)
        return dict(cache, k=cache["k"].astype(jnp.float32),
                    v=cache["v"].astype(jnp.float32)), logits

    monkeypatch.setattr(JM, "prefill", prefill_f32_cache)
    ref_engine = jax_engine.ServeEngine(jcfg, p32, batch_lanes=2, max_len=64
                                        ).generate(_requests(jax_engine, jcfg))

    reqs = _requests(jax_engine, jcfg)
    assert sorted(got) == sorted(ref_engine) == list(range(5))
    for w in range(0, len(reqs), 2):
        # greedy decoding over the reference model, checked by teacher
        # forcing: with causal attention the logits at each position see
        # only the tokens up to it, so one forward over the wave's prompts
        # and the port's tokens gives every step's logits at once
        wave = reqs[w:w + 2]
        S = max(len(r.prompt) for r in wave)
        seq = np.zeros((len(wave), S + 8), np.int32)
        for j, r in enumerate(wave):
            seq[j, S - len(r.prompt):S] = r.prompt   # the engine's left-pad
            seq[j, S:] = got[r.rid]
        x, pos = JM._embed_inputs(p32, {"tokens": jnp.asarray(seq)}, jcfg)
        logits = np.asarray(JM._logits(p32, JM.backbone(p32, x, pos, jcfg)[0],
                                       jcfg))[:, S - 1:S + 7]
        for j, r in enumerate(wave):
            for step in range(8):
                if logits[j, step].argmax() != got[r.rid][step]:
                    top = np.sort(logits[j, step])[-2:]
                    pytest.fail(f"request {r.rid} diverges from the "
                                f"reference model at step {step}: top-2 "
                                f"margin {top[1] - top[0]:.3e}")
    for rid in ref_engine:
        assert len(got[rid]) == 8
        assert got[rid][:2] == ref_engine[rid][:2]


@pytest.mark.parametrize("dtype,tol", [("f32", 1e-5), ("bf16", 2e-2)])
def test_score_pairs_with_lm_matches_reference(jax_params, dataset, dtype,
                                               tol):
    jcfg, cfg = jax_get(ARCH).reduced(), get(ARCH).reduced()
    model = model_params_from_numpy(cfg, jax.tree.map(_np32, jax_params),
                                    "cpu")
    params = jax_params
    if dtype == "f32":
        params = jax.tree.map(lambda x: x.astype(jnp.float32), params)
        model = model.float()
    texts_a, texts_b = dataset.records[:40], dataset.records[1081:1081 + 37]
    ref = jax_engine.score_pairs_with_lm(jcfg, params, texts_a, texts_b)
    got = engine.score_pairs_with_lm(cfg, model, texts_a, texts_b)
    assert got.shape == ref.shape == (40, 37) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)


def test_product_dataset_is_the_reference(dataset):
    ref = jax_product_dataset()
    assert dataset.name == ref.name
    assert dataset.records == ref.records
    np.testing.assert_array_equal(dataset.entity_of, ref.entity_of)
    assert dataset.total_true_matches == ref.total_true_matches
    for f in ("u", "v", "likelihood", "truth"):
        np.testing.assert_array_equal(getattr(dataset.pairs, f),
                                      getattr(ref.pairs, f))
    assert dataset.pairs.n_objects == ref.pairs.n_objects == 1081 + 1092


def test_hash_tokenize_is_the_reference(dataset):
    texts = dataset.records[:200] + ["", "Apple  IPAD pro", "a " * 50]
    for vocab, max_len in ((32768, 32), (512, 8)):
        for t in texts:
            got, ref = hash_tokenize(t, vocab, max_len), \
                jax_hash_tokenize(t, vocab, max_len)
            assert got.dtype == ref.dtype == np.int32
            np.testing.assert_array_equal(got, ref)


def test_pair_scores_counts_at_nonpositive_threshold():
    """At tau = -1 (``score_pairs_with_lm``'s call) every column counts.
    The reference's wrapper pads b to a 256-row tile and, for tau <= 0,
    counts the zero-padded columns too (512 here with ``impl="auto"``,
    against its oracle's 300; ROADMAP queue C records this deviation of the
    reference).  The port passes the valid column count and matches the
    oracle."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=(40, 16)).astype(np.float32)
    b = rng.normal(size=(300, 16)).astype(np.float32)
    s_ref, c_ref = jax_pair_scores(jnp.asarray(a), jnp.asarray(b), -1.0,
                                   impl="ref")
    s, c = pair_scores(torch.from_numpy(a), torch.from_numpy(b), -1.0)
    np.testing.assert_array_equal(c.numpy(), np.asarray(c_ref))
    assert (c.numpy() == 300).all()
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=0,
                               atol=4 * 2.0 ** -23)
