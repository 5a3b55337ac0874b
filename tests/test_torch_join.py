"""The paper's pipeline on the port (``repro_torch.core.join`` and the
from-scratch engine wrappers of ``repro_torch.core.graph``) against the JAX
package's, on the CPU.

Everything compared here is integer or boolean and must be equal exactly:
the wrappers' roots, neg keys, deductions, frontier masks and packed
arrays against ``jax_graph``'s; ``label_parallel_torch(_batch)`` against
``label_parallel_jax(_batch)`` (labels, crowdsourced masks, round sizes,
conflicts) under perfect and noisy answers, with a prior and without;
``crowdsourced_join`` field for field, the wall clock aside (quality's
floats are ratios of equal integers, so they are equal too), for every
labeler and every order, ``labeler="torch"`` against the reference's
``labeler="jax"``, on the paper's own datasets as well.  The port's crowds
answer in ``POS`` / ``NEG`` and the reference's in ``"M"`` / ``"N"``; the
noisy ones draw the same rng stream, so both sides see the same answers.
"""
import dataclasses
import io
import runpy
from contextlib import redirect_stdout
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import crowd as jcrowd
from repro.core import jax_graph as jg
from repro.core import join as jjoin
from repro.data import entities as jent
from repro_torch.core import crowd as tcrowd
from repro_torch.core import graph as tg
from repro_torch.core import join as tjoin
from repro_torch.core.cluster_graph import NEG, POS, UNKNOWN
from repro_torch.data import entities as tent

ROOT = Path(__file__).resolve().parent.parent
# one capacity for the wrappers' sessions, so the reference compiles each
# entry point once in this file
N_CAP, P_CAP, B = 16, 32, 3


def _eq(got, exp, msg: str = "") -> None:
    got = got.numpy() if hasattr(got, "numpy") else np.asarray(got)
    exp = np.asarray(exp)
    assert got.dtype == exp.dtype, f"{msg}: {got.dtype} != {exp.dtype}"
    np.testing.assert_array_equal(got, exp, err_msg=msg)


def _packed(make_random_world, seed: int):
    """B random worlds packed to (B, P_CAP) by both packages, with some
    pairs labeled by the truth and some of the rest published."""
    rng = np.random.default_rng(seed)
    worlds = [make_random_world(rng) for _ in range(B)]
    sessions = [(u, v, n) for n, u, v, _ in worlds]
    got = tg.pack_sessions(sessions, P_CAP, N_CAP)
    exp = jg.pack_sessions(sessions, P_CAP, N_CAP)
    for k, (x, y) in enumerate(zip(got, exp)):
        _eq(x, y, f"pack_sessions output {k}")
    U, V, labels, valid, n_cap = got
    published = np.zeros_like(valid)
    for b, (_, _, _, truth) in enumerate(worlds):
        m = len(truth)
        lab = rng.random(m) < 0.5
        labels[b, :m] = np.where(lab, truth, UNKNOWN)
        published[b, :m] = ~lab & (rng.random(m) < 0.3)
    return U, V, labels, published, n_cap


@pytest.mark.parametrize("seed", range(6))
def test_from_scratch_wrappers_match_reference(make_random_world, seed):
    """``connected_components(_batch)``, ``neg_keys``, ``deduce_batch``,
    ``boruvka_frontier(_batch)``, ``deduce_sessions`` and
    ``pack_sessions`` equal ``jax_graph``'s as integers."""
    U, V, L, PUB, n = _packed(make_random_world, seed)
    j = {k: jnp.asarray(x) for k, x in
         dict(U=U, V=V, L=L, PUB=PUB).items()}
    roots_b = tg.connected_components_batch(U, V, L == POS, n, device="cpu")
    _eq(roots_b, jg.connected_components_batch(j["U"], j["V"], j["L"] == POS,
                                               n), "connected_components_batch")
    _eq(tg.boruvka_frontier_batch(U, V, L, PUB, n, device="cpu"),
        jg.boruvka_frontier_batch(j["U"], j["V"], j["L"], j["PUB"], n),
        "boruvka_frontier_batch")
    _eq(tg.deduce_sessions(U, V, L, n, device="cpu"),
        jg.deduce_sessions(j["U"], j["V"], j["L"], n), "deduce_sessions")
    rng = np.random.default_rng(100 + seed)
    for b in range(B):
        u, v, lab, pub = U[b], V[b], L[b], PUB[b]
        roots = tg.connected_components(u, v, lab == POS, n, device="cpu")
        exp_roots = jg.connected_components(j["U"][b], j["V"][b],
                                            j["L"][b] == POS, n)
        _eq(roots, exp_roots, f"connected_components lane {b}")
        _eq(roots, roots_b[b], f"connected_components lane {b} vs batch")
        keys = tg.neg_keys(roots, u, v, lab == NEG, n, device="cpu")
        exp_keys = jg.neg_keys(exp_roots, j["U"][b], j["V"][b],
                               j["L"][b] == NEG, n)
        _eq(keys, exp_keys, f"neg_keys lane {b}")
        qu = rng.integers(0, n, P_CAP).astype(np.int32)
        qv = rng.integers(0, n, P_CAP).astype(np.int32)
        _eq(tg.deduce_batch(roots, keys, qu, qv, n, device="cpu"),
            jg.deduce_batch(exp_roots, exp_keys, jnp.asarray(qu),
                            jnp.asarray(qv), n), f"deduce_batch lane {b}")
        _eq(tg.boruvka_frontier(u, v, lab, pub, n, device="cpu"),
            jg.boruvka_frontier(j["U"][b], j["V"][b], j["L"][b],
                                j["PUB"][b], n), f"boruvka_frontier lane {b}")


def test_pack_sessions_pads_with_labeled_self_loops():
    U, V, L, valid, n = tg.pack_sessions(
        [(np.array([1, 2]), np.array([3, 4]), 5), (np.array([0]),
                                                   np.array([2]), 3)], 4)
    assert n == 5 and U.shape == (2, 4)
    assert (U[~valid] == 0).all() and (V[~valid] == 0).all()
    assert (L[~valid] == POS).all() and (L[valid] == UNKNOWN).all()


def _answers(world_truth, seed: int, flip: float):
    """Per-pair answers, each flipped against the truth with ``flip``:
    the same fixed answer whenever a pair is asked."""
    rng = np.random.default_rng(seed)
    flips = rng.random(len(world_truth)) < flip
    return np.where(flips, 1 - world_truth, world_truth).astype(np.int32)


@pytest.mark.parametrize("prior", [False, True])
@pytest.mark.parametrize("flip", [0.0, 0.35])
def test_label_parallel_torch_matches_reference(prior, flip):
    """Sessions from ``make_session_pairsets`` through the whole loop;
    noisy answers make the fold reject some (asserted)."""
    sessions = jent.make_session_pairsets(4, seed=3, n_objects=(25, 35),
                                          n_pairs=(120, 200), n_entities=4,
                                          likelihood=(0.7, 0.4, 0.25))
    conflicts = 0
    for k, ps in enumerate(sessions):
        ans = _answers(np.where(ps.truth, POS, NEG), k, flip)
        pr = ps.likelihood if prior else None
        got = tg.label_parallel_torch(ps.u, ps.v, ps.n_objects,
                                      lambda idx: ans[idx], prior=pr,
                                      device="cpu")
        exp = jg.label_parallel_jax(ps.u, ps.v, ps.n_objects,
                                    lambda idx: ans[idx], prior=pr)
        _eq(got[0], exp[0], f"session {k} labels")
        _eq(got[1], exp[1], f"session {k} crowdsourced")
        assert got[2:] == tuple(exp[2:]), f"session {k}"
        conflicts += got[3]
        if flip == 0.0:
            _eq(got[0], ans, f"session {k} labels vs truth")
    if flip:
        assert conflicts > 0, "no answer was rejected"


@pytest.mark.parametrize("flip", [0.0, 0.35])
def test_label_parallel_torch_batch_matches_reference(flip):
    """Stacked sessions of different sizes: each equals the reference's
    batch result and the port's one-session run."""
    sessions_ps = jent.make_session_pairsets(
        4, seed=5, n_objects=(20, 35), n_pairs=(60, 200), n_entities=4,
        likelihood=(0.7, 0.4, 0.25))
    sessions = [(ps.u, ps.v, ps.n_objects) for ps in sessions_ps]
    answers = [_answers(np.where(ps.truth, POS, NEG), 10 + k, flip)
               for k, ps in enumerate(sessions_ps)]
    got = tg.label_parallel_torch_batch(
        sessions, lambda b, idx: answers[b][idx], device="cpu")
    exp = jg.label_parallel_jax_batch(sessions,
                                      lambda b, idx: answers[b][idx])
    conflicts = 0
    for k, (g, e, (u, v, n)) in enumerate(zip(got, exp, sessions)):
        _eq(g[0], e[0], f"session {k} labels")
        _eq(g[1], e[1], f"session {k} crowdsourced")
        assert g[2:] == tuple(e[2:]), f"session {k}"
        alone = tg.label_parallel_torch(u, v, n, lambda idx: answers[k][idx],
                                        device="cpu")
        _eq(g[0], alone[0], f"session {k} alone labels")
        assert g[2:] == tuple(alone[2:]), f"session {k} alone"
        conflicts += g[3]
    if flip:
        assert conflicts > 0, "no answer was rejected"


# ---------------------------------------------------------------------------
# crowdsourced_join
# ---------------------------------------------------------------------------
def _fields(res) -> dict:
    out = {}
    for f in dataclasses.fields(res):
        if f.name == "wall_seconds":
            continue
        val = getattr(res, f.name)
        if isinstance(val, np.ndarray):
            val = (str(val.dtype), val.tolist())
        elif dataclasses.is_dataclass(val):
            val = dataclasses.astuple(val)
        out[f.name] = val
    return out


def _crowds(kind: str, seed: int):
    if kind == "perfect":
        return jcrowd.PerfectCrowd(), tcrowd.PerfectCrowd()
    kw = dict(error_rate=0.35, qualification=False, seed=seed)
    return jcrowd.NoisyCrowd(**kw), tcrowd.NoisyCrowd(**kw)


@pytest.mark.parametrize("crowd", ["perfect", "noisy"])
@pytest.mark.parametrize("order", ["expected", "adaptive", "random",
                                   "optimal"])
@pytest.mark.parametrize("labeler", ["sequential", "parallel", "all",
                                     "torch"])
def test_crowdsourced_join_matches_reference(labeler, order, crowd):
    """Every labeler and order on three small sessions; ``"torch"`` is held
    against the reference's ``"jax"``."""
    kw = dict(n_objects=(25, 35), n_pairs=(120, 200), n_entities=4,
              likelihood=(0.7, 0.4, 0.25), seed=1)
    for k, (jps, tps) in enumerate(zip(jent.make_session_pairsets(3, **kw),
                                       tent.make_session_pairsets(3, **kw))):
        jc, tc = _crowds(crowd, 30 + k)
        exp = jjoin.crowdsourced_join(
            jps, jc, order=order, seed=7,
            labeler="jax" if labeler == "torch" else labeler)
        got = tjoin.crowdsourced_join(tps, tc, order=order, seed=7,
                                      labeler=labeler, device="cpu")
        assert _fields(got) == _fields(exp), f"session {k}"


@pytest.fixture(scope="module")
def datasets():
    """The paper's two datasets from the port and from the reference."""
    return {"paper": (tent.make_paper_dataset(), jent.make_paper_dataset()),
            "product": (tent.make_product_dataset(),
                        jent.make_product_dataset())}


# (dataset, threshold, order, crowd): crowdsourced / rounds / conflicts of
# the reference's labeler="jax" on the CPU, which the port must equal
PAPER_CASES = [
    ("product", 0.3, "expected", "perfect", (3670, 4, 0)),
    ("product", 0.3, "adaptive", "perfect", (3677, 4, 0)),
    ("paper", 0.5, "expected", "perfect", (1410, 5, 0)),
    ("paper", 0.5, "adaptive", "perfect", (1392, 4, 0)),
    ("paper", 0.3, "expected", "noisy", (1691, 7, 1)),
    ("product", 0.3, "expected", "noisy", (3672, 4, 0)),
    ("product", 0.3, "adaptive", "noisy", (3678, 4, 0)),
    ("paper", 0.5, "expected", "noisy", (1435, 5, 1)),
    ("paper", 0.5, "adaptive", "noisy", (1427, 6, 0)),
]


@pytest.mark.parametrize("name,tau,order,crowd,figures", PAPER_CASES,
                         ids=[f"{c[0]}-{c[1]}-{c[2]}-{c[3]}"
                              for c in PAPER_CASES])
def test_crowdsourced_join_on_paper_datasets(datasets, name, tau, order,
                                             crowd, figures):
    """``labeler="torch"`` against ``labeler="jax"`` on the paper's own
    datasets, field for field; the noisy cases run the quickstart's
    ``NoisyCrowd(error_rate=0.08)``, and two of them reject an answer."""
    tds, jds = datasets[name]
    if crowd == "perfect":
        jc, tc = jcrowd.PerfectCrowd(), tcrowd.PerfectCrowd()
    else:
        jc, tc = jcrowd.NoisyCrowd(error_rate=0.08), \
            tcrowd.NoisyCrowd(error_rate=0.08)
    exp = jjoin.crowdsourced_join(jds.pairs.above(tau), jc, order=order,
                                  labeler="jax",
                                  total_true_matches=jds.total_true_matches)
    got = tjoin.crowdsourced_join(tds.pairs.above(tau), tc, order=order,
                                  labeler="torch", device="cpu",
                                  total_true_matches=tds.total_true_matches)
    assert _fields(got) == _fields(exp)
    assert (got.n_crowdsourced, got.n_iterations, got.n_conflicts) == \
        figures


@pytest.mark.parametrize("labeler", ["jax", "bogus"])
def test_unknown_labeler_raises(labeler):
    ps = tent.make_session_pairsets(1, seed=0)[0]
    with pytest.raises(ValueError, match="unknown labeler"):
        tjoin.crowdsourced_join(ps, labeler=labeler, device="cpu")
    with pytest.raises(ValueError):
        jjoin.crowdsourced_join(jent.make_session_pairsets(1, seed=0)[0],
                                labeler="torch")


def test_torch_quickstart_prints_the_reference_quickstart():
    """``examples/torch_quickstart.py --device cpu``: its four host lines
    are the reference quickstart's, and the engine line reports the
    reference engine's 1655 pairs in 7 rounds."""
    outs = []
    for script, argv in (("torch_quickstart.py", ["--device", "cpu"]),
                         ("quickstart.py", None)):
        buf = io.StringIO()
        with redirect_stdout(buf):
            mod = runpy.run_path(str(ROOT / "examples" / script),
                                 run_name="quickstart")
            if argv is not None:
                mod["main"](argv)
        outs.append(buf.getvalue().splitlines())
    port, ref = outs
    assert port[:4] == ref
    assert port[4].startswith("engine:         1655 pairs in 7 rounds (95% "
                              "saved")
