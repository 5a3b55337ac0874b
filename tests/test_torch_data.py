"""The port's datasets (``repro_torch.data.entities``) against the JAX
package's: the same rng stream draw for draw, so every record string,
entity id, candidate pair, likelihood (f32 bit for bit), truth bit and
total of true matches is equal, and so is every session of
``make_session_pairsets``."""
import numpy as np
import pytest

from repro.data import entities as jent
from repro_torch.data import entities as tent


def _same_pairs(got, exp, msg: str = "") -> None:
    assert got.n_objects == exp.n_objects, msg
    for f in ("u", "v", "likelihood", "truth"):
        x, y = getattr(got, f), getattr(exp, f)
        assert x.dtype == y.dtype, f"{msg} {f}"
        np.testing.assert_array_equal(x, y, err_msg=f"{msg} {f}")


@pytest.mark.parametrize("name,seed", [("paper", 0), ("paper", 3),
                                       ("product", 1), ("product", 0)])
def test_dataset_matches_reference(name, seed):
    got, exp = tent.DATASETS[name](seed=seed), jent.DATASETS[name](seed=seed)
    assert got.name == exp.name == name
    assert got.records == exp.records
    np.testing.assert_array_equal(got.entity_of, exp.entity_of)
    assert got.entity_of.dtype == exp.entity_of.dtype
    assert got.total_true_matches == exp.total_true_matches
    _same_pairs(got.pairs, exp.pairs, name)
    np.testing.assert_array_equal(got.cluster_sizes(), exp.cluster_sizes())
    for tau in (0.1, 0.3, 0.5):
        _same_pairs(got.pairs.above(tau), exp.pairs.above(tau), f"{tau}")
    l_got, l_exp = tent.load_dataset(name, seed), jent.load_dataset(name,
                                                                    seed)
    _same_pairs(l_got.pairs, l_exp.pairs, "load_dataset")


def test_paper_dataset_is_the_papers_size():
    """§6's Cora-like setting: 997 records, a 102-record cluster, and the
    candidate counts the labelers' figures are quoted at."""
    ds = tent.make_paper_dataset()
    assert ds.n_objects == 997 and ds.cluster_sizes()[0] == 102
    assert [len(ds.pairs.above(t)) for t in (0.1, 0.2, 0.3, 0.4, 0.5)] == \
        [77096, 38645, 31156, 25313, 20001]
    assert len(tent.make_product_dataset().pairs.above(0.3)) == 4229


@pytest.mark.parametrize("kw", [
    dict(seed=0),
    dict(seed=11, n_objects=(12, 24), n_pairs=(20, 60)),
    dict(seed=1, n_objects=(25, 35), n_pairs=(120, 200), n_entities=4,
         likelihood=(0.7, 0.4, 0.25)),
    dict(seed=2, n_objects=(3, 5), n_pairs=(20, 60), n_entities=None),
])
def test_session_pairsets_match_reference(kw):
    got = tent.make_session_pairsets(5, **kw)
    exp = jent.make_session_pairsets(5, **kw)
    assert len(got) == len(exp) == 5
    for k, (g, e) in enumerate(zip(got, exp)):
        _same_pairs(g, e, f"session {k}")
