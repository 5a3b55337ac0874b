"""The port's mesh paths against the JAX package's on host meshes, on the
CPU: ``sharded_candidates`` and ``sharded_pair_scores`` on 4 x 2 and 2 x 4,
two ``StreamingCandidateIndex`` epochs, a served join
(``JoinService.submit_embeddings(..., mesh)``, two lanes and a streamed
request), ``moe_block_a2a``, and DTensor placements against
``NamedSharding``.

One module-scoped reference subprocess (``XLA_FLAGS`` forcing 8 host
devices, which must be set before JAX is imported) writes the reference's
side; one module-scoped ``spawn`` of 8 gloo CPU ranks a mesh shape computes
the port's (the rank bodies are ``tests/torch_mesh_ranks.py``).  Bars:

* candidates: rows, cols, their order, ``n_dropped`` and ``capacity``
  exact; scores within 4 ulp of 1.0 (ROADMAP C4: each side normalizes, at
  D = 32), with no score that close to the threshold, so the sets cannot
  flip; counts exact;
* the served join: every result field exact against the reference's 4 x 2
  session, the data kept clear of ties (as in
  ``tests/test_torch_join_service.py``); the port's 1 x 1 session the same
  join, pair for pair;
* ``moe_block_a2a`` on 2 x 4, forward and input gradient: in bf16 within
  the reference's 8e-3 (``tests/test_sharding.py``) of the port's
  ``moe_block`` and within ``tests/test_torch_moe.py``'s cross-framework
  bf16 bar of the reference's a2a; in f32 within 1e-5 of the reference's
  a2a.  On 4 x 2 (two experts a rank) the reference's a2a is not
  ``moe_block`` (ROADMAP R8) and the port's is; in f32 the router's and
  the experts' gradients are ``moe_block``'s within 1e-5;
* the a2a aux loss on 4 x 2 and 2 x 4, and a reduced olmoe backbone's
  logits and loss under ``moe_impl="a2a"`` on 2 x 4 with the mesh set as
  the current one: in f32 within 1e-5 of the reference's;
* every rank's results are identical.
"""
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from repro_torch.launch.mesh import spawn

ROOT = Path(__file__).resolve().parent.parent
ULP_ONE = 2.0 ** -23
C4_TOL = 4 * ULP_ONE
A2A_TOL = 8e-3

REF = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import math, pickle, sys
    sys.path.insert(0, "src")
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import get
    from repro.core import NoisyCrowd, PerfectCrowd
    from repro.kernels.pair_scores.sharded import (
        StreamingCandidateIndex, sharded_candidates, sharded_pair_scores)
    from repro.launch.mesh import make_host_mesh
    from repro.models import model as MM
    from repro.models.moe import moe_block
    from repro.models.moe_a2a import moe_block_a2a
    from repro.serve.join_service import JoinService
    from repro.sharding import set_current_mesh

    out_path = sys.argv[1]
    ins, ref = {}, {}
    rng = np.random.default_rng(2)
    ins["a"] = rng.normal(size=(103, 32)).astype(np.float32)
    ins["b"] = rng.normal(size=(66, 32)).astype(np.float32)
    ins["cand_tau"], ins["small_cap"] = 0.3, 3
    ins["epoch_a"], ins["epoch_b"] = 60, 40
    a, b = jnp.asarray(ins["a"]), jnp.asarray(ins["b"])

    def cand(c):
        return {"rows": c.rows, "cols": c.cols, "scores": c.scores,
                "n_dropped": c.n_dropped, "capacity": c.capacity}

    for shape in ((4, 2), (2, 4)):
        mesh = make_host_mesh(*shape)
        r = {"lossless": cand(sharded_candidates(
                 a, b, 0.3, mesh, impl="interpret")),
             "small": cand(sharded_candidates(
                 a, b, 0.3, mesh, capacity=3, impl="interpret"))}
        s, c = sharded_pair_scores(a, b, 0.3, mesh, impl="interpret")
        r["dense"], r["counts"] = np.asarray(s), np.asarray(c)
        ref[shape] = r
    mesh = make_host_mesh(4, 2)
    idx = StreamingCandidateIndex(0.3, mesh, impl="interpret")
    ref[(4, 2)]["epochs"] = [cand(idx.append(a[:60], b[:40])),
                             cand(idx.append(a[60:], b[40:]))]

    # the served join: tests/test_torch_join_service.py's seed-3 corpus
    rng = np.random.default_rng(3)
    cents = rng.normal(size=(12, 16))
    ia, ib = rng.integers(0, 12, 40), rng.integers(0, 12, 35)
    ins["ea"] = (cents[ia] + 0.15 * rng.normal(size=(40, 16))).astype(
        np.float32)
    ins["eb"] = (cents[ib] + 0.15 * rng.normal(size=(35, 16))).astype(
        np.float32)
    ins["ia"], ins["ib"], ins["tau"], ins["half"] = ia, ib, 0.8, 20
    truth = lambda r, c: ia[r] == ib[c]
    svc = JoinService(lanes=2)
    ea, eb = jnp.asarray(ins["ea"]), jnp.asarray(ins["eb"])
    rids = [svc.submit_embeddings(
                ea, eb, 0.8, mesh, crowd=PerfectCrowd(), truth_fn=truth,
                impl="interpret",
                total_true_matches=int((ia[:, None] == ib[None, :]).sum())),
            svc.submit_embeddings(ea, eb, 0.8, mesh,
                                  crowd=NoisyCrowd(error_rate=0.08),
                                  truth_fn=truth, impl="interpret")]
    rids.append(svc.submit_embeddings(
        ea[:20], eb[:20], 0.8, mesh, crowd=PerfectCrowd(), truth_fn=truth,
        impl="interpret", streaming=True))
    svc.append_embeddings(rids[-1], ea[20:], eb[20:])
    ref["likelihood"] = [svc.queue[i].pairs.likelihood for i in range(2)]
    ref["pairs"] = []
    for req, rid in zip(svc.queue, rids):
        epochs = [req.pairs, *svc._pending_arrivals.get(rid, ())]
        ref["pairs"].append((np.concatenate([e.u for e in epochs]).tolist(),
                             np.concatenate([e.v for e in epochs]).tolist()))
    res = svc.run()
    ref["session"] = [res[r] for r in rids]

    # NamedSharding's blocks on the 4 x 2 mesh, by mesh coordinate
    cases = [((16, 12), ("data", "model")), ((16, 12), (("data", "model"),
             None)), ((8, 6, 4), (None, "model", "data")),
             ((16, 8), ("model", None)), ((24,), (("data", "model"),))]
    ins["dtensor_cases"] = []
    for k, (shape, spec) in enumerate(cases):
        full = np.arange(math.prod(shape), dtype=np.float32).reshape(shape)
        where = NamedSharding(mesh, P(*spec)).devices_indices_map(shape)
        slices = {}
        for dev, idx in where.items():
            pos = tuple(int(i) for i in np.argwhere(mesh.devices == dev)[0])
            slices[pos] = [(s.start or 0, shape[d] if s.stop is None
                            else s.stop) for d, s in enumerate(idx)]
        ins["dtensor_cases"].append((full, spec, slices))

    # moe_block_a2a: tests/test_sharding.py's setup
    cfg = get("olmoe-1b-7b").reduced().replace(capacity_factor=8.0)
    ins["capacity_factor"] = 8.0
    key = jax.random.PRNGKey(0)
    specs = {k: v for k, v in MM.layer_specs(cfg).items()
             if k.startswith("moe/")}
    flat = {}
    for i, (k, v) in enumerate(sorted(specs.items())):
        kk = jax.random.fold_in(key, i)
        scale = 1.0 / math.sqrt(max(v.fan_in, 1))
        flat[k] = (jax.random.normal(kk, v.shape, jnp.float32) * scale
                   ).astype(v.dtype)
    p = MM._nest(flat)["moe"]
    x = (jax.random.normal(jax.random.PRNGKey(1), (8, 64, cfg.d_model))
         * 0.5).astype(jnp.bfloat16)
    for k, v in p.items():
        ins["moe_" + k] = np.asarray(v.astype(jnp.float32))
    ins["moe_x"] = np.asarray(x.astype(jnp.float32))
    p32 = {k: v.astype(jnp.float32) for k, v in p.items()}
    for shape in ((2, 4), (4, 2)):
        mesh = make_host_mesh(*shape)
        ref[shape]["a2a"] = {}
        # 4 x 2 shows R8, in f32
        for tag, pp, xx in (("bf16", p, x),
                            ("f32", p32, x.astype(jnp.float32)))[
                                shape == (4, 2):]:
            fwd = jax.jit(lambda xx, pp=pp: moe_block_a2a(xx, pp, cfg,
                                                          mesh))
            grad = jax.jit(jax.grad(lambda xx, pp=pp: jnp.sum(
                moe_block_a2a(xx, pp, cfg, mesh)[0].astype(jnp.float32))))
            y, aux = fwd(xx)
            ref[shape]["a2a"][tag] = {
                "y": np.asarray(y.astype(jnp.float32)), "aux": float(aux),
                "x_grad": np.asarray(grad(xx).astype(jnp.float32))}

    # the backbone's dispatch to moe_block_a2a (model.py's layer_step under
    # moe_impl="a2a" and the current mesh), 2 x 4: one expert a rank
    bcfg = get("olmoe-1b-7b").reduced().replace(moe_impl="a2a")
    bparams = jax.tree.map(lambda v: v.astype(jnp.float32),
                           MM.init_params(bcfg, jax.random.PRNGKey(3)))
    toks = np.random.default_rng(4).integers(
        2, bcfg.vocab, size=(2, 33)).astype(np.int32)
    ins["bb_params"] = jax.tree.map(lambda v: np.asarray(v), bparams)
    ins["bb_tokens"] = toks
    set_current_mesh(make_host_mesh(2, 4))
    batch = {"tokens": jnp.asarray(toks[:, :-1]),
             "targets": jnp.asarray(toks[:, 1:])}

    def logits_fn(params, batch):
        x, pos = MM._embed_inputs(params, batch, bcfg)
        return MM._logits(params, MM.backbone(params, x, pos, bcfg)[0], bcfg)

    ref["backbone"] = {
        "logits": np.asarray(jax.jit(logits_fn)(bparams, batch)),
        "loss": float(jax.jit(lambda p, b: MM.loss_fn(p, b, bcfg))(
            bparams, batch))}
    set_current_mesh(None)
    with open(out_path, "wb") as f:
        pickle.dump((ins, ref), f)
    print("REF_OK")
""")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(inputs, the reference's results, the port's results by mesh shape,
    the port's 1 x 1 session)."""
    path = tmp_path_factory.mktemp("sharded") / "ref.pkl"
    r = subprocess.run([sys.executable, "-c", REF, str(path)],
                       capture_output=True, text=True, cwd=str(ROOT),
                       timeout=900)
    assert "REF_OK" in r.stdout, r.stdout[-2000:] + r.stderr[-4000:]
    with open(path, "rb") as f:   # written by the subprocess above
        ins, ref = pickle.load(f)
    port = {shape: spawn(ranks.sharded_case, *shape, device="cpu",
                         args=(ins,), timeout=600)
            for shape in ((4, 2), (2, 4))}
    one = ranks.serve(None, ins)
    return ins, ref, port, one


SHAPES = [(4, 2), (2, 4)]


def _assert_same_candidates(got, want, tau):
    for key in ("rows", "cols"):
        np.testing.assert_array_equal(got[key], want[key])
    assert (got["n_dropped"], got["capacity"]) == \
        (want["n_dropped"], want["capacity"])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                               atol=C4_TOL)
    assert (np.abs(want["scores"] - tau) > C4_TOL).all()


@pytest.mark.parametrize("shape", SHAPES, ids=["4x2", "2x4"])
@pytest.mark.parametrize("case", ["lossless", "small"])
def test_sharded_candidates_match_the_reference(world, shape, case):
    """Rows, cols, their order (the reference's rank-major gather), the
    summed drops and the per-device capacity, exactly."""
    ins, ref, port, _ = world
    want, got = ref[shape][case], port[shape][case]
    _assert_same_candidates(got, want, ins["cand_tau"])
    if case == "small":
        assert got["n_dropped"] > 0 and len(got["rows"]) == \
            shape[0] * shape[1] * ins["small_cap"]


@pytest.mark.parametrize("shape", SHAPES, ids=["4x2", "2x4"])
def test_sharded_pair_scores_match_the_reference(world, shape):
    ins, ref, port, _ = world
    want, got = ref[shape], port[shape]
    assert got["dense"].shape == (103, 66)
    np.testing.assert_allclose(got["dense"], want["dense"], rtol=0,
                               atol=C4_TOL)
    raw = want["dense"][want["dense"] != 0]
    assert (np.abs(raw - ins["cand_tau"]) > C4_TOL).all()
    np.testing.assert_array_equal(got["counts"], want["counts"])


def test_streaming_epochs_on_the_mesh(world):
    """Each epoch the reference's, and the epochs' union the batch call's
    candidates on the same mesh."""
    ins, ref, port, _ = world
    got, want = port[(4, 2)]["epochs"], ref[(4, 2)]["epochs"]
    for g, w in zip(got, want):
        _assert_same_candidates(g, w, ins["cand_tau"])
    union = {(int(r), int(c)): s for e in got
             for r, c, s in zip(e["rows"], e["cols"], e["scores"])}
    batch = port[(4, 2)]["lossless"]
    assert union == {(int(r), int(c)): s for r, c, s in
                     zip(batch["rows"], batch["cols"], batch["scores"])}


def test_mesh_session_matches_the_reference(world):
    """Two lanes (perfect and noisy crowds) and a request streamed in two
    epochs, served on the 4 x 2 mesh: every field the reference's 4 x 2
    session's.  The scores keep clear of the threshold and of each other,
    so the labeling order cannot flip."""
    ins, ref, port, _ = world
    for lik in ref["likelihood"]:
        scores = np.sort(2.0 * lik - 1.0)
        assert (np.abs(scores - ins["tau"]) >
                4 * np.spacing(np.float32(ins["tau"]))).all()
        assert (np.diff(scores) > 4 * np.spacing(scores[1:])).all()
    got = port[(4, 2)]["session"]
    assert got["pairs"] == ref["pairs"]
    for g, w in zip(got["fields"], ref["session"]):
        assert g == ranks._fields(w)
    assert got["fields"][0]["n_rounds"] > 0


def test_one_device_session_is_the_mesh_session(world):
    """The 1 x 1 session is the same join: the candidates come in another
    order (row-major over the whole grid, not rank-major), and each pair's
    label and crowdsourcing, and every other field, are the 4 x 2
    session's."""
    _, _, port, one = world
    mesh = port[(4, 2)]["session"]
    for k, (fo, fm) in enumerate(zip(one["fields"], mesh["fields"])):
        for key in fo:
            if key in ("labels", "crowdsourced"):
                pick = {p: i for i, p in enumerate(zip(*mesh["pairs"][k]))}
                perm = [pick[p] for p in zip(*one["pairs"][k])]
                assert fo[key][1] == [fm[key][1][i] for i in perm], key
            else:
                assert fo[key] == fm[key], key
    assert sorted(zip(*one["pairs"][0])) == sorted(zip(*mesh["pairs"][0]))
    assert one["pairs"][0] != mesh["pairs"][0]


@pytest.mark.parametrize("shape", SHAPES, ids=["4x2", "2x4"])
def test_every_rank_holds_the_same_results(world, shape):
    _, _, port, _ = world
    assert len(set(port[shape]["digests"])) == 1


def test_dtensor_shards_are_the_named_sharding_blocks(world):
    """placements_for: each rank's local DTensor shard is the block
    NamedSharding.devices_indices_map gives its device, dims over two mesh
    axes included."""
    _, _, port, _ = world
    assert all(all(ok) for ok in port[(4, 2)]["dtensor_ok"])
    assert len(port[(4, 2)]["dtensor_ok"]) == 8


def test_a2a_matches_the_reference_and_moe_block(world):
    """2 x 4, the reference test's setup.  bf16: forward and input gradient
    within the reference's 8e-3 of the port's moe_block (both sides round in
    torch's order), and within tests/test_torch_moe.py's cross-framework
    bar of the reference's a2a: one bf16 ulp of each element plus one of
    the scale (2**-7 |ref| + 2**-7 max |ref|), since each side rounds its
    expert products, gate multiply and pick sum to bf16 in sums of its own
    order.  f32: within 1e-5 of the reference's a2a."""
    _, ref, port, _ = world
    got = port[(2, 4)]["a2a"]
    want = ref[(2, 4)]["a2a"]
    for key in ("y", "x_grad"):
        assert np.abs(got["bf16_a2a"][key]
                      - got["bf16_one"][key]).max() < A2A_TOL
        w = want["bf16"][key]
        tol = 2.0 ** -7 * (np.abs(w) + np.abs(w).max())
        assert (np.abs(got["bf16_a2a"][key] - w) <= tol).all(), key
        np.testing.assert_allclose(got["f32_a2a"][key], want["f32"][key],
                                   rtol=1e-5, atol=1e-5, err_msg=key)


@pytest.mark.parametrize("shape", SHAPES, ids=["4x2", "2x4"])
def test_a2a_aux_matches_the_reference(world, shape):
    """The aux loss: each rank's load-balance estimate over its own tokens,
    averaged over the model axis and then the data axis, in f32 within
    1e-5 of the reference's a2a (the routing does not depend on how the
    experts are regrouped, so 4 x 2 compares too despite ROADMAP R8)."""
    _, ref, port, _ = world
    got, want = port[shape]["a2a"]["f32_a2a"]["aux"], \
        ref[shape]["a2a"]["f32"]["aux"]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert abs(got - port[shape]["a2a"]["f32_one"]["aux"]) > 1e-6


def test_backbone_dispatches_to_a2a_on_the_mesh(world):
    """A reduced olmoe-1b-7b under moe_impl="a2a", the 2 x 4 mesh set as
    the current one in every rank: the backbone's logits and the loss (the
    expert layers' aux summed into it) in f32 within 1e-5 of the
    reference's under its current mesh."""
    _, ref, port, _ = world
    got, want = port[(2, 4)]["backbone"], ref["backbone"]
    assert got["logits"].shape == want["logits"].shape == (2, 32, 512)
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES, ids=["4x2", "2x4"])
def test_a2a_gradients_are_moe_block_s(world, shape):
    """f32: the output, the input's, the router's and the experts'
    gradients within 1e-5 of the one-device moe_block (sums in another
    order).  On 4 x 2 each rank holds two experts, where the reference's
    a2a regroups its buffers by shard instead of by expert (ROADMAP R8):
    its output is far from moe_block's."""
    _, ref, port, _ = world
    got = port[shape]["a2a"]
    for key in ("y", "x_grad", "router_grad", "wi_gate_grad", "wi_up_grad",
                "wo_grad"):
        np.testing.assert_allclose(got["f32_a2a"][key], got["f32_one"][key],
                                   rtol=1e-5, atol=1e-5, err_msg=key)
    for key in ("y", "x_grad"):
        assert np.abs(got["bf16_a2a"][key]
                      - got["bf16_one"][key]).max() < A2A_TOL
    ref_gap = np.abs(ref[shape]["a2a"]["f32"]["y"]
                     - got["f32_one"]["y"]).max()
    assert (ref_gap > 0.1) == (shape == (4, 2)), ref_gap
