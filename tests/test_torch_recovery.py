"""Durable serving (ROADMAP A10, DESIGN.md §16): the port's kill-at-checkpoint
and restore against the JAX package on the CPU, on the same seeds.

Every case of ``tests/test_recovery.py`` is ported; each restored port run
is held, field for field (the wall clock aside), against the reference's
uninterrupted run.  ``sim_minutes`` and spend are compared with ``==``: every
rng stream is the reference's draw for draw.  Then the checkpoints
themselves: the crowd, worker-model and gateway state dicts equal the
reference's JSON at the same point, and both packages killed at the same
checkpoint write the same sidecar (key for key, but ``elapsed`` and
``wall_seconds``) and the same arrays (``priority`` bitwise).  Last, the
``--mode join`` launcher prints the reference launcher's lines."""
import contextlib
import dataclasses
import io
import json
import os

import numpy as np
import pytest
import torch

from repro.core import CrowdGateway as JaxGateway
from repro.core import LatencyModel as JaxLatencyModel
from repro.core import NoisyCrowd as JaxNoisyCrowd
from repro.core import PerfectCrowd as JaxPerfectCrowd
from repro.core import WorkerModel as JaxWorkerModel
from repro.core.crowd import crowd_to_state as jax_crowd_to_state
from repro.core.pairs import PairSet as JaxPairSet
from repro.serve.join_service import JoinService as JaxJoinService
from repro.serve.join_service import ServiceKilled as JaxServiceKilled
from repro_torch.core.crowd import (CrowdGateway, LatencyModel, NoisyCrowd,
                                    PerfectCrowd, WorkerModel,
                                    crowd_from_state, crowd_to_state)
from repro_torch.core.graph import key_sentinel
from repro_torch.core.pairs import PairSet
from repro_torch.serve.join_service import (AdmissionError, AdmissionPolicy,
                                            JoinService, ServiceKilled)
from repro_torch.train.checkpoint import CheckpointManager


def _pairs(seed, n=36, p=110, clusters=7):
    """``tests/test_recovery.py``'s session generator, as numpy arrays."""
    rng = np.random.default_rng(seed)
    assign = rng.integers(0, clusters, n)
    u = rng.integers(0, n, p).astype(np.int32)
    v = rng.integers(0, n, p).astype(np.int32)
    keep = u != v
    u, v = u[keep], v[keep]
    truth = assign[u] == assign[v]
    lik = np.clip(rng.random(len(u)) * 0.5 + truth * 0.4, 0.0, 1.0)
    return u, v, lik.astype(np.float32), truth, n


def _port(seed, **kw):
    return PairSet(*_pairs(seed, **kw))


def _ref(seed, **kw):
    u, v, lik, truth, n = _pairs(seed, **kw)
    return JaxPairSet(u=u, v=v, likelihood=lik, truth=truth, n_objects=n)


def _noisy(seed, **kw):
    return NoisyCrowd(seed=seed, **kw), JaxNoisyCrowd(seed=seed, **kw)


def _fields(res) -> dict:
    out = {}
    for f in dataclasses.fields(res):
        if f.name == "wall_seconds":
            continue
        val = getattr(res, f.name)
        if isinstance(val, np.ndarray):
            val = (val.dtype, val.tolist())
        elif dataclasses.is_dataclass(val):
            val = dataclasses.asdict(val)
        out[f.name] = val
    return out


def _assert_same(got: dict, ref: dict) -> None:
    assert sorted(got) == sorted(ref)
    for r in ref:
        assert _fields(got[r]) == _fields(ref[r]), f"rid {r}"


def _ref_run(svc_kwargs, n_reqs=3, crowd="noisy", crowd_kw=None):
    """The reference's uninterrupted run of ``n_reqs`` sessions."""
    kw = dict(svc_kwargs)
    if "latency" in kw:
        kw["latency"] = JaxLatencyModel(**kw["latency"])
    svc = JaxJoinService(**kw)
    for s in range(n_reqs):
        c = (JaxNoisyCrowd(seed=s, **(crowd_kw or {})) if crowd == "noisy"
             else JaxPerfectCrowd())
        svc.submit(_ref(s), crowd=c)
    return svc.run()


def _port_service(svc_kwargs, n_reqs=3, crowd="noisy", crowd_kw=None,
                  **extra):
    kw = dict(svc_kwargs)
    if "latency" in kw:
        kw["latency"] = LatencyModel(**kw["latency"])
    svc = JoinService(device="cpu", **kw, **extra)
    for s in range(n_reqs):
        c = (NoisyCrowd(seed=s, **(crowd_kw or {})) if crowd == "noisy"
             else PerfectCrowd())
        svc.submit(_port(s), crowd=c)
    return svc


def _killed_then_restored(tmp_path, kill_after, svc_kwargs, **kw):
    """A port service killed right after its ``kill_after``-th checkpoint
    and one restored from disk: (restored results, cents committed at the
    kill, the restored service)."""
    svc = _port_service(svc_kwargs, checkpoint_dir=str(tmp_path), **kw)
    svc._crash_after_checkpoints = kill_after
    with pytest.raises(ServiceKilled):
        svc.run()
    restored = JoinService.restore(str(tmp_path), device="cpu")
    spent_at_kill = restored.last_recovery["spent_cents"]
    return restored.run(), spent_at_kill, restored


# ---------------------------------------------------------------------------
# tests/test_recovery.py, ported
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("async_mode", [False, True],
                         ids=["round_barrier", "async"])
def test_kill_restore_label_parity(tmp_path, async_mode):
    """Kill at checkpoint 2, restore, finish: every field of every result
    is the reference's uninterrupted run's."""
    kw = dict(lanes=2, async_mode=async_mode)
    rec, _, _ = _killed_then_restored(tmp_path, 2, kw)
    _assert_same(rec, _ref_run(kw))


def test_kill_restore_parity_latency_em_requery(tmp_path):
    """The hard configuration: async ID/NF over a simulated worker pool, EM
    aggregation, requery escalation; the tickets in flight, the platform
    clock and the worker model come back, so ``sim_minutes`` is the
    reference's as a float."""
    kw = dict(lanes=2, async_mode=True, nf=True,
              latency=dict(n_workers=10, seed=3), aggregation="em",
              conflict_policy="requery")
    crowd_kw = dict(error_rate=0.15, n_workers=12)
    ref = _ref_run(kw, crowd_kw=crowd_kw)
    rec, _, _ = _killed_then_restored(
        tmp_path, 4, dict(kw, checkpoint_every=3), crowd_kw=crowd_kw)
    _assert_same(rec, ref)


def test_restore_never_rebills_answered_pairs(tmp_path):
    """The recovered total spend is the uninterrupted total; what was
    committed at the kill is never bought again."""
    kw = dict(lanes=2)
    ref = _ref_run(kw)
    total_ref = sum(r.n_spent_cents for r in ref.values())
    rec, spent_at_kill, _ = _killed_then_restored(tmp_path, 2, kw)
    assert sum(r.n_spent_cents for r in rec.values()) == total_ref
    assert 0 < spent_at_kill < total_ref


def test_restore_brings_back_results_queue_and_sidecar(tmp_path):
    """A request finished before the kill comes back in ``results``; one
    still queued serves after the restore; ``last_recovery`` counts them."""
    kw = dict(lanes=1)
    svc = _port_service(kw, crowd="perfect", checkpoint_dir=str(tmp_path))
    svc._crash_after_checkpoints = 2
    with pytest.raises(ServiceKilled):
        svc.run()
    restored = JoinService.restore(str(tmp_path), device="cpu")
    info = restored.last_recovery
    assert info["n_results"] >= 1
    assert info["n_results"] + info["n_lanes"] + info["n_queued"] == 3
    pre = dict(restored.results)
    out = restored.run()
    ref = _ref_run(kw, crowd="perfect")
    _assert_same(out, ref)
    for r, res in pre.items():  # finished-before-kill results round-trip
        assert _fields(res) == _fields(ref[r])


def _epochs(seed, pairs_fn):
    all_pairs = pairs_fn(seed, p=140)
    k = len(all_pairs) // 2
    return [all_pairs.take(np.arange(k)),
            all_pairs.take(np.arange(k, len(all_pairs)))]


def test_restore_streaming_arrivals(tmp_path):
    """Pending arrival epochs survive the kill: the restored run ingests
    them and matches the reference's uninterrupted stream."""
    ref_svc = JaxJoinService(lanes=1)
    ref_rid = ref_svc.submit_stream(_epochs(0, _ref),
                                    crowd=JaxNoisyCrowd(seed=0))
    ref = ref_svc.run()
    svc = JoinService(lanes=1, checkpoint_dir=str(tmp_path), device="cpu")
    rid = svc.submit_stream(_epochs(0, _port), crowd=NoisyCrowd(seed=0))
    svc._crash_after_checkpoints = 1
    with pytest.raises(ServiceKilled):
        svc.run()
    restored = JoinService.restore(str(tmp_path), device="cpu")
    assert restored._pending_arrivals
    assert rid == ref_rid
    _assert_same(restored.run(), ref)


def test_admission_max_pending_sheds():
    """A submit that finds the queue at ``max_pending`` raises without
    enqueueing; ``admission_deferred`` marks the request that waited."""
    svc = JoinService(lanes=1, admission=AdmissionPolicy(max_pending=2),
                      device="cpu")
    r0 = svc.submit(_port(0))
    r1 = svc.submit(_port(1))
    with pytest.raises(AdmissionError):
        svc.submit(_port(2))
    assert svc.n_shed == 1
    assert len(svc.queue) == 2
    res = svc.run()
    assert not res[r0].admission_deferred
    assert res[r1].admission_deferred
    from repro.serve.join_service import AdmissionPolicy as JaxPolicy
    ref_svc = JaxJoinService(lanes=1, admission=JaxPolicy(max_pending=2))
    ref_svc.submit(_ref(0))
    ref_svc.submit(_ref(1))
    _assert_same(res, ref_svc.run())


def test_admission_budget_envelope_clamps_and_frees():
    """An uncapped request is clamped to the envelope (and flagged), a
    second submit against the reserved envelope sheds, and finalize turns
    the reservation into realized spend — the reference's figures."""
    svc = JoinService(lanes=2,
                      admission=AdmissionPolicy(global_budget_cents=50.0),
                      device="cpu")
    ra = svc.submit(_port(0), crowd=NoisyCrowd(seed=0))
    with pytest.raises(AdmissionError):
        svc.submit(_port(1), crowd=NoisyCrowd(seed=1))
    out = svc.run()
    res = out[ra]
    assert res.envelope_clamped
    assert res.n_spent_cents <= 50.0 + 1e-9
    assert svc._envelope_reserved == 0.0
    assert svc._envelope_spent == res.n_spent_cents
    from repro.serve.join_service import AdmissionPolicy as JaxPolicy
    ref_svc = JaxJoinService(
        lanes=2, admission=JaxPolicy(global_budget_cents=50.0))
    ref_svc.submit(_ref(0), crowd=JaxNoisyCrowd(seed=0))
    _assert_same(out, ref_svc.run())
    assert svc._envelope_spent == ref_svc._envelope_spent
    if svc._envelope_spent < 50.0:
        svc.submit(_port(2), crowd=NoisyCrowd(seed=2))


def test_admission_envelope_survives_restore(tmp_path):
    """The envelope's ledgers are checkpointed: a restored service still
    refuses what the envelope cannot fund, and finishes as the reference."""
    svc = JoinService(lanes=1, checkpoint_dir=str(tmp_path),
                      admission=AdmissionPolicy(global_budget_cents=40.0),
                      device="cpu")
    svc.submit(_port(0), crowd=NoisyCrowd(seed=0))
    svc._crash_after_checkpoints = 1
    with pytest.raises(ServiceKilled):
        svc.run()
    restored = JoinService.restore(str(tmp_path), device="cpu")
    assert restored._envelope_reserved == 40.0
    with pytest.raises(AdmissionError):
        restored.submit(_port(1), crowd=NoisyCrowd(seed=1))
    from repro.serve.join_service import AdmissionPolicy as JaxPolicy
    ref_svc = JaxJoinService(
        lanes=1, admission=JaxPolicy(global_budget_cents=40.0))
    ref_svc.submit(_ref(0), crowd=JaxNoisyCrowd(seed=0))
    with pytest.raises(Exception):  # the reference sheds it too
        ref_svc.submit(_ref(1), crowd=JaxNoisyCrowd(seed=1))
    _assert_same(restored.run(), ref_svc.run())


def test_checkpoint_every_validates():
    with pytest.raises(ValueError, match="checkpoint_every"):
        JoinService(checkpoint_every=0, device="cpu")


def test_restore_without_sidecar_rejected(tmp_path):
    """A checkpoint without a serving sidecar is not read as serving
    state."""
    CheckpointManager(tmp_path).save(0, {"x": np.ones(3)})
    with pytest.raises(FileNotFoundError, match="sidecar"):
        JoinService.restore(str(tmp_path), device="cpu")


def test_perfect_crowd_fused_path_parity(tmp_path):
    """``PerfectCrowd`` sessions ride the fused path; a kill between fused
    waves restores and still gives the reference's uninterrupted run."""
    kw = dict(lanes=2)
    rec, _, _ = _killed_then_restored(tmp_path, 2, kw, crowd="perfect")
    _assert_same(rec, _ref_run(kw, crowd="perfect"))


# ---------------------------------------------------------------------------
# the checkpoint contents against the reference's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["homogeneous", "pool"])
def test_crowd_state_dicts_equal_reference(kind):
    """After the same draws a ``NoisyCrowd``'s state is the reference's JSON,
    and a crowd rebuilt from it draws on as the original does."""
    kw = dict(error_rate=0.2, seed=4)
    if kind == "pool":
        kw.update(n_workers=9)
    port, ref = NoisyCrowd(**kw), JaxNoisyCrowd(**kw)
    ps, ref_ps = _port(0), _ref(0)
    for i in range(7):
        port.ask_ballot(ps, i, exclude=(1, 2))
        ref.ask_ballot(ref_ps, i, exclude=(1, 2))
    state = crowd_to_state(port)
    assert json.loads(json.dumps(state)) == \
        json.loads(json.dumps(jax_crowd_to_state(ref)))
    back = crowd_from_state(json.loads(json.dumps(state)))
    for i in range(7, 12):
        a, b = back.ask_ballot(ps, i), port.ask_ballot(ps, i)
        assert (a.label, a.votes, a.workers) == (b.label, b.votes, b.workers)
    perfect = PerfectCrowd()
    perfect._fresh_workers(5)
    ref_perfect = JaxPerfectCrowd()
    ref_perfect._fresh_workers(5)
    assert crowd_to_state(perfect) == jax_crowd_to_state(ref_perfect)
    assert crowd_from_state(crowd_to_state(perfect))._fresh_workers(1) == (5,)
    wm, ref_wm = WorkerModel(), JaxWorkerModel()
    for votes, workers in (((1, 0, 1), (3, 4, 5)), ((0, 0, 1), (3, 6, 5))):
        wm.record(votes, workers)
        ref_wm.record(votes, workers)
    assert wm.state_dict() == ref_wm.state_dict()
    wm2 = WorkerModel()
    wm2.load_state_dict(json.loads(json.dumps(wm.state_dict())))
    assert wm2.state_dict() == wm.state_dict()


GATEWAY_MODES = {
    "immediate": dict(),
    "immediate_em": dict(aggregation="em"),
    "latency": dict(latency=dict(n_workers=3, mean_minutes=10.0, seed=5)),
    "latency_nf_em": dict(latency=dict(n_workers=3, mean_minutes=10.0,
                                       seed=5), nf=True, aggregation="em"),
}


def _gateways(mode):
    kw = dict(GATEWAY_MODES[mode])
    lat = kw.pop("latency", None)
    port = CrowdGateway(latency=None if lat is None else LatencyModel(**lat),
                        **kw)
    ref = JaxGateway(latency=None if lat is None else JaxLatencyModel(**lat),
                     **kw)
    return port, ref


def _answers(got):
    return [(a.rid, a.index, a.label, a.minutes, tuple(a.votes),
             tuple(a.workers)) for a in got]


@pytest.mark.parametrize("mode", sorted(GATEWAY_MODES))
def test_gateway_state_dict_equals_reference(mode):
    """One-vote posts, noisy ballots, a cluster task and a requery leave
    answers waiting or running: the gateway's state is the reference's JSON
    (``seen`` with the one-vote runs folded in, ``waiting`` in the
    reference's list order), and the port's gateway rebuilt from either
    package's state answers on as the reference does."""
    port, ref = _gateways(mode)
    ps, ref_ps = _port(1), _ref(1)
    crowds = {"perfect": (PerfectCrowd(), JaxPerfectCrowd()),
              "noisy": _noisy(2, error_rate=0.3, n_workers=8)}

    def both(name, *args, **kw):
        (c, rc) = crowds[kw.pop("crowd")]
        a = getattr(port, name)(args[0], ps, *args[1:], c, **kw)
        b = getattr(ref, name)(args[0], ref_ps, *args[1:], rc, **kw)
        return a, b

    both("post", 0, range(0, 6), crowd="perfect", cents_per_assignment=2.0)
    both("post", 1, [9, 7, 8], crowd="noisy", cents_per_assignment=1.5)
    both("post_cluster", 1, [10, 11, 12, 13], crowd="noisy", cents=4.0,
         n_assignments=2, pair_cents_per_assignment=1.5)
    if port.latency is not None:
        assert _answers(port.poll()) == _answers(ref.poll())
    both("requery", 1, [9, 7], crowd="noisy", cents_per_assignment=1.5)
    both("post", 0, range(20, 26), crowd="perfect", cents_per_assignment=2.0)
    state = json.loads(json.dumps(port.state_dict()))
    ref_state = json.loads(json.dumps(ref.state_dict()))
    assert state == ref_state
    assert state["waiting"]
    for source in (state, ref_state):
        back, _ = _gateways(mode)
        back.load_state_dict(source)
        assert back.in_flight == ref.in_flight
        assert json.loads(json.dumps(back.state_dict())) == ref_state
    back, _ = _gateways(mode)
    back.load_state_dict(ref_state)
    assert _answers(back.drain()) == _answers(ref.drain())
    assert back.now_minutes == ref.now_minutes


def _kill(svc, k):
    svc._crash_after_checkpoints = k
    with pytest.raises((ServiceKilled, JaxServiceKilled)):
        svc.run()


def _latest(path):
    steps = sorted(d for d in os.listdir(path) if d.startswith("step_"))
    d = os.path.join(path, steps[-1])
    side = json.load(open(os.path.join(d, "sidecar.json")))
    manifest = json.load(open(os.path.join(d, "manifest.json")))
    with np.load(os.path.join(d, "arrays.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    return side, manifest, arrays


def _strip(side):
    """The sidecar without wall clocks."""
    side = json.loads(json.dumps(side))
    for lane in side.get("lanes", []):
        del lane["elapsed"]
    for res in side.get("results", {}).values():
        del res["wall_seconds"]
    return side


SAME_POINT = {
    "round_barrier": (dict(lanes=2, fused_rounds=False), 3),
    "async_immediate": (dict(lanes=2, async_mode=True), 2),
    "async_latency_em_requery": (
        dict(lanes=2, async_mode=True, nf=True,
             latency=dict(n_workers=10, seed=3), aggregation="em",
             conflict_policy="requery", checkpoint_every=3), 4),
}


@pytest.mark.parametrize("config", sorted(SAME_POINT))
def test_both_packages_checkpoint_the_same_state(tmp_path, config):
    """Both packages killed at the same checkpoint write the same sidecar,
    key for key (the wall clocks aside), the same manifest (class paths by
    name) and the same arrays, dtype for dtype and bit for bit."""
    svc_kwargs, k = SAME_POINT[config]
    crowd_kw = (dict(error_rate=0.15, n_workers=12)
                if "em" in config else None)
    port = _port_service(svc_kwargs, crowd_kw=crowd_kw,
                         checkpoint_dir=str(tmp_path / "port"))
    kw = dict(svc_kwargs)
    if "latency" in kw:
        kw["latency"] = JaxLatencyModel(**kw["latency"])
    ref = JaxJoinService(checkpoint_dir=str(tmp_path / "ref"), **kw)
    for s in range(3):
        ref.submit(_ref(s), crowd=JaxNoisyCrowd(seed=s, **(crowd_kw or {})))
    _kill(port, k)
    _kill(ref, k)
    side, manifest, arrays = _latest(tmp_path / "port")
    ref_side, ref_manifest, ref_arrays = _latest(tmp_path / "ref")
    assert side.get("lanes"), "the kill must land with lanes open"
    assert _strip(side) == _strip(ref_side)
    for key in ("step", "keys", "dtypes", "statics", "extra"):
        assert manifest[key] == ref_manifest[key], key
    assert {p: c.rsplit(".", 1)[1] for p, c in manifest["classes"].items()} \
        == {p: c.rsplit(".", 1)[1] for p, c in ref_manifest["classes"].items()}
    assert sorted(arrays) == sorted(ref_arrays)
    for name, a in arrays.items():
        b = ref_arrays[name]
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name


def test_restored_service_has_no_embedding_index(tmp_path):
    """Streaming embedding indexes are not checkpointed, in the reference
    either: after a restore ``append_embeddings`` refuses the rid as the
    reference's does, and the request still finishes on its scored pairs."""
    rng = np.random.default_rng(0)
    base = rng.normal(size=(4, 8)).astype(np.float32)
    emb = base[np.arange(16) % 4] + \
        0.05 * rng.normal(size=(16, 8)).astype(np.float32)
    svc = JoinService(lanes=1, checkpoint_dir=str(tmp_path), device="cpu")
    rid = svc.submit_embeddings(emb[:8], emb[8:], 0.3, streaming=True,
                                truth_fn=lambda r, c: r % 4 == c % 4)
    svc._crash_after_checkpoints = 1
    with pytest.raises(ServiceKilled):
        svc.run()
    restored = JoinService.restore(str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="no cached embedding index"):
        restored.append_embeddings(rid, emb[:2])
    assert rid in restored.run()


def test_restore_widened_int64_lane(tmp_path):
    """A lane whose universe passed 46340 objects while open (its keys
    widened to int64 at ingest) restores with int64 neg keys padded with
    the int64 sentinel, not re-derived, and finishes as the uninterrupted
    run does."""
    rng = np.random.default_rng(7)
    low = rng.choice(30000, 60, replace=False)
    high = 46341 + rng.choice(65536 - 46341, 60, replace=False)
    ent = np.zeros(65536, np.int64)
    ent[low] = rng.integers(0, 6, 60)
    ent[high] = rng.integers(0, 6, 60)

    def epoch(pool, p):
        u, v = rng.choice(pool, p), rng.choice(pool, p)
        keep = u != v
        u, v = u[keep], v[keep]
        truth = ent[u] == ent[v]
        lik = np.clip(0.5 + 0.3 * (truth - 0.5)
                      + 0.2 * rng.random(len(u)), 0, 1).astype(np.float32)
        return PairSet(u, v, lik, truth,
                       n_objects=int(max(u.max(), v.max())) + 1)

    both = np.concatenate([low, high])
    epochs = [epoch(low, 200), epoch(both, 200), epoch(both, 200),
              epoch(both, 200)]

    def serve(**kw):
        svc = JoinService(lanes=1, fused_rounds=False, device="cpu", **kw)
        svc.submit_stream(epochs, crowd=NoisyCrowd(seed=1, error_rate=0.2),
                          interleave=True)
        return svc

    base = serve().run()
    svc = serve(checkpoint_dir=str(tmp_path))
    svc._crash_after_checkpoints = 3
    with pytest.raises(ServiceKilled):
        svc.run()
    restored = JoinService.restore(str(tmp_path), device="cpu")
    lanes, _ = restored._resume
    keys = lanes[0].state.neg_keys
    assert lanes[0].state.n_objects == 65536
    assert keys.dtype == torch.int64
    pad = keys == key_sentinel(torch.int64)
    assert key_sentinel(torch.int64) == 2 ** 63 - 1
    assert bool(pad.any()) and bool((~pad).any())  # real neg keys, padded
    assert restored.last_recovery["spent_cents"] > 0
    _assert_same(restored.run(), base)


# ---------------------------------------------------------------------------
# the --mode join launcher
# ---------------------------------------------------------------------------
def _launch(main, argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


def test_join_launcher_prints_the_reference_lines(tmp_path, monkeypatch):
    """``--mode join --kill-after 2`` then ``--resume``: every line the
    reference launcher prints, the checkpoint paths aside."""
    import sys

    from repro.launch import serve as jax_serve
    from repro_torch.launch import serve as port_serve

    def jax_main(argv):
        monkeypatch.setattr(sys, "argv", ["serve"] + argv)
        jax_serve.main()

    lines = {}
    for name, main, extra in (("port", port_serve.main, ["--device", "cpu"]),
                              ("ref", jax_main, [])):
        ckpt = str(tmp_path / name)
        args = ["--mode", "join", "--checkpoint-dir", ckpt] + extra
        text = _launch(main, args + ["--kill-after", "2"]) \
            + _launch(main, args + ["--resume"])
        lines[name] = text.replace(ckpt, "CKPT").splitlines()
    assert lines["port"] == lines["ref"]
    assert lines["port"][-1] == "[serve] 8 join requests completed"
