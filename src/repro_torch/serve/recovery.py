"""Serving-state capture and restore for :class:`JoinService` (DESIGN.md §16;
the port of ``repro/serve/recovery.py``, with its on-disk schema).

``capture_service`` turns the whole serving state — the open lanes (their
``SessionState`` tensors pulled to the host), the admitted queue, finished
results, pending arrival epochs, the gateway's tickets and spend ledgers,
and the admission envelope — into the ``(tree, sidecar)`` pair the
:class:`~repro_torch.train.checkpoint.CheckpointManager` commits atomically:
arrays ride the npz, everything else the JSON sidecar.

``restore_service`` inverts it on any device: it rebuilds the service from
the saved configuration, the lanes (each ``SessionState`` back on the
service's device under the capacity bucket it had, its pair keys in the
dtype they were saved in — int64 with the int64 sentinel past 46340
objects) and the gateway (tickets in flight come back as checkpointed: the
crowd was asked and billed at post time, so a restored run never buys an
answered pair again), and parks them in ``service._resume`` for the next
:meth:`JoinService.run`.  Every rng stream (crowds, platform, worker model)
is checkpointed exactly, so the resumed run's labels are an uninterrupted
run's under both serving disciplines.

As in the reference, streaming embedding indexes
(``submit_embeddings(streaming=True)``) are not checkpointed: a restored
request keeps its scored pairs and pending arrival epochs, but
``append_embeddings`` needs a live index and must be re-submitted.
Requests sharing one crowd instance come back with independent copies.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.crowd import (CostModel, CrowdGateway, LatencyModel,
                                    crowd_from_state, crowd_to_state)
from repro_torch.core.graph import SessionState
from repro_torch.core.metrics import Quality
from repro_torch.core.pairs import PairSet
from repro_torch.device import DeviceLike

_VERSION = 1


def _host(x: Any) -> np.ndarray:
    """A restored leaf (a CPU tensor) or a live array as numpy."""
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# -- pair sets ---------------------------------------------------------------
def _pairs_arrays(pairs: PairSet) -> Dict[str, np.ndarray]:
    out = {"u": np.asarray(pairs.u), "v": np.asarray(pairs.v),
           "lik": np.asarray(pairs.likelihood)}
    if pairs.truth is not None:
        out["truth"] = np.asarray(pairs.truth, bool)
    return out


def _pairs_meta(pairs: PairSet) -> dict:
    return {"n_objects": int(pairs.n_objects)}


def _pairs_from(arrays: Dict[str, Any], meta: dict) -> PairSet:
    truth = arrays.get("truth")
    return PairSet(u=_host(arrays["u"]), v=_host(arrays["v"]),
                   likelihood=_host(arrays["lik"]),
                   truth=None if truth is None else _host(truth),
                   n_objects=int(meta["n_objects"]))


# -- join requests -----------------------------------------------------------
def _request_arrays(req) -> Dict[str, Any]:
    out: Dict[str, Any] = {"pairs": _pairs_arrays(req.pairs)}
    if req.seed_labels is not None:
        out["seed"] = np.asarray(req.seed_labels, np.int32)
    return out


def _request_meta(req) -> dict:
    return {
        "rid": int(req.rid),
        "order": req.order,
        "total_true_matches": (None if req.total_true_matches is None
                               else int(req.total_true_matches)),
        "budget_cents": (None if req.budget_cents is None
                         else float(req.budget_cents)),
        "cost_per_assignment": (None if req.cost_per_assignment is None
                                else float(req.cost_per_assignment)),
        "admission_deferred": bool(req.admission_deferred),
        "envelope_clamped": bool(req.envelope_clamped),
        "crowd": crowd_to_state(req.crowd),
        "pairs": _pairs_meta(req.pairs),
    }


def _request_from(arrays: Dict[str, Any], meta: dict):
    from repro_torch.serve.join_service import JoinRequest
    seed = arrays.get("seed")
    return JoinRequest(
        rid=int(meta["rid"]),
        pairs=_pairs_from(arrays["pairs"], meta["pairs"]),
        crowd=crowd_from_state(meta["crowd"]),
        order=meta["order"],
        total_true_matches=meta["total_true_matches"],
        budget_cents=meta["budget_cents"],
        cost_per_assignment=meta["cost_per_assignment"],
        seed_labels=None if seed is None else _host(seed),
        admission_deferred=bool(meta["admission_deferred"]),
        envelope_clamped=bool(meta["envelope_clamped"]))


# -- lanes -------------------------------------------------------------------
def _lane_arrays(lane) -> Dict[str, Any]:
    return {
        "session": lane.state,   # a dataclass: its tensors go to the host
        "perm": np.asarray(lane.perm),
        "labels": np.asarray(lane.labels_host, np.int32),
        "crowdsourced": np.asarray(lane.crowdsourced, bool),
        "inflight": np.asarray(lane.inflight_host, bool),
        "req": _request_arrays(lane.req),
    }


def _lane_meta(lane) -> dict:
    return {
        "req": _request_meta(lane.req),
        "p": int(lane.p),
        "round_sizes": [int(n) for n in lane.round_sizes],
        "in_flight": int(lane.in_flight),
        "n_requeried": int(lane.n_requeried),
        "budget_stopped": bool(lane.budget_stopped),
        "fused_ok": bool(lane.fused_ok),
        "n_cache_hits": int(lane.n_cache_hits),
        "n_cluster_tasks": int(lane.n_cluster_tasks),
        "n_cluster_cents": float(lane.n_cluster_cents),
        "elapsed": float(time.perf_counter() - lane.t0),
    }


def _lane_from(service, arrays: Dict[str, Any], meta: dict):
    from repro_torch.serve.join_service import _Lane
    req = _request_from(arrays["req"], meta["req"])
    perm = _host(arrays["perm"])
    ordered = req.pairs.take(perm)
    # the session comes back as host tensors in the dtypes it was saved in
    # (int64 neg keys past 46340 objects); one copy puts it back on the
    # service's device under the capacity bucket it had
    saved = arrays["session"]
    state = SessionState(
        **{f: getattr(saved, f).to(service.device)
           for f in SessionState.TENSOR_FIELDS},
        n_objects=int(saved.n_objects))
    p_cap = int(state.u.shape[0])
    p = int(meta["p"])
    prior_host = np.zeros(p_cap, np.float32)
    prior_host[:p] = ordered.likelihood
    adaptive = req.order == "adaptive"
    rate = (req.cost_per_assignment if req.cost_per_assignment is not None
            else service.cost.cents_per_assignment)
    return _Lane(
        req=req,
        perm=perm,
        ordered=ordered,
        p=p,
        state=state,
        labels_host=np.asarray(_host(arrays["labels"]), np.int32),
        crowdsourced=np.asarray(_host(arrays["crowdsourced"]), bool),
        round_sizes=list(meta["round_sizes"]),
        t0=time.perf_counter() - float(meta["elapsed"]),
        prior_host=prior_host,
        prior_dev=(torch.from_numpy(prior_host).to(service.device)
                   if service.async_mode and (
                       adaptive or req.budget_cents is not None) else None),
        adaptive=adaptive,
        rate_cents=float(rate),
        per_pair_cents=float(rate) * getattr(req.crowd, "n_assignments", 1),
        budget_cents=req.budget_cents,
        inflight_host=np.asarray(_host(arrays["inflight"]), bool),
        answers_host=req.crowd.precomputed_answers(ordered),
        fused_ok=bool(meta["fused_ok"]),
        n_cache_hits=int(meta["n_cache_hits"]),
        in_flight=int(meta["in_flight"]),
        n_requeried=int(meta["n_requeried"]),
        budget_stopped=bool(meta["budget_stopped"]),
        n_cluster_tasks=int(meta["n_cluster_tasks"]),
        n_cluster_cents=float(meta["n_cluster_cents"]),
    )


# -- results -----------------------------------------------------------------
def _result_arrays(res) -> Dict[str, np.ndarray]:
    return {"labels": np.asarray(res.labels, bool),
            "crowdsourced": np.asarray(res.crowdsourced, bool)}


def _result_meta(res) -> dict:
    q = None
    if res.quality is not None:
        q = {"precision": float(res.quality.precision),
             "recall": float(res.quality.recall),
             "f_measure": float(res.quality.f_measure),
             "tp": int(res.quality.tp), "fp": int(res.quality.fp),
             "fn": int(res.quality.fn)}
    return {
        "rid": int(res.rid),
        "n_rounds": int(res.n_rounds),
        "round_sizes": [int(n) for n in res.round_sizes],
        "n_hits": int(res.n_hits),
        "cost_cents": float(res.cost_cents),
        "quality": q,
        "wall_seconds": float(res.wall_seconds),
        "sim_minutes": (None if res.sim_minutes is None
                        else float(res.sim_minutes)),
        "fold_rounds": int(res.fold_rounds),
        "n_conflicts": int(res.n_conflicts),
        "n_requeried": int(res.n_requeried),
        "n_spent_cents": float(res.n_spent_cents),
        "stopped_on_budget": bool(res.stopped_on_budget),
        "n_cache_hits": int(res.n_cache_hits),
        "n_cluster_tasks": int(res.n_cluster_tasks),
        "n_cluster_pairs": int(res.n_cluster_pairs),
        "n_cluster_cents": float(res.n_cluster_cents),
        "admission_deferred": bool(res.admission_deferred),
        "envelope_clamped": bool(res.envelope_clamped),
    }


def _result_from(arrays: Dict[str, Any], meta: dict):
    from repro_torch.serve.join_service import JoinSessionResult
    q = meta["quality"]
    return JoinSessionResult(
        rid=int(meta["rid"]),
        labels=np.asarray(_host(arrays["labels"]), bool),
        crowdsourced=np.asarray(_host(arrays["crowdsourced"]), bool),
        n_rounds=int(meta["n_rounds"]),
        round_sizes=list(meta["round_sizes"]),
        n_hits=int(meta["n_hits"]),
        cost_cents=float(meta["cost_cents"]),
        quality=None if q is None else Quality(**q),
        wall_seconds=float(meta["wall_seconds"]),
        sim_minutes=meta["sim_minutes"],
        fold_rounds=int(meta["fold_rounds"]),
        n_conflicts=int(meta["n_conflicts"]),
        n_requeried=int(meta["n_requeried"]),
        n_spent_cents=float(meta["n_spent_cents"]),
        stopped_on_budget=bool(meta["stopped_on_budget"]),
        n_cache_hits=int(meta["n_cache_hits"]),
        n_cluster_tasks=int(meta["n_cluster_tasks"]),
        n_cluster_pairs=int(meta["n_cluster_pairs"]),
        n_cluster_cents=float(meta["n_cluster_cents"]),
        admission_deferred=bool(meta["admission_deferred"]),
        envelope_clamped=bool(meta["envelope_clamped"]))


# -- service config ----------------------------------------------------------
def _service_config(service) -> dict:
    """The constructor's options, as the reference saves them (the device
    is the restoring caller's choice, not part of the state)."""
    return {
        "lanes": int(service.lanes),
        "cost": dataclasses.asdict(service.cost),
        "latency": (None if service.latency is None
                    else dataclasses.asdict(service.latency)),
        "async_mode": bool(service.async_mode),
        "nf": bool(service.nf),
        "conflict_policy": service.conflict_policy,
        "order": service.order,
        "budget_cents": (None if service.budget_cents is None
                         else float(service.budget_cents)),
        "cost_per_assignment": (
            None if service.cost_per_assignment is None
            else float(service.cost_per_assignment)),
        "slots_per_round": (None if service.slots_per_round is None
                            else int(service.slots_per_round)),
        "fused_rounds": bool(service.fused_rounds),
        "aggregation": service.aggregation,
        "cluster_tasks": bool(service.cluster_tasks),
        "cluster_size": int(service.cluster_size),
        "cluster_assignments": int(service.cluster_assignments),
        "admission": (None if service.admission is None
                      else dataclasses.asdict(service.admission)),
        "cache_path": service.cache_path,
        "checkpoint_every": int(service.checkpoint_every),
        "checkpoint_keep": int(service.checkpoint_keep),
    }


# -- capture -----------------------------------------------------------------
def capture_service(service, active: list,
                    gateway: CrowdGateway) -> Tuple[dict, dict]:
    """Snapshot a running service into ``(tree, sidecar)``: ``tree`` holds
    every array (lane sessions, pair sets, result labels) for the npz;
    ``sidecar`` the JSON rest — configuration, ledgers, gateway tickets,
    per-lane and per-request metadata in the order of the tree's keyed
    entries.  ``active`` are the open lanes, their group stacks flushed."""
    tree: Dict[str, Any] = {}
    side: Dict[str, Any] = {
        "version": _VERSION,
        "config": _service_config(service),
        "next_rid": int(service._next_rid),
        "n_shed": int(service.n_shed),
        "envelope_spent": float(service._envelope_spent),
        "envelope_reserved": float(service._envelope_reserved),
        # the step being written now is service._ckpt_step; the restored
        # service continues at the next one
        "ckpt_step": int(service._ckpt_step) + 1,
        "ckpt_tick": int(service._ckpt_tick),
        "gateway": gateway.state_dict(),
        "interleave": {str(r): bool(v) for r, v in
                       service._stream_interleave.items()},
        "cache_fps": {str(r): [list(fu), list(fv)] for r, (fu, fv) in
                      service._cache_fps.items()},
    }
    if active:
        tree["lanes"] = {f"{i:03d}": _lane_arrays(lane)
                         for i, lane in enumerate(active)}
        side["lanes"] = [_lane_meta(lane) for lane in active]
    if service.queue:
        tree["queue"] = {f"{i:03d}": _request_arrays(r)
                         for i, r in enumerate(service.queue)}
        side["queue"] = [_request_meta(r) for r in service.queue]
    if service.results:
        tree["results"] = {str(r): _result_arrays(res)
                           for r, res in service.results.items()}
        side["results"] = {str(r): _result_meta(res)
                           for r, res in service.results.items()}
    if service._pending_arrivals:
        tree["arrivals"] = {
            str(r): {f"{i:03d}": _pairs_arrays(p)
                     for i, p in enumerate(epochs)}
            for r, epochs in service._pending_arrivals.items()}
        side["arrivals"] = {
            str(r): [_pairs_meta(p) for p in epochs]
            for r, epochs in service._pending_arrivals.items()}
    return tree, side


# -- restore -----------------------------------------------------------------
def restore_service(cls, checkpoint_dir: str, step: Optional[int] = None,
                    cluster_cache=None, device: DeviceLike = None):
    """Rebuild a :class:`JoinService` from a checkpoint directory on
    ``device``: the saved configuration (a fresh ``CheckpointManager`` on
    the same directory, so checkpoints continue at the next step), the
    queue, results, arrival epochs, envelope counters, and — parked in
    ``service._resume`` — the lanes and gateway the next run resumes.
    ``cluster_cache`` overrides the cache (by default the saved
    ``cache_path``, if any, is reloaded).  ``service.last_recovery`` says
    what came back."""
    from repro_torch.serve.join_service import AdmissionPolicy
    from repro_torch.train.checkpoint import CheckpointManager

    mgr = CheckpointManager(checkpoint_dir)
    got_step, tree, _ = mgr.restore(step)
    side = mgr.sidecar(got_step)
    if side is None:
        raise FileNotFoundError(
            f"checkpoint step {got_step} in {checkpoint_dir} has no serving "
            "sidecar — was it written by JoinService checkpointing?")
    cfg = side["config"]
    service = cls(
        lanes=cfg["lanes"],
        cost=CostModel(**cfg["cost"]),
        latency=(None if cfg["latency"] is None
                 else LatencyModel(**cfg["latency"])),
        async_mode=cfg["async_mode"],
        nf=cfg["nf"],
        conflict_policy=cfg["conflict_policy"],
        order=cfg["order"],
        budget_cents=cfg["budget_cents"],
        cost_per_assignment=cfg["cost_per_assignment"],
        slots_per_round=cfg["slots_per_round"],
        fused_rounds=cfg["fused_rounds"],
        aggregation=cfg["aggregation"],
        cluster_tasks=cfg["cluster_tasks"],
        cluster_size=cfg["cluster_size"],
        cluster_assignments=cfg["cluster_assignments"],
        admission=(None if cfg["admission"] is None
                   else AdmissionPolicy(**cfg["admission"])),
        cluster_cache=cluster_cache,
        cache_path=cfg["cache_path"],
        checkpoint_dir=checkpoint_dir,
        checkpoint_every=cfg["checkpoint_every"],
        checkpoint_keep=cfg["checkpoint_keep"],
        device=device)
    service._next_rid = int(side["next_rid"])
    service.n_shed = int(side["n_shed"])
    service._envelope_spent = float(side["envelope_spent"])
    service._envelope_reserved = float(side["envelope_reserved"])
    service._ckpt_step = int(side["ckpt_step"])
    service._ckpt_tick = int(side["ckpt_tick"])
    service._stream_interleave = {int(r): bool(v) for r, v in
                                  side.get("interleave", {}).items()}
    service._cache_fps = {int(r): (list(fu), list(fv)) for r, (fu, fv) in
                          side.get("cache_fps", {}).items()}
    for r, meta in side.get("results", {}).items():
        service.results[int(r)] = _result_from(tree["results"][r], meta)
    for i, meta in enumerate(side.get("queue", [])):
        service.queue.append(
            _request_from(tree["queue"][f"{i:03d}"], meta))
    for r, metas in side.get("arrivals", {}).items():
        service._pending_arrivals[int(r)] = collections.deque(
            _pairs_from(tree["arrivals"][r][f"{i:03d}"], m)
            for i, m in enumerate(metas))
    gateway = CrowdGateway(latency=service.latency, nf=service.nf,
                           aggregation=service.aggregation)
    gateway.load_state_dict(side["gateway"])
    lanes = [_lane_from(service, tree["lanes"][f"{i:03d}"], meta)
             for i, meta in enumerate(side.get("lanes", []))]
    service._resume = (lanes, gateway)
    service.last_recovery = {
        "step": int(got_step),
        "n_lanes": len(lanes),
        "n_queued": len(service.queue),
        "n_results": len(service.results),
        "in_flight": int(gateway.in_flight),
        "spent_cents": float(sum(side["gateway"]["spent_cents"].values())),
    }
    return service
