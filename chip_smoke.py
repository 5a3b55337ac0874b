#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
CUDA device and exits non-zero on any failure; no phase catches an error and
carries on.  Phases, one output line or block each:

1. environment: torch and CUDA versions, the card's name and power limit;
2. build: the port's CUDA kernels, compiled from ``src/repro_torch/csrc``;
3. each kernel against its plain PyTorch version on the card, at the main
   path's shapes: ``pair_scores`` at (4096, 384) x (4096, 384) within 1e-5
   (f32 sums of 384 unit-vector products taken in another order), and
   ``union_deduce`` bitwise on the stacked lanes of phase 4's first round
   and on an n = 8192 path graph (the pointer-jumping worst case);
4. the main path: ``JoinService(lanes=4)``, four ``submit_embeddings``
   sessions of (4096, 384) x (4096, 384) f32 embeddings under a
   ``PerfectCrowd``, then ``run()``; every kernel of the path must have
   launched, every session must label all its pairs with precision 1.0 and
   a transitively consistent result; then the same ``run()`` once more under
   ``torch.profiler``, for where its time goes;
5. engine parity: the first session's candidates through ``submit`` on the
   card and on the CPU (the plain versions) give identical results;
6. a ``{"kernels": [...]}`` line with each kernel's launches on the main
   path, error, and times beside its bound, its plain version and a library
   call;
7. last line: ``{"ok": true, "device": {...}}``.

The embeddings come from a seed: two-level centroid hierarchies (families of
near-duplicate entities, several records per entity on each side), so that
each session has 10^4 - 10^5 candidates, most of them non-matching, and the
neg-key index and NEG deduction carry real traffic.  384 is the width of a
common sentence-embedding model used for entity-matching blocking.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
N_ROWS, DIM, THRESHOLD, N_SESSIONS, SEED = 4096, 384, 0.7, 4, 0
# peaks of one H100 SXM (NVIDIA data sheet): f32 outside the tensor cores
# and HBM3 bandwidth
PEAK_F32_FLOPS, PEAK_BYTES_PER_S = 67e12, 3.35e12


def make_corpus(seed: int, n: int, d: int):
    """Two embedding tables of ``n`` records over a shared entity universe:
    families of 1-12 near-duplicate entities (entity-to-family cosine about
    0.9), records scattered around their entity (record-to-entity cosine
    about 0.95).  Returns (entity id per a-row, a, entity id per b-row, b)."""
    rng = np.random.default_rng(seed)

    def unit(x):
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    fam_sizes = []
    while sum(fam_sizes) < n // 2:
        fam_sizes.append(int(rng.integers(1, 13)))
    fam_of = np.repeat(np.arange(len(fam_sizes)), fam_sizes)
    family = unit(rng.normal(size=(len(fam_sizes), d)))
    entity = unit(family[fam_of]
                  + 0.5 * unit(rng.normal(size=(len(fam_of), d))))

    def side():
        ids = rng.integers(0, len(fam_of), n)
        rows = entity[ids] + np.sqrt(0.1) * unit(rng.normal(size=(n, d)))
        return ids, rows.astype(np.float32)

    ids_a, a = side()
    ids_b, b = side()
    return ids_a, a, ids_b, b


def cuda_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def result_fields(res) -> dict:
    """Every result field but the wall clock, comparable with ==."""
    out = {}
    for f in dataclasses.fields(res):
        if f.name == "wall_seconds":
            continue
        val = getattr(res, f.name)
        if isinstance(val, np.ndarray):
            val = (str(val.dtype), val.tolist())
        elif dataclasses.is_dataclass(val):
            val = dataclasses.asdict(val)
        out[f.name] = val
    return out


def _queue_sessions(svc, dev, corpora) -> None:
    from repro_torch.core.crowd import PerfectCrowd
    from repro_torch.convert import embeddings_from_numpy

    for ids_a, ea, ids_b, eb in corpora:
        svc.submit_embeddings(
            embeddings_from_numpy(ea, dev), embeddings_from_numpy(eb, dev),
            THRESHOLD, crowd=PerfectCrowd(),
            truth_fn=lambda r, c, ia=ids_a, ib=ids_b: ia[r] == ib[c])


def profile_run(dev, corpora) -> None:
    """Where the main path's serving time goes, from two more runs of the
    four sessions' ``run()``: one with the round engine and the gateway
    replay timed on the host clock, one under ``torch.profiler`` for the
    device time by kernel.  The device's idle share is taken against the
    unprofiled wall clock (the profiler slows the host many times over)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.crowd import CrowdGateway
    from repro_torch.serve import join_service

    spent = {"engine": 0.0, "gateway": 0.0}

    def timed(fn, key):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            spent[key] += time.perf_counter() - t0
            return out
        return call

    engine, post = join_service.session_run_rounds_batch, CrowdGateway.post
    svc = join_service.JoinService(lanes=N_SESSIONS, device=dev)
    _queue_sessions(svc, dev, corpora)
    torch.cuda.synchronize()
    join_service.session_run_rounds_batch = timed(engine, "engine")
    CrowdGateway.post = timed(post, "gateway")
    try:
        t0 = time.perf_counter()
        svc.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        join_service.session_run_rounds_batch = engine
        CrowdGateway.post = post

    svc = join_service.JoinService(lanes=N_SESSIONS, device=dev)
    _queue_sessions(svc, dev, corpora)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        svc.run()
        torch.cuda.synchronize()
    events = prof.key_averages()
    on_card = [e for e in events if e.device_type == DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    busy = sum(dev_us(e) for e in on_card) / 1e6
    syncs = sum(e.count for e in events
                if e.key in ("aten::_local_scalar_dense",
                             "cudaStreamSynchronize"))
    launches = sum(e.count for e in events if e.key == "cudaLaunchKernel")
    rest = wall - spent["engine"] - spent["gateway"]
    print(f"[4 profile] run() wall {wall:.4f} s: round engine "
          f"{spent['engine']:.4f} s, gateway replay {spent['gateway']:.4f} "
          f"s, rest {rest:.4f} s; device busy {busy:.4f} s (idle share "
          f"{1 - busy / wall:.4f}); {launches} kernel launches, {syncs} "
          f"host syncs")
    for e in sorted(on_card, key=dev_us, reverse=True)[:10]:
        print(f"[4 profile]   {dev_us(e) / 1e3:9.3f} ms  x{e.count:<6d} "
              f"{e.key[:90]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from the root of a checkout "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    run(torch.device("cuda"))
    return 0


def run(dev) -> None:
    """Phases 1-7 on ``dev``."""
    import torch

    from repro_torch.core.crowd import PerfectCrowd
    from repro_torch.core.graph import (KEY_SENTINEL, _apply_fast,
                                        _finish_apply, _frontier_impl,
                                        _screen_fused, stack_states,
                                        session_grow)
    from repro_torch.core.metrics import transitively_consistent
    from repro_torch.core.ordering import _refresh_masked_impl
    from repro_torch.core.pairs import PairSet
    from repro_torch.convert import embeddings_from_numpy
    from repro_torch.device import set_precision
    from repro_torch.kernels._build import extension
    from repro_torch.kernels.pair_scores import kernel as ps_kernel
    from repro_torch.kernels.pair_scores import ops as ps_ops
    from repro_torch.kernels.pair_scores.ref import pair_scores_ref
    from repro_torch.kernels.union_deduce import kernel as ud_kernel
    from repro_torch.kernels.union_deduce import ops as ud_ops
    from repro_torch.kernels.union_deduce.ref import union_deduce_ref
    from repro_torch.serve.join_service import JoinService

    set_precision()

    # -- 1. environment ------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"[1 env] python {sys.version.split()[0]} torch {torch.__version__}"
          f" cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}"
          f" count {torch.cuda.device_count()}")
    print(smi)

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    extension()
    print(f"[2 build] kernels built in {time.perf_counter() - t0:.3f} s")

    corpora = [make_corpus(SEED + i, N_ROWS, DIM)
               for i in range(N_SESSIONS)]

    # -- 3. kernels against their plain versions -----------------------------
    ids_a, ea, ids_b, eb = corpora[0]
    a = ps_ops.l2_normalize(embeddings_from_numpy(ea, dev))
    b = ps_ops.l2_normalize(embeddings_from_numpy(eb, dev))
    s_k, c_k = ps_kernel.pair_scores(a, b, THRESHOLD, N_ROWS)
    s_p, c_p = pair_scores_ref(a, b, THRESHOLD)
    raw = a @ b.T
    near = (raw - THRESHOLD).abs() <= 1e-5
    flips = (s_k != 0) != (s_p != 0)
    ps_err = float((s_k - s_p)[~flips].abs().max())
    both = (s_k != 0) & (s_p != 0)
    ulp = int((s_k[both].view(torch.int32).long()
               - s_p[both].view(torch.int32).long()).abs().max())
    print(f"[3 pair_scores] shape ({N_ROWS}, {DIM}) x ({N_ROWS}, {DIM}) "
          f"candidates {int(c_p.sum())} max|dscore| {ps_err:.3e} "
          f"max ulp {ulp} set flips {int(flips.sum())} "
          f"(all within 1e-5 of tau: {bool((~flips | near).all())})")
    if ps_err > 1e-5 or bool((flips & ~near).any()):
        raise AssertionError("pair_scores kernel disagrees with its plain "
                             "version beyond 1e-5")
    if not bool(near.any()) and not torch.equal(c_k, c_p):
        raise AssertionError("pair_scores counts differ")
    ps_args = (a, b)

    # union_deduce on the stacked lanes of the main path's first round
    probe = JoinService(lanes=N_SESSIONS, device=dev)
    for ids_a, ea, ids_b, eb in corpora:
        probe.submit_embeddings(
            embeddings_from_numpy(ea, dev), embeddings_from_numpy(eb, dev),
            THRESHOLD, crowd=PerfectCrowd(),
            truth_fn=lambda r, c, ia=ids_a, ib=ids_b: ia[r] == ib[c])
    lanes = [probe._open_lane(req) for req in probe.queue]
    p_cap = max(int(lane.state.u.shape[0]) for lane in lanes)
    n_cap = max(lane.state.n_objects for lane in lanes)
    st = stack_states([session_grow(lane.state, p_cap, n_cap)
                       for lane in lanes])
    answers = torch.full((len(lanes), p_cap), -1, dtype=torch.int32,
                         device=dev)
    prior = torch.zeros((len(lanes), p_cap), dtype=torch.float32, device=dev)
    for i, lane in enumerate(lanes):
        answers[i, :lane.p] = torch.from_numpy(lane.answers_host).to(dev)
        prior[i, :lane.p] = torch.from_numpy(lane.ordered.likelihood).to(dev)
    st = _refresh_masked_impl(st, prior,
                              torch.zeros(len(lanes), dtype=torch.bool,
                                          device=dev))
    frontier = _frontier_impl(st)
    updates = torch.where(frontier, answers, -1)
    new, pos_new, neg_new, roots_opt, _ = _screen_fused(st, updates)
    folded = _finish_apply(st, *_apply_fast(st, updates, new, pos_new,
                                            neg_new, roots_opt), new)
    screen_args = (st.roots, st.u, st.v, pos_new, st.neg_keys, n_cap)
    deduce_args = (folded.roots, folded.u, folded.v,
                   torch.zeros_like(pos_new), folded.neg_keys, n_cap)
    n_path = 8192
    path_u = torch.arange(n_path - 1, dtype=torch.int32, device=dev)[None]
    path_args = (torch.arange(n_path, dtype=torch.int32, device=dev)[None],
                 path_u, path_u + 1, torch.ones_like(path_u, dtype=torch.bool),
                 torch.full_like(path_u, KEY_SENTINEL), n_path)
    for name, args in (("round-1 screen", screen_args),
                       ("round-1 deduce", deduce_args),
                       ("path graph", path_args)):
        got = ud_kernel.union_deduce(*args)
        exp = union_deduce_ref(*args)
        same = [torch.equal(x, y) for x, y in zip(got, exp)]
        print(f"[3 union_deduce] {name}: lanes {args[0].shape[0]} n "
              f"{args[0].shape[1]} P {args[1].shape[1]} pos edges "
              f"{int(args[3].sum())} neg keys "
              f"{int((args[4] != KEY_SENTINEL).sum())} "
              f"deduced NEG {int((got[1] == 0).sum())} bitwise equal "
              f"{same}")
        if not all(same):
            raise AssertionError(f"union_deduce kernel disagrees ({name})")
    del probe, lanes, st, folded

    # -- 4. the main path ----------------------------------------------------
    ps_ops.pair_scores.launches = 0
    ud_ops.union_deduce.launches = 0
    t_main = time.perf_counter()
    svc = JoinService(lanes=N_SESSIONS, device=dev)
    rids, pairsets, machine_s = [], [], []
    for ids_a, ea, ids_b, eb in corpora:
        t0 = time.perf_counter()
        rid = svc.submit_embeddings(
            embeddings_from_numpy(ea, dev), embeddings_from_numpy(eb, dev),
            THRESHOLD, crowd=PerfectCrowd(),
            truth_fn=lambda r, c, ia=ids_a, ib=ids_b: ia[r] == ib[c],
            total_true_matches=int((ids_a[:, None] == ids_b[None, :]).sum()))
        machine_s.append(time.perf_counter() - t0)
        rids.append(rid)
        pairsets.append(svc.queue[-1].pairs)
    results = svc.run()
    main_s = time.perf_counter() - t_main
    launches = {"pair_scores": ps_ops.pair_scores.launches,
                "union_deduce": ud_ops.union_deduce.launches}
    for rid, ps, t_mp in zip(rids, pairsets, machine_s):
        res = results[rid]
        q = res.quality
        print(f"[4 session {rid}] P {len(ps)} non-matching "
              f"{float((~ps.truth).mean()):.4f} crowdsourced "
              f"{res.n_crowdsourced} deduced {res.n_deduced} rounds "
              f"{res.n_rounds} saved {res.n_deduced / len(ps):.4f} "
              f"precision {q.precision:.6f} recall {q.recall:.6f} F "
              f"{q.f_measure:.6f} machine phase {t_mp:.4f} s engine "
              f"{res.wall_seconds:.4f} s")
        if res.n_crowdsourced + res.n_deduced != len(ps) \
                or q.precision != 1.0 \
                or not transitively_consistent(ps, res.labels):
            raise AssertionError(f"session {rid} result is wrong")
    print(f"[4 main path] {N_SESSIONS} sessions in {main_s:.4f} s, "
          f"launches {launches}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the main path never launched: "
                             f"{launches}")
    profile_run(dev, corpora)

    # -- 5. engine parity, card against CPU ----------------------------------
    fields = []
    for device in (dev, "cpu"):
        one = JoinService(lanes=1, device=device)
        rid = one.submit(PairSet(pairsets[0].u, pairsets[0].v,
                                 pairsets[0].likelihood, pairsets[0].truth,
                                 pairsets[0].n_objects), PerfectCrowd())
        fields.append(result_fields(one.run()[rid]))
    diff = [k for k in fields[0] if fields[0][k] != fields[1][k]]
    print(f"[5 parity] card vs cpu engine on session 0: "
          f"{len(fields[0])} fields, differing {diff}")
    if diff:
        raise AssertionError(f"card and CPU engines differ in {diff}")

    # -- 6. kernels ----------------------------------------------------------
    N, M, D = N_ROWS, N_ROWS, DIM
    ps_bytes = 4 * (N * D + M * D + N * M + N)
    ps_flops = 2 * N * M * D
    ud_B, ud_n = screen_args[0].shape
    ud_P = screen_args[1].shape[1]
    ud_bytes = ud_B * (4 * ud_n * 2 + ud_P * (4 + 4 + 1 + 4 + 4) + 4)
    def library_pair_scores():
        s = torch.matmul(a, b.T)
        return torch.where(s >= THRESHOLD, s, 0.0)

    kernels = [
        {"name": "pair_scores", "route": "cuda",
         "source": "src/repro_torch/csrc/pair_scores.cu",
         "replaces": "src/repro/kernels/pair_scores/kernel.py:62",
         "launches": launches["pair_scores"], "max_abs_err": ps_err,
         "ms": cuda_ms(lambda: ps_kernel.pair_scores(*ps_args, THRESHOLD,
                                                     N)),
         "plain_ms": cuda_ms(lambda: pair_scores_ref(*ps_args, THRESHOLD)),
         "bound_ms": 1e3 * max(ps_flops / PEAK_F32_FLOPS,
                               ps_bytes / PEAK_BYTES_PER_S),
         "bound_by": ("operations" if ps_flops / PEAK_F32_FLOPS
                      > ps_bytes / PEAK_BYTES_PER_S else "bytes"),
         "library_ms": cuda_ms(library_pair_scores)},
        {"name": "union_deduce", "route": "cuda",
         "source": "src/repro_torch/csrc/union_deduce.cu",
         "replaces": "src/repro/kernels/union_deduce/kernel.py:129",
         "launches": launches["union_deduce"], "max_abs_err": 0.0,
         "ms": cuda_ms(lambda: ud_kernel.launch(*screen_args)),
         "plain_ms": cuda_ms(lambda: union_deduce_ref(*screen_args), 5),
         "bound_ms": 1e3 * ud_bytes / PEAK_BYTES_PER_S,
         "bound_by": "bytes", "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
