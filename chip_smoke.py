#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
CUDA device and exits non-zero on any failure; no phase catches an error and
carries on.  Phases, one output line or block each:

1. environment: torch and CUDA versions, the card's name and power limit;
2. build: the port's CUDA kernels, compiled from ``src/repro_torch/csrc``;
3. each kernel against its plain PyTorch version on the card, at the main
   paths' shapes: ``pair_scores`` at (4096, 384) x (4096, 384) within 1e-5
   (f32 sums of 384 unit-vector products taken in another order), five
   calls bit for bit, and no stack frame or spill in its resources
   (``cuobjdump -res-usage``); ``union_deduce`` bitwise on the stacked lanes of
   phase 4's first round and on an n = 8192 path graph (the
   pointer-jumping worst case), its launch plan (a cluster of blocks a
   lane) printed, five calls on each round-1 call bit for bit;
   ``pair_scores_compact`` on the first 256-tile chunk of blocked session 0
   (phase 4b): rows and cols equal but for cells within 1e-5 of tau, scores
   within 1e-5, the order identical; through ``dense_block_pairs`` on phase
   4's corpus 0 its candidates equal the dense kernel's bit for bit; at half
   the capacity it keeps the first half of the list and the true count; one
   call over all of session 0's tiles equals its 256-tile chunk calls
   concatenated, bit for bit; five calls on the chunk agree bit for bit;
   ``flash_attention`` at the first LM wave's prefill shape (8, S, 12, 64),
   at phase 4d's record batches (32, 25 and 4 records of 32 tokens) and at
   granite-3-2b's (2, 2048, 32 / 8, 64) and deepseek-67b's (1, 2048, 64 /
   8, 128) head layouts, bf16 on the tensor-core kernel and f32 on the SIMT
   one, and the bf16 kernel's SASS must hold wgmma (``HGMMA``) and TMA
   loads (``UTMALDG``), counted on a line of their own;
   ``decode_attention`` at (8, 12, 64) against an (8,
   2048, 12, 64) cache at lengths 1, 192, 193, 1337 and 2048 (and at the
   first split boundary and one past it, as the launch plans them on this
   card), an f32 query over a bf16 cache (the f32-weight run of phase 4c),
   and five calls at length 2048 that agree bit for bit.  f32 outputs
   within 2e-5 (flash) and 1e-5 (decode): sums in another order.  bf16
   outputs within 2**-7 |expected| + 1e-4 element by element: both sides
   sum in f32 and round once to bf16, whose 8 significant bits put one ulp
   at most 2**-7 of the value;
4. the dense main path: ``JoinService(lanes=4)``, four ``submit_embeddings``
   sessions of (4096, 384) x (4096, 384) f32 embeddings under a
   ``PerfectCrowd``, then ``run()``; every kernel of the path must have
   launched, every session must label all its pairs with precision 1.0 and
   a transitively consistent result; then the same ``run()`` once more under
   ``torch.profiler``, for where its time goes;
4b. the blocked main path: ``JoinService(lanes=4)``, four
   ``submit_embeddings(..., blocking=BlockingConfig(n_bits=6, n_tables=8,
   bn=128, bm=128, tiles_per_call=256))`` sessions of (16384, 384) x
   (16384, 384), then ``run()``; ``pair_scores_compact`` and
   ``union_deduce`` must have launched and the dense ``pair_scores`` not;
   each session must label all its pairs with precision 1.0 and a
   transitively consistent result, and its candidates must be a subset of
   the dense kernel's on the same corpus with bitwise-equal scores; the
   machine phase is split into host LSH, gather + kernel chunks and dedup,
   beside the dense machine phase at the same size; then ``union_deduce``
   bitwise against its plain version on these lanes' first round
   (n = 32768);
4c. the LM serving path: ``paper-scorer`` at full width (12 layers, d_model
   768, 12 heads of 64, vocab 32768; bf16 weights from ``init_params`` with
   a seeded generator on the card), ``ServeEngine(batch_lanes=8,
   max_len=2048).generate`` on 16 seeded requests of 256-1536 prompt tokens
   and 64 new tokens each (two waves); every request must get 64 tokens,
   ``flash_attention`` must launch 12 times a wave and ``decode_attention``
   12 x 63 times; ``prefill(n) + decode_step`` must agree with
   ``prefill(n + 1)`` on the card within 5e-2 of the logits' scale (bf16);
   a short wave (2 requests of 64 tokens, 8 new) under f32-cast weights must
   give the same tokens on the card as the port's plain versions on the CPU;
   then 16 decode steps of the first wave timed and 16 more under
   ``torch.profiler``, for where a decode step's time goes;
4d. the LM machine phase into the join: ``score_pairs_with_lm`` over the
   whole product dataset (1081 x 1092 records: 69 backbone batches of 32
   records x 32 tokens, then one ``pair_scores`` of (1081, 768) x (1092,
   768) at tau = -1), the likelihoods within 1e-5 of the plain
   ``pair_scores_ref`` on the same card embeddings; then the blend and
   threshold of ``examples/crowdsourced_join.py`` (0.3 LM + 0.7 a seeded Beta
   base, tau 0.62) make a ``PairSet`` that ``JoinService(lanes=1).submit``
   under a ``PerfectCrowd`` and ``run()`` must label whole, at precision 1.0
   and transitively consistent;
4e. the noisy dense path: phase 4's four corpora through
   ``JoinService(lanes=4, fused_rounds=False)`` under
   ``NoisyCrowd(error_rate=0.1, n_assignments=3, n_workers=25,
   worker_concentration=3.0, qualification=False)``, seeds 0-3 (the worker
   pool of ``examples/crowdsourced_join.py``), then ``run()``: every session
   must label all its pairs, transitively consistent, the sessions must
   reject answers, the exact replay must run and ``union_deduce`` launch on
   the folds; session 0 on the CPU with the same crowd seed must give every
   result field identical; then a run split on the host clock into gateway
   asks, frontier, fast fold, exact replays and deduce (each stage
   synchronized), and a profiled run;
4f. the paper's pipeline: ``crowdsourced_join(labeler="torch")`` (the
   array engine: a from-scratch rebuild, the priority-Boruvka frontier, the
   crowd's asks in index order, the screened fold and deduce, every round)
   on the paper's own datasets at their full sizes (section 6:
   ``make_paper_dataset``, 997 records, ``make_product_dataset``, 1081 +
   1092): the paper dataset at 0.3 (the quickstart's; expected and adaptive
   orders under a ``PerfectCrowd``, expected under ``NoisyCrowd(error_rate=
   0.08)``), at 0.1 (77096 pairs, 52 rounds) and the product dataset at
   0.3; each run's crowdsourced pairs, rounds and rejected answers must be
   the reference's (``PIPELINE_RUNS``), its labels the truth under a
   ``PerfectCrowd``; then the section 6 threshold sweep, the paper dataset
   at 0.1-0.5 as five stacked lanes of ``label_parallel_torch_batch``, each
   equal to its run alone and to the reference's figures; the first
   frontier on the card equal to Algorithm 3's selection
   (``parallel_crowdsourced_pairs``) as a set; the noisy and the product
   runs again on the CPU with identical fields; each run profiled and the
   paper-0.1 run split into rebuild, frontier, crowd and fold;
   ``union_deduce`` bitwise against its plain version on the sweep's first
   round (one lane and five, n = 997, P = 77096);
5. engine parity: the first session's candidates through ``submit`` on the
   card and on the CPU (the plain versions) give identical results;
6. the device time of one ``pair_scores``, ``pair_scores_compact``,
   ``union_deduce`` and ``decode_attention`` call by kernel (each wrapper's
   fills and memsets beside its launch: ``union_deduce`` must be one
   kernel); a ``{"kernels": [...]}`` line with each kernel's launches on its
   main path (and on each path, where it runs on more than one), error, and
   times beside its bound, its plain version and a library call
   (``union_deduce``'s with its cluster size, and its times and bounds at
   phase 4f's shapes);
7. last line: ``{"ok": true, "device": {...}}``.

The embeddings come from a seed: two-level centroid hierarchies (families of
near-duplicate entities, several records per entity on each side), so that
each session has 10^4 - 10^5 candidates, most of them non-matching, and the
neg-key index and NEG deduction carry real traffic.  384 is the width of a
common sentence-embedding model used for entity-matching blocking.  The
blocked path runs the reference's own full blocking configuration
(``benchmarks/bench_blocking.py``: 16384 rows a side, 6 bits, 8 tables,
128 x 128 tiles, 256 tiles a kernel call).  The LM phases run the paper's
own likelihood model, ``paper-scorer``, at its configured widths, over the
paper's Abt-Buy-like product table.
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
# the blocked path: rows a side, corpus seeds SEED + 100 + i, LSH config
BLOCK_ROWS, BLOCK_SEED = 16384, SEED + 100
BLOCKING = dict(n_bits=6, n_tables=8, bn=128, bm=128, tiles_per_call=256)
RECALL_SAMPLE = 1024
# phase 4e's crowd: examples/crowdsourced_join.py's heterogeneous worker
# pool (benchmarks/noise_sweep.py draws the same pool with 30 workers)
NOISY_CROWD = dict(error_rate=0.1, n_assignments=3, n_workers=25,
                   worker_concentration=3.0, qualification=False)
# phase 4f, the paper's pipeline: crowdsourced_join(labeler="torch") on the
# paper's datasets at the sizes of its section 6 (make_paper_dataset: 997
# records; make_product_dataset: 1081 + 1092), examples/quickstart.py's
# threshold and noisy crowd.  Each run's (crowdsourced pairs, rounds, answers
# rejected) are the JAX package's crowdsourced_join(..., labeler="jax") on
# the CPU (jax 0.9.0) on the same data: tests/test_torch_join.py holds the
# port to the reference itself on the CPU.
PIPELINE_RUNS = (
    # (dataset, threshold, order, NoisyCrowd error rate or None, figures)
    ("paper", 0.3, "expected", None, (1655, 7, 0)),
    ("paper", 0.3, "adaptive", None, (1623, 7, 0)),
    ("paper", 0.3, "expected", 0.08, (1691, 7, 1)),
    ("paper", 0.1, "expected", None, (8534, 52, 0)),
    ("product", 0.3, "expected", None, (3670, 4, 0)),
)
# the section 6 threshold sweep over the paper dataset, stacked as five
# lanes of one state: (crowdsourced, rounds) of the reference, as above
PIPELINE_SWEEP = {0.1: (8534, 52), 0.2: (2846, 16), 0.3: (1655, 7),
                  0.4: (1524, 5), 0.5: (1410, 5)}
# the LM serving path (phase 4c) and its machine phase (4d)
LM_ARCH, LM_LANES, LM_MAX_LEN = "paper-scorer", 8, 2048
LM_REQUESTS, LM_NEW = 16, 64
LM_PROMPT = (256, 1536)     # prompt lengths, both ends included
LM_JOIN_TAU = 0.62          # examples/crowdsourced_join.py's threshold
LM_SIDES = (1081, 1092)     # the product dataset's two tables
LM_EMBED_BATCH, LM_EMBED_LEN = 32, 32   # score_pairs_with_lm's batches
LM_BF16_TOL = 5e-2          # of the logits' scale, tests/test_torch_model.py
# kernel-only head layouts (B, S, H, K, d): granite-3-2b, deepseek-67b
FLASH_GQA_SHAPES = ((2, 2048, 32, 8, 64), (1, 2048, 64, 8, 128))
# 192 and 193: the first split boundary and one past it at (8, 2048, 12,
# 64) on a 132-SM H100 (chunks of 192 positions); phase 3 adds the boundary
# the launch plans on the card at hand
DECODE_LENGTHS = (1, 192, 193, 1337, 2048)
# f32 outputs: absolute; bf16 outputs: one bf16 ulp of the expected value
# (2**-7 relative at most) plus an absolute floor for the f32 sums' order
ATTN_TOL_F32 = {"flash": 2e-5, "decode": 1e-5}
ATTN_TOL_BF16 = (2.0 ** -7, 1e-4)
# flash_attention at (8, 1491, 12, 64) bf16 before the tensor-core kernel:
# the SIMT kernel's time recorded in PERF.md section 6, row 4 (H100 80GB
# HBM3, 700 W). Printed as a recorded figure, never as a measurement.
FLASH_MS_BEFORE = 1.4197
# card clock cycles cuda_ms spins before its timed calls: about 12 ms at
# the H100's 1.7-2.0 GHz, room for 20 calls of a wrapper costing up to
# 0.5 ms on the host
SPIN_CYCLES = 20_000_000
# the runtime calls that launch a kernel start so in torch.profiler's names:
# cudaLaunchKernel, and cudaLaunchKernelExC for union_deduce's cluster launch
LAUNCH_CALL = "cudaLaunchKernel"
# peaks of one H100 SXM (NVIDIA data sheet, dense): f32 outside the tensor
# cores, bf16 on the tensor cores, and HBM3 bandwidth
PEAK_F32_FLOPS, PEAK_BF16_FLOPS, PEAK_BYTES_PER_S = 67e12, 989e12, 3.35e12


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
    """Mean device time of ``fn`` over ``iters`` calls, after a warm-up.
    The card first spins for some milliseconds (``torch.cuda._sleep``), so
    the host has queued the calls before the first one runs and a kernel
    shorter than its wrapper's host cost is timed on the card, not at the
    host's issue rate.  Calls that wait on the host (the plain versions'
    ``nonzero`` and ``item``) still include it."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_split(fn, iters: int = 20) -> str:
    """The kernels (fills and memsets included) a call of ``fn`` launches,
    each with its mean device time a launch and its launches a call, from
    ``torch.profiler`` over ``iters`` calls after a warm-up: what a
    wrapper's time is made of."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    parts = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if e.device_type == DeviceType.CUDA and us:
            parts.append((us / e.count / 1e3, e.count / iters, e.key))
    return "; ".join(f"{ms:.4f} ms a launch, {n:.2f} a call: {key[:60]}"
                     for ms, n, key in sorted(parts, reverse=True))


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
    on_card, busy, syncs, launches = profile_counts(prof)
    rest = wall - spent["engine"] - spent["gateway"]
    print(f"[4 profile] run() wall {wall:.4f} s: round engine "
          f"{spent['engine']:.4f} s, gateway replay {spent['gateway']:.4f} "
          f"s, rest {rest:.4f} s; device busy {busy:.4f} s (idle share "
          f"{1 - busy / wall:.4f}); {launches} kernel launches, {syncs} "
          f"host syncs")
    top = sorted(on_card, key=dev_us, reverse=True)
    for e in top[:10] + [e for e in top[10:] if "union_deduce" in e.key]:
        print(f"[4 profile]   {dev_us(e) / 1e3:9.3f} ms  x{e.count:<6d} "
              f"{e.key[:90]}")


def profile_counts(prof):
    """From a ``torch.profiler`` run: the device events, their busy seconds,
    the host syncs and the kernel launches."""
    from torch.autograd import DeviceType

    events = prof.key_averages()
    on_card = [e for e in events if e.device_type == DeviceType.CUDA]
    busy = sum(dev_us(e) for e in on_card) / 1e6
    syncs = sum(e.count for e in events
                if e.key in ("aten::_local_scalar_dense",
                             "cudaStreamSynchronize"))
    launches = sum(e.count for e in events if e.key.startswith(LAUNCH_CALL))
    return on_card, busy, syncs, launches


def dev_us(e) -> float:
    """An event's device microseconds, under either profiler's name."""
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def noisy_path(dev, corpora) -> dict:
    """Phase 4e: phase 4's four dense corpora through
    ``JoinService(lanes=4, fused_rounds=False)`` under ``NoisyCrowd``s
    (``NOISY_CROWD``, seeds ``SEED + i``), then ``run()``.  Every session must
    label all its pairs, transitively consistent; the sessions must reject
    answers (conflicts), the exact replay must run and ``union_deduce`` must
    launch on the folds.  Session 0 again on the CPU with the same crowd
    seed must give every result field identical.  Then a run split on the
    host clock (each stage synchronized) and a profiled run.  Returns the
    path's kernel launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import graph
    from repro_torch.core.crowd import CrowdGateway, NoisyCrowd
    from repro_torch.core.metrics import transitively_consistent
    from repro_torch.core.pairs import PairSet
    from repro_torch.convert import embeddings_from_numpy
    from repro_torch.kernels.pair_scores import ops as ps_ops
    from repro_torch.kernels.union_deduce import ops as ud_ops
    from repro_torch.serve import join_service

    ttms = [int((ia[:, None] == ib[None, :]).sum())
            for ia, _, ib, _ in corpora]

    def crowd(i):
        return NoisyCrowd(seed=SEED + i, **NOISY_CROWD)

    def serve():
        """A four-lane per-round service with the four corpora queued."""
        svc = join_service.JoinService(lanes=N_SESSIONS, fused_rounds=False,
                                       device=dev)
        for i, (ids_a, ea, ids_b, eb) in enumerate(corpora):
            svc.submit_embeddings(
                embeddings_from_numpy(ea, dev),
                embeddings_from_numpy(eb, dev), THRESHOLD, crowd=crowd(i),
                truth_fn=lambda r, c, ia=ids_a, ib=ids_b: ia[r] == ib[c],
                total_true_matches=ttms[i])
        return svc

    spent = {"gateway asks": 0.0, "frontier": 0.0, "fold": 0.0,
             "exact replays": 0.0, "deduce": 0.0}
    calls = dict.fromkeys(spent, 0)

    def timed(fn, key, sync):
        def call(*args, **kwargs):
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if sync:
                torch.cuda.synchronize()
            spent[key] += time.perf_counter() - t0
            calls[key] += 1
            return out
        return call

    patched = [(CrowdGateway, "post", "gateway asks"),
               (join_service, "session_frontier_batch", "frontier"),
               (join_service, "session_fold_answers_batch", "fold"),
               (graph, "_apply_sequential", "exact replays"),
               (graph, "_deduce_impl", "deduce")]
    originals = [getattr(obj, name) for obj, name, _ in patched]

    def patch(sync, only=None):
        for (obj, name, key), fn in zip(patched, originals):
            if only is None or key == only:
                setattr(obj, name, timed(fn, key, sync))

    def unpatch():
        for (obj, name, _), fn in zip(patched, originals):
            setattr(obj, name, fn)

    # the run: replays counted (unsynchronized), kernel counts zeroed just
    # before the path and read just after it
    ps_ops.pair_scores.launches = 0
    svc = serve()
    rids = [req.rid for req in svc.queue]
    pairsets = [req.pairs for req in svc.queue]
    ps_launches = ps_ops.pair_scores.launches
    ud_ops.union_deduce.launches = 0
    patch(sync=False, only="exact replays")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = svc.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        unpatch()
    launches = {"pair_scores": ps_launches,
                "union_deduce": ud_ops.union_deduce.launches}
    replays = calls["exact replays"]
    conflicts = 0
    for rid, ps in zip(rids, pairsets):
        res = results[rid]
        q = res.quality
        conflicts += res.n_conflicts
        print(f"[4e session {rid}] P {len(ps)} rounds {res.n_rounds} "
              f"crowdsourced {res.n_crowdsourced} deduced {res.n_deduced} "
              f"conflicts {res.n_conflicts} spent {res.n_spent_cents:.1f} "
              f"cents precision {q.precision:.6f} recall {q.recall:.6f} F "
              f"{q.f_measure:.6f}")
        if res.n_crowdsourced + res.n_deduced != len(ps) \
                or not transitively_consistent(ps, res.labels):
            raise AssertionError(f"noisy session {rid} result is wrong")
    print(f"[4e noisy path] run() wall {wall:.4f} s, {conflicts} answers "
          f"rejected, {replays} exact replays, launches {launches}")
    if conflicts < 1 or replays < 1 or min(launches.values()) < 1:
        raise AssertionError(f"the noisy path exercised too little: "
                             f"conflicts {conflicts}, replays {replays}, "
                             f"launches {launches}")

    ps0 = pairsets[0]
    one = join_service.JoinService(lanes=1, fused_rounds=False,
                                   device="cpu")
    rid0 = one.submit(PairSet(ps0.u, ps0.v, ps0.likelihood, ps0.truth,
                              ps0.n_objects), crowd(0),
                      total_true_matches=ttms[0])
    t0 = time.perf_counter()
    cpu = result_fields(one.run()[rid0])
    cpu_s = time.perf_counter() - t0
    card = result_fields(results[rids[0]])
    diff = [k for k in card if card[k] != cpu[k]]
    print(f"[4e parity] session 0 on the card and on the CPU ({cpu_s:.4f} s)"
          f": {len(card)} fields, differing {diff}")
    if diff:
        raise AssertionError(f"noisy session 0: card and CPU differ in "
                             f"{diff}")

    # the host-clock split: each stage synchronized before and after
    for key in spent:
        spent[key], calls[key] = 0.0, 0
    svc = serve()
    patch(sync=True)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        svc.run()
        torch.cuda.synchronize()
        split_wall = time.perf_counter() - t0
    finally:
        unpatch()
    fast = spent["fold"] - spent["exact replays"] - spent["deduce"]
    rest = split_wall - spent["gateway asks"] - spent["frontier"] \
        - spent["fold"]
    print(f"[4e split] run() wall {split_wall:.4f} s (synchronized stages): "
          f"gateway asks {spent['gateway asks']:.4f} s in "
          f"{calls['gateway asks']} posts, frontier {spent['frontier']:.4f} "
          f"s in {calls['frontier']} calls, fast fold {fast:.4f} s in "
          f"{calls['fold']} folds, exact replays {calls['exact replays']} in "
          f"{spent['exact replays']:.4f} s, deduce {spent['deduce']:.4f} s, "
          f"rest {rest:.4f} s")

    svc = serve()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        svc.run()
        torch.cuda.synchronize()
    on_card, busy, syncs, n_launch = profile_counts(prof)
    print(f"[4e profile] device busy {busy:.4f} s (idle share "
          f"{1 - busy / wall:.4f} of the unprofiled run() wall); {n_launch} "
          f"kernel launches, {syncs} host syncs")
    top = sorted(on_card, key=dev_us, reverse=True)
    for e in top[:6] + [e for e in top[6:] if "union_deduce" in e.key]:
        print(f"[4e profile]   {dev_us(e) / 1e3:9.3f} ms  x{e.count:<6d} "
              f"{e.key[:90]}")
    return launches


def _pipeline_candidates(name: str, tau: float):
    from repro_torch.data.entities import DATASETS

    ds = DATASETS[name]()
    return ds, ds.pairs.above(tau)


def sweep_lanes():
    """The threshold sweep's sessions: the paper dataset at each of
    ``PIPELINE_SWEEP``'s thresholds, pairs in the expected order, as
    ``(u, v, n_objects)`` lanes beside their true answers (int32 POS/NEG)."""
    from repro_torch.core.cluster_graph import NEG, POS
    from repro_torch.core.sorting import order_expected

    lanes, answers = [], []
    for tau in PIPELINE_SWEEP:
        _, cand = _pipeline_candidates("paper", tau)
        ordered = cand.take(order_expected(cand))
        lanes.append((ordered.u, ordered.v, ordered.n_objects))
        answers.append(np.where(ordered.truth, POS, NEG).astype(np.int32))
    return lanes, answers


def pipeline_round_args(dev):
    """The ``union_deduce`` arguments of the sweep's first round: the five
    lanes of :func:`sweep_lanes`, packed to the largest and stacked, their
    frontier answered by the truth; the screen (its POS answers united into
    the forest) and the deduce after the fold.  Lane 0 (threshold 0.1,
    unpadded) alone is the one-lane run's first round."""
    import torch

    from repro_torch.core import graph
    from repro_torch.core.cluster_graph import UNKNOWN

    lanes, answers = sweep_lanes()
    U, V, labels0, _, n = graph.pack_sessions(lanes)
    st = graph.make_session_state_batch(U, V, labels0, n, dev)
    packed = np.full(U.shape, UNKNOWN, np.int32)
    for b, a in enumerate(answers):
        packed[b, :len(a)] = a
    updates = torch.where(graph._frontier_impl(st),
                          torch.from_numpy(packed).to(dev), UNKNOWN)
    new, pos_new, neg_new, roots_opt, _ = graph._screen_impl(st, updates)
    folded = graph._finish_apply(st, *graph._apply_fast(
        st, updates, new, pos_new, neg_new, roots_opt), new, True, False)
    return ((st.roots, st.u, st.v, pos_new, st.neg_keys, n),
            (folded.roots, folded.u, folded.v, torch.zeros_like(pos_new),
             folded.neg_keys, n))


def paper_pipeline(dev) -> dict:
    """Phase 4f: the paper's pipeline, ``crowdsourced_join(labeler="torch")``
    on ``dev``: the ``PIPELINE_RUNS`` (each run's crowdsourced pairs, rounds
    and rejected answers must be the reference's, the labels the truth
    under a ``PerfectCrowd``), then the section 6 threshold sweep as five
    stacked lanes of ``label_parallel_torch_batch``, each lane equal to its
    run alone and to the reference's figures.  The first frontier on the
    card must equal Algorithm 3's selection by the host
    ``parallel_crowdsourced_pairs``, as a set; the noisy and the product
    runs again on the CPU must give identical fields.  Then each run
    profiled (device busy, kernel launches, host syncs) and the paper-0.1
    run split on the host clock (each stage synchronized): rebuild,
    frontier, crowd, fold.  ``union_deduce``'s launches are counted from
    just before the runs to just after them and must be above 0.  Returns
    them with the per-run figures."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import graph
    from repro_torch.core.cluster_graph import UNKNOWN
    from repro_torch.core.crowd import NoisyCrowd, PerfectCrowd
    from repro_torch.core.join import crowdsourced_join
    from repro_torch.core.metrics import transitively_consistent
    from repro_torch.core.parallel import parallel_crowdsourced_pairs
    from repro_torch.core.sorting import order_expected
    from repro_torch.kernels.union_deduce import ops as ud_ops

    def crowd_of(err):
        return PerfectCrowd() if err is None else NoisyCrowd(error_rate=err)

    cases = []
    for name, tau, order, err, figures in PIPELINE_RUNS:
        ds, cand = _pipeline_candidates(name, tau)
        cases.append((f"{name} {tau} {order}"
                      + ("" if err is None else f" noisy {err}"),
                      ds, cand, order, err, figures))

    def join(case, device):
        _, ds, cand, order, err, _ = case
        return crowdsourced_join(cand, crowd_of(err), order=order,
                                 labeler="torch", device=device,
                                 total_true_matches=ds.total_true_matches)

    # the runs: kernel counts zeroed just before the path, read just after
    join(cases[0], dev)     # warm-up: allocator, kernel attributes
    torch.cuda.synchronize()
    ud_ops.union_deduce.launches = 0
    results, walls, per_run = [], [], []
    for case in cases:
        before = ud_ops.union_deduce.launches
        t0 = time.perf_counter()
        results.append(join(case, dev))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        per_run.append(ud_ops.union_deduce.launches - before)
    lanes, truths = sweep_lanes()
    before = ud_ops.union_deduce.launches
    t0 = time.perf_counter()
    sweep = graph.label_parallel_torch_batch(
        lanes, lambda b, idx: truths[b][idx], device=dev)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    sweep_launches = ud_ops.union_deduce.launches - before
    launches = {"union_deduce": ud_ops.union_deduce.launches}

    for case, res, wall, n_launch in zip(cases, results, walls, per_run):
        tag, ds, cand, order, err, figures = case
        q = res.quality
        got = (res.n_crowdsourced, res.n_iterations, res.n_conflicts)
        print(f"[4f {tag}] P {len(cand)} crowdsourced {res.n_crowdsourced} "
              f"deduced {res.n_deduced} rounds {res.n_iterations} conflicts "
              f"{res.n_conflicts} (reference {figures}) precision "
              f"{q.precision:.6f} recall {q.recall:.6f} wall {wall:.4f} s, "
              f"{n_launch} union_deduce launches")
        if got != figures:
            raise AssertionError(f"4f {tag}: {got}, the reference's "
                                 f"{figures}")
        if err is None and not np.array_equal(res.labels, cand.truth):
            raise AssertionError(f"4f {tag}: labels differ from the truth")
        if not transitively_consistent(cand, res.labels):
            raise AssertionError(f"4f {tag}: labels not consistent")
    for (tau, figures), lane, truth, out in zip(
            PIPELINE_SWEEP.items(), lanes, truths, sweep):
        alone = graph.label_parallel_torch(*lane, lambda idx, t=truth: t[idx],
                                           device=dev)
        same = np.array_equal(out[0], alone[0]) \
            and np.array_equal(out[1], alone[1]) \
            and out[2:] == tuple(alone[2:])
        got = (int(out[1].sum()), len(out[2]))
        print(f"[4f sweep {tau}] P {len(truth)} crowdsourced {got[0]} rounds"
              f" {got[1]} (reference {figures}), equal to its run alone "
              f"{same}")
        if got != figures or not same or out[3] \
                or not np.array_equal(out[0], truth):
            raise AssertionError(f"4f sweep lane {tau} is wrong")
    print(f"[4f sweep] {len(sweep)} lanes stacked at P "
          f"{max(len(t) for t in truths)}: {sweep_s:.4f} s, "
          f"{max(len(o[2]) for o in sweep)} rounds, {sweep_launches} "
          f"union_deduce launches")
    print(f"[4f paper pipeline] {len(cases)} runs in {sum(walls):.4f} s and "
          f"the sweep, launches {launches}")
    if launches["union_deduce"] < 1:
        raise AssertionError("union_deduce never launched on the paper "
                             "pipeline")

    # round 1: the card's frontier is Algorithm 3's selection, as a set
    for tag, ds, cand, order, err, figures in cases:
        if order != "expected" or err is not None:
            continue
        ordered = cand.take(order_expected(cand))
        card = graph.boruvka_frontier(
            ordered.u, ordered.v, np.full(len(ordered), UNKNOWN, np.int32),
            np.zeros(len(ordered), bool), ordered.n_objects, device=dev)
        host = set(parallel_crowdsourced_pairs(ordered,
                                               np.arange(len(ordered)), {}))
        sel = set(np.flatnonzero(card.cpu().numpy()).tolist())
        print(f"[4f first frontier {tag}] card {len(sel)} pairs, Algorithm 3"
              f" {len(host)}: equal {sel == host}")
        if sel != host:
            raise AssertionError(f"4f {tag}: the first frontier is not "
                                 f"Algorithm 3's selection")

    # the noisy and the product runs on the CPU: identical fields
    for case, res in zip(cases, results):
        if case[4] is None and not case[0].startswith("product"):
            continue
        t0 = time.perf_counter()
        cpu = result_fields(join(case, "cpu"))
        cpu_s = time.perf_counter() - t0
        card = result_fields(res)
        diff = [k for k in card if card[k] != cpu[k]]
        print(f"[4f parity {case[0]}] card and CPU ({cpu_s:.4f} s): "
              f"{len(card)} fields, differing {diff}")
        if diff:
            raise AssertionError(f"4f {case[0]}: card and CPU differ in "
                                 f"{diff}")

    # each run profiled: device busy against its unprofiled wall
    for case, wall in zip(cases, walls):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            join(case, dev)
            torch.cuda.synchronize()
        on_card, busy, syncs, n_launch = profile_counts(prof)
        print(f"[4f profile {case[0]}] device busy {busy:.4f} s (idle share "
              f"{1 - busy / wall:.4f} of the unprofiled wall); {n_launch} "
              f"kernel launches, {syncs} host syncs")
        if case[0] == "paper 0.1 expected":
            top = sorted(on_card, key=dev_us, reverse=True)
            for e in top[:6] + [e for e in top[6:]
                                if "union_deduce" in e.key]:
                print(f"[4f profile]   {dev_us(e) / 1e3:9.3f} ms  "
                      f"x{e.count:<6d} {e.key[:90]}")

    # the paper-0.1 run split on the host clock, each stage synchronized
    big = next(c for c in cases if c[0] == "paper 0.1 expected")
    spent = {"rebuild": 0.0, "frontier": 0.0, "crowd": 0.0, "fold": 0.0}
    calls = dict.fromkeys(spent, 0)

    def timed(fn, key):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spent[key] += time.perf_counter() - t0
            calls[key] += 1
            return out
        return call

    patched = [(graph, "_state_from_labels_impl", "rebuild"),
               (graph, "_frontier_impl", "frontier"),
               (graph, "_fold_impl", "fold")]
    originals = [getattr(obj, name) for obj, name, _ in patched]
    ask = PerfectCrowd.ask

    def timed_ask(self, pairs, i):
        t0 = time.perf_counter()
        out = ask(self, pairs, i)
        spent["crowd"] += time.perf_counter() - t0
        calls["crowd"] += 1
        return out

    for (obj, name, key), fn in zip(patched, originals):
        setattr(obj, name, timed(fn, key))
    PerfectCrowd.ask = timed_ask
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        join(big, dev)
        torch.cuda.synchronize()
        split_wall = time.perf_counter() - t0
    finally:
        for (obj, name, _), fn in zip(patched, originals):
            setattr(obj, name, fn)
        PerfectCrowd.ask = ask
    rest = split_wall - sum(spent.values())
    print(f"[4f split paper 0.1] wall {split_wall:.4f} s (synchronized "
          f"stages): rebuild {spent['rebuild']:.4f} s in {calls['rebuild']}"
          f", frontier {spent['frontier']:.4f} s in {calls['frontier']}, "
          f"crowd {spent['crowd']:.4f} s in {calls['crowd']} asks, fold "
          f"{spent['fold']:.4f} s in {calls['fold']}, rest {rest:.4f} s; "
          f"engine {spent['rebuild'] + spent['frontier'] + spent['fold']:.4f}"
          f" s against the crowd's {spent['crowd']:.4f} s")
    return {"launches": launches, "walls": walls,
            "launches_by_run": per_run}


def first_round_args(svc, dev):
    """The queued sessions of ``svc`` opened as lanes, grown to one capacity
    and stacked, at their first round: the ``union_deduce`` arguments of the
    round's screen (its POS answers united into the forest) and of the
    deduce after the fold."""
    import torch

    from repro_torch.core.graph import (_apply_fast, _finish_apply,
                                        _frontier_impl, _screen_impl,
                                        session_grow, stack_states)
    from repro_torch.core.ordering import _refresh_masked_impl

    lanes = [svc._open_lane(req) for req in svc.queue]
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
    new, pos_new, neg_new, roots_opt, _ = _screen_impl(st, updates)
    folded = _finish_apply(st, *_apply_fast(st, updates, new, pos_new,
                                            neg_new, roots_opt), new, True,
                           False)
    screen_args = (st.roots, st.u, st.v, pos_new, st.neg_keys, n_cap)
    deduce_args = (folded.roots, folded.u, folded.v,
                   torch.zeros_like(pos_new), folded.neg_keys, n_cap)
    return screen_args, deduce_args


def check_union_deduce(tag: str, name: str, args) -> None:
    """``union_deduce`` bit for bit against its plain version."""
    import torch

    from repro_torch.core.graph import KEY_SENTINEL
    from repro_torch.kernels.union_deduce import kernel as ud_kernel
    from repro_torch.kernels.union_deduce.ref import union_deduce_ref

    got = ud_kernel.union_deduce(*args)
    exp = union_deduce_ref(*args)
    same = [torch.equal(x, y) for x, y in zip(got, exp)]
    print(f"[{tag}] {name}: lanes {args[0].shape[0]} n "
          f"{args[0].shape[1]} P {args[1].shape[1]} pos edges "
          f"{int(args[3].sum())} neg keys "
          f"{int((args[4] != KEY_SENTINEL).sum())} "
          f"deduced NEG {int((got[1] == 0).sum())} bitwise equal {same}")
    if not all(same):
        raise AssertionError(f"union_deduce kernel disagrees ({name})")


def gather_chunk(a, b, tiles_a, tiles_b):
    """One chunk of tile pairs gathered on the device as
    ``score_block_pairs`` gathers it: (a_g, b_g, ida, idb)."""
    import torch

    dev = a.device
    a_ext = torch.cat([a, a.new_zeros((1, a.shape[1]))])
    b_ext = torch.cat([b, b.new_zeros((1, b.shape[1]))])
    ga = np.where(tiles_a < 0, a.shape[0], tiles_a).reshape(-1)
    gb = np.where(tiles_b < 0, b.shape[0], tiles_b).reshape(-1)
    return (a_ext[torch.from_numpy(ga).to(dev)],
            b_ext[torch.from_numpy(gb).to(dev)],
            torch.from_numpy(tiles_a.reshape(-1, 1).astype(np.int32)).to(dev),
            torch.from_numpy(tiles_b.reshape(-1, 1).astype(np.int32)).to(dev))


def check_compact(a_g, b_g, ida, idb, bn: int, bm: int) -> float:
    """``pair_scores_compact`` against its plain version on one chunk.  Both
    first run with each row's flat gather position as its id, so every
    candidate names its cell: the two lists may differ only in cells within
    1e-5 of tau, each must be in (tile, row, col) order, and the scores of
    the cells in both agree within 1e-5.  The kernel's run with the real ids
    must then be the positional run mapped through the ids.  Returns the
    largest score difference."""
    import torch

    from repro_torch.kernels.pair_scores import kernel as ps_kernel
    from repro_torch.kernels.pair_scores.ref import pair_scores_compact_ref

    dev = a_g.device
    T = a_g.shape[0] // bn
    cap = T * bn * bm
    pos_a = torch.where(ida >= 0, torch.arange(
        T * bn, dtype=torch.int32, device=dev)[:, None], -1)
    pos_b = torch.where(idb >= 0, torch.arange(
        T * bm, dtype=torch.int32, device=dev)[:, None], -1)
    got = ps_kernel.pair_scores_compact(a_g, b_g, pos_a, pos_b, THRESHOLD,
                                        cap, bn, bm)
    exp = pair_scores_compact_ref(a_g, b_g, pos_a, pos_b, THRESHOLD, cap, bn,
                                  bm)
    n_got, n_exp = int(got[3]), int(exp[3])
    k_got = got[0][:n_got, 0].long() * (T * bm) + got[1][:n_got, 0].long()
    k_exp = exp[0][:n_exp, 0].long() * (T * bm) + exp[1][:n_exp, 0].long()
    ordered = bool((k_got[1:] > k_got[:-1]).all()) \
        and bool((k_exp[1:] > k_exp[:-1]).all())
    in_exp = torch.isin(k_got, k_exp)
    in_got = torch.isin(k_exp, k_got)
    flips = torch.cat([k_got[~in_exp], k_exp[~in_got]])
    fr, fc = flips // (T * bm), flips % (T * bm)
    s = torch.bmm(a_g.view(T, bn, -1), b_g.view(T, bm, -1).transpose(1, 2))
    near = (s[fr // bn, fr % bn, fc % bm] - THRESHOLD).abs() <= 1e-5
    err = float((got[2][:n_got, 0][in_exp]
                 - exp[2][:n_exp, 0][in_got]).abs().max())
    real = ps_kernel.pair_scores_compact(a_g, b_g, ida, idb, THRESHOLD, cap,
                                         bn, bm)
    pos_r, pos_c = got[0][:n_got, 0].long(), got[1][:n_got, 0].long()
    mapped = int(real[3]) == n_got \
        and torch.equal(real[0][:n_got, 0], ida[pos_r, 0]) \
        and torch.equal(real[1][:n_got, 0], idb[pos_c, 0]) \
        and torch.equal(real[2], got[2])
    print(f"[3 pair_scores_compact] chunk T {T} tile {bn} x {bm} depth "
          f"{a_g.shape[1]}: candidates kernel {n_got} plain {n_exp} set "
          f"flips {len(flips)} (all within 1e-5 of tau: "
          f"{bool(near.all())}) max|dscore| {err:.3e} in order {ordered} "
          f"real ids map onto positions {mapped}")
    if not (ordered and bool(near.all()) and err <= 1e-5 and mapped):
        raise AssertionError("pair_scores_compact kernel disagrees with its "
                             "plain version")
    return err


def blocked_main_path(dev, corpora, cfg) -> dict:
    """Phase 4b: four blocked ``submit_embeddings`` sessions through
    ``run()``, then each checked against the dense kernel's candidates on
    the same corpus, and ``union_deduce`` on these lanes' first round.  The
    machine phase is split by timing the blocking module's stages on the
    host clock (the chunk stage ends in copies to the host, so it includes
    its device time).  Returns the kernel launches of the blocked run."""
    import torch

    from repro_torch.convert import embeddings_from_numpy
    from repro_torch.core.crowd import CrowdGateway, PerfectCrowd
    from repro_torch.core.metrics import transitively_consistent
    from repro_torch.kernels.pair_scores import blocking
    from repro_torch.kernels.pair_scores import ops as ps_ops
    from repro_torch.kernels.pair_scores.sharded import sharded_candidates
    from repro_torch.kernels.union_deduce import ops as ud_ops
    from repro_torch.serve import join_service

    spent: dict = {}
    cands: list = []

    def timed(fn, key, keep=None):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            spent[key] = spent.get(key, 0.0) + time.perf_counter() - t0
            if keep is not None:
                keep.append(out)
            return out
        return call

    stages = [(blocking, "signatures", "signatures"),
              (blocking, "block_pairs", "block_pairs"),
              (blocking, "_score_chunks", "chunks"),
              (blocking, "_dedup", "dedup"),
              (join_service, "blocked_candidates", "machine"),
              (join_service, "session_run_rounds_batch", "engine"),
              (CrowdGateway, "post", "gateway")]
    originals = [(mod, name, getattr(mod, name)) for mod, name, _ in stages]
    for mod, name, key in stages:
        setattr(mod, name, timed(getattr(mod, name), key,
                                 cands if key == "machine" else None))
    for counter in (ps_ops.pair_scores, ps_ops.pair_scores_compact,
                    ud_ops.union_deduce):
        counter.launches = 0
    splits, rids, pairsets = [], [], []
    try:
        t_main = time.perf_counter()
        svc = join_service.JoinService(lanes=N_SESSIONS, device=dev)
        for ids_a, ea, ids_b, eb in corpora:
            spent.clear()
            k = int(max(ids_a.max(), ids_b.max())) + 1
            ttm = int((np.bincount(ids_a, minlength=k)
                       * np.bincount(ids_b, minlength=k)).sum())
            t0 = time.perf_counter()
            rid = svc.submit_embeddings(
                embeddings_from_numpy(ea, dev),
                embeddings_from_numpy(eb, dev), THRESHOLD,
                crowd=PerfectCrowd(),
                truth_fn=lambda r, c, ia=ids_a, ib=ids_b: ia[r] == ib[c],
                total_true_matches=ttm, blocking=cfg)
            splits.append(dict(spent, submit=time.perf_counter() - t0))
            rids.append(rid)
            pairsets.append(svc.queue[-1].pairs)
        spent.clear()
        t0 = time.perf_counter()
        results = svc.run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        main_s = time.perf_counter() - t_main
    finally:
        for mod, name, fn in originals:
            setattr(mod, name, fn)
    launches = {"pair_scores": ps_ops.pair_scores.launches,
                "pair_scores_compact": ps_ops.pair_scores_compact.launches,
                "union_deduce": ud_ops.union_deduce.launches}

    rng = np.random.default_rng(SEED)
    for (ids_a, ea, ids_b, eb), rid, ps, cand, split in zip(
            corpora, rids, pairsets, cands, splits):
        res = results[rid]
        q = res.quality
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dense = sharded_candidates(embeddings_from_numpy(ea, dev),
                                   embeddings_from_numpy(eb, dev), THRESHOLD)
        dense_s = time.perf_counter() - t0
        M = len(eb)
        d_keys = dense.rows.astype(np.int64) * M + dense.cols
        b_keys = cand.rows.astype(np.int64) * M + cand.cols
        at = np.minimum(np.searchsorted(d_keys, b_keys), len(d_keys) - 1)
        subset = bool((d_keys[at] == b_keys).all())
        bitwise = subset and np.array_equal(dense.scores[at].view(np.int32),
                                            cand.scores.view(np.int32))
        a_n = ps_ops.l2_normalize(embeddings_from_numpy(ea, dev))
        b_n = ps_ops.l2_normalize(embeddings_from_numpy(eb, dev))
        sample = np.sort(rng.choice(len(ea), RECALL_SAMPLE, replace=False))
        recall, _ = blocking.blocker_recall(cand, a_n, b_n, THRESHOLD,
                                            row_sample=sample)
        print(f"[4b session {rid}] P {len(ps)} tiles {cand.n_tiles} cells "
              f"scored {cand.cells_scored} of dense {cand.dense_cells} "
              f"({cand.cells_scored / cand.dense_cells:.4f}) padded "
              f"{cand.padded_cells} duplicates {cand.n_duplicates}; recall "
              f"sample of {RECALL_SAMPLE} rows {recall:.4f} all rows "
              f"{len(b_keys) / len(d_keys):.4f} expected "
              f"{blocking.expected_recall(cfg, THRESHOLD):.4f}")
        print(f"[4b session {rid}] machine phase {split['submit']:.4f} s: "
              f"blocked_candidates {split['machine']:.4f} s = host LSH "
              f"{split['signatures'] + split['block_pairs']:.4f} s "
              f"(signatures {split['signatures']:.4f} s, block_pairs "
              f"{split['block_pairs']:.4f} s), gather + kernel chunks "
              f"{split['chunks']:.4f} s, dedup {split['dedup']:.4f} s; dense "
              f"machine phase at the same size {dense_s:.4f} s "
              f"({len(d_keys)} candidates)")
        print(f"[4b session {rid}] crowdsourced {res.n_crowdsourced} deduced "
              f"{res.n_deduced} rounds {res.n_rounds} saved "
              f"{res.n_deduced / len(ps):.4f} precision {q.precision:.6f} "
              f"recall {q.recall:.6f} F {q.f_measure:.6f} engine "
              f"{res.wall_seconds:.4f} s; candidates a subset of the dense "
              f"kernel's {subset}, scores bitwise {bitwise}")
        if res.n_crowdsourced + res.n_deduced != len(ps) \
                or q.precision != 1.0 \
                or not transitively_consistent(ps, res.labels) \
                or not bitwise:
            raise AssertionError(f"blocked session {rid} result is wrong")
    print(f"[4b blocked path] {len(corpora)} sessions in {main_s:.4f} s, "
          f"launches {launches}; run() wall {run_s:.4f} s: round engine "
          f"{spent['engine']:.4f} s, gateway replay {spent['gateway']:.4f} "
          f"s, rest {run_s - spent['engine'] - spent['gateway']:.4f} s")
    if launches["pair_scores"] or min(launches["pair_scores_compact"],
                                      launches["union_deduce"]) < 1:
        raise AssertionError(f"the blocked path's kernels: {launches}")

    probe = join_service.JoinService(lanes=N_SESSIONS, device=dev)
    for ps in pairsets:
        probe.submit(ps, PerfectCrowd())
    screen_args, deduce_args = first_round_args(probe, dev)
    check_union_deduce("4b union_deduce", "blocked round-1 screen",
                       screen_args)
    check_union_deduce("4b union_deduce", "blocked round-1 deduce",
                       deduce_args)
    return launches


def lm_config():
    """The LM phases' model: ``LM_ARCH`` as configured, at full width."""
    from repro_torch.configs import get

    return get(LM_ARCH)


def lm_requests(vocab: int):
    """``LM_REQUESTS`` seeded prompts of ``LM_PROMPT`` tokens."""
    from repro_torch.serve.engine import Request

    rng = np.random.default_rng(SEED)
    lo, hi = LM_PROMPT
    return [Request(rid=i, prompt=rng.integers(
                2, vocab, size=int(rng.integers(lo, hi + 1))).astype(np.int32),
                max_new_tokens=LM_NEW)
            for i in range(LM_REQUESTS)]


def embed_batches() -> list:
    """The record counts of phase 4d's backbone batches, largest first."""
    B = LM_EMBED_BATCH
    return sorted({B} | {n % B for n in LM_SIDES} - {0}, reverse=True)


def _randn(dev, shape, dtype, seed):
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


def attn_error(kind: str, got, exp):
    """(max |error|, whether it is within tolerance, the tolerance as text)
    of an attention kernel's output against its plain version's."""
    import torch

    diff = (got.float() - exp.float()).abs()
    err = float(diff.max())
    if exp.dtype == torch.bfloat16:
        rel, floor = ATTN_TOL_BF16
        worst = float((diff / (rel * exp.float().abs() + floor)).max())
        return err, worst <= 1.0, (f"2**-7 |expected| + {floor}, worst "
                                   f"{worst:.3f} of it")
    tol = ATTN_TOL_F32[kind]
    return err, err <= tol, f"{tol}"


def check_flash(dev, B, S, H, K, d, dtype, seed=0):
    """``flash_attention``'s kernel against its plain version on seeded
    inputs; returns (max |error|, (q, k, v))."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention.ref import mha_causal_ref

    q = _randn(dev, (B, S, H, d), dtype, seed)
    k = _randn(dev, (B, S, K, d), dtype, seed + 1)
    v = _randn(dev, (B, S, K, d), dtype, seed + 2)
    got = fa_kernel.flash_attention(q, k, v)
    exp = mha_causal_ref(q, k, v)
    err, ok, tol = attn_error("flash", got, exp)
    print(f"[3 flash_attention] q ({B}, {S}, {H}, {d}) kv heads {K} "
          f"{str(dtype).split('.')[-1]}: max|d| {err:.3e} (tolerance {tol})")
    if not ok:
        raise AssertionError("flash_attention kernel disagrees with its plain "
                             "version")
    return err, (q, k, v)


def check_decode(dev, B, S, H, K, d, length, q_dtype, kv_dtype, seed=0):
    """``decode_attention``'s kernel against its plain version with the
    cache past ``length`` filled with garbage; returns (max |error|, args)."""
    import torch

    from repro_torch.kernels.decode_attention import kernel as da_kernel
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    q = _randn(dev, (B, H, d), q_dtype, seed)
    kc = _randn(dev, (B, S, K, d), kv_dtype, seed + 1)
    vc = _randn(dev, (B, S, K, d), kv_dtype, seed + 2)
    kc[:, length:] = 1e4
    vc[:, length:] = -1e4
    n = torch.tensor(length, dtype=torch.int32, device=dev)
    got = da_kernel.decode_attention(q, kc, vc, n)
    exp = decode_attention_ref(q, kc, vc, length)
    err, ok, tol = attn_error("decode", got, exp)
    print(f"[3 decode_attention] q ({B}, {H}, {d}) "
          f"{str(q_dtype).split('.')[-1]} cache ({B}, {S}, {K}, {d}) "
          f"{str(kv_dtype).split('.')[-1]} length {length}: max|d| "
          f"{err:.3e} (tolerance {tol})")
    if not ok:
        raise AssertionError("decode_attention kernel disagrees with its "
                             "plain version")
    return err, (q, kc, vc, n)


def lm_serving_path(dev, cfg, model) -> dict:
    """Phase 4c: ``ServeEngine.generate`` over ``lm_requests``, with the
    kernels' launches counted over exactly that call; then the card's
    ``decode == prefill(n + 1)`` and the short f32 wave card-vs-CPU."""
    import copy

    import torch

    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import model as M
    from repro_torch.serve.engine import Request, ServeEngine

    engine = ServeEngine(cfg, model, batch_lanes=LM_LANES, max_len=LM_MAX_LEN)
    reqs = lm_requests(cfg.vocab)
    rng = np.random.default_rng(SEED + 1)
    warm = [Request(rid=i, prompt=rng.integers(2, cfg.vocab, 64).astype(
        np.int32), max_new_tokens=8) for i in range(2)]
    engine.generate(warm)           # cuBLAS and allocator set-up
    torch.cuda.synchronize()

    prefill, run_wave = M.prefill, engine._run_wave
    waves: list = []

    def timed_prefill(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = prefill(*args, **kwargs)
        torch.cuda.synchronize()
        waves[-1]["prefill_s"] = time.perf_counter() - t0
        waves[-1]["S"] = int(args[1]["tokens"].shape[1])
        return out

    def timed_wave(wave):
        waves.append({})
        t0 = time.perf_counter()
        out = run_wave(wave)        # ends in a copy of the tokens to the host
        waves[-1]["wave_s"] = time.perf_counter() - t0
        return out

    fa_ops.flash_attention.launches = 0
    da_ops.decode_attention.launches = 0
    M.prefill, engine._run_wave = timed_prefill, timed_wave
    try:
        t0 = time.perf_counter()
        out = engine.generate(reqs)
        gen_s = time.perf_counter() - t0
    finally:
        M.prefill = prefill
        del engine._run_wave
    launches = {"flash_attention": fa_ops.flash_attention.launches,
                "decode_attention": da_ops.decode_attention.launches}
    n_waves = len(waves)
    for i, w in enumerate(waves):
        decode_s = w["wave_s"] - w["prefill_s"]
        print(f"[4c wave {i}] {LM_LANES} lanes prefill S {w['S']} "
              f"{w['prefill_s']:.4f} s, decode {LM_NEW - 1} steps "
              f"{decode_s:.4f} s ({1e3 * decode_s / (LM_NEW - 1):.4f} ms a "
              f"step of {LM_LANES} tokens), wave {w['wave_s']:.4f} s")
    n_tok = sum(len(t) for t in out.values())
    print(f"[4c serving] {len(out)} requests, {n_tok} tokens in {gen_s:.4f} "
          f"s ({n_tok / gen_s:.1f} tokens/s), launches {launches}")
    expected = {"flash_attention": cfg.n_layers * n_waves,
                "decode_attention": cfg.n_layers * (LM_NEW - 1) * n_waves}
    if sorted(out) != [r.rid for r in reqs] \
            or any(len(t) != LM_NEW for t in out.values()) \
            or launches != expected:
        raise AssertionError(f"LM serving path: {len(out)} requests, "
                             f"launches {launches}, expected {expected}")

    # decode == prefill(n + 1), bf16, on the card
    n = LM_PROMPT[0] - 1
    toks = torch.from_numpy(np.stack([r.prompt[:n + 1]
                                      for r in reqs[:2]])).to(dev)
    cache, _ = M.prefill(model, {"tokens": toks[:, :n]}, LM_MAX_LEN)
    l2, _ = M.decode_step(model, cache, {"tokens": toks[:, n:n + 1]})
    _, l3 = M.prefill(model, {"tokens": toks}, LM_MAX_LEN)
    gap = float((l2 - l3).abs().max()) / max(float(l3.abs().max()), 1.0)
    print(f"[4c decode == prefill(n+1)] n {n}, 2 sequences: max|d logits| "
          f"{gap:.3e} of their scale (tolerance {LM_BF16_TOL})")
    if not gap <= LM_BF16_TOL:
        raise AssertionError("decode_step disagrees with prefill on the card")

    # a short wave under f32-cast weights, card against the CPU
    short = [Request(rid=i, prompt=rng.integers(2, cfg.vocab, 64).astype(
        np.int32), max_new_tokens=8) for i in range(2)]
    tokens = {}
    for where in (dev, torch.device("cpu")):
        m32 = copy.deepcopy(model).to(device=where, dtype=torch.float32)
        tokens[where.type] = ServeEngine(cfg, m32, batch_lanes=2,
                                         max_len=LM_MAX_LEN).generate(short)
        del m32
    same = tokens["cuda"] == tokens["cpu"] if "cuda" in tokens else None
    print(f"[4c parity] f32 weights, 2 x 64 tokens + 8 new: card "
          f"{tokens.get(dev.type)} cpu {tokens['cpu']} equal {same}")
    if dev.type == "cuda" and not same:
        raise AssertionError("card and CPU tokens differ on the short wave")
    return {"launches": launches, "waves": waves, "gen_s": gen_s,
            "tokens": n_tok}


def lm_profile(dev, cfg, model, steps: int = 16) -> None:
    """Where a decode step's time goes: the first wave prefilled, then
    ``steps`` decode steps timed on the host clock, and as many more under
    ``torch.profiler`` for the device time by kernel.  The idle share is
    taken against the unprofiled steps' wall clock."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import model as M

    wave = lm_requests(cfg.vocab)[:LM_LANES]
    S = max(len(r.prompt) for r in wave)
    toks = np.zeros((len(wave), S), np.int32)
    for j, r in enumerate(wave):
        toks[j, S - len(r.prompt):] = r.prompt
    cache, logits = M.prefill(model, {"tokens": torch.from_numpy(toks).to(
        dev)}, LM_MAX_LEN)
    cur = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)

    def step():
        nonlocal cache, cur
        logits, cache = M.decode_step(model, cache, {"tokens": cur[:, None]})
        cur = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    events = prof.key_averages()
    on_card = [e for e in events if e.device_type == DeviceType.CUDA]

    busy = sum(dev_us(e) for e in on_card) / 1e3 / steps
    attn = sum(dev_us(e) for e in on_card
               if "decode_attention_kernel" in e.key) / 1e3 / steps
    launches = sum(e.count for e in events
                   if e.key.startswith(LAUNCH_CALL)) / steps
    print(f"[4c profile] decode step at context {S + 1}-{S + 2 * steps + 1}"
          f", {LM_LANES} lanes: wall {1e3 * wall:.4f} ms a step; device "
          f"busy {busy:.4f} ms (idle share {1 - busy / (1e3 * wall):.4f}), "
          f"decode_attention {attn:.4f} ms ({attn / max(busy, 1e-9):.4f} of "
          f"busy); "
          f"{launches:.1f} kernel launches a step")
    for e in sorted(on_card, key=dev_us, reverse=True)[:8]:
        print(f"[4c profile]   {dev_us(e) / 1e3 / steps:9.4f} ms a step  "
              f"x{e.count // steps:<4d} {e.key[:90]}")


def lm_machine_phase(dev, cfg, model) -> dict:
    """Phase 4d: ``score_pairs_with_lm`` over the product dataset, checked
    against the plain ``pair_scores_ref`` on the same embeddings, then the
    example's blend + threshold through ``JoinService``."""
    import torch

    from repro_torch.core.crowd import PerfectCrowd
    from repro_torch.core.metrics import transitively_consistent
    from repro_torch.core.pairs import PairSet
    from repro_torch.data.entities import make_product_dataset
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.pair_scores import ops as ps_ops
    from repro_torch.kernels.pair_scores.ref import pair_scores_ref
    from repro_torch.serve import engine
    from repro_torch.serve.join_service import JoinService

    n_a, n_b = LM_SIDES
    ds = make_product_dataset(n_a=n_a, n_b=n_b)
    texts_a, texts_b = ds.records[:n_a], ds.records[n_a:]
    spent = {"embed": 0.0, "score": 0.0}
    embeds: list = []
    embed_records, pair_scores = engine.embed_records, engine.pair_scores

    def timed(fn, key, keep=None):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spent[key] += time.perf_counter() - t0
            if keep is not None:
                keep.append(out)
            return out
        return call

    fa_ops.flash_attention.launches = 0
    ps_ops.pair_scores.launches = 0
    engine.embed_records = timed(embed_records, "embed", embeds)
    engine.pair_scores = timed(pair_scores, "score")
    try:
        lik = engine.score_pairs_with_lm(cfg, model, texts_a, texts_b)
    finally:
        engine.embed_records, engine.pair_scores = embed_records, pair_scores
    launches = {"flash_attention": fa_ops.flash_attention.launches,
                "pair_scores": ps_ops.pair_scores.launches}
    ea, eb = embeds
    s_ref, _ = pair_scores_ref(ps_ops.l2_normalize(ea),
                               ps_ops.l2_normalize(eb), -1.0)
    err = float(np.abs(lik - ((s_ref + 1.0) / 2.0).cpu().numpy()).max())
    n_batches = -(-n_a // LM_EMBED_BATCH) + -(-n_b // LM_EMBED_BATCH)
    print(f"[4d machine phase] {n_a} x {n_b} records, {n_batches} backbone "
          f"batches, embeddings {tuple(ea.shape)} x {tuple(eb.shape)}: embed "
          f"{spent['embed']:.4f} s, pair_scores {spent['score']:.4f} s; "
          f"likelihood {float(lik.min()):.4f}-{float(lik.max()):.4f}, "
          f"max|d| against pair_scores_ref {err:.3e}; launches {launches}")
    expected = {"flash_attention": cfg.n_layers * n_batches, "pair_scores": 1}
    if lik.shape != (n_a, n_b) or not np.isfinite(lik).all() \
            or not err <= 1e-5 or launches != expected:
        raise AssertionError(f"LM machine phase: shape {lik.shape}, error "
                             f"{err}, launches {launches} (expected "
                             f"{expected})")

    # the example's blend with a calibrated base, then the join
    ents_a, ents_b = ds.entity_of[:n_a], ds.entity_of[n_a:]
    iu, ju = np.meshgrid(np.arange(n_a), np.arange(n_b), indexing="ij")
    truth = ents_a[iu] == ents_b[ju]
    base = np.zeros((n_a, n_b), np.float32)
    rng = np.random.default_rng(0)
    base[truth] = rng.beta(3.2, 2.2, size=int(truth.sum()))
    base[~truth] = rng.beta(1.0, 16.0, size=int((~truth).sum()))
    blend = 0.3 * lik + 0.7 * base
    keep = blend >= LM_JOIN_TAU
    cand = PairSet(iu[keep].astype(np.int32),
                   (ju[keep] + n_a).astype(np.int32),
                   blend[keep].astype(np.float32), truth[keep],
                   n_objects=n_a + n_b)
    t0 = time.perf_counter()
    svc = JoinService(lanes=1, device=dev)
    rid = svc.submit(cand, PerfectCrowd(),
                     total_true_matches=int(truth.sum()))
    res = svc.run()[rid]
    join_s = time.perf_counter() - t0
    q = res.quality
    print(f"[4d join] {len(cand)} candidates above {LM_JOIN_TAU} "
          f"({int(cand.truth.sum())} true of {int(truth.sum())}): "
          f"crowdsourced {res.n_crowdsourced} deduced {res.n_deduced} rounds "
          f"{res.n_rounds} precision {q.precision:.6f} recall "
          f"{q.recall:.6f} join {join_s:.4f} s")
    if res.n_crowdsourced + res.n_deduced != len(cand) \
            or q.precision != 1.0 \
            or not transitively_consistent(cand, res.labels):
        raise AssertionError("the LM machine phase's join result is wrong")
    return {"launches": launches, "err": err, "embeds": (ea, eb)}


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
    from repro_torch.core.graph import KEY_SENTINEL
    from repro_torch.core.metrics import transitively_consistent
    from repro_torch.core.pairs import PairSet
    from repro_torch.convert import embeddings_from_numpy
    from repro_torch.device import set_precision
    from repro_torch.kernels._build import extension, resources, sass
    from repro_torch.kernels.pair_scores import blocking
    from repro_torch.kernels.pair_scores import kernel as ps_kernel
    from repro_torch.kernels.pair_scores import ops as ps_ops
    from repro_torch.kernels.pair_scores.ref import (pair_scores_compact_ref,
                                                     pair_scores_ref)
    from repro_torch.kernels.pair_scores.sharded import sharded_candidates
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
    repeats = [ps_kernel.pair_scores(a, b, THRESHOLD, N_ROWS)
               for _ in range(5)]
    ps_repeat = all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                    for out in repeats for x, y in zip(out, (s_k, c_k)))
    print(f"[3 pair_scores] five calls equal bit for bit {ps_repeat}")
    if not ps_repeat:
        raise AssertionError("pair_scores differs between calls")
    del repeats, s_p, raw
    ps_res = resources("pair_scores_kernel")
    print(f"[3 pair_scores] kernel resources (cuobjdump): {ps_res['REG']} "
          f"registers, {ps_res['STACK']} B stack, {ps_res['LOCAL']} B local, "
          f"{ps_res['SHARED']} B shared")
    if ps_res["STACK"] or ps_res["LOCAL"]:
        raise AssertionError("pair_scores keeps a stack frame or spills")

    # union_deduce on the stacked lanes of the main path's first round
    probe = JoinService(lanes=N_SESSIONS, device=dev)
    for ids_a, ea, ids_b, eb in corpora:
        probe.submit_embeddings(
            embeddings_from_numpy(ea, dev), embeddings_from_numpy(eb, dev),
            THRESHOLD, crowd=PerfectCrowd(),
            truth_fn=lambda r, c, ia=ids_a, ib=ids_b: ia[r] == ib[c])
    screen_args, deduce_args = first_round_args(probe, dev)
    n_path = 8192
    path_u = torch.arange(n_path - 1, dtype=torch.int32, device=dev)[None]
    path_args = (torch.arange(n_path, dtype=torch.int32, device=dev)[None],
                 path_u, path_u + 1, torch.ones_like(path_u, dtype=torch.bool),
                 torch.full_like(path_u, KEY_SENTINEL), n_path)
    ud_B, ud_n = screen_args[0].shape
    ud_plan = ud_kernel.plan(ud_n, screen_args[1].shape[1], ud_B)
    print(f"[3 union_deduce] launch plan at the round-1 screen: {ud_B} lanes"
          f" x a cluster of {ud_plan.cluster} blocks = "
          f"{ud_B * ud_plan.cluster} blocks, {ud_plan.pair_slice} pairs and {ud_plan.smem_bytes} B of "
          f"shared memory a block (the forest, then {ud_plan.edge_cache} POS"
          f" edges), a hash set of {ud_plan.table_size} slots a lane")
    for name, args in (("round-1 screen", screen_args),
                       ("round-1 deduce", deduce_args),
                       ("path graph", path_args)):
        check_union_deduce("3 union_deduce", name, args)
    for name, args in (("round-1 screen", screen_args),
                       ("round-1 deduce", deduce_args)):
        outs = [ud_kernel.union_deduce(*args) for _ in range(5)]
        same = all(torch.equal(x, y) for out in outs[1:]
                   for x, y in zip(out, outs[0]))
        print(f"[3 union_deduce] five calls on the {name} equal bit for bit "
              f"{same}")
        if not same:
            raise AssertionError(f"union_deduce differs between calls "
                                 f"({name})")
    del probe

    # pair_scores_compact on the first chunk of blocked session 0's tiles
    cfg = blocking.BlockingConfig(**BLOCKING)
    blocked_corpora = [make_corpus(BLOCK_SEED + i, BLOCK_ROWS, DIM)
                       for i in range(N_SESSIONS)]
    _, ea, _, eb = blocked_corpora[0]
    a16 = ps_ops.l2_normalize(embeddings_from_numpy(ea, dev))
    b16 = ps_ops.l2_normalize(embeddings_from_numpy(eb, dev))
    every = np.arange(BLOCK_ROWS)
    tiles_a, tiles_b = blocking.block_pairs(
        blocking.signatures(a16, cfg), every, blocking.signatures(b16, cfg),
        every, cfg.bn, cfg.bm)
    chunk, bn, bm = cfg.tiles_per_call, cfg.bn, cfg.bm
    if len(tiles_a) < chunk:
        raise AssertionError(f"blocked session 0 has {len(tiles_a)} tiles, "
                             f"fewer than one {chunk}-tile chunk")
    chunk_args = gather_chunk(a16, b16, tiles_a[:chunk], tiles_b[:chunk])
    cs_err = check_compact(*chunk_args, bn, bm)
    c_call = chunk * bn * bm
    full = ps_kernel.pair_scores_compact(*chunk_args, THRESHOLD, c_call, bn,
                                         bm)
    n_chunk = int(full[3])
    half = n_chunk // 2
    part = ps_kernel.pair_scores_compact(*chunk_args, THRESHOLD, half, bn, bm)
    prefix = int(part[3]) == n_chunk and all(
        torch.equal(x[:half], y[:half]) for x, y in zip(part[:3], full[:3]))
    print(f"[3 pair_scores_compact] capacity {half} of {n_chunk} candidates:"
          f" n_total {int(part[3])}, kept prefix equal {prefix}")
    if not prefix:
        raise AssertionError("pair_scores_compact overflow prefix differs")
    whole_args = gather_chunk(a16, b16, tiles_a, tiles_b)
    T_all = len(tiles_a)
    whole = ps_kernel.pair_scores_compact(*whole_args, THRESHOLD,
                                          T_all * bn * bm, bn, bm)
    parts, n_parts = [], 0
    for t0 in range(0, T_all, chunk):
        args = gather_chunk(a16, b16, tiles_a[t0:t0 + chunk],
                            tiles_b[t0:t0 + chunk])
        out = ps_kernel.pair_scores_compact(*args, THRESHOLD,
                                            len(args[2]) // bn * bn * bm,
                                            bn, bm)
        k = int(out[3])
        parts.append([x[:k, 0] for x in out[:3]])
        n_parts += k
    n_whole = int(whole[3])
    concat = n_whole == n_parts and all(
        torch.equal(whole[i][:n_whole, 0].view(torch.int32),
                    torch.cat([p[i] for p in parts]).view(torch.int32))
        for i in range(3))
    print(f"[3 pair_scores_compact] one call over session 0's {T_all} tiles"
          f": {n_whole} candidates; {len(parts)} chunk calls: {n_parts}; "
          f"equal bit for bit {concat}")
    if not concat:
        raise AssertionError("pair_scores_compact over the whole session "
                             "differs from its chunk calls")
    del whole_args, whole, parts
    repeats = [ps_kernel.pair_scores_compact(*chunk_args, THRESHOLD, c_call,
                                             bn, bm) for _ in range(5)]
    cs_repeat = all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                    for out in repeats[1:] for x, y in zip(out, repeats[0]))
    print(f"[3 pair_scores_compact] five calls on the chunk equal bit for "
          f"bit {cs_repeat}")
    if not cs_repeat:
        raise AssertionError("pair_scores_compact differs between calls")
    del repeats
    ta, tb = blocking.dense_block_pairs(N_ROWS, N_ROWS, bn, bm)
    tiled = blocking.score_block_pairs(a, b, ta, tb, THRESHOLD, cfg)
    dense = sharded_candidates(a, b, THRESHOLD, normalize=False)
    bitwise = tiled.n_dropped == dense.n_dropped == 0 \
        and np.array_equal(tiled.rows, dense.rows) \
        and np.array_equal(tiled.cols, dense.cols) \
        and np.array_equal(tiled.scores.view(np.int32),
                           dense.scores.view(np.int32))
    print(f"[3 pair_scores_compact] dense tiling of ({N_ROWS}, {DIM}) x "
          f"({N_ROWS}, {DIM}), {len(ta)} tiles: {len(tiled.rows)} "
          f"candidates, equal to the dense kernel's {len(dense.rows)} bit "
          f"for bit {bitwise}")
    if not bitwise:
        raise AssertionError("pair_scores_compact differs from the dense "
                             "kernel on a dense tiling")
    del a16, b16, full, part, tiled, dense

    # flash_attention and decode_attention at the LM paths' shapes
    lm_cfg = lm_config()
    H, K, hd = lm_cfg.n_heads, lm_cfg.n_kv_heads, lm_cfg.hd
    S0 = max(len(r.prompt) for r in lm_requests(lm_cfg.vocab)[:LM_LANES])
    fa_err, fa_args = check_flash(dev, LM_LANES, S0, H, K, hd, torch.bfloat16)
    check_flash(dev, LM_LANES, S0, H, K, hd, torch.float32)
    for B in embed_batches():
        for dtype in (torch.bfloat16, torch.float32):
            check_flash(dev, B, LM_EMBED_LEN, H, K, hd, dtype)
    for shape in FLASH_GQA_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            check_flash(dev, *shape, dtype)
    fa_sass = sass("flash_attention_bf16_kernel")
    ops = {op: fa_sass.count(op) for op in ("HGMMA", "UTMALDG")}
    print(f"[3 flash_attention] bf16 kernel SASS (cuobjdump): "
          f"{ops['HGMMA']} HGMMA, {ops['UTMALDG']} UTMALDG")
    if not ops["HGMMA"] or not ops["UTMALDG"]:
        raise AssertionError("the bf16 flash kernel runs no wgmma or no TMA")
    from repro_torch.kernels.decode_attention import kernel as da_kernel

    probe_q = torch.zeros((LM_LANES, H, hd), dtype=torch.bfloat16, device=dev)
    probe_c = torch.zeros((LM_LANES, LM_MAX_LEN, K, hd), dtype=torch.bfloat16,
                          device=dev)
    da_splits, da_chunk = da_kernel.split_plan(probe_q, probe_c)
    del probe_q, probe_c
    print(f"[3 decode_attention] launch plan at ({LM_LANES}, {LM_MAX_LEN}, "
          f"{K}, {hd}) bf16: {LM_LANES * K} (lane, kv head) pairs x "
          f"{da_splits} splits of {da_chunk} positions = "
          f"{LM_LANES * K * da_splits} blocks on "
          f"{torch.cuda.get_device_properties(dev).multi_processor_count} SMs")
    da_err, da_args = 0.0, None
    for length in sorted(set(DECODE_LENGTHS) | {min(da_chunk, LM_MAX_LEN),
                                                min(da_chunk + 1,
                                                    LM_MAX_LEN)}):
        err, args = check_decode(dev, LM_LANES, LM_MAX_LEN, H, K, hd, length,
                                 torch.bfloat16, torch.bfloat16)
        da_err = max(da_err, err)
        if length == LM_MAX_LEN:
            da_args = args
        check_decode(dev, LM_LANES, LM_MAX_LEN, H, K, hd, length,
                     torch.float32, torch.float32)
    check_decode(dev, LM_LANES, LM_MAX_LEN, H, K, hd, 1337, torch.float32,
                 torch.bfloat16)
    repeats = [da_kernel.decode_attention(*da_args) for _ in range(5)]
    da_repeat = all(torch.equal(x.view(torch.int16), repeats[0].view(
        torch.int16)) for x in repeats[1:])
    print(f"[3 decode_attention] five calls at length {int(da_args[3])} "
          f"equal bit for bit {da_repeat}")
    if not da_repeat:
        raise AssertionError("decode_attention differs between calls")
    del repeats

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

    # -- 4b. the blocked main path -------------------------------------------
    blocked_launches = blocked_main_path(dev, blocked_corpora, cfg)

    # -- 4c. the LM serving path ---------------------------------------------
    from repro_torch.models.model import init_params, n_params

    lm_model = init_params(lm_cfg, torch.Generator(device=dev).manual_seed(
        SEED), dev)
    print(f"[4c model] {lm_cfg.name}: {lm_cfg.n_layers} layers, d_model "
          f"{lm_cfg.d_model}, {H} heads / {K} kv heads of {hd}, d_ff "
          f"{lm_cfg.d_ff}, vocab {lm_cfg.vocab}, {n_params(lm_cfg)} bf16 "
          f"parameters")
    serving = lm_serving_path(dev, lm_cfg, lm_model)
    lm_profile(dev, lm_cfg, lm_model)

    # -- 4d. the LM machine phase into the join ------------------------------
    machine = lm_machine_phase(dev, lm_cfg, lm_model)
    del lm_model

    # -- 4e. the noisy dense path --------------------------------------------
    noisy_launches = noisy_path(dev, corpora)

    # -- 4f. the paper's pipeline -------------------------------------------
    pipeline = paper_pipeline(dev)
    pl_args = []    # (lanes, call, args) at the pipeline's shapes
    for call, args in zip(("screen", "deduce"), pipeline_round_args(dev)):
        for lanes in (1, args[0].shape[0]):
            lane_args = tuple(x[:lanes] for x in args[:5]) + (args[5],)
            check_union_deduce("4f union_deduce",
                               f"the sweep's round-1 {call}, {lanes} lanes",
                               lane_args)
            pl_args.append((lanes, call, lane_args))

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
    def ud_bytes_of(lanes, n, P):
        """Forest in and roots out; u, v, the mask and the keys in, the
        deduced labels out; the conflict flags out."""
        return lanes * (4 * n * 2 + P * (4 + 4 + 1 + 4 + 4) + 4)

    ud_bytes = ud_bytes_of(ud_B, ud_n, screen_args[1].shape[1])
    # one 256-tile chunk of blocked session 0; D is already a multiple of 16
    cs_flops = 2 * chunk * bn * bm * DIM
    cs_bytes = chunk * (bn + bm) * (4 * DIM + 4) + 12 * min(n_chunk, c_call)

    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention.ref import mha_causal_ref

    # flash at the first wave's prefill shape; causal FLOPs (QK^T and PV)
    fq, fk, fv = fa_args
    fa_B, fa_S = fq.shape[:2]
    fa_flops = 4 * fa_B * H * hd * fa_S * (fa_S + 1) // 2
    fa_bytes = fq.element_size() * (2 * fq.numel() + fk.numel() + fv.numel())
    # decode at length LM_MAX_LEN: k and v up to length, q and o
    dq, dk, dv, dn = da_args
    da_len = int(dn)
    da_bytes = dk.element_size() * 2 * LM_LANES * da_len * K * hd \
        + 2 * dq.numel() * dq.element_size()
    da_flops = 4 * LM_LANES * H * hd * da_len
    sdpa = torch.nn.functional.scaled_dot_product_attention
    da_mask = (torch.arange(dk.shape[1], device=dev) < da_len)[None, None,
                                                                None]

    def bound(flops, nbytes, dtype):
        """The least time at the peak rate for the inputs' type."""
        peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
        t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES_PER_S
        return 1e3 * max(t_ops, t_bytes), \
            "operations" if t_ops > t_bytes else "bytes"

    fa_bound, fa_by = bound(fa_flops, fa_bytes, fq.dtype)
    da_bound, da_by = bound(da_flops, da_bytes, dq.dtype)

    def library_pair_scores():
        s = torch.matmul(a, b.T)
        return torch.where(s >= THRESHOLD, s, 0.0)

    kernels = [
        {"name": "pair_scores", "route": "cuda",
         "source": "src/repro_torch/csrc/pair_scores.cu",
         "replaces": "src/repro/kernels/pair_scores/kernel.py:62",
         "launches": launches["pair_scores"],
         "launches_by_path": {
             "dense": launches["pair_scores"],
             "lm_machine_phase": machine["launches"]["pair_scores"],
             "noisy_dense": noisy_launches["pair_scores"]},
         "max_abs_err": ps_err,
         "ms": cuda_ms(lambda: ps_kernel.pair_scores(*ps_args, THRESHOLD,
                                                     N)),
         "plain_ms": cuda_ms(lambda: pair_scores_ref(*ps_args, THRESHOLD)),
         "bound_ms": 1e3 * max(ps_flops / PEAK_F32_FLOPS,
                               ps_bytes / PEAK_BYTES_PER_S),
         "bound_by": ("operations" if ps_flops / PEAK_F32_FLOPS
                      > ps_bytes / PEAK_BYTES_PER_S else "bytes"),
         "library_ms": cuda_ms(library_pair_scores)},
        {"name": "pair_scores_compact", "route": "cuda",
         "source": "src/repro_torch/csrc/pair_scores_compact.cu",
         "replaces": "src/repro/kernels/pair_scores/kernel.py:141",
         "launches": blocked_launches["pair_scores_compact"],
         "max_abs_err": cs_err,
         "ms": cuda_ms(lambda: ps_kernel.pair_scores_compact(
             *chunk_args, THRESHOLD, c_call, bn, bm)),
         "plain_ms": cuda_ms(lambda: pair_scores_compact_ref(
             *chunk_args, THRESHOLD, c_call, bn, bm), 5),
         "bound_ms": 1e3 * max(cs_flops / PEAK_F32_FLOPS,
                               cs_bytes / PEAK_BYTES_PER_S),
         "bound_by": ("operations" if cs_flops / PEAK_F32_FLOPS
                      > cs_bytes / PEAK_BYTES_PER_S else "bytes"),
         "library_ms": cuda_ms(lambda: torch.bmm(
             chunk_args[0].view(chunk, bn, -1),
             chunk_args[1].view(chunk, bm, -1).transpose(1, 2)))},
        {"name": "union_deduce", "route": "cuda",
         "source": "src/repro_torch/csrc/union_deduce.cu",
         "replaces": "src/repro/kernels/union_deduce/kernel.py:129",
         "launches": launches["union_deduce"],
         "launches_by_path": {
             "dense": launches["union_deduce"],
             "blocked": blocked_launches["union_deduce"],
             "noisy_dense": noisy_launches["union_deduce"],
             "paper_pipeline": pipeline["launches"]["union_deduce"]},
         "max_abs_err": 0.0,
         "cluster": ud_plan.cluster,
         "ms": cuda_ms(lambda: ud_kernel.launch(*screen_args)),
         "plain_ms": cuda_ms(lambda: union_deduce_ref(*screen_args), 5),
         "bound_ms": 1e3 * ud_bytes / PEAK_BYTES_PER_S,
         "bound_by": "bytes", "library_ms": None,
         "at_paper_pipeline": [
             {"call": call, "lanes": lanes, "n": args[0].shape[1],
              "P": args[1].shape[1],
              "ms": cuda_ms(lambda a=args: ud_kernel.launch(*a)),
              "plain_ms": cuda_ms(lambda a=args: union_deduce_ref(*a), 5),
              "bound_ms": 1e3 * ud_bytes_of(lanes, args[0].shape[1],
                                            args[1].shape[1])
              / PEAK_BYTES_PER_S, "bound_by": "bytes"}
             for lanes, call, args in pl_args]},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention_wgmma.cu",
         "source_f32": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:72",
         "launches": serving["launches"]["flash_attention"],
         "launches_by_path": {
             "lm_serving": serving["launches"]["flash_attention"],
             "lm_machine_phase": machine["launches"]["flash_attention"]},
         "max_abs_err": fa_err,
         "ms": cuda_ms(lambda: fa_kernel.flash_attention(fq, fk, fv)),
         "plain_ms": cuda_ms(lambda: mha_causal_ref(fq, fk, fv), 5),
         "bound_ms": fa_bound, "bound_by": fa_by,
         "library_ms": cuda_ms(lambda: sdpa(
             fq.transpose(1, 2), fk.transpose(1, 2), fv.transpose(1, 2),
             is_causal=True, enable_gqa=True))},
        {"name": "decode_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/decode_attention.cu",
         "replaces": "src/repro/kernels/decode_attention/kernel.py:65",
         "launches": serving["launches"]["decode_attention"],
         "splits": da_splits, "max_abs_err": da_err,
         "ms": cuda_ms(lambda: da_kernel.decode_attention(dq, dk, dv, dn)),
         "plain_ms": cuda_ms(lambda: decode_attention_ref(dq, dk, dv, dn)),
         "bound_ms": da_bound, "bound_by": da_by,
         "library_ms": cuda_ms(lambda: sdpa(
             dq[:, :, None], dk.transpose(1, 2), dv.transpose(1, 2),
             attn_mask=da_mask, enable_gqa=True))},
    ]
    print("[6 pair_scores] one call's device time by kernel: "
          + device_split(lambda: ps_kernel.pair_scores(*ps_args, THRESHOLD,
                                                       N)))
    ud_split = device_split(lambda: ud_kernel.launch(*screen_args))
    print("[6 union_deduce] one call's device time by kernel: " + ud_split)
    if ud_split.count(" a call: ") != 1:
        raise AssertionError("union_deduce's launch runs more than its kernel")
    print("[6 pair_scores_compact] one call's device time by kernel: "
          + device_split(lambda: ps_kernel.pair_scores_compact(
              *chunk_args, THRESHOLD, c_call, bn, bm)))
    print("[6 decode_attention] one call's device time by kernel: "
          + device_split(lambda: da_kernel.decode_attention(dq, dk, dv, dn)))
    print(f"recorded, not measured here: flash_attention (8, 1491, 12, 64)"
          f" bf16 took {FLASH_MS_BEFORE} ms with the SIMT kernel"
          f" (PERF.md section 6, row 4; H100 80GB HBM3, 700 W)")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
