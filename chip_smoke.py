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
   lane) printed, five calls on each round-1 call bit for bit; the wide
   ``union_deduce`` kernel (past 46340 objects, int64 keys, the forest in
   global memory) bitwise on an n = 65536 path graph with int64 sentinel
   keys and on three stacked lanes of (65536, 131072) with int64 neg keys
   and a conflict, five calls on those lanes bit for bit;
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
   and five calls at length 2048 that agree bit for bit; its int8 cache
   path (the int8 KV cache with bf16 scales, dequantized in the kernel) at
   the same shape and lengths, at (4, 8 / 2, 32) over a (4, 1024, 2, 32)
   cache and internlm2-1.8b's (8, 16 / 8, 128) over (8, 2048, 8, 128),
   bf16 and f32 queries, against its plain version (which dequantizes
   first); under scales of 1 (the dequantized cache is the int8 integers)
   against the plain f32 attention within the f32 rule; five calls bit for
   bit.  f32 outputs
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
   ``torch.profiler``, for where a decode step's time goes (phase 4n, after
   4m, drives the LM stack's other families);
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
4g. a universe past 46340 objects: phase 4b's corpus generator and blocking
   configuration at 32768 rows a side (seed 100, width 384), one blocked
   session of 65536 objects through ``JoinService(lanes=1)
   .submit_embeddings(..., blocking=...)`` and ``run()`` under a
   ``PerfectCrowd``: its labels must be the truth and the wide
   ``union_deduce`` kernel must launch on int64 keys; the machine phase's
   split and ``run()``'s wall printed; the wide kernel bitwise on its
   round-1 screen and deduce; then a 5000-pair session among 50000 objects
   (``large_pairset``) through ``submit`` on the card and on the CPU with
   every result field identical;
4h. asynchronous ID/NF serving on a latency-modelled crowd: the paper's
   datasets at the quickstart's threshold (``make_paper_dataset()`` at 0.3,
   31156 pairs; ``make_product_dataset()`` at 0.3, 4229 pairs) through
   ``JoinService(lanes=2, latency=LatencyModel(n_workers=20,
   mean_minutes=30.0, seed=3))`` (``benchmarks/table1_latency.py``'s
   platform): async ID/NF (``async_mode=True, nf=True``) under a
   ``PerfectCrowd``, the round barrier on the same platform, the paper
   dataset alone async under the quickstart's ``NoisyCrowd(error_rate=
   0.08)``, and the product dataset alone async; each session's
   crowdsourced pairs, rounds, round sizes, rejected answers and
   ``sim_minutes`` must be the reference's (``ASYNC_RUNS``), its labels the
   truth (transitively consistent under the noisy crowd), async must
   finish in fewer simulated minutes than the barrier, and the product run
   again on the CPU must give identical fields; each run's wall, answers,
   events and ``union_deduce`` launches printed;
4i. the service's crowd economics: (a) phase 4's four corpora through
   ``submit_embeddings(..., budget_cents=ECON_DENSE_BUDGET,
   cost_per_assignment=2.0)`` on ``JoinService(lanes=4)`` under a
   ``PerfectCrowd`` (about half what phase 4's session 0 spends): every lane
   must stop on budget within it, consistent, and session 0 alone on the
   CPU must give identical fields; (b) the paper's datasets at 0.3 under
   budgets (``bench_join_service.py:503``'s 120 cents, barrier and async on
   phase 4h's platform), ``slots_per_round=256``, ``conflict_policy=
   "requery"`` (barrier, and async with a budget) and
   ``benchmarks/noise_sweep.py``'s worker-quality stage (majority, EM, EM
   with cluster tasks), every session's figures the reference's
   (``ECON_RUNS``, ``WORKER_RUNS``), the requery runs requerying, the mixed
   workers cheaper a resolved pair than majority, the slots run identical
   on the CPU; each run's wall, rounds, events and launches, the syncs
   and idle share of (a) and the requery run with a budget, and host-clock
   splits of (a) and the mixed run;
4j. streaming ingest: (a) phase 4's four corpora through
   ``submit_embeddings(..., streaming=True)`` on 2048 rows a side and four
   ``append_embeddings`` epochs (1024 a-rows; 1024 b-rows; 512 + 512; 512 +
   512; every row in corpus order) on ``JoinService(lanes=4)`` under a
   ``PerfectCrowd``, then ``run()``: each session's epoch candidates
   together must equal ``sharded_candidates`` over its full corpora bit for
   bit (set and f32 scores), the index must have scored 4096 x 4096 cells
   (fewer than re-scoring every epoch), every label must be the truth, and
   session 0's epochs through ``submit_stream`` on the CPU must give every
   result field identical; the machine phase an epoch (beside the batch
   ``submit_embeddings`` of the full corpora), ``run()``'s wall, ``_ingest``
   an epoch (a separate pass, each call synchronized) and a profiled run's
   idle share, launches and syncs printed; (b) the paper's
   datasets at 0.3 split into four epochs each (``split_epochs``) through
   ``submit_stream`` (``STREAM_RUNS``): up front under the barrier, async,
   and async on phase 4h's platform; interleaved under the barrier and
   async on that platform; interleaved under a 120-cent budget; up front
   under the quickstart's ``NoisyCrowd``; every session's figures must be
   the reference's, its labels the truth under a ``PerfectCrowd`` (unless
   stopped on budget), and an up-front stream under a ``PerfectCrowd``
   equal to the single-shot ``submit`` of the same pairs (every result
   field; on phase 4h's platform its ``ASYNC_RUNS`` figures,
   ``sim_minutes`` as floats); (c) phase 4g's corpus under the blocking
   configuration as a stream: 16384 rows a side, then four epochs of 8192
   rows alternating sides (the universe passes 46340 objects at the
   second, the lane's 65536-object bucket at the first): the union equal to ``blocked_candidates`` over the full corpus
   bit for bit, fewer cells scored than dense, labels the truth, the lane's
   keys widened from int32 to int64 while open and the wide
   ``union_deduce`` launched; host LSH seconds an epoch beside phase 4g's
   batch ``signatures``; then a 5000-pair stream whose first two epochs
   lie below 32768 ids (int32 keys) and whose later three reach 65535,
   interleaved, so the lane widens its keys to int64 with real neg keys in
   its index (recorded at ``session_grow``) and then launches the wide
   ``union_deduce``, on the card and on the CPU with every field identical;
   each streaming run's ``union_deduce`` launches are its own, the (b)
   batch runs apart;
4k. kill and restore on the card (durable serving, DESIGN.md §16), every
   run killed by ``_crash_after_checkpoints`` at a checkpoint mid-run (a
   lane open, cents spent, less than the uninterrupted total), restored
   and finished: (a) phase 4e's service with ``checkpoint_every=1``
   uninterrupted (every field phase 4e's; ms and bytes a commit, its wall
   beside 4e's), then killed half way and restored (timed): every field
   but the wall clock phase 4e's, the same total spend, the cents a
   restart would pay again; (b) ``tests/test_recovery.py:68-89``'s hard
   configuration (async ID/NF, EM, requery) on phase 4h's platform at the
   paper's datasets' full size, each alone under phase 4i's requery crowd
   (seed 10 + k): the uninterrupted run's figures, passes and requeries
   the reference's (``RECOVERY_RUNS``, ``sim_minutes`` as floats), the
   kill at the reference's cadence with its cents committed, the restored
   run's every field the uninterrupted run's, and the product run
   restored once more on the CPU with identical fields; (c) phase 4g's
   blocked session (65536 objects) per round, killed after a checkpoint
   with answers folded: the restored lane's neg keys int64 padded with the
   int64 sentinel, the wide ``union_deduce`` launched after the restore,
   labels the truth, every field an uninterrupted per-round run's; (d)
   ``bench_join_service.py``'s recovery stage at 2 and 4 sessions
   (``RECOVERY_BENCH``: 0.5368 of the cents saved at 2);
4l. the plan layer: ``bench_plan.py``'s repeat, pushdown and ordering
   stages at its CI and full sizes, every figure the reference's
   (``PLAN_RUNS``: the warm repeat crowdsourcing nothing with the cold
   signature, 0.383 fewer candidates at the CI size); a filtered
   ``MultiJoin`` at 0.7 over three tables of one ``make_corpus`` family
   (4096, 4096 and 2048 rows x 384), cold, then warm over the cache saved
   to disk (0 crowdsourced, the same signature); a ``JoinService
   (cache_path=, checkpoint_dir=)`` of phase 4's corpora 0 and 1 killed
   and restored (the cache reloaded and deposited into; a repeat of corpus
   0 crowdsourcing nothing; the cache file and every field an
   uninterrupted service's);
4m. training: ``paper-scorer`` at full width through the port's
   ``Runner`` (loss and gradients through the flash kernel's forward,
   AdamW, checkpoints): the same 40 steps uninterrupted, with a failure
   injected at step 25 and resumed, and again, the three final states
   equal bit for bit, the loss falling, the flash kernel launched twice a
   layer a step; a reduced config on the card against the CPU, and
   ``FlashAttentionFn``'s backward against the plain version's autograd;
   a batch of 64 in 2 microbatches with int8 compression timed and
   profiled (ms a step, tokens a second, peak memory, idle share, the
   split into forward, backward, compression and optimizer);
4n. the LM stack's other families at full width, each drawn on the card
   from a seeded generator: (a) ``internlm2-1.8b`` under ``kv_quant``
   (``ServeEngine`` on 8 requests of 256-1536 tokens, 64 new) against the
   same weights over the bf16 cache: the int8 decode kernel launched 24 x
   63 times and the bf16 one never, ms a decode step each, cache bytes, the
   first step where the greedy tokens part, one decode step's logits
   within 0.08 of the bf16 cache's scale; (b) ``qwen2-vl-2b`` (M-RoPE, 256
   patch embeddings, ``positions3`` as ``configs/shapes.py`` builds them)
   and (c) ``musicgen-medium`` (64 conditioning frames) through the
   model-level ``prefill`` of 8 sequences of 256-1024 text tokens and 32
   ``decode_step``s, launches exact, ``decode == prefill(n + 1)``; (d)
   ``olmoe-1b-7b`` (``ServeEngine``, 8 requests of 256-1024 tokens, 32
   new), a profiled window of decode steps (busy share, the experts'
   products' share), ``decode == prefill(n + 1)`` at ``capacity_factor``
   8 where the expert picks agree and near ties where they part;
4o. the SSM and hybrid families at full width, each drawn on the card from
   a seeded generator: (a) ``rwkv6-3b`` (attention-free) and (b)
   ``zamba2-1.2b`` (Mamba2 layers, the shared attention block after every
   6th) through ``ServeEngine`` (8 requests of 256-1024 tokens, 32 new):
   no attention launch for (a), exactly 7 flash launches for the wave's
   prefill and 7 decode launches a step for (b); prefill s, ms a step, the
   state's bytes, the SSD's chunk length and count, a profiled window of
   decode steps (busy share, launches, time by kernel); the flash and
   decode kernels against their plain versions at (b)'s shapes;
   ``decode == prefill(n + 1)`` on the 8 sequences within 5e-2 (a) and
   the reference test's 8e-2 (b); (c) ``configs/shapes.py``'s
   ``long_500k`` (524288 positions, batch 1): each family's cache filled
   from a seeded draw, 8 decode steps timed ending at the last position
   (zamba2 over 28 GiB of K/V: the bytes a step reads against the HBM
   peak; RWKV's cache bytes the same at every ``max_len``), and the decode
   kernel against its plain version at (1, 524288, 32 / 32, 64) bf16 at
   length 524280, timed beside its bound, plain version and SDPA;
4p. the dry-run's accounting against the card, and ``moonshot-v1-16b-a3b``
   at full width: (a) moonshot (28.06 B parameters, 56.1 GB in bf16)
   drawn on the card from a seeded generator, its three expert leaves a
   layer at a time (init seconds and peak bytes: at most the parameters
   and the largest single f32 draw), served by ``ServeEngine`` (8 requests
   of 256-1024 tokens, 16 new; exactly 48 flash launches for the wave and
   48 decode launches a step), a profiled window of decode steps (the
   experts' ``bmm`` share of busy), ``decode == prefill(n + 1)`` within
   5e-2 where the expert picks agree and near ties where they part, the
   kernels at its heads (16 / 16 of 128) against their plain versions;
   (b) three of ``configs/shapes.py``'s cells at a cut batch, each with its
   record from ``repro_torch.launch.dryrun`` and its roofline terms, one
   step measured on the card: moonshot at decode_32k (batch 1 of 128, 8
   steps from a seeded 12.9 GB cache), ``internlm2-1.8b`` at prefill_32k
   (batch 1 of 32: one prefill of 32768 tokens) and at decode_32k (batch 8
   of 128, 8 steps from a seeded 25.8 GB cache); no measured time may be
   below 0.95 of its bound (the accounting would over-count), and each
   cell prints its measured fraction, the card's peak and
   ``fits_one_card``; ``internlm2-1.8b``'s draw equal to the whole-leaf
   draw of before, leaf for leaf; the flash kernel at (1, 32768, 16 / 8,
   128) (its plain version at S = 8192, its last 256 rows at 32768 against
   the plain attention of those rows) and the decode kernel at (8, 32768,
   16 / 8, 128) against their plain versions, timed beside their bounds
   and SDPA; (c) the H100 roofline table of every arch x shape, traced on
   the host;
4q. the (data, model) mesh on the card: a (2, 2) mesh of four ranks
   (``repro_torch.launch.mesh.spawn``) sharing the one card on the backend
   the launcher names (gloo: NCCL refuses two ranks of one communicator on
   one card), the backend, each rank's place and device printed: (a)
   phase 4's four corpora through ``sharded_candidates`` on the mesh, each
   rank launching the ``pair_scores`` kernel once a corpus on its (2048,
   2048) block (its count read in the rank); the candidates equal phase
   4's single-device candidates bit for bit (a cell is summed with fmaf in
   k order from 0 whatever the block's size, ``score_tile.cuh``), in the
   rank-major order, no drop, identical on every rank, and the gather's ms
   and bytes; (b) corpus 0 served by ``JoinService.submit_embeddings(...,
   mesh)`` and ``run()`` in every rank: every result field identical on
   the four ranks, and the same session at (1, 1): its scalar fields equal
   and each pair's label and crowdsourcing equal (the arrays follow the
   candidates, which come in another order); ``union_deduce`` launched in
   every rank; (c) ``moe_block_a2a`` at ``olmoe-1b-7b``'s full width (d
   2048, 64 experts, top 8, d_ff 1024) in bf16 at capacity factor 8 over
   (8, 512) tokens, 32 experts a rank: forward and input gradient within
   the reference's 8e-3 of ``moe_block`` on rank 0, the aux loss within
   1e-5 of the ranks' router estimates averaged on one device, ms a call
   and the all-to-all's bytes; any rank's failure fails the phase;
5. engine parity: the first session's candidates through ``submit`` on the
   card and on the CPU (the plain versions) give identical results;
6. the device time of one ``pair_scores``, ``pair_scores_compact``,
   ``union_deduce`` and ``decode_attention`` call by kernel (each wrapper's
   fills and memsets beside its launch: ``union_deduce`` must be one
   kernel), taken right after phase 4g, before the LM phases: the
   profiler drops device records for a while after a profile taken with
   the card nearly full; a ``{"kernels": [...]}`` line with each kernel's launches on its
   main path (and on each path, where it runs on more than one), error, and
   times beside its bound, its plain version and a library call
   (``union_deduce``'s with its cluster size, and its times and bounds at
   phase 4f's shapes; the wide ``union_deduce`` as an entry of its own, at
   phase 4g's round-1 screen, with its launches in phase 4g; phase 4i's,
   4j's, 4k's, 4l's, 4m's and 4n's launches in ``launches_by_path``, and
   the wide kernel's after 4k's restore; ``decode_attention``'s int8 path
   as an entry of its own, its launches from phase 4n a; phase 4o's
   flash and decode launches under ``ssm_hybrid``, and the decode
   kernel's figures at ``long_500k`` under ``at_long_500k``; phase 4p's
   under ``moonshot`` and ``dryrun_cells``, the flash kernel's figures at
   prefill_32k under ``at_prefill_32k`` and the decode kernel's at
   decode_32k under ``at_decode_32k``);
7. last line: ``{"ok": true, "device": {...}}``.

The embeddings come from a seed: two-level centroid hierarchies (families of
near-duplicate entities, several records per entity on each side), so that
each session has 10^4 - 10^5 candidates, most of them non-matching, and the
neg-key index and NEG deduction carry real traffic.  384 is the width of a
common sentence-embedding model used for entity-matching blocking.  The
blocked path runs the reference's own full blocking configuration
(``benchmarks/bench_blocking.py``: 16384 rows a side, 6 bits, 8 tables,
128 x 128 tiles, 256 tiles a kernel call; phase 4g at 32768 rows a side).
The LM phases run the paper's own likelihood model, ``paper-scorer``, at
its configured widths, over the paper's Abt-Buy-like product table.
"""
from __future__ import annotations

import dataclasses
import json
import math
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
# phase 4g, a universe past 46340 objects (int64 pair keys, the wide
# union_deduce kernel): one blocked session of phase 4b's corpus generator
# and blocking config at 32768 rows a side (65536 objects), then a
# make_session_pairsets-style session of 5000 pairs among 50000 objects
LARGE_ROWS, LARGE_SEED = 32768, SEED + 100
LARGE_PAIRS = dict(n=50000, m=5000, seed=SEED + 50)
# phase 4h, asynchronous ID/NF serving: the paper's datasets at the
# quickstart's threshold on benchmarks/table1_latency.py's platform (20
# workers, lognormal minutes of mean 30, seed 3), two lanes.  Each session's
# (crowdsourced pairs, rounds, sha256 of its round sizes' JSON list (first
# 16 hex digits), answers rejected, sim_minutes) are the JAX package's
# JoinService on the CPU (jax 0.9.0) with the same options and data;
# tests/test_torch_async.py holds the port to the reference itself.
ASYNC_TAU, ASYNC_LANES = 0.3, 2
ASYNC_LATENCY = dict(n_workers=20, mean_minutes=30.0, seed=3)
ASYNC_NOISY = dict(error_rate=0.08)     # examples/quickstart.py's crowd
ASYNC_RUNS = {
    # run: (sessions, async_mode, noisy, {session: figures})
    "async": (("paper", "product"), True, False, {
        "paper": (1810, 297, "935bb7ad58aca263", 0, 8324.949865851608),
        "product": (3698, 654, "5361fe657173bdb4", 0, 8244.928055729753)}),
    "barrier": (("paper", "product"), False, False, {
        "paper": (1655, 7, "f2e1635ff256656f", 0, 8959.603864398692),
        "product": (3670, 4, "99c52893d4627b8a", 0, 8719.675722064681)}),
    "noisy async": (("paper",), True, True, {
        "paper": (1844, 321, "f5f4772403e0d190", 1, 2902.937042806693)}),
    "product async": (("product",), True, False, {
        "product": (3696, 637, "4361e6c81a05b5a3", 0, 5791.368661342403)}),
}
# the window of the phase 4i runs that are profiled: their first events
ASYNC_PROFILE_EVENTS = 300
# phase 4i, the service's crowd economics.  (a) phase 4's four corpora with
# a budget of about half the cents phase 4's session 0 spends unbudgeted at
# 2 cents an assignment, so every lane stops on budget mid-run.  (b) the
# paper's datasets at phase 4h's threshold: budgets
# (benchmarks/bench_join_service.py:503's 120 cents at 2 cents), the slot
# allocator, requery escalation with and without a budget, barrier and async
# on phase 4h's platform.  Requery runs under the crowd of
# benchmarks/bench_join_service.py:388-389 (a 35% error, its first seed):
# under phase 4e's pool, at about half its spend, the budgeted async run
# stops before its first rejected answer and requeries nothing.  Each
# session's figures (see econ_figures) are the JAX package's JoinService on
# the CPU (jax 0.9.0) with the same options and data, from
# tools/econ_reference.py; tests/test_torch_{budget,requery,workers}.py hold
# the port to the reference itself.
ECON_DENSE_BUDGET = 17340.0
# the 4i runs timed a second time under torch.profiler (the others once)
ECON_PROFILED = ("budgeted dense", "requery budget async")
ECON_TAU, ECON_LANES = 0.3, 2
ECON_BUDGET = dict(budget_cents=120.0, cost_per_assignment=2.0)
ECON_RUNS = {
    # run: (sessions, service options ("latency": phase 4h's platform),
    #       request options, crowd, {session: figures})
    "budget barrier": (("paper", "product"), {}, ECON_BUDGET, "perfect", {
        "paper": (60, 1, "b3fdec1080bd5304", 0, 0, 120.0, True, 0, 0, 0.0,
                  0.011790529946691754, None),
        "product": (60, 1, "b3fdec1080bd5304", 0, 0, 120.0, True, 0, 0, 0.0,
                    0.10353753235547886, None)}),
    "budget async": (("paper", "product"),
                     {"latency": True, "async_mode": True, "nf": True},
                     ECON_BUDGET, "perfect", {
        "paper": (60, 1, "b3fdec1080bd5304", 0, 0, 120.0, True, 0, 0, 0.0,
                  0.011790529946691754, 504.8174598599428),
        "product": (60, 1, "b3fdec1080bd5304", 0, 0, 120.0, True, 0, 0, 0.0,
                    0.10353753235547886, 177.139239789756)}),
    "slots": (("paper", "product"), {"slots_per_round": 256}, {}, "perfect", {
        "paper": (1611, 23, "4b3af894ecdcd2d4", 0, 0, 3222.0, False, 0, 0,
                  0.0, 0.9963274868612677, None),
        "product": (3647, 21, "9ac0a9b3e6c9b361", 0, 0, 7294.0, False, 0, 0,
                    0.0, 0.9558194774346793, None)}),
    "requery barrier": (("paper",), {"conflict_policy": "requery"}, {},
                        "noisy", {
        "paper": (1986, 10, "92d5ff7a4fc0c3db", 51, 32, 12236.0, False, 0, 0,
                  0.0, 0.4280613316530141, None)}),
    "requery budget async": (("paper",),
                             {"conflict_policy": "requery", "latency": True,
                              "async_mode": True, "nf": True},
                             {"budget_cents": 6500.0}, "noisy", {
        "paper": (1081, 48, "d72f489ace851a62", 2, 1, 6496.0, True, 0, 0,
                  0.0, 0.24704478906843075, 1936.1143304169275)}),
}
REQUERY_CROWD = dict(error_rate=0.35, qualification=False, seed=10)
# (b) continued: benchmarks/noise_sweep.py:83-150's worker-quality stage at
# its full size (the paper dataset at 0.3, its 30-worker pool, one lane,
# billed at the HIT-amortized quantum of 2 / 20 cents an assignment)
WORKER_CROWD = dict(error_rate=0.1, n_assignments=3, seed=7, n_workers=30,
                    worker_concentration=3.0, qualification=False)
WORKER_RUNS = {
    # config: (service options, figures)
    "majority": ({}, (1694, 8, "dd648203a9fb723d", 1, 0, 508.2000000000135,
                      False, 0, 0, 0.0, 0.9765348762455802, None)),
    "em": ({"aggregation": "em"},
           (1679, 7, "80884228f50d1f88", 0, 0, 503.70000000001335, False, 0,
            0, 0.0, 0.9707261437080218, None)),
    "mixed": ({"aggregation": "em", "cluster_tasks": True, "cluster_size": 8},
              (3659, 6, "dd5cb6b5a8b3850c", 11, 0, 166.419999999998, False,
               504, 3490, 115.72000000000082, 0.9917628724994435, None)),
}
# phase 4j, streaming ingest.  (a) phase 4's four corpora through
# submit_embeddings(..., streaming=True) on STREAM_FIRST rows a side, then
# append_embeddings epochs of (a rows, b rows), every row in corpus order.
# (b) the paper's datasets at phase 4h's threshold, each split into
# STREAM_K arrival epochs by split_epochs (seed STREAM_SPLIT_SEED + its
# index in the run), through submit_stream; each session's figures (see
# econ_figures) are the JAX package's JoinService on the CPU (jax 0.9.0)
# with the same options and epochs, from tools/stream_reference.py;
# tests/test_torch_streaming.py holds the port to the reference itself.
# (c) phase 4g's corpus under the blocking config: half of it a side, then
# epochs of a quarter alternating sides (the universe passes 46340 objects
# at the second; the lane's capacity bucket, 65536 objects, widens its keys
# at the first), and a large_pairset-style session of LARGE_STREAM_PAIRS,
# interleaved, whose first two epochs lie below LARGE_STREAM_FIRST_IDS
# (int32 keys; an interleaved stream ingests its second epoch before the
# first round) and whose later epochs reach its top id, so its keys widen
# to int64 with answers folded into them
STREAM_FIRST = 2048
STREAM_EPOCHS = ((1024, 0), (0, 1024), (512, 512), (512, 512))
STREAM_K, STREAM_SPLIT_SEED = 4, SEED
LARGE_STREAM_EPOCHS = ((8192, 0), (0, 8192), (8192, 0), (0, 8192))
LARGE_STREAM_PAIRS = dict(n=65536, m=5000, seed=SEED + 60)
LARGE_STREAM_FIRST_IDS = 32768
STREAM_RUNS = {
    # run: (sessions, service options ("latency": phase 4h's platform),
    #       submit_stream options, crowd, {session: figures})
    "upfront barrier": (("paper", "product"), {}, {}, "perfect", {
        "paper": (1655, 7, "f2e1635ff256656f", 0, 0, 3310.0, False, 0, 0,
                  0.0, 0.9963274868612677, None),
        "product": (3670, 4, "99c52893d4627b8a", 0, 0, 7340.0, False, 0, 0,
                    0.0, 0.9558194774346793, None)}),
    "upfront async": (("paper", "product"), {"async_mode": True}, {},
                      "perfect", {
        "paper": (1655, 7, "f2e1635ff256656f", 0, 0, 3310.0, False, 0, 0,
                  0.0, 0.9963274868612677, None),
        "product": (3670, 4, "99c52893d4627b8a", 0, 0, 7340.0, False, 0, 0,
                    0.0, 0.9558194774346793, None)}),
    "upfront async latency": (("paper", "product"),
                              {"latency": True, "async_mode": True,
                               "nf": True}, {}, "perfect", {
        "paper": (1810, 297, "935bb7ad58aca263", 0, 0, 3620.0, False, 0, 0,
                  0.0, 0.9963274868612677, 8324.949865851608),
        "product": (3698, 654, "5361fe657173bdb4", 0, 0, 7396.0, False, 0,
                    0, 0.0, 0.9558194774346793, 8244.928055729753)}),
    "interleave barrier": (("paper", "product"), {}, {"interleave": True},
                           "perfect", {
        "paper": (1796, 8, "e90d34a6a0747244", 0, 0, 3592.0, False, 0, 0,
                  0.0, 0.9963274868612677, None),
        "product": (3797, 4, "83127fc59a86383d", 0, 0, 7594.0, False, 0, 0,
                    0.0, 0.9558194774346793, None)}),
    "interleave async latency": (("paper", "product"),
                                 {"latency": True, "async_mode": True,
                                  "nf": True}, {"interleave": True},
                                 "perfect", {
        "paper": (2326, 516, "c8ab05a738ce4383", 0, 0, 4652.0, False, 0, 0,
                  0.0, 0.9963274868612677, 9962.113743600179),
        "product": (3705, 777, "9b6dd02dfcb2945c", 0, 0, 7410.0, False, 0,
                    0, 0.0, 0.9558194774346793, 9064.019851367448)}),
    "interleave budget": (("paper", "product"), {},
                          dict(interleave=True, **ECON_BUDGET), "perfect", {
        "paper": (60, 1, "b3fdec1080bd5304", 0, 0, 120.0, True, 0, 0, 0.0,
                  0.012538398846467305, None),
        "product": (60, 1, "b3fdec1080bd5304", 0, 0, 120.0, True, 0, 0, 0.0,
                    0.10353753235547886, None)}),
    "upfront noisy": (("paper",), {}, {}, "noisy", {
        "paper": (1690, 7, "424831e7902f7d21", 1, 0, 10140.0, False, 0, 0,
                  0.0, 0.9790368271954675, None)}),
}
# phase 4k, durable serving (DESIGN.md §16).  (a) phase 4e's service with a
# checkpoint every run-loop pass.  (b) tests/test_recovery.py:68-89's hard
# configuration (async ID/NF, EM ballots, requery escalation) at the paper's
# datasets' full size on phase 4h's platform, each dataset alone under the
# crowd of phase 4i's requery runs with seed 10 + k: a cadence of about a
# tenth of the run's passes, killed after RECOVERY_KILL commits.  Each
# run's (passes, checkpoint_every, cents committed at the kill,
# econ_figures) are the JAX package's JoinService on the CPU (jax 0.9.0)
# with the same options, data and kill, from tools/recovery_reference.py.
RECOVERY_SERVICE = dict(async_mode=True, nf=True, aggregation="em",
                        conflict_policy="requery")
RECOVERY_KILL = 5
RECOVERY_RUNS = {
    # dataset: (run-loop passes, checkpoint_every, cents at the kill,
    #           econ_figures of the uninterrupted run)
    "paper": (2470, 247, 9634.0, (
        2341, 469, "25713b9ec2725a4c", 208, 129, 15336.0, False, 0, 0, 0.0,
        0.29114670335069276, 3975.5145437597657)),
    "product": (3781, 378, 17454.0, (
        3776, 751, "22337b5d0776152d", 8, 5, 22706.0, False, 0, 0, 0.0,
        0.5112443778110944, 5791.368661342403)),
}
# benchmarks/bench_join_service.py's recovery stage (make_session_pairsets
# seed 5, NoisyCrowd(error_rate=0.15, seed=40 + k), two lanes, killed after
# 2 commits): sessions -> (restart cents, cents committed at the kill), the
# reference's (2 sessions: BENCH_join.json's recovery entry, 0.5368 of the
# cents saved)
RECOVERY_BENCH = {2: (570.0, 306.0), 4: (1206.0, 306.0)}
# phase 4l, the plan layer: benchmarks/bench_plan.py's stages (catalogs of
# dim 16 around n_ent entity centroids, threshold 0.80; seeds 3, 4, 5) at
# its CI size and its full size.  Each stage's figures are the JAX
# package's on the CPU, from tools/recovery_reference.py: repeat (cold and
# warm crowdsourced, warm cache hits, cold and warm cents, candidates),
# pushdown (raw and optimized candidates and crowdsourced), ordering (the
# greedy leg order, its expected crowd cost, the best and worst orders').
PLAN_TAU, PLAN_DIM = 0.80, 16
PLAN_SIZES = {"ci": ((24, 20, 18), (24, 20, 18, 16), 12),
              "full": ((90, 80, 70), (90, 80, 70, 60), 30)}
PLAN_RUNS = {
    "ci": {"repeat": (33, 0, 54, 66.0, 0.0, 51, True),
           "pushdown": (94, 58, 49, 36, True),
           "ordering": ("bdca", 316.0, 316.0, 407.0)},
    "full": {"repeat": (118, 0, 289, 236.0, 0.0, 241, True),
             "pushdown": (657, 259, 210, 125, True),
             "ordering": ("cdba", 1780.234375, 1780.234375, 2085.3125)},
}
# then at the join cells' width: three collections of make_corpus's families
# (two sides and a third), filtered, at phase 4's threshold
PLAN_WIDE_ROWS = (4096, 4096, 2048)
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
# phase 4m (training): examples/train_likelihood_model.py --full's run
# (paper-scorer at full width on the paper dataset's 181 packed rows of 128
# tokens, batch 8), 40 steps with a checkpoint every 10 and a failure
# injected at 25; then a card-sized batch of 64 in 2 microbatches with
# int8 gradient compression, 20 steps
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS, TRAIN_EVERY, TRAIN_FAIL = 128, 8, 40, \
    10, 25
TRAIN_BIG = dict(batch=64, microbatches=2, steps=20)
# phase 4m (b): 3 reduced steps on the card against the CPU within the bf16
# loss bound of tests/test_torch_train.py; FlashAttentionFn's backward at
# the full model's per-layer shape
TRAIN_CPU_STEPS, TRAIN_LOSS_RTOL = 3, 2e-3
TRAIN_ATTN_SHAPE = (8, 128, 12, 12, 64)
# phase 4n: the LM stack's other families at full width, each drawn on
# the card from a seeded generator.  (a) internlm2-1.8b under kv_quant, the
# reference's own int8 config (tests/test_models.py:160-176), served by
# ServeEngine against the same weights over the bf16 cache; (b)
# qwen2-vl-2b (M-RoPE, 256 patch embeddings) and (c) musicgen-medium (64
# conditioning frames) through the model-level prefill / decode_step with
# text of FAM_TEXT tokens; (d) olmoe-1b-7b (64 experts, top 8) served by
# ServeEngine, then decode == prefill(n + 1) at capacity_factor 8
# (tests/test_models.py:88-101).  decode == prefill(n + 1) is held to
# LM_BF16_TOL, the card's rule since phase 4c: the bf16 flash kernel rounds
# P to bf16 for P.V on the tensor cores where the decode kernel keeps f32,
# about 1e-2 of the logits' scale whatever the depth (4c reads 1.1e-2 at 12
# layers).  Under the experts a token's last pick can flip between the two
# paths: the first layer where it does must do so at a near tie, its 8th
# and 9th router probabilities within FAM_MOE_TIE of each other (that same
# 1e-2 of the hidden states moves a router probability by about as much)
FAM_KV_ARCH, FAM_KV_NEW = "internlm2-1.8b", 64
FAM_KV_TOL = 0.08           # int8 against bf16 logits, of their scale
FAM_PREFIX_ARCHS = ("qwen2-vl-2b", "musicgen-medium")
FAM_TEXT, FAM_DECODE = (256, 1024), 32
FAM_MOE_ARCH, FAM_MOE_PROMPT, FAM_MOE_NEW = "olmoe-1b-7b", (256, 1024), 32
FAM_MOE_CF, FAM_MOE_TIE = 8.0, 2.0 ** -5
FAM_PROFILE_STEPS = 8
# phase 4o: the SSM and hybrid families at full width, each drawn on the
# card from a seeded generator: (a) rwkv6-3b (attention-free) and (b)
# zamba2-1.2b (38 Mamba2 layers, the shared attention block after every
# 6th over concat(hidden, embedding): 7 invocations of 32 heads over 32 kv
# heads of 64 on a 4096-wide input), each served by ServeEngine, 8 requests
# of SSM_PROMPT tokens, SSM_NEW new, then decode == prefill(n + 1) on the
# 8 sequences' first SSM_PROMPT[0] tokens: RWKV within LM_BF16_TOL (its
# reference test holds 1e-3 at the reduced config), zamba2 within its
# reference test's 8e-2 (tests/test_models.py:57-59); (c) configs/
# shapes.py's long_500k (524288 positions, batch 1, decode) for both:
# SSM_LONG_STEPS timed decode steps from a seeded state ending at the last
# position, and the decode kernel against its plain version at zamba2's
# (1, 524288, 32 / 32, 64) bf16 there.  No 524288-token prefill: the SSD's
# intra-chunk tensors alone would be 17 GiB each at that length
SSM_RWKV_ARCH, SSM_HYBRID_ARCH = "rwkv6-3b", "zamba2-1.2b"
SSM_PROMPT, SSM_NEW = (256, 1024), 32
SSM_HYBRID_TOL = 8e-2
SSM_LONG_SHAPE, SSM_LONG_STEPS = "long_500k", 8
# phase 4p: the dry-run's accounting against the card, and
# moonshot-v1-16b-a3b at full width.  (a) moonshot (28.06 B parameters,
# 48 layers of 64 experts top 6, 16 / 16 heads of 128) drawn on the card
# (its expert leaves a layer at a time) and served as 4n (d) serves
# olmoe-1b-7b, ACCT_NEW new tokens; (b) ACCT_CELLS: configs/shapes.py's
# cells at a cut batch, each measured against its record from
# repro_torch.launch.dryrun; no measured time may be below
# ACCT_BOUND_FLOOR of its bound.  The plain flash version is held at
# ACCT_FLASH_PLAIN_S: its f32 score matrix at S = 32768 would be 68.7 GB;
# the kernel's last ACCT_FLASH_TAIL rows at 32768 are held to the plain
# f32 attention of those rows
ACCT_MOE_ARCH, ACCT_NEW = "moonshot-v1-16b-a3b", 16
ACCT_CELLS = (("moonshot-v1-16b-a3b", "decode_32k", 1),
              ("internlm2-1.8b", "prefill_32k", 1),
              ("internlm2-1.8b", "decode_32k", 8))
ACCT_DECODE_STEPS = 8
ACCT_BOUND_FLOOR = 0.95
ACCT_FLASH_PLAIN_S, ACCT_FLASH_TAIL = 8192, 256
# the config whose card draw must be the whole-leaf draw of before, leaf
# for leaf
ACCT_DRAW_ARCH = "internlm2-1.8b"
# phase 3: the int8 decode path at head dims 32 and 128 beside the serving
# shape's 64: (B, S, H, K, d, length)
DECODE_INT8_SHAPES = ((4, 1024, 8, 2, 32, 700), (8, 2048, 16, 8, 128, 1500))
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
# phase 4q: the (data, model) mesh of ranks sharing the card; the a2a
# layer's tokens (B, S) at olmoe-1b-7b's full width, at the capacity factor
# of the reference's own test (tests/test_sharding.py:87), held to its
# bound (:103, :107); the ranks' time limit
MESH_SHAPE = (2, 2)
MESH_A2A_ARCH, MESH_A2A_TOKENS = "olmoe-1b-7b", (8, 512)
MESH_A2A_CF, MESH_A2A_TOL = 8.0, 8e-3
MESH_AUX_TOL = 1e-5     # f32 aux: the same sums, the mean in another order
MESH_TIMEOUT = 600.0


def make_corpus(seed: int, n: int, d: int, more=()):
    """Two embedding tables of ``n`` records over a shared entity universe:
    families of 1-12 near-duplicate entities (entity-to-family cosine about
    0.9), records scattered around their entity (record-to-entity cosine
    about 0.95).  Returns (entity id per a-row, a, entity id per b-row, b),
    and with ``more`` row counts a list of (entity ids, table) for further
    tables over the same entities, drawn after the first two."""
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

    def side(m):
        ids = rng.integers(0, len(fam_of), m)
        rows = entity[ids] + np.sqrt(0.1) * unit(rng.normal(size=(m, d)))
        return ids, rows.astype(np.float32)

    ids_a, a = side(n)
    ids_b, b = side(n)
    if more:
        return ids_a, a, ids_b, b, [side(m) for m in more]
    return ids_a, a, ids_b, b


def plan_catalogs(seed: int, sizes, n_ent: int, dim: int = PLAN_DIM,
                  noise: float = 0.05):
    """``benchmarks/bench_plan.py::_catalogs``'s draws as raw tables:
    (name, (n, dim) f32 embeddings, attrs, entity ids) a collection."""
    rng = np.random.default_rng(seed)
    cents = rng.normal(size=(n_ent, dim))
    out = []
    for name, n in zip("abcde", sizes):
        ids = rng.integers(0, n_ent, n)
        emb = (cents[ids] + noise * rng.normal(size=(n, dim))
               ).astype(np.float32)
        attrs = {"sku": np.arange(n), "price": rng.integers(5, 100, n),
                 "region": ids % 3}
        out.append((name, emb, attrs, ids))
    return out


def plan_query(ns, raw, tau: float = PLAN_TAU):
    """``bench_plan.py::_plan`` in the plan package ``ns`` (the port's, or
    another with the same names): a filtered multi-way join over ``raw``'s
    collections."""
    colls = [ns.Collection(name, emb, attrs=dict(attrs), entities=ids)
             for name, emb, attrs, ids in raw]
    join = ns.MultiJoin([ns.Scan(c) for c in colls], threshold=tau)
    return ns.Filter(ns.Cmp(f"{colls[0].name}.price", "<", 70),
                     ns.Filter(ns.Cmp(f"{colls[1].name}.region", "==", 0),
                               join)), colls


def plan_bench(ns, executor, size: str) -> tuple:
    """``bench_plan.py``'s three stages at ``PLAN_SIZES[size]`` in the plan
    package ``ns``; ``executor(cache, optimize_plans)`` builds a
    ``PlanExecutor``.  Returns (figures, seconds): figures comparable with
    ``==`` (``PLAN_RUNS``), the stages' walls."""
    import itertools

    sizes3, sizes4, n_ent = PLAN_SIZES[size]
    secs = {}
    plan, _ = plan_query(ns, plan_catalogs(3, sizes3, n_ent))
    cache = ns.ClusterCache()
    t0 = time.perf_counter()
    cold = executor(cache, True).execute(plan)
    secs["cold"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    warm = executor(cache, True).execute(plan)
    secs["warm"] = time.perf_counter() - t0
    repeat = (cold.n_crowdsourced, warm.n_crowdsourced, warm.n_cache_hits,
              cold.spent_cents, warm.spent_cents, cold.n_candidates,
              warm.signature() == cold.signature())
    plan, _ = plan_query(ns, plan_catalogs(4, sizes3, n_ent))
    t0 = time.perf_counter()
    raw = executor(ns.ClusterCache(), False).execute(plan)
    secs["raw"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    opt = executor(ns.ClusterCache(), True).execute(plan)
    secs["optimized"] = time.perf_counter() - t0
    pushdown = (raw.n_candidates, opt.n_candidates, raw.n_crowdsourced,
                opt.n_crowdsourced, opt.signature() == raw.signature())
    colls = [ns.Collection(name, emb, attrs=dict(attrs), entities=ids)
             for name, emb, attrs, ids in plan_catalogs(5, sizes4, n_ent)]
    opt = ns.optimize(ns.MultiJoin([ns.Scan(c) for c in colls],
                                   threshold=PLAN_TAU))
    names = [c.name for c in colls]
    order = [next(iter(kid.collections())) for kid in opt.children()]
    n = len(colls)
    sampled = [ns.optimizer._sample_rows(c.embeddings, np.ones(len(c), bool),
                                         64, i) for i, c in enumerate(colls)]
    sel = np.zeros((n, n))
    for i, j in itertools.combinations(range(n), 2):
        sel[i, j] = sel[j, i] = ns.optimizer._pair_selectivity(
            sampled[i], sampled[j], PLAN_TAU)
    costs = {perm: ns.expected_crowd_cost([len(c) for c in colls], sel,
                                          list(perm))
             for perm in itertools.permutations(range(n))}
    ordering = ("".join(order),
                float(costs[tuple(names.index(x) for x in order)]),
                float(min(costs.values())), float(max(costs.values())))
    return {"repeat": repeat, "pushdown": pushdown,
            "ordering": ordering}, secs


def recovery_bench(join_service, noisy_crowd, make_session_pairsets,
                   n_sessions: int, ckpt_dir: str, **device) -> dict:
    """``benchmarks/bench_join_service.py::_bench_recovery`` with the
    service class, crowd class and session generator of one package:
    uninterrupted, then killed after 2 commits, restored and finished.
    ``device`` goes to the port's constructor and ``restore``."""
    pairsets = make_session_pairsets(n_sessions, seed=5, n_objects=(20, 30),
                                     n_pairs=(60, 110))

    def service(**kw):
        svc = join_service.JoinService(lanes=2, **kw, **device)
        rids = [svc.submit(ps, noisy_crowd(error_rate=0.15, seed=40 + k))
                for k, ps in enumerate(pairsets)]
        return svc, rids

    svc, rids = service()
    base = svc.run()
    restart = sum(base[r].n_spent_cents for r in rids)
    svc, _ = service(checkpoint_dir=ckpt_dir)
    svc._crash_after_checkpoints = 2
    try:
        svc.run()
        killed = False
    except join_service.ServiceKilled:
        killed = True
    t0 = time.perf_counter()
    restored = join_service.JoinService.restore(ckpt_dir, **device)
    restore_s = time.perf_counter() - t0
    at_kill = restored.last_recovery["spent_cents"]
    rec = restored.run()
    identical = killed and all(
        np.array_equal(base[r].labels, rec[r].labels)
        and np.array_equal(base[r].crowdsourced, rec[r].crowdsourced)
        for r in rids)
    return {"restart_cents": restart, "at_kill": at_kill,
            "recovered_cents": sum(rec[r].n_spent_cents for r in rids),
            "identical": identical, "restore_s": restore_s}


def split_epochs(pairs, k: int, seed: int):
    """Split a ``PairSet`` into k non-empty arrival epochs, contiguous chunks
    of its pair order; each epoch's universe is the largest id it holds, so
    later epochs grow it (a copy of ``benchmarks/common.py::split_epochs``
    for the port's ``PairSet``)."""
    from repro_torch.core.pairs import PairSet

    rng = np.random.default_rng(seed)
    cuts = np.sort(rng.choice(np.arange(1, len(pairs)), size=k - 1,
                              replace=False))
    bounds = [0, *cuts.tolist(), len(pairs)]
    return [PairSet(pairs.u[a:b], pairs.v[a:b], pairs.likelihood[a:b],
                    None if pairs.truth is None else pairs.truth[a:b])
            for a, b in zip(bounds, bounds[1:])]


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
    wrapper's time is made of.  The profiler's device trace sometimes
    comes back empty (H100 runs have recorded no activity for one window
    after a long profile, and once for three windows in a row), so a
    window with no device activity at all is profiled again after a pause,
    up to five times, the later ones tracing the host too."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    parts = []
    for attempt in range(5):
        if attempt:
            time.sleep(1.0)
        activities = [ProfilerActivity.CUDA] if attempt < 2 else \
            [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with profile(activities=activities) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
            if e.device_type == DeviceType.CUDA and us:
                parts.append((us / e.count / 1e3, e.count / iters, e.key))
        if parts:
            break
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


def noisy_service(dev, corpora, **options):
    """Phase 4e's service: ``JoinService(lanes=4, fused_rounds=False)`` on
    ``dev`` (with ``options``), the four corpora queued through
    ``submit_embeddings`` under ``NoisyCrowd(seed=SEED + i, **NOISY_CROWD)``
    with their true-match counts."""
    from repro_torch.core.crowd import NoisyCrowd
    from repro_torch.convert import embeddings_from_numpy
    from repro_torch.serve import join_service

    svc = join_service.JoinService(lanes=N_SESSIONS, fused_rounds=False,
                                   device=dev, **options)
    for i, (ids_a, ea, ids_b, eb) in enumerate(corpora):
        svc.submit_embeddings(
            embeddings_from_numpy(ea, dev), embeddings_from_numpy(eb, dev),
            THRESHOLD, crowd=NoisyCrowd(seed=SEED + i, **NOISY_CROWD),
            truth_fn=lambda r, c, ia=ids_a, ib=ids_b: ia[r] == ib[c],
            total_true_matches=int((ids_a[:, None] == ids_b[None, :]).sum()))
    return svc


def noisy_path(dev, corpora) -> tuple:
    """Phase 4e: phase 4's four dense corpora through
    ``JoinService(lanes=4, fused_rounds=False)`` under ``NoisyCrowd``s
    (``NOISY_CROWD``, seeds ``SEED + i``), then ``run()``.  Every session must
    label all its pairs, transitively consistent; the sessions must reject
    answers (conflicts), the exact replay must run and ``union_deduce`` must
    launch on the folds.  Session 0 again on the CPU with the same crowd
    seed must give every result field identical.  Then a run split on the
    host clock (each stage synchronized) and a profiled run.  Returns the
    path's kernel launches, every result field of its run (by rid) and its
    ``run()`` wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import graph
    from repro_torch.core.crowd import CrowdGateway, NoisyCrowd
    from repro_torch.core.metrics import transitively_consistent
    from repro_torch.core.pairs import PairSet
    from repro_torch.kernels.pair_scores import ops as ps_ops
    from repro_torch.kernels.union_deduce import ops as ud_ops
    from repro_torch.serve import join_service

    ttms = [int((ia[:, None] == ib[None, :]).sum())
            for ia, _, ib, _ in corpora]

    def crowd(i):
        return NoisyCrowd(seed=SEED + i, **NOISY_CROWD)

    def serve():
        return noisy_service(dev, corpora)

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
    fields = {rid: result_fields(results[rid]) for rid in rids}
    return launches, fields, wall


def large_pairset(n: int, m: int, seed: int):
    """A ``make_session_pairsets``-style session past 46340 objects (that
    function enumerates every pair of its universe, which 50000 objects
    make too many): ``m`` distinct pairs among 1000 records spread over
    ``[0, n)``, the top id among them, in 160 entities, half of the pairs
    drawn inside an entity; likelihoods correlated with the truth as that
    function's (0.8 / 0.3 plus a 0.15 uniform jitter)."""
    from repro_torch.core.pairs import PairSet

    rng = np.random.default_rng(seed)
    objs = np.append(np.sort(rng.choice(n - 1, 999, replace=False)), n - 1)
    ent = rng.integers(0, 160, len(objs))
    members = [np.flatnonzero(ent == e) for e in range(160)]
    seen, pairs = set(), []
    while len(pairs) < m:
        group = members[int(rng.integers(160))] if rng.random() < 0.5 \
            else np.arange(len(objs))
        if len(group) < 2:
            continue
        a, b = sorted(int(x) for x in rng.choice(group, 2, replace=False))
        if (a, b) not in seen:
            seen.add((a, b))
            pairs.append((a, b))
    a, b = np.array(pairs).T
    truth = ent[a] == ent[b]
    lik = (np.where(truth, 0.8, 0.3) + 0.15 * rng.random(m)).astype(
        np.float32)
    return PairSet(objs[a].astype(np.int32), objs[b].astype(np.int32), lik,
                   truth, n_objects=n)


def wide_lanes(dev, n: int, p: int, lanes: int, seed: int):
    """Stacked ``union_deduce`` arguments past 46340 objects: a compressed
    forest over some POS edges of a random partition, their int64 neg keys
    sorted and padded, and a fresh POS mask (with 1% noise edges across the
    partition); lane 0 also unites the two roots of its first neg key, so it
    conflicts."""
    import torch

    from repro_torch.core.graph import _union_impl, key_sentinel

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(lanes):
        u = torch.from_numpy(rng.integers(0, n, p).astype(np.int32)).to(dev)
        v = torch.from_numpy(rng.integers(0, n, p).astype(np.int32)).to(dev)
        cluster = torch.from_numpy(rng.integers(0, n // 3, n)).to(dev)
        truth = cluster[u.long()] == cluster[v.long()]
        stage = torch.from_numpy(rng.integers(0, 3, p)).to(dev)
        parent0 = _union_impl(torch.arange(n, dtype=torch.int32, device=dev),
                              u, v, (stage == 0) & truth, n)
        ru, rv = parent0[u.long()], parent0[v.long()]
        keys = torch.minimum(ru, rv).long() * n + torch.maximum(ru, rv)
        negk = torch.where((stage == 0) & ~truth & (ru != rv), keys,
                           key_sentinel(torch.int64)).sort().values
        noise = torch.from_numpy(rng.random(p) < 0.01).to(dev)
        out.append([parent0, u, v, (stage == 2) & (truth | noise), negk])
    parent0, u, v, pos, negk = (torch.stack(x) for x in zip(*out))
    u[0, 0], v[0, 0], pos[0, 0] = negk[0, 0] // n, negk[0, 0] % n, True
    return parent0, u, v, pos, negk, n


def large_universe(dev) -> dict:
    """Phase 4g: sessions past 46340 objects, where pair keys are int64 and
    ``union_deduce`` runs its wide kernel.  One blocked session of
    ``make_corpus(LARGE_SEED, LARGE_ROWS, DIM)`` (65536 objects) through
    ``JoinService(lanes=1).submit_embeddings(..., blocking=...)`` and
    ``run()`` under a ``PerfectCrowd``: its labels must be the truth and the
    wide kernel must launch; the machine phase is split on the host clock
    as phase 4b's.  Then ``union_deduce`` bitwise on its round-1 screen and
    deduce, and a 5000-pair session among 50000 objects
    (:func:`large_pairset`) through ``submit`` on the card and on the CPU
    with every result field identical.  Returns the launches and the
    round-1 screen's arguments."""
    import torch

    from repro_torch.convert import embeddings_from_numpy
    from repro_torch.core.crowd import CrowdGateway, PerfectCrowd
    from repro_torch.core.metrics import transitively_consistent
    from repro_torch.kernels.pair_scores import blocking
    from repro_torch.kernels.pair_scores import ops as ps_ops
    from repro_torch.kernels.union_deduce import kernel as ud_kernel
    from repro_torch.kernels.union_deduce import ops as ud_ops
    from repro_torch.serve import join_service

    cfg = blocking.BlockingConfig(**BLOCKING)
    ids_a, ea, ids_b, eb = make_corpus(LARGE_SEED, LARGE_ROWS, DIM)
    k = int(max(ids_a.max(), ids_b.max())) + 1
    ttm = int((np.bincount(ids_a, minlength=k)
               * np.bincount(ids_b, minlength=k)).sum())
    spent = dict.fromkeys(("signatures", "block_pairs", "chunks", "dedup",
                           "machine", "engine", "gateway"), 0.0)

    def timed(fn, key):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            spent[key] += time.perf_counter() - t0
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
        setattr(mod, name, timed(getattr(mod, name), key))
    for counter in (ps_ops.pair_scores, ps_ops.pair_scores_compact,
                    ud_ops.union_deduce):
        counter.launches = 0
    ud_ops.union_deduce.wide_launches = 0
    try:
        svc = join_service.JoinService(lanes=1, device=dev)
        t0 = time.perf_counter()
        rid = svc.submit_embeddings(
            embeddings_from_numpy(ea, dev), embeddings_from_numpy(eb, dev),
            THRESHOLD, crowd=PerfectCrowd(),
            truth_fn=lambda r, c: ids_a[r] == ids_b[c],
            total_true_matches=ttm, blocking=cfg)
        submit_s = time.perf_counter() - t0
        ps = svc.queue[-1].pairs
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = svc.run()[rid]
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    finally:
        for mod, name, fn in originals:
            setattr(mod, name, fn)
    launches = {"pair_scores": ps_ops.pair_scores.launches,
                "pair_scores_compact": ps_ops.pair_scores_compact.launches,
                "union_deduce": ud_ops.union_deduce.launches,
                "union_deduce_wide": ud_ops.union_deduce.wide_launches}
    q = res.quality
    print(f"[4g large universe] {LARGE_ROWS} x {LARGE_ROWS} rows, "
          f"{ps.n_objects} objects, P {len(ps)}: machine phase "
          f"{submit_s:.4f} s: blocked_candidates {spent['machine']:.4f} s = "
          f"signatures {spent['signatures']:.4f} s, block_pairs "
          f"{spent['block_pairs']:.4f} s, gather + kernel chunks "
          f"{spent['chunks']:.4f} s, dedup {spent['dedup']:.4f} s")
    print(f"[4g large universe] run() wall {run_s:.4f} s: round engine "
          f"{spent['engine']:.4f} s, gateway replay {spent['gateway']:.4f} s,"
          f" rest {run_s - spent['engine'] - spent['gateway']:.4f} s; "
          f"crowdsourced {res.n_crowdsourced} deduced {res.n_deduced} rounds "
          f"{res.n_rounds} precision {q.precision:.6f} recall "
          f"{q.recall:.6f}; launches {launches}")
    if ps.n_objects <= ud_kernel.MAX_OBJECTS \
            or not np.array_equal(res.labels, ps.truth) \
            or not transitively_consistent(ps, res.labels) \
            or launches["union_deduce_wide"] < 1 \
            or launches["pair_scores_compact"] < 1 \
            or launches["pair_scores"]:
        raise AssertionError("the large-universe session is wrong or missed "
                             f"its kernels: {launches}")
    probe = join_service.JoinService(lanes=1, device=dev)
    probe.submit(ps, PerfectCrowd())
    screen_args, deduce_args = first_round_args(probe, dev)
    if screen_args[4].dtype != torch.int64:
        raise AssertionError(f"the large universe's keys are "
                             f"{screen_args[4].dtype}, not int64")
    check_union_deduce("4g union_deduce", "round-1 screen", screen_args)
    check_union_deduce("4g union_deduce", "round-1 deduce", deduce_args)

    lp = large_pairset(**LARGE_PAIRS)
    wide = ud_ops.union_deduce.wide_launches
    fields = []
    for device in (dev, "cpu"):
        one = join_service.JoinService(lanes=1, device=device)
        rid = one.submit(lp, PerfectCrowd())
        t0 = time.perf_counter()
        out = one.run()[rid]
        fields.append(result_fields(out))
        print(f"[4g large pairs] {LARGE_PAIRS['m']} pairs among "
              f"{LARGE_PAIRS['n']} objects on {device}: crowdsourced "
              f"{out.n_crowdsourced} deduced {out.n_deduced} rounds "
              f"{out.n_rounds} in {time.perf_counter() - t0:.4f} s")
    wide = ud_ops.union_deduce.wide_launches - wide
    diff = [k for k in fields[0] if fields[0][k] != fields[1][k]]
    print(f"[4g large pairs] card vs cpu: {len(fields[0])} fields, "
          f"differing {diff}; wide union_deduce launches {wide}")
    if diff or wide < 1 or not np.array_equal(
            np.asarray(fields[0]["labels"][1]), lp.truth):
        raise AssertionError(f"the 50000-object session: differing {diff},"
                             f" {wide} wide launches")
    return {"launches": launches, "large_pairs_wide": wide,
            "screen_args": screen_args,
            "signatures_s": spent["signatures"]}


def _async_figures(res) -> tuple:
    import hashlib

    sizes = json.dumps(res.round_sizes).encode()
    return (res.n_crowdsourced, res.n_rounds,
            hashlib.sha256(sizes).hexdigest()[:16], res.n_conflicts,
            res.sim_minutes)


def econ_figures(res) -> tuple:
    """A session's crowd-economics figures, comparable with ``==``:
    crowdsourced pairs, rounds, a SHA-256 prefix of the round sizes,
    rejected and requeried answers, cents spent, whether it stopped on
    budget, cluster tasks, cluster pairs and cluster cents, F-measure and
    ``sim_minutes``."""
    return _async_figures(res)[:4] + (
        res.n_requeried, res.n_spent_cents, res.stopped_on_budget,
        res.n_cluster_tasks, res.n_cluster_pairs, res.n_cluster_cents,
        res.quality.f_measure, res.sim_minutes)


def async_path(dev) -> dict:
    """Phase 4h: asynchronous ID/NF serving on a latency-modelled crowd.
    The paper's datasets at ``ASYNC_TAU`` through ``JoinService(lanes=2,
    latency=LatencyModel(**ASYNC_LATENCY))``: async ID/NF under a
    ``PerfectCrowd``, the round barrier on the same platform, the paper
    dataset alone async under ``NoisyCrowd(**ASYNC_NOISY)``, the product
    dataset alone async.  Each session's figures must be the reference's
    (``ASYNC_RUNS``), its labels the truth under a ``PerfectCrowd`` and
    transitively consistent under the noisy one, and async must finish in
    fewer simulated minutes than the barrier.  The product run again on the
    CPU must give every result field identical.  ``union_deduce``'s
    launches are
    counted from just before each run to just after it."""
    import torch

    from repro_torch.core.crowd import (CrowdGateway, LatencyModel,
                                        NoisyCrowd, PerfectCrowd)
    from repro_torch.core.metrics import transitively_consistent
    from repro_torch.kernels.union_deduce import ops as ud_ops
    from repro_torch.serve import join_service

    cands = {name: _pipeline_candidates(name, ASYNC_TAU)[1]
             for name in ("paper", "product")}
    counts = {"events": 0, "answers": 0}

    def counted(poll):
        def counted_poll(self):
            out = poll(self)
            if out:
                counts["events"] += 1
                counts["answers"] += len(out)
            return out
        return counted_poll

    def service(tag, device=dev):
        names, async_mode, noisy, _ = ASYNC_RUNS[tag]
        svc = join_service.JoinService(
            lanes=ASYNC_LANES, latency=LatencyModel(**ASYNC_LATENCY),
            async_mode=async_mode, nf=async_mode, device=device)
        rids = [svc.submit(cands[n], NoisyCrowd(**ASYNC_NOISY) if noisy
                           else PerfectCrowd()) for n in names]
        return svc, rids

    def timed_run(svc):
        counts.update(events=0, answers=0)
        poll = CrowdGateway.poll
        CrowdGateway.poll = counted(poll)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = svc.run()
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0
        finally:
            CrowdGateway.poll = poll

    walls, launches, results = {}, {}, {}
    for tag, (names, _, noisy, expected) in ASYNC_RUNS.items():
        svc, rids = service(tag)
        ud_ops.union_deduce.launches = 0
        out, wall = timed_run(svc)
        launches[tag] = ud_ops.union_deduce.launches
        walls[tag] = wall
        for name, rid in zip(names, rids):
            res = results[tag, name] = out[rid]
            ps = cands[name]
            got = _async_figures(res)
            print(f"[4h {tag} {name}] P {len(ps)} crowdsourced "
                  f"{res.n_crowdsourced} deduced {res.n_deduced} rounds "
                  f"{res.n_rounds} rejected {res.n_conflicts} sim_minutes "
                  f"{res.sim_minutes!r}; the reference's figures "
                  f"{got == expected[name]}")
            right = np.array_equal(res.labels, ps.truth) if not noisy \
                else (transitively_consistent(ps, res.labels) and
                      res.n_crowdsourced + res.n_deduced == len(ps))
            if got != expected[name] or not right:
                raise AssertionError(f"4h {tag} {name}: figures {got}, "
                                     f"expected {expected[name]}, labels "
                                     f"right {right}")
        print(f"[4h {tag}] run() wall {wall:.4f} s: {counts['answers']} "
              f"answers in {counts['events']} events, union_deduce launches"
              f" {launches[tag]}")
        if launches[tag] < 1:
            raise AssertionError(f"4h {tag}: union_deduce never launched")
    sim = {tag: max(results[tag, n].sim_minutes
                    for n in ASYNC_RUNS[tag][0])
           for tag in ("async", "barrier")}
    print(f"[4h async vs barrier] simulated minutes {sim['async']!r} "
          f"against {sim['barrier']!r}: async first "
          f"{sim['async'] < sim['barrier']}")
    if not sim["async"] < sim["barrier"]:
        raise AssertionError(f"async ID/NF is not faster: {sim}")

    svc, rids = service("product async", "cpu")
    t0 = time.perf_counter()
    cpu = result_fields(svc.run()[rids[0]])
    card = result_fields(results["product async", "product"])
    diff = [k for k in card if card[k] != cpu[k]]
    print(f"[4h parity] the product run on the card and on the CPU "
          f"({time.perf_counter() - t0:.4f} s): {len(card)} fields, "
          f"differing {diff}")
    if diff:
        raise AssertionError(f"4h product run: card and CPU differ in {diff}")

    return {"launches": launches, "walls": walls}


def econ_path(dev, corpora) -> dict:
    """Phase 4i: the service's crowd economics.  (a) phase 4's four dense
    corpora through ``submit_embeddings(..., budget_cents=
    ECON_DENSE_BUDGET, cost_per_assignment=2.0)`` on ``JoinService(lanes=4)``
    under a ``PerfectCrowd``: every lane must stop on budget within it with
    transitively consistent labels, and session 0 again alone on the CPU must
    give every result field identical.  (b) ``ECON_RUNS`` and
    ``WORKER_RUNS`` on the paper's datasets: each session's figures must be
    the reference's, every requery run must requery, and the mixed workers'
    cents a resolved pair must be below majority's; the slots run again on
    the CPU must give identical fields.  Each run's wall, rounds, events
    and ``union_deduce`` launches are printed, and for the runs of
    ``ECON_PROFILED`` (run again under ``torch.profiler``) its launches,
    host syncs and idle share; run (a) and the mixed run are split on the
    host clock, each stage
    synchronized.  Kernel counts are zeroed just before each run and read
    just after it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.crowd import (CostModel, CrowdGateway,
                                        LatencyModel, NoisyCrowd,
                                        PerfectCrowd)
    from repro_torch.core.metrics import transitively_consistent
    from repro_torch.core.pairs import PairSet
    from repro_torch.convert import embeddings_from_numpy
    from repro_torch.kernels.pair_scores import ops as ps_ops
    from repro_torch.kernels.union_deduce import ops as ud_ops
    from repro_torch.serve import join_service

    t_phase = time.perf_counter()
    counts = {"events": 0}
    poll = CrowdGateway.poll

    class Window(Exception):
        """Ends a profiled run after ``ASYNC_PROFILE_EVENTS`` events."""

    def counted_poll(self):
        out = poll(self)
        if out:
            counts["events"] += 1
            if counts["events"] == ASYNC_PROFILE_EVENTS:
                if counts["profiling"]:
                    raise Window
                torch.cuda.synchronize()
                counts["window"] = time.perf_counter() - counts["t0"]
        return out

    def measure(tag, make, svc=None):
        """Run ``svc`` (default: ``make()``'s service) once timed, kernel
        counts zeroed just before, then, for the runs of
        ``ECON_PROFILED``, a fresh ``make()`` under the profiler over at
        most its first ``ASYNC_PROFILE_EVENTS`` events (the idle share is
        taken over the same window of the timed run).  Returns the results
        and the union_deduce launches."""
        svc = svc or make()
        counts.update(events=0, profiling=False, window=None)
        ud_ops.union_deduce.launches = 0
        CrowdGateway.poll = counted_poll
        try:
            torch.cuda.synchronize()
            counts["t0"] = t0 = time.perf_counter()
            out = svc.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            ud, events = ud_ops.union_deduce.launches, counts["events"]
            prof = None
            if tag in ECON_PROFILED:
                svc = make()
                counts.update(events=0, profiling=True)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    try:
                        svc.run()
                    except Window:
                        pass
                    torch.cuda.synchronize()
        finally:
            CrowdGateway.poll = poll
        rounds = sum(r.n_rounds for r in out.values())
        line = (f"[4i {tag}] run() wall {wall:.4f} s, {rounds} rounds, "
                f"{events} events, union_deduce launches {ud}")
        if prof is not None:
            _, busy, syncs, n_launch = profile_counts(prof)
            window = counts["window"] or wall
            n_ev = min(events, ASYNC_PROFILE_EVENTS)
            line += (f"; over the first {n_ev} events ({window:.4f} s): "
                     f"{n_launch} kernel launches, {syncs} host syncs, "
                     f"device busy {busy:.4f} s (idle share "
                     f"{1 - busy / window:.4f})")
        print(line)
        if ud < 1:
            raise AssertionError(f"4i {tag}: union_deduce never launched")
        return out, ud

    def split(tag, make, stages):
        """A run of ``make()``'s service with each (object, name, key)
        stage timed on the host clock, synchronized before and after."""
        spent = dict.fromkeys((key for _, _, key in stages), 0.0)
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

        originals = [getattr(obj, name) for obj, name, _ in stages]
        svc = make()
        for (obj, name, key), fn in zip(stages, originals):
            setattr(obj, name, timed(fn, key))
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            svc.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            for (obj, name, _), fn in zip(stages, originals):
                setattr(obj, name, fn)
        print(f"[4i split {tag}] run() wall {wall:.4f} s (synchronized "
              f"stages): " + ", ".join(f"{key} {spent[key]:.4f} s in "
                                       f"{calls[key]}" for key in spent))
        return spent

    # (a) budgeted dense sessions at full width
    ttms = [int((ia[:, None] == ib[None, :]).sum())
            for ia, _, ib, _ in corpora]
    budget = dict(budget_cents=ECON_DENSE_BUDGET, cost_per_assignment=2.0)

    def dense_service():
        svc = join_service.JoinService(lanes=N_SESSIONS, device=dev)
        for i, (ids_a, ea, ids_b, eb) in enumerate(corpora):
            svc.submit_embeddings(
                embeddings_from_numpy(ea, dev),
                embeddings_from_numpy(eb, dev), THRESHOLD,
                crowd=PerfectCrowd(),
                truth_fn=lambda r, c, ia=ids_a, ib=ids_b: ia[r] == ib[c],
                total_true_matches=ttms[i], **budget)
        return svc

    ps_ops.pair_scores.launches = 0
    dense_svc = dense_service()
    ps_launches = ps_ops.pair_scores.launches
    rids = [req.rid for req in dense_svc.queue]
    pairsets = [req.pairs for req in dense_svc.queue]
    out, ud_dense = measure("budgeted dense", dense_service, dense_svc)
    B = ECON_DENSE_BUDGET
    for rid, ps in zip(rids, pairsets):
        res = out[rid]
        ok = (res.stopped_on_budget and 0 < res.n_spent_cents <= B
              and res.n_crowdsourced <= B / 2
              and transitively_consistent(ps, res.labels))
        print(f"[4i budgeted dense {rid}] P {len(ps)} crowdsourced "
              f"{res.n_crowdsourced} deduced {res.n_deduced} rounds "
              f"{res.n_rounds} spent {res.n_spent_cents!r} of {B} cents, "
              f"stopped on budget {res.stopped_on_budget}; right {ok}")
        if not ok:
            raise AssertionError(f"4i budgeted dense session {rid} is wrong")
    ps0 = pairsets[0]
    one = join_service.JoinService(lanes=1, device="cpu")
    rid0 = one.submit(PairSet(ps0.u, ps0.v, ps0.likelihood, ps0.truth,
                              ps0.n_objects), PerfectCrowd(),
                      total_true_matches=ttms[0], **budget)
    t0 = time.perf_counter()
    cpu = result_fields(one.run()[rid0])
    card = result_fields(out[rids[0]])
    diff = [k for k in card if card[k] != cpu[k]]
    print(f"[4i parity] budgeted session 0 on the card and on the CPU "
          f"({time.perf_counter() - t0:.4f} s): {len(card)} fields, "
          f"differing {diff}")
    if diff:
        raise AssertionError(f"4i budgeted session 0: card and CPU differ in "
                             f"{diff}")
    Svc = join_service.JoinService
    spent = split("budgeted dense", dense_service, [
        (join_service, "session_frontier_batch", "frontier"),
        (Svc, "_allocate", "allocate"),
        (join_service, "session_gains_batch", "gains dispatch"),
        (CrowdGateway, "post", "post"),
        (CrowdGateway, "drain", "drain"),
        (join_service, "session_fold_answers_batch", "fold"),
        (Svc, "_budget_stop", "budget stop")])
    print(f"[4i split budgeted dense] allocate's host selection "
          f"{spent['allocate'] - spent['gains dispatch']:.4f} s")

    # (b) the paper's datasets, figures the reference's
    cands = {}
    for name in ("paper", "product"):
        ds, cand = _pipeline_candidates(name, ECON_TAU)
        cands[name] = (cand, ds.total_true_matches)

    def crowd(kind):
        return (PerfectCrowd() if kind == "perfect"
                else NoisyCrowd(**REQUERY_CROWD))

    def econ_service(tag, device=dev):
        names, svc_opts, req_opts, kind, _ = ECON_RUNS[tag]
        opts = dict(svc_opts)
        if opts.pop("latency", False):
            opts["latency"] = LatencyModel(**ASYNC_LATENCY)
        svc = join_service.JoinService(lanes=ECON_LANES, device=device,
                                       **opts)
        for n in names:
            svc.submit(cands[n][0], crowd(kind),
                       total_true_matches=cands[n][1], **req_opts)
        return svc

    ud_launches = {"budgeted dense": ud_dense}
    results = {}
    for tag, (names, _, _, kind, expected) in ECON_RUNS.items():
        out, ud_launches[tag] = measure(tag, lambda t=tag: econ_service(t))
        results[tag] = out
        for name, rid in zip(names, sorted(out)):
            res = out[rid]
            ps = cands[name][0]
            got = econ_figures(res)
            right = (np.array_equal(res.labels, ps.truth)
                     if tag == "slots" else
                     transitively_consistent(ps, res.labels))
            print(f"[4i {tag} {name}] P {len(ps)} crowdsourced "
                  f"{res.n_crowdsourced} rounds {res.n_rounds} rejected "
                  f"{res.n_conflicts} requeried {res.n_requeried} spent "
                  f"{res.n_spent_cents!r} stopped {res.stopped_on_budget} F "
                  f"{res.quality.f_measure!r} sim_minutes "
                  f"{res.sim_minutes!r}; the reference's figures "
                  f"{got == expected[name]}")
            if got != expected[name] or not right or (
                    "requery" in tag and res.n_requeried < 1):
                raise AssertionError(f"4i {tag} {name}: figures {got}, "
                                     f"expected {expected[name]}, labels "
                                     f"right {right}")
    t0 = time.perf_counter()
    cpu_out = econ_service("slots", "cpu").run()
    diff = [(rid, k) for rid in cpu_out
            for k, v in result_fields(results["slots"][rid]).items()
            if result_fields(cpu_out[rid])[k] != v]
    print(f"[4i parity] the slots run (paper and product) on the card and "
          f"on the CPU ({time.perf_counter() - t0:.4f} s): differing {diff}")
    if diff:
        raise AssertionError(f"4i slots run: card and CPU differ in {diff}")

    cost = CostModel()
    quantum = cost.cents_per_assignment / cost.pairs_per_hit
    paper, paper_ttm = cands["paper"]

    def worker_service(name):
        svc = join_service.JoinService(lanes=1, device=dev,
                                       **WORKER_RUNS[name][0])
        svc.submit(paper, NoisyCrowd(**WORKER_CROWD),
                   cost_per_assignment=quantum,
                   total_true_matches=paper_ttm)
        return svc

    cpp = {}
    for name, (_, expected) in WORKER_RUNS.items():
        out, ud_launches[f"workers {name}"] = measure(
            f"workers {name}", lambda n=name: worker_service(n))
        res = next(iter(out.values()))
        got = econ_figures(res)
        cpp[name] = res.n_spent_cents / len(paper)
        right = (transitively_consistent(paper, res.labels)
                 and res.n_crowdsourced + res.n_deduced == len(paper))
        print(f"[4i workers {name}] crowdsourced {res.n_crowdsourced} "
              f"rounds {res.n_rounds} cluster tasks {res.n_cluster_tasks} "
              f"cluster pairs {res.n_cluster_pairs} spent "
              f"{res.n_spent_cents!r} cents ({cpp[name]!r} a resolved pair) "
              f"F {res.quality.f_measure!r}; the reference's figures "
              f"{got == expected}")
        if got != expected or not right:
            raise AssertionError(f"4i workers {name}: figures {got}, "
                                 f"expected {expected}")
    print(f"[4i workers] cents a resolved pair: mixed {cpp['mixed']!r} "
          f"against majority {cpp['majority']!r}: below "
          f"{cpp['mixed'] < cpp['majority']}")
    if not cpp["mixed"] < cpp["majority"]:
        raise AssertionError(f"mixed scheduling is not cheaper: {cpp}")
    split("workers mixed", lambda: worker_service("mixed"), [
        (Svc, "_plan_tasks", "plan tasks"),
        (CrowdGateway, "post_cluster", "post_cluster"),
        (join_service, "session_fold_answers_batch", "fold")])
    print(f"[4i] phase wall {time.perf_counter() - t_phase:.1f} s")
    return {"union_deduce": sum(ud_launches.values()),
            "union_deduce_by_run": ud_launches,
            "pair_scores": ps_launches}


def large_stream_epochs():
    """Phase 4j (c)'s pair stream: ``large_pairset(**LARGE_STREAM_PAIRS)``;
    its pairs with both ids below ``LARGE_STREAM_FIRST_IDS`` make the first
    two epochs, the rest three more (:func:`split_epochs`, seed ``SEED``).
    Each epoch's universe is the largest id it holds."""
    lp = large_pairset(**LARGE_STREAM_PAIRS)
    low = np.maximum(lp.u, lp.v) < LARGE_STREAM_FIRST_IDS
    return split_epochs(lp.take(np.flatnonzero(low)), 2, SEED) \
        + split_epochs(lp.take(np.flatnonzero(~low)), 3, SEED)


def _union_bits(cands, m: int):
    """The union of candidate batches as (sorted keys row * m + col, their
    scores' bits); raises on a cell reported twice."""
    rows = np.concatenate([np.asarray(c.rows, np.int64) for c in cands])
    cols = np.concatenate([np.asarray(c.cols, np.int64) for c in cands])
    bits = np.concatenate([np.asarray(c.scores, np.float32).view(np.int32)
                           for c in cands])
    keys = rows * m + cols
    order = np.argsort(keys, kind="stable")
    keys, bits = keys[order], bits[order]
    if len(np.unique(keys)) != len(keys):
        raise AssertionError("a cell was reported by two epochs")
    return keys, bits


def streaming_path(dev, corpora, batch_signatures_s: float) -> dict:
    """Phase 4j: streaming ingest.  (a) phase 4's four corpora through
    ``submit_embeddings(..., streaming=True)`` on ``STREAM_FIRST`` rows a
    side and the ``STREAM_EPOCHS`` of ``append_embeddings``, then ``run()``:
    each session's epoch candidates together must equal
    ``sharded_candidates`` over its full corpora bit for bit (set and
    scores), the index must have scored exactly N x M cells (fewer than
    re-scoring every epoch), every label must be the truth, and session 0's
    epochs through ``submit_stream`` alone on the CPU must give every
    result field identical; the machine phase a session and epoch (beside
    the batch ``submit_embeddings`` of the full corpora, timed the same
    way), ``_ingest`` a call, ``run()``'s wall and, from a
    second run under ``torch.profiler``, its idle share, launches and syncs
    are printed.  (b) ``STREAM_RUNS`` on the paper's datasets: every
    session's figures the reference's, its labels the truth under a
    ``PerfectCrowd`` (transitively consistent under the noisy one and after
    a budget stop); each up-front stream under a ``PerfectCrowd`` equal to
    the single-shot ``submit`` of the same pairs (every result field; for
    the run on phase 4h's platform, ``ASYNC_RUNS``' async figures,
    ``sim_minutes`` as floats).  (c) phase 4g's corpus as a
    blocked stream of ``LARGE_STREAM_EPOCHS`` past 46340 objects: the union
    equal to ``blocked_candidates`` over the full corpus bit for bit, fewer
    cells scored than dense, labels the truth, the lane's keys widened from
    int32 to int64 while it was open and the wide ``union_deduce`` launched
    after; host LSH seconds an epoch beside phase 4g's batch signatures;
    then :func:`large_stream_epochs` interleaved on the card and on the CPU
    with every field identical.  Kernel counts are zeroed just before each
    path and read just after it."""
    import torch

    from repro_torch.kernels.pair_scores import blocking
    from repro_torch.kernels.pair_scores.sharded import \
        StreamingCandidateIndex
    from repro_torch.serve import join_service

    t_phase = time.perf_counter()
    recorded = {}       # id(index) -> every epoch's candidates
    # (keys before, keys after, n before, n after, the neg keys before):
    # the keys are kept, not counted, so recording makes no host sync
    grown = []
    spent = {"signatures": []}
    originals = {
        "append": StreamingCandidateIndex.append,
        "session_grow": join_service.session_grow,
        "signatures": blocking.signatures}

    def rec_append(self, new_a=None, new_b=None):
        out = originals["append"](self, new_a, new_b)
        recorded.setdefault(id(self), []).append(out)
        return out

    def rec_grow(state, p_cap, n_cap):
        out = originals["session_grow"](state, p_cap, n_cap)
        grown.append((state.neg_keys.dtype, out.neg_keys.dtype,
                      state.n_objects, out.n_objects, state.neg_keys))
        return out

    def timed_signatures(x, config):
        t0 = time.perf_counter()
        out = originals["signatures"](x, config)
        spent["signatures"].append(time.perf_counter() - t0)
        return out

    StreamingCandidateIndex.append = rec_append
    join_service.session_grow = rec_grow
    blocking.signatures = timed_signatures
    try:
        out = _streaming_runs(dev, corpora, batch_signatures_s, recorded,
                              grown, spent)
    finally:
        StreamingCandidateIndex.append = originals["append"]
        join_service.session_grow = originals["session_grow"]
        blocking.signatures = originals["signatures"]
    print(f"[4j] phase wall {time.perf_counter() - t_phase:.1f} s")
    return out


def _streaming_runs(dev, corpora, batch_signatures_s, recorded, grown,
                    spent) -> dict:
    """The body of :func:`streaming_path`, its stages instrumented."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.convert import embeddings_from_numpy
    from repro_torch.core.crowd import LatencyModel, NoisyCrowd, PerfectCrowd
    from repro_torch.core.metrics import transitively_consistent
    from repro_torch.kernels.pair_scores import blocking
    from repro_torch.kernels.pair_scores import ops as ps_ops
    from repro_torch.kernels.pair_scores.sharded import sharded_candidates
    from repro_torch.kernels.union_deduce import kernel as ud_kernel
    from repro_torch.kernels.union_deduce import ops as ud_ops
    from repro_torch.serve import join_service

    launches = {}

    def growth(g):
        """A recorded growth as printed: dtypes, universes, live keys."""
        old, new, n0, n1, keys = g
        return (str(old).split(".")[-1], str(new).split(".")[-1], n0, n1,
                int((keys != np.iinfo(str(old).split(".")[-1]).max).sum()))

    def on(x):
        return embeddings_from_numpy(x, dev)

    # (a) dense embedding streams at the join cells' width
    bounds_a, bounds_b = [STREAM_FIRST], [STREAM_FIRST]
    for da, db in STREAM_EPOCHS:
        bounds_a.append(bounds_a[-1] + da)
        bounds_b.append(bounds_b[-1] + db)
    n_full = bounds_a[-1]
    if bounds_b[-1] != n_full or n_full > len(corpora[0][1]):
        raise AssertionError("the stream's epochs do not cover the corpus")
    ttms = [int((ia[:, None] == ib[None, :]).sum())
            for ia, _, ib, _ in corpora]

    def dense_stream_service(machine_s=None):
        svc = join_service.JoinService(lanes=N_SESSIONS, device=dev)
        for i, (ids_a, ea, ids_b, eb) in enumerate(corpora):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rid = svc.submit_embeddings(
                on(ea[:STREAM_FIRST]), on(eb[:STREAM_FIRST]), THRESHOLD,
                crowd=PerfectCrowd(),
                truth_fn=lambda r, c, ia=ids_a, ib=ids_b: ia[r] == ib[c],
                total_true_matches=ttms[i], streaming=True)
            torch.cuda.synchronize()
            times = [time.perf_counter() - t0]
            for k in range(len(STREAM_EPOCHS)):
                a0, a1 = bounds_a[k], bounds_a[k + 1]
                b0, b1 = bounds_b[k], bounds_b[k + 1]
                t0 = time.perf_counter()
                svc.append_embeddings(rid, on(ea[a0:a1]) if a1 > a0 else None,
                                      on(eb[b0:b1]) if b1 > b0 else None)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            if machine_s is not None:
                machine_s.append(times)
        return svc

    recorded.clear()
    ps_ops.pair_scores.launches = 0
    ud_ops.union_deduce.launches = 0
    machine_s = []
    svc = dense_stream_service(machine_s)
    indexes = [svc._streams[req.rid].index for req in svc.queue]
    sessions = [(req.rid, [req.pairs, *svc._pending_arrivals[req.rid]])
                for req in svc.queue]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = svc.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches["dense"] = {"pair_scores": ps_ops.pair_scores.launches,
                         "union_deduce": ud_ops.union_deduce.launches}
    for (rid, epochs), index, (ids_a, ea, ids_b, eb) in zip(
            sessions, indexes, corpora):
        keys, bits = _union_bits(recorded[id(index)], n_full)
        full = sharded_candidates(on(ea[:n_full]), on(eb[:n_full]),
                                  THRESHOLD)
        want_keys, want_bits = _union_bits([full], n_full)
        bitwise = np.array_equal(keys, want_keys) and \
            np.array_equal(bits, want_bits)
        res = results[rid]
        truth = np.concatenate([e.truth for e in epochs])
        right = (np.array_equal(res.labels, truth)
                 and index.pairs_scored == n_full * n_full
                 and index.pairs_scored < index.full_rescore_pairs)
        print(f"[4j dense {rid}] P {len(truth)} in {len(epochs)} epochs "
              f"({', '.join(str(len(e)) for e in epochs)}): union of the "
              f"epochs equal to sharded_candidates bit for bit {bitwise} "
              f"({len(keys)} candidates); cells scored {index.pairs_scored}"
              f" of {index.full_rescore_pairs} re-scoring each epoch; "
              f"crowdsourced {res.n_crowdsourced} deduced {res.n_deduced} "
              f"rounds {res.n_rounds}; labels the truth {right}")
        if not (bitwise and right):
            raise AssertionError(f"4j dense session {rid} is wrong")
    batch_s = []
    batch = join_service.JoinService(lanes=N_SESSIONS, device=dev)
    for ids_a, ea, ids_b, eb in corpora:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch.submit_embeddings(
            on(ea[:n_full]), on(eb[:n_full]), THRESHOLD, crowd=PerfectCrowd(),
            truth_fn=lambda r, c, ia=ids_a, ib=ids_b: ia[r] == ib[c])
        torch.cuda.synchronize()
        batch_s.append(time.perf_counter() - t0)
    del batch
    # _ingest's own time, in a separate pass: each call synchronized before
    # and after, so this pass's run() is not the one timed above
    ingest_ms = []
    svc = dense_stream_service()
    Svc = join_service.JoinService
    plain_ingest = Svc._ingest

    def timed_ingest(self, lane, new_pairs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain_ingest(self, lane, new_pairs)
        torch.cuda.synchronize()
        ingest_ms.append(1e3 * (time.perf_counter() - t0))

    Svc._ingest = timed_ingest
    try:
        svc.run()
    finally:
        Svc._ingest = plain_ingest
    per_epoch = np.median(np.asarray(machine_s), axis=0)
    print(f"[4j dense] machine phase a session (median of {N_SESSIONS}): "
          f"submit {per_epoch[0]:.4f} s, epochs "
          + ", ".join(f"{t:.4f}" for t in per_epoch[1:])
          + f" s (sum {per_epoch.sum():.4f} s) against the batch "
          f"submit_embeddings {np.median(batch_s):.4f} s (median); _ingest "
          "calls (a separate synchronized pass), lane by lane, "
          "epoch by epoch: " + ", ".join(f"{t:.3f}" for t in ingest_ms)
          + f" ms; run() wall {run_s:.4f} s; launches {launches['dense']}")
    if min(launches["dense"].values()) < 1:
        raise AssertionError(f"4j dense: a kernel never launched: "
                             f"{launches['dense']}")
    rid0, epochs0 = sessions[0]
    one = join_service.JoinService(lanes=1, device="cpu")
    cpu_rid = one.submit_stream(epochs0, PerfectCrowd(),
                                total_true_matches=ttms[0])
    t0 = time.perf_counter()
    cpu = result_fields(one.run()[cpu_rid])
    card = result_fields(results[rid0])
    diff = [k for k in card if k != "rid" and card[k] != cpu[k]]
    print(f"[4j parity] session 0's epochs through submit_stream on the "
          f"card and on the CPU ({time.perf_counter() - t0:.4f} s): "
          f"{len(card)} fields, differing {diff}")
    if diff:
        raise AssertionError(f"4j dense session 0: card and CPU differ in "
                             f"{diff}")
    svc = dense_stream_service()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        svc.run()
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    _, busy, syncs, n_launch = profile_counts(prof)
    print(f"[4j profile dense] run() under the profiler {prof_s:.4f} s: "
          f"device busy {busy:.4f} s (idle share {1 - busy / prof_s:.4f}), "
          f"{n_launch} kernel launches, {syncs} host syncs")

    # (b) pair streams of the paper's datasets against the reference
    cands = {name: _pipeline_candidates(name, ASYNC_TAU)
             for name in ("paper", "product")}

    def crowd(kind):
        return (PerfectCrowd() if kind == "perfect"
                else NoisyCrowd(**ASYNC_NOISY))

    def stream_service(tag, stream=True):
        names, svc_opts, sub_opts, kind, _ = STREAM_RUNS[tag]
        opts = dict(svc_opts)
        if opts.pop("latency", False):
            opts["latency"] = LatencyModel(**ASYNC_LATENCY)
        svc = join_service.JoinService(lanes=ECON_LANES, device=dev, **opts)
        sub = dict(sub_opts)
        interleave = sub.pop("interleave", False)
        for i, n in enumerate(names):
            ds, ps = cands[n]
            if stream:
                svc.submit_stream(split_epochs(ps, STREAM_K,
                                               STREAM_SPLIT_SEED + i),
                                  crowd(kind), interleave=interleave,
                                  total_true_matches=ds.total_true_matches,
                                  **sub)
            else:
                svc.submit(ps, crowd(kind),
                           total_true_matches=ds.total_true_matches, **sub)
        return svc

    walls = {}
    stream_launches = {}    # each streaming run's own, batch runs apart
    for tag, (names, svc_opts, sub_opts, kind, expected) in \
            STREAM_RUNS.items():
        svc = stream_service(tag)
        ud_ops.union_deduce.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = svc.run()
        torch.cuda.synchronize()
        walls[tag] = time.perf_counter() - t0
        stream_launches[tag] = ud_ops.union_deduce.launches
        # an up-front stream equals its single-shot batch run where the
        # crowd's answers do not depend on the order they are drawn in (a
        # stream's pair slots follow the epochs, a noisy crowd's draws
        # follow the slots)
        upfront = kind == "perfect" and not sub_opts.get("interleave")
        batch = None
        if upfront and not svc_opts.get("latency"):
            batch = stream_service(tag, stream=False).run()
        for rid, name in zip(sorted(out), names):
            res = out[rid]
            ps = cands[name][1]
            got = econ_figures(res)
            # a budget stop trusts the graph for what it cannot afford
            right = (np.array_equal(res.labels, ps.truth)
                     if kind == "perfect" and not res.stopped_on_budget
                     else (transitively_consistent(ps, res.labels)
                           and res.n_crowdsourced + res.n_deduced == len(ps)))
            if batch is not None:
                same = result_fields(batch[rid]) == result_fields(res)
            elif upfront:
                same = _async_figures(res) == ASYNC_RUNS["async"][3][name]
            else:
                same = None
            print(f"[4j {tag} {name}] P {len(ps)} crowdsourced "
                  f"{res.n_crowdsourced} rounds {res.n_rounds} rejected "
                  f"{res.n_conflicts} spent {res.n_spent_cents!r} stopped "
                  f"{res.stopped_on_budget} sim_minutes {res.sim_minutes!r};"
                  f" the reference's figures {got == expected[name]}"
                  + ("" if same is None else
                     f"; equal to the single-shot batch run {same}"))
            if got != expected[name] or not right or same is False:
                raise AssertionError(f"4j {tag} {name}: figures {got}, "
                                     f"expected {expected[name]}, labels "
                                     f"right {right}, batch {same}")
        print(f"[4j {tag}] run() wall {walls[tag]:.4f} s; union_deduce "
              f"launches {stream_launches[tag]}")
    launches["pairs"] = {"union_deduce": sum(stream_launches.values())}
    if min(stream_launches.values()) < 1:
        raise AssertionError(f"4j (b): union_deduce never launched in a "
                             f"stream: {stream_launches}")

    # (c) a blocked stream past 46340 objects
    cfg = blocking.BlockingConfig(**BLOCKING)
    ids_a, ea, ids_b, eb = make_corpus(LARGE_SEED, LARGE_ROWS, DIM)
    k = int(max(ids_a.max(), ids_b.max())) + 1
    ttm = int((np.bincount(ids_a, minlength=k)
               * np.bincount(ids_b, minlength=k)).sum())
    first = LARGE_ROWS // 2
    la, lb = [first], [first]
    for da, db in LARGE_STREAM_EPOCHS:
        la.append(la[-1] + da)
        lb.append(lb[-1] + db)
    if la[-1] != LARGE_ROWS or lb[-1] != LARGE_ROWS:
        raise AssertionError("the large stream does not cover the corpus")
    recorded.clear()
    grown.clear()
    spent["signatures"].clear()
    for counter in (ps_ops.pair_scores, ps_ops.pair_scores_compact,
                    ud_ops.union_deduce):
        counter.launches = 0
    ud_ops.union_deduce.wide_launches = 0
    svc = join_service.JoinService(lanes=1, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rid = svc.submit_embeddings(
        on(ea[:first]), on(eb[:first]), THRESHOLD, crowd=PerfectCrowd(),
        truth_fn=lambda r, c: ids_a[r] == ids_b[c], total_true_matches=ttm,
        blocking=cfg, streaming=True)
    torch.cuda.synchronize()
    epoch_s = [time.perf_counter() - t0]
    for j in range(len(LARGE_STREAM_EPOCHS)):
        t0 = time.perf_counter()
        svc.append_embeddings(
            rid, on(ea[la[j]:la[j + 1]]) if la[j + 1] > la[j] else None,
            on(eb[lb[j]:lb[j + 1]]) if lb[j + 1] > lb[j] else None)
        torch.cuda.synchronize()
        epoch_s.append(time.perf_counter() - t0)
    sig_s = list(spent["signatures"])
    index = svc._streams[rid].index
    epochs = [svc.queue[0].pairs, *svc._pending_arrivals[rid]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = svc.run()[rid]
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches["blocked"] = {
        "pair_scores": ps_ops.pair_scores.launches,
        "pair_scores_compact": ps_ops.pair_scores_compact.launches,
        "union_deduce": ud_ops.union_deduce.launches,
        "union_deduce_wide": ud_ops.union_deduce.wide_launches}
    keys, bits = _union_bits(recorded[id(index)], LARGE_ROWS)
    full = blocking.blocked_candidates(on(ea), on(eb), THRESHOLD, cfg)
    want_keys, want_bits = _union_bits([full], LARGE_ROWS)
    bitwise = np.array_equal(keys, want_keys) and \
        np.array_equal(bits, want_bits)
    truth = np.concatenate([e.truth for e in epochs])
    n_objects = max(e.n_objects for e in epochs)
    widened = [growth(g) for g in grown]
    whole = epochs[0]
    for e in epochs[1:]:
        whole = whole.concat(e)
    right = (np.array_equal(res.labels, truth)
             and transitively_consistent(whole, res.labels))
    print(f"[4j large stream] {first} rows a side, then "
          f"{len(LARGE_STREAM_EPOCHS)} epochs to {LARGE_ROWS} ({n_objects} "
          f"objects), P {len(truth)}: union equal to blocked_candidates bit "
          f"for bit {bitwise} ({len(keys)} candidates); cells scored "
          f"{index.pairs_scored} of {LARGE_ROWS * LARGE_ROWS} dense "
          f"({index.pairs_scored / LARGE_ROWS ** 2:.4f}); lane growth "
          f"{widened}; crowdsourced {res.n_crowdsourced} deduced "
          f"{res.n_deduced} rounds {res.n_rounds}; labels the truth {right};"
          f" launches {launches['blocked']}")
    print(f"[4j large stream] machine phase: submit {epoch_s[0]:.4f} s, "
          f"epochs " + ", ".join(f"{t:.4f}" for t in epoch_s[1:])
          + " s; host LSH (signatures, a side a call: the submit's two "
          "sides, then each epoch's) " + ", ".join(f"{t:.4f}" for t in sig_s)
          + f" s against phase 4g's batch {batch_signatures_s:.4f} s; "
          f"run() wall {run_s:.4f} s")
    if not (bitwise and right) or n_objects <= ud_kernel.MAX_OBJECTS \
            or index.pairs_scored >= LARGE_ROWS * LARGE_ROWS \
            or not any(a == torch.int32 and b == torch.int64
                       for a, b, *_ in grown) \
            or launches["blocked"]["union_deduce_wide"] < 1 \
            or launches["blocked"]["pair_scores_compact"] < 1 \
            or launches["blocked"]["pair_scores"]:
        raise AssertionError(f"4j large stream is wrong: launches "
                             f"{launches['blocked']}, growth {widened}")
    epochs = large_stream_epochs()
    fields = []
    for device in (dev, "cpu"):
        grown.clear()
        wide = ud_ops.union_deduce.wide_launches
        one = join_service.JoinService(lanes=1, device=device)
        rid = one.submit_stream(epochs, PerfectCrowd(), interleave=True)
        t0 = time.perf_counter()
        out = one.run()[rid]
        fields.append(result_fields(out))
        print(f"[4j large pairs] {sum(len(e) for e in epochs)} pairs in "
              f"{len(epochs)} interleaved epochs (universes "
              f"{[e.n_objects for e in epochs]}) on {device}: crowdsourced "
              f"{out.n_crowdsourced} deduced {out.n_deduced} rounds "
              f"{out.n_rounds} in {time.perf_counter() - t0:.4f} s")
        if device == dev:
            wide = ud_ops.union_deduce.wide_launches - wide
            # (keys before, after, universes, real neg keys before)
            widened = [growth(g) for g in grown]
    diff = [k for k in fields[0] if fields[0][k] != fields[1][k]]
    truth = np.concatenate([e.truth for e in epochs])
    live_widening = any(g[:2] == ("int32", "int64") and g[4] > 0
                        for g in widened)
    print(f"[4j large pairs] card vs cpu: {len(fields[0])} fields, "
          f"differing {diff}; lane growth on the card {widened} (keys "
          f"widened with real neg keys in the index {live_widening}); wide "
          f"union_deduce launches {wide}")
    if diff or wide < 1 or not live_widening \
            or max(e.n_objects for e in epochs[:2]) > LARGE_STREAM_FIRST_IDS \
            or not np.array_equal(np.asarray(fields[0]["labels"][1]), truth):
        raise AssertionError(f"4j large pairs: differing {diff}, {wide} "
                             f"wide launches, growth {widened}")
    launches["large_pairs_wide"] = wide
    return {"launches": launches, "walls": walls}


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

    from repro_torch.core.graph import key_sentinel
    from repro_torch.kernels.union_deduce import kernel as ud_kernel
    from repro_torch.kernels.union_deduce.ref import union_deduce_ref

    got = ud_kernel.union_deduce(*args)
    exp = union_deduce_ref(*args)
    same = [torch.equal(x, y) for x, y in zip(got, exp)]
    print(f"[{tag}] {name}: lanes {args[0].shape[0]} n "
          f"{args[0].shape[1]} P {args[1].shape[1]} pos edges "
          f"{int(args[3].sum())} neg keys "
          f"{int((args[4] != key_sentinel(args[4].dtype)).sum())} "
          f"({args[4].dtype}) "
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


def int8_cache(dev, B, S, K, d, length, seed, unit_scales=False):
    """An int8 KV cache and its bf16 scales from ``quantize_kv`` of seeded
    bf16 rows (or small integers under scales of 1), garbage past
    ``length``."""
    import torch

    from repro_torch.models.layers import quantize_kv

    if unit_scales:
        gen = torch.Generator(device=dev).manual_seed(seed)
        vals = torch.randint(-4, 5, (B, S, K, d), generator=gen, device=dev,
                             dtype=torch.int8)
        scales = torch.ones((B, S, K), dtype=torch.bfloat16, device=dev)
    else:
        vals, scales = quantize_kv(_randn(dev, (B, S, K, d), torch.bfloat16,
                                          seed))
    vals[:, length:] = 127
    scales[:, length:] = 1e4
    return vals, scales


def check_decode_int8(dev, B, S, H, K, d, length, q_dtype, seed=0,
                      unit_scales=False):
    """The int8 path of ``decode_attention``'s kernel against its plain
    version (which dequantizes first): the bf16 rule for a bf16 query, the
    f32 one for an f32 query; under scales of 1 (the dequantized cache is
    the integers) against the plain f32 attention within the f32 rule.
    Returns (max |error|, args)."""
    import torch

    from repro_torch.kernels.decode_attention import kernel as da_kernel
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    q = _randn(dev, (B, H, d), q_dtype, seed)
    kc, ks = int8_cache(dev, B, S, K, d, length, seed + 1, unit_scales)
    vc, vs = int8_cache(dev, B, S, K, d, length, seed + 2, unit_scales)
    n = torch.tensor(length, dtype=torch.int32, device=dev)
    got = da_kernel.decode_attention(q, kc, vc, n, ks, vs)
    exp = decode_attention_ref(q, kc.float(), vc.float(), length) \
        if unit_scales else decode_attention_ref(q, kc, vc, length, ks, vs)
    err, ok, tol = attn_error("decode", got, exp)
    print(f"[3 decode_attention int8] q ({B}, {H}, {d}) "
          f"{str(q_dtype).split('.')[-1]} cache ({B}, {S}, {K}, {d}) int8 "
          f"{'scales 1' if unit_scales else 'with bf16 scales'} length "
          f"{length}: max|d| {err:.3e} (tolerance {tol})")
    if not ok:
        raise AssertionError("decode_attention's int8 path disagrees with "
                             "its plain version")
    return err, (q, kc, vc, n, ks, vs)


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
    gap = _decode_gap(model, {"tokens": toks[:, :n]},
                      {"tokens": toks[:, n:n + 1]}, {"tokens": toks})
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


def _timed_generate(engine, reqs, new: int) -> tuple:
    """``engine.generate(reqs)`` of one wave, its prefill synchronized and
    timed apart: (tokens, prefill s, ms a decode step)."""
    import torch

    from repro_torch.models import model as M

    prefill, spent = M.prefill, {}

    def timed_prefill(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = prefill(*args, **kwargs)
        torch.cuda.synchronize()
        spent["prefill_s"] = time.perf_counter() - t0
        return out

    M.prefill = timed_prefill
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = engine.generate(reqs)     # ends in a copy of the tokens
        wall = time.perf_counter() - t0
    finally:
        M.prefill = prefill
    return out, spent["prefill_s"], \
        1e3 * (wall - spent["prefill_s"]) / (new - 1)


def _family_requests(vocab: int, lo_hi, new: int, seed: int) -> list:
    from repro_torch.serve.engine import Request

    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(2, vocab, size=int(
                rng.integers(lo_hi[0], lo_hi[1] + 1))).astype(np.int32),
                max_new_tokens=new) for i in range(LM_LANES)]


def _decode_gap(model, batch_n: dict, nxt: dict, batch_n1: dict) -> float:
    """``prefill(n) + decode_step`` against ``prefill(n + 1)``: the largest
    difference of the last logits over their scale."""
    from repro_torch.models import model as M

    cache, _ = M.prefill(model, batch_n, LM_MAX_LEN)
    l2, _ = M.decode_step(model, cache, nxt)
    _, l3 = M.prefill(model, batch_n1, LM_MAX_LEN)
    return float((l2 - l3).abs().max()) / max(float(l3.abs().max()), 1.0)


def _moe_gap(model, toks) -> list:
    """``prefill(n) + decode_step`` against ``prefill(n + 1)`` under the
    experts, a sequence at a time: (the gap of its last logits over their
    scale, the layers where its last token's picks part between the two
    paths, the prefill path's k-th to (k+1)-th router probability margin,
    relative, at the first of those layers, the largest gap of the last
    token's router inputs over their scale up to that layer (every layer
    where none parts)), from ``moe.route`` recorded on both paths."""
    import torch

    from repro_torch.models import model as M
    from repro_torch.models import moe

    rec, real = [], moe.route

    def spy(xt, router, cfg):
        r = real(xt, router, cfg)
        rec.append((r.expert, torch.softmax((xt @ router).float(), -1),
                    xt))
        return r

    moe.route = spy
    try:
        cache, _ = M.prefill(model, {"tokens": toks[:, :-1]}, LM_MAX_LEN)
        rec.clear()
        l2, _ = M.decode_step(model, cache, {"tokens": toks[:, -1:]})
        dec = list(rec)
        rec.clear()
        _, l3 = M.prefill(model, {"tokens": toks}, LM_MAX_LEN)
        pre = list(rec)
    finally:
        moe.route = real
    B, S = toks.shape
    k = model.cfg.top_k
    out = []
    for b in range(B):
        gap = float((l2[b] - l3[b]).abs().max()) \
            / max(float(l3[b].abs().max()), 1.0)
        parted = [li for li, (d, p) in enumerate(zip(dec, pre))
                  if set(d[0][b].tolist())
                  != set(p[0].view(B, S, k)[b, -1].tolist())]
        margin = None
        if parted:
            probs = pre[parted[0]][1].view(B, S, -1)[b, -1]
            top = torch.sort(probs, descending=True).values
            margin = float((top[k - 1] - top[k]) / top[k - 1])
        upto = parted[0] + 1 if parted else len(dec)
        x_gap = 0.0
        for d, p in zip(dec[:upto], pre[:upto]):
            xd = d[2][b].float()
            xp = p[2].view(B, S, -1)[b, -1].float()
            x_gap = max(x_gap, float((xd - xp).abs().max())
                        / max(float(xp.abs().max()), 1e-6))
        out.append((gap, parted, margin, x_gap))
    return out


def _profile_steps(step, steps: int) -> tuple:
    """(wall ms a step, device busy ms a step, bmm device ms a step, kernel
    launches a step, the six device events of most time as (ms a step,
    launches a step, name)) of ``steps`` calls of ``step``, timed
    unprofiled and then under ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0) / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    on_card, busy, _, launches = profile_counts(prof)
    bmm = sum(getattr(e, "device_time_total", getattr(
        e, "cuda_time_total", 0.0)) for e in prof.key_averages()
        if e.key == "aten::bmm")
    top = [(dev_us(e) / 1e3 / steps, e.count / steps, e.key)
           for e in sorted(on_card, key=dev_us, reverse=True)[:6]]
    return wall, 1e3 * busy / steps, bmm / 1e3 / steps, launches / steps, \
        top


def _attn_counts() -> dict:
    """The attention kernels' launch counts."""
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops

    return {"flash_attention": fa_ops.flash_attention.launches,
            "decode_attention": da_ops.decode_attention.launches,
            "decode_attention_int8": da_ops.decode_attention.int8_launches}


def _zero_attn_counts() -> None:
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops

    fa_ops.flash_attention.launches = 0
    da_ops.decode_attention.launches = 0
    da_ops.decode_attention.int8_launches = 0


def _draw_model(dev, cfg, tag: str):
    """``cfg``'s model at full width from a seeded generator on the card."""
    import torch

    from repro_torch.models import model as M

    t0 = time.perf_counter()
    model = M.init_params(cfg, torch.Generator(device=dev).manual_seed(
        SEED), dev)
    torch.cuda.synchronize()
    heads = (f"{cfg.n_heads} heads / {cfg.n_kv_heads} kv heads of {cfg.hd}"
             if cfg.n_heads else "attention-free")
    print(f"[{tag} model] {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {heads}, vocab {cfg.vocab}, {M.n_params(cfg)} "
          f"bf16 parameters ({M.n_active_params(cfg)} active a token), "
          f"drawn in {time.perf_counter() - t0:.3f} s")
    return model


def _warm_engine(engine, vocab: int, rng) -> None:
    """Two short requests through ``engine``, synchronized."""
    import torch

    from repro_torch.serve.engine import Request

    engine.generate([Request(rid=i, prompt=rng.integers(
        2, vocab, 64).astype(np.int32), max_new_tokens=4) for i in range(2)])
    torch.cuda.synchronize()


def lm_families_path(dev) -> dict:
    """Phase 4n: the LM stack's families at full width, each model drawn on
    the card from a seeded generator and freed before the next.  Every
    kernel count is zeroed just before a path and read just after it.
    (a) ``internlm2-1.8b`` under ``kv_quant``: ``ServeEngine.generate`` of
    8 requests of ``LM_PROMPT`` tokens, ``FAM_KV_NEW`` new, against the
    same weights over the bf16 cache; the int8 decode kernel must launch
    once a layer a decode step and the bf16 one never; ms a step, cache
    bytes, the first step where the two runs' greedy tokens part, the int8
    step's logits within 0.08 of the bf16 step's scale.  (b)
    ``qwen2-vl-2b`` and (c) ``musicgen-medium``: ``prefill`` of 8
    sequences of ``configs/shapes.py``'s ``dummy_batch`` (the stub's prefix
    embeddings and image-grid positions, then a ``FAM_TEXT`` draw of text
    tokens), then
    ``FAM_DECODE`` greedy ``decode_step``s (under M-RoPE with their
    ``positions3``), launches exact, ``decode == prefill(n + 1)`` within
    ``LM_BF16_TOL``.  (d) ``olmoe-1b-7b``: ``ServeEngine.generate`` of 8
    requests of ``FAM_MOE_PROMPT`` tokens, ``FAM_MOE_NEW`` new; a profiled
    window of decode steps (busy share, the experts' ``bmm`` share of
    device time); ``decode == prefill(n + 1)`` at ``capacity_factor`` 8 on
    the 8 sequences: within ``LM_BF16_TOL`` where the last token's expert
    picks agree in every layer (at least one sequence must), and where
    they part, first at a near tie (``FAM_MOE_TIE``)."""
    import torch

    from repro_torch.configs import get
    from repro_torch.configs.shapes import dummy_batch
    from repro_torch.models import model as M
    from repro_torch.serve.engine import ServeEngine

    counts, zero = _attn_counts, _zero_attn_counts

    def draw(cfg):
        return _draw_model(dev, cfg, "4n")

    out: dict = {"launches": {}}
    warm_rng = np.random.default_rng(SEED + 7)

    def warm(engine, vocab):
        _warm_engine(engine, vocab, warm_rng)

    # -- (a) the int8 KV cache ----------------------------------------------
    cfg = get(FAM_KV_ARCH).replace(kv_quant=True)
    model = draw(cfg)
    bf16 = M.Model(cfg.replace(kv_quant=False), dict(model.named_leaves()))
    reqs = _family_requests(cfg.vocab, LM_PROMPT, FAM_KV_NEW, SEED + 11)
    runs = {}
    for tag, m in (("int8", model), ("bf16", bf16)):
        engine = ServeEngine(m.cfg, m, batch_lanes=LM_LANES,
                             max_len=LM_MAX_LEN)
        warm(engine, cfg.vocab)
        zero()
        toks, pre_s, step_ms = _timed_generate(engine, reqs, FAM_KV_NEW)
        runs[tag] = (toks, pre_s, step_ms, counts())
    S = max(len(r.prompt) for r in reqs)
    n_pos = cfg.n_layers * LM_LANES * LM_MAX_LEN * cfg.n_kv_heads
    bytes_q = 2 * n_pos * (cfg.hd + 2)
    bytes_bf = 2 * n_pos * cfg.hd * 2
    parted = {}
    for r in reqs:
        a, b = runs["int8"][0][r.rid], runs["bf16"][0][r.rid]
        parted[r.rid] = next((i for i in range(len(a)) if a[i] != b[i]),
                             None)
    want_q = {"flash_attention": cfg.n_layers, "decode_attention": 0,
              "decode_attention_int8": cfg.n_layers * (FAM_KV_NEW - 1)}
    want_bf = {"flash_attention": cfg.n_layers,
               "decode_attention": cfg.n_layers * (FAM_KV_NEW - 1),
               "decode_attention_int8": 0}
    toks2 = torch.from_numpy(np.stack([r.prompt[:LM_PROMPT[0]]
                                       for r in reqs[:2]])).to(dev)
    logits = {}
    for tag, m in (("int8", model), ("bf16", bf16)):
        cache, _ = M.prefill(m, {"tokens": toks2[:, :-1]}, LM_MAX_LEN)
        logits[tag], _ = M.decode_step(m, cache, {"tokens": toks2[:, -1:]})
    gap = float((logits["int8"] - logits["bf16"]).abs().max()) \
        / max(float(logits["bf16"].abs().max()), 1e-6)
    print(f"[4n a] {cfg.name} kv_quant, {LM_LANES} requests of "
          f"{LM_PROMPT[0]}-{LM_PROMPT[1]} tokens (longest {S}), "
          f"{FAM_KV_NEW} new: int8 cache prefill {runs['int8'][1]:.4f} s, "
          f"decode {runs['int8'][2]:.4f} ms a step; bf16 cache prefill "
          f"{runs['bf16'][1]:.4f} s, decode {runs['bf16'][2]:.4f} ms a step;"
          f" cache bytes int8 + scales {bytes_q} against bf16 {bytes_bf} "
          f"({bytes_q / bytes_bf:.4f}); launches int8 run {runs['int8'][3]}"
          f", bf16 run {runs['bf16'][3]}")
    print(f"[4n a] greedy tokens int8 against bf16: first step where they "
          f"part, by request: {parted}; one decode step's logits over "
          f"{LM_PROMPT[0] - 1} tokens: max|d| {gap:.3e} of the bf16 scale "
          f"(tolerance {FAM_KV_TOL})")
    if runs["int8"][3] != want_q or runs["bf16"][3] != want_bf \
            or any(len(t) != FAM_KV_NEW for t in runs["int8"][0].values()):
        raise AssertionError(f"phase 4n a: launches {runs['int8'][3]} / "
                             f"{runs['bf16'][3]}, expected {want_q} / "
                             f"{want_bf}")
    if not gap <= FAM_KV_TOL:
        raise AssertionError("phase 4n a: the int8 cache's logits are not "
                             "within 0.08 of the bf16 cache's")
    out["kv"] = {"step_ms": runs["int8"][2], "bf16_step_ms": runs["bf16"][2],
                 "bytes": bytes_q, "bf16_bytes": bytes_bf, "gap": gap,
                 "parted": parted}
    out["launches"]["kv_quant"] = runs["int8"][3]
    out["launches"]["kv_bf16"] = runs["bf16"][3]
    del model, bf16, engine, logits
    torch.cuda.empty_cache()

    # -- (b), (c) the prefix families ---------------------------------------
    for tag, arch in zip("bc", FAM_PREFIX_ARCHS):
        cfg = get(arch)
        model = draw(cfg)
        n_prefix = cfg.n_patch_tokens + cfg.n_cond_tokens
        n_text = int(np.random.default_rng(SEED + 12).integers(
            FAM_TEXT[0], FAM_TEXT[1] + 1))
        S = n_prefix + n_text
        # the stubs' prefix embeddings and image-grid positions, over the
        # decode steps too
        full = dummy_batch(cfg, S + FAM_DECODE, LM_LANES, "prefill",
                           torch.Generator(device=dev).manual_seed(SEED + 13))

        def cut(n, B=LM_LANES):
            b = {"tokens": full["tokens"][:B, :n - n_prefix],
                 "prefix_embeds": full["prefix_embeds"][:B]}
            if cfg.mrope:
                b["positions3"] = full["positions3"][:B, :n]
            return b

        M.prefill(model, cut(n_prefix + 64, 2), LM_MAX_LEN)    # warm-up
        torch.cuda.synchronize()
        zero()
        t0 = time.perf_counter()
        cache, logits = M.prefill(model, cut(S), LM_MAX_LEN)
        torch.cuda.synchronize()
        pre_s = time.perf_counter() - t0
        cur = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        t0 = time.perf_counter()
        for i in range(FAM_DECODE):
            step = {"tokens": cur[:, None]}
            if cfg.mrope:
                step["positions3"] = full["positions3"][:, S + i:S + i + 1]
            logits, cache = M.decode_step(model, cache, step)
            cur = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0) / FAM_DECODE
        got = counts()
        want = {"flash_attention": cfg.n_layers,
                "decode_attention": cfg.n_layers * FAM_DECODE,
                "decode_attention_int8": 0}
        ok = bool(torch.isfinite(logits).all()) \
            and int(cache["length"]) == S + FAM_DECODE
        # decode == prefill(n + 1) on two of the sequences
        nxt = {"tokens": full["tokens"][:2, n_text - 1:n_text]}
        if cfg.mrope:
            nxt["positions3"] = full["positions3"][:2, S - 1:S]
        gap = _decode_gap(model, cut(S - 1, 2), nxt, cut(S, 2))
        print(f"[4n {tag}] {arch}: prefill of {LM_LANES} x ({n_prefix} "
              f"prefix + {n_text} text) = {S} positions {pre_s:.4f} s, "
              f"{FAM_DECODE} decode steps {step_ms:.4f} ms a step; "
              f"launches {got}; decode == prefill(n+1): max|d logits| "
              f"{gap:.3e} of their scale (tolerance {LM_BF16_TOL})")
        if got != want or not ok:
            raise AssertionError(f"phase 4n {tag}: launches {got}, expected "
                                 f"{want}; finite and long enough {ok}")
        if not gap <= LM_BF16_TOL:
            raise AssertionError(f"phase 4n {tag}: decode_step disagrees "
                                 f"with prefill")
        out[arch] = {"prefill_s": pre_s, "step_ms": step_ms, "gap": gap,
                     "S": S}
        out["launches"][arch] = got
        del model, cache, logits, full
        torch.cuda.empty_cache()

    # -- (d) the experts on one device --------------------------------------
    cfg = get(FAM_MOE_ARCH)
    model = draw(cfg)
    reqs = _family_requests(cfg.vocab, FAM_MOE_PROMPT, FAM_MOE_NEW,
                            SEED + 14)
    engine = ServeEngine(cfg, model, batch_lanes=LM_LANES,
                         max_len=LM_MAX_LEN)
    warm(engine, cfg.vocab)
    zero()
    toks, pre_s, step_ms = _timed_generate(engine, reqs, FAM_MOE_NEW)
    got = counts()
    want = {"flash_attention": cfg.n_layers,
            "decode_attention": cfg.n_layers * (FAM_MOE_NEW - 1),
            "decode_attention_int8": 0}
    S = max(len(r.prompt) for r in reqs)
    wave = np.zeros((LM_LANES, S), np.int32)
    for j, r in enumerate(reqs):
        wave[j, S - len(r.prompt):] = r.prompt
    cache, logits = M.prefill(model, {"tokens": torch.from_numpy(wave).to(
        dev)}, LM_MAX_LEN)
    cur = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)

    def step():
        nonlocal cache, cur
        logits, cache = M.decode_step(model, cache, {"tokens": cur[:, None]})
        cur = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)

    wall, busy, bmm, launches, _ = _profile_steps(step, FAM_PROFILE_STEPS)
    del cache
    expert_bytes = 3 * cfg.n_layers * cfg.n_experts * cfg.d_model \
        * cfg.d_ff * 2
    print(f"[4n d] {cfg.name}: {LM_LANES} requests of {FAM_MOE_PROMPT[0]}-"
          f"{FAM_MOE_PROMPT[1]} tokens (longest {S}), {FAM_MOE_NEW} new: "
          f"prefill {pre_s:.4f} s, decode {step_ms:.4f} ms a step; launches "
          f"{got}; profiled window of {FAM_PROFILE_STEPS} steps: wall "
          f"{wall:.4f} ms a step, device busy {busy:.4f} ms (busy share "
          f"{busy / wall:.4f}), the experts' bmm {bmm:.4f} ms "
          f"({bmm / max(busy, 1e-9):.4f} of busy), {launches:.1f} launches "
          f"a step; every expert's weights"
          f" read a step: {expert_bytes} bytes, "
          f"{1e3 * expert_bytes / PEAK_BYTES_PER_S:.4f} ms at the HBM peak")
    if got != want or any(len(t) != FAM_MOE_NEW for t in toks.values()):
        raise AssertionError(f"phase 4n d: launches {got}, expected {want}")
    moe8 = M.Model(cfg.replace(capacity_factor=FAM_MOE_CF),
                   dict(model.named_leaves()))
    n = FAM_MOE_PROMPT[0]
    seqs = _moe_gap(moe8, torch.from_numpy(np.stack(
        [r.prompt[:n] for r in reqs])).to(dev))
    agree = [g for g, parted, _, _ in seqs if not parted]
    ties = [m for _, parted, m, _ in seqs if parted]
    gap = max(agree) if agree else float("nan")
    print(f"[4n d] decode == prefill(n+1) at capacity_factor {FAM_MOE_CF}, "
          f"n {n - 1}, {len(seqs)} sequences: (max|d logits| of their scale,"
          f" layers where the last token's picks part, the first such "
          f"layer's 8th-to-9th router probability margin) "
          + ", ".join(f"({g:.3e}, {p}, "
                      f"{'-' if m is None else f'{m:.3e}'})"
                      for g, p, m, _ in seqs)
          + f"; where every pick agrees at most {gap:.3e} (tolerance "
          f"{LM_BF16_TOL}), first partings at margins up to "
          f"{max(ties, default=0.0):.3e} (tolerance {FAM_MOE_TIE:.4f})")
    if not agree or not gap <= LM_BF16_TOL \
            or not all(m <= FAM_MOE_TIE for m in ties):
        raise AssertionError("phase 4n d: decode_step disagrees with "
                             "prefill under the experts")
    out["moe"] = {"prefill_s": pre_s, "step_ms": step_ms, "busy_ms": busy,
                  "wall_ms": wall, "bmm_ms": bmm, "gap": gap}
    out["launches"]["moe"] = got
    del model, moe8, engine
    torch.cuda.empty_cache()
    return out


def ssm_families_path(dev) -> dict:
    """Phase 4o: the SSM and hybrid families at full width, each model
    drawn on the card from a seeded generator and freed before the next.
    Every kernel count is zeroed just before a path and read just after.
    (a) ``rwkv6-3b`` and (b) ``zamba2-1.2b``: ``ServeEngine.generate`` of 8
    requests of ``SSM_PROMPT`` tokens, ``SSM_NEW`` new; prefill s, ms a
    decode step, a profiled window of decode steps (busy share, launches,
    time by kernel), the state's bytes; RWKV launches no attention kernel,
    zamba2 the flash kernel once an invocation for the wave's prefill and
    the decode kernel once an invocation a step; zamba2's SSD chunk length
    and chunk count for the wave; the flash and decode kernels against
    their plain versions at the wave's shapes; ``decode == prefill(n +
    1)`` on the 8 sequences.  (c) ``long_500k``: each family's cache at
    524288 positions and batch 1 filled from a seeded draw, ``length`` at
    524288 - ``SSM_LONG_STEPS``, that many decode steps timed (zamba2: the
    decode kernel once an invocation a step; the bytes a step reads
    against the HBM peak); RWKV's cache bytes the same at every
    ``max_len``; the decode kernel against ``decode_attention_ref`` at
    zamba2's shape there (``check_decode``), timed beside its bound, its
    plain version and SDPA."""
    import torch

    from repro_torch.configs import get
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.kernels.decode_attention import kernel as da_kernel
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.models import model as M
    from repro_torch.models.ssm import ssd_chunk
    from repro_torch.serve.engine import ServeEngine

    out: dict = {"launches": {}}
    warm_rng = np.random.default_rng(SEED + 8)
    gen = torch.Generator(device=dev).manual_seed(SEED + 23)
    long = SHAPES[SSM_LONG_SHAPE]
    L_long, B_long = long.seq_len, long.global_batch

    def nbytes(cache, names=None) -> int:
        return sum(t.numel() * t.element_size() for n, t in cache.items()
                   if n != "length" and (names is None or n in names))

    def serve(cfg, model, seed):
        """The engine's run with its launches, a profiled window of decode
        steps over the same wave, and the decode-against-prefill gap."""
        reqs = _family_requests(cfg.vocab, SSM_PROMPT, SSM_NEW, seed)
        engine = ServeEngine(cfg, model, batch_lanes=LM_LANES,
                             max_len=LM_MAX_LEN)
        _warm_engine(engine, cfg.vocab, warm_rng)
        _zero_attn_counts()
        toks, pre_s, step_ms = _timed_generate(engine, reqs, SSM_NEW)
        got = _attn_counts()
        if any(len(t) != SSM_NEW for t in toks.values()):
            raise AssertionError(f"phase 4o: {cfg.name} served "
                                 f"{[len(t) for t in toks.values()]} tokens")
        S = max(len(r.prompt) for r in reqs)
        wave = np.zeros((len(reqs), S), np.int32)
        for j, r in enumerate(reqs):
            wave[j, S - len(r.prompt):] = r.prompt
        cache, logits = M.prefill(model, {"tokens": torch.from_numpy(
            wave).to(dev)}, LM_MAX_LEN)
        cur = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)

        def step():
            nonlocal cache, cur
            logits, cache = M.decode_step(model, cache,
                                          {"tokens": cur[:, None]})
            cur = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)

        prof = _profile_steps(step, FAM_PROFILE_STEPS)
        del cache
        n = SSM_PROMPT[0]
        seqs = torch.from_numpy(np.stack([r.prompt[:n] for r in reqs])).to(
            dev)
        gap = _decode_gap(model, {"tokens": seqs[:, :-1]},
                          {"tokens": seqs[:, -1:]}, {"tokens": seqs})
        return S, got, pre_s, step_ms, prof, gap

    def window(prof) -> str:
        wall, busy, _, launches, top = prof
        return (f"profiled window of {FAM_PROFILE_STEPS} steps: wall "
                f"{wall:.4f} ms a step, device busy {busy:.4f} ms (busy "
                f"share {busy / wall:.4f}), {launches:.1f} launches a step; "
                f"by kernel (ms a step, launches a step): " + "; ".join(
                    f"{ms:.4f} x{k:.0f} {name[:50]}" for ms, k, name in top))

    def long_decode(model, cache, vocab):
        """``SSM_LONG_STEPS`` timed decode steps after one untimed, from
        ``length`` 524288 - ``SSM_LONG_STEPS`` - 1: (ms a step, launches,
        finite and at the last position)."""
        cache["length"].fill_(L_long - SSM_LONG_STEPS - 1)
        cur = torch.randint(2, vocab, (B_long,), generator=gen, device=dev,
                            dtype=torch.int32)
        logits, cache = M.decode_step(model, cache, {"tokens": cur[:, None]})
        cur = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        torch.cuda.synchronize()
        _zero_attn_counts()
        t0 = time.perf_counter()
        for _ in range(SSM_LONG_STEPS):
            logits, cache = M.decode_step(model, cache,
                                          {"tokens": cur[:, None]})
            cur = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / SSM_LONG_STEPS
        got = _attn_counts()
        ok = bool(torch.isfinite(logits).all()) \
            and int(cache["length"]) == L_long
        return ms, got, ok

    # -- (a) RWKV6, attention-free ------------------------------------------
    cfg = get(SSM_RWKV_ARCH)
    model = _draw_model(dev, cfg, "4o")
    S, got, pre_s, step_ms, prof, gap = serve(cfg, model, SEED + 21)
    lane = M.make_cache(cfg, 1, LM_MAX_LEN, dev)
    wkv_bytes, shift_bytes = nbytes(lane, ("wkv",)), \
        nbytes(lane, ("tm_x", "cm_x"))
    del lane
    want = {"flash_attention": 0, "decode_attention": 0,
            "decode_attention_int8": 0}
    print(f"[4o a] {cfg.name}: {LM_LANES} requests of {SSM_PROMPT[0]}-"
          f"{SSM_PROMPT[1]} tokens (longest {S}), {SSM_NEW} new: prefill "
          f"{pre_s:.4f} s, decode {step_ms:.4f} ms a step; launches {got}; "
          f"state a lane: wkv {wkv_bytes} bytes, token shifts {shift_bytes} "
          f"bytes; " + window(prof))
    print(f"[4o a] decode == prefill(n+1) on {LM_LANES} sequences, n "
          f"{SSM_PROMPT[0] - 1}: max|d logits| {gap:.3e} of their scale "
          f"(tolerance {LM_BF16_TOL})")
    if got != want:
        raise AssertionError(f"phase 4o a: launches {got}, expected {want}")
    if not gap <= LM_BF16_TOL:
        raise AssertionError("phase 4o a: decode_step disagrees with prefill")
    out["rwkv"] = {"prefill_s": pre_s, "step_ms": step_ms, "gap": gap,
                   "wall_ms": prof[0], "busy_ms": prof[1],
                   "launches_a_step": prof[3], "wkv_bytes_a_lane": wkv_bytes}
    out["launches"]["rwkv"] = got

    # -- (c) RWKV6 at long_500k ----------------------------------------------
    small = nbytes(M.make_cache(cfg, B_long, LM_MAX_LEN, dev))
    cache = M.make_cache(cfg, B_long, L_long, dev)
    big = nbytes(cache)
    for name in ("wkv", "tm_x", "cm_x"):
        cache[name].normal_(generator=gen)
    ms, got, ok = long_decode(model, cache, cfg.vocab)
    print(f"[4o c] {cfg.name} at {SSM_LONG_SHAPE} ({L_long} positions, "
          f"batch {B_long}): cache bytes {big} at max_len {L_long}, {small} "
          f"at {LM_MAX_LEN}; {SSM_LONG_STEPS} decode steps from a seeded "
          f"state {ms:.4f} ms a step, launches {got}, finite at position "
          f"{L_long - 1} {ok}")
    if big != small or got != want or not ok:
        raise AssertionError(f"phase 4o c: {cfg.name}'s cache {big} / "
                             f"{small} bytes, launches {got}, ok {ok}")
    out["rwkv_long"] = {"step_ms": ms, "cache_bytes": big}
    out["launches"]["rwkv_long"] = got
    del model, cache
    torch.cuda.empty_cache()

    # -- (b) zamba2: Mamba2 and the shared attention block -------------------
    cfg = get(SSM_HYBRID_ARCH)
    model = _draw_model(dev, cfg, "4o")
    n_inv = cfg.n_shared_attn
    S, got, pre_s, step_ms, prof, gap = serve(cfg, model, SEED + 22)
    Q = ssd_chunk(S, cfg.ssm_chunk)
    lanes = M.make_cache(cfg, LM_LANES, LM_MAX_LEN, dev)
    kv_bytes, ssm_lane = nbytes(lanes, ("k", "v")), \
        nbytes(lanes, ("ssm",)) // LM_LANES
    del lanes
    want = {"flash_attention": n_inv,
            "decode_attention": n_inv * (SSM_NEW - 1),
            "decode_attention_int8": 0}
    print(f"[4o b] {cfg.name}: {LM_LANES} requests of {SSM_PROMPT[0]}-"
          f"{SSM_PROMPT[1]} tokens (longest {S}: SSD chunk {Q}, {S // Q} "
          f"chunks), {SSM_NEW} new: prefill {pre_s:.4f} s, decode "
          f"{step_ms:.4f} ms a step; launches {got}; KV cache {kv_bytes} "
          f"bytes at max_len {LM_MAX_LEN}, SSM state {ssm_lane} bytes a "
          f"lane; " + window(prof))
    n = SSM_PROMPT[0]
    print(f"[4o b] decode == prefill(n+1) on {LM_LANES} sequences, n "
          f"{n - 1} (SSD chunk {ssd_chunk(n - 1, cfg.ssm_chunk)}, prefill(n "
          f"+ 1)'s {ssd_chunk(n, cfg.ssm_chunk)}): max|d logits| {gap:.3e} "
          f"of their scale (tolerance {SSM_HYBRID_TOL})")
    if got != want:
        raise AssertionError(f"phase 4o b: launches {got}, expected {want}")
    if not gap <= SSM_HYBRID_TOL:
        raise AssertionError("phase 4o b: decode_step disagrees with prefill")
    # the two kernels at the wave's shapes
    fa_err, _ = check_flash(dev, LM_LANES, S, cfg.n_heads, cfg.n_kv_heads,
                            cfg.hd, torch.bfloat16)
    da_err, _ = check_decode(dev, LM_LANES, LM_MAX_LEN, cfg.n_heads,
                             cfg.n_kv_heads, cfg.hd, S + SSM_NEW - 1,
                             torch.bfloat16, torch.bfloat16)
    out["hybrid"] = {"prefill_s": pre_s, "step_ms": step_ms, "gap": gap,
                     "S": S, "chunk": Q, "wall_ms": prof[0],
                     "busy_ms": prof[1], "launches_a_step": prof[3],
                     "kv_bytes": kv_bytes, "ssm_bytes_a_lane": ssm_lane,
                     "flash_err": fa_err, "decode_err": da_err}
    out["launches"]["hybrid"] = got

    # -- (c) zamba2 at long_500k ---------------------------------------------
    cache = M.make_cache(cfg, B_long, L_long, dev)
    kv_long = nbytes(cache, ("k", "v"))
    for name in ("k", "v"):
        for j in range(n_inv):
            cache[name][j].normal_(generator=gen)
    for name in ("ssm", "conv"):
        cache[name].normal_(generator=gen)
    ms, got, ok = long_decode(model, cache, cfg.vocab)
    want = {"flash_attention": 0, "decode_attention": n_inv * SSM_LONG_STEPS,
            "decode_attention_int8": 0}
    # a step reads the K/V up to its length, every parameter and the SSM
    # and conv states (and writes the states back)
    mean_len = L_long - SSM_LONG_STEPS + (SSM_LONG_STEPS + 1) / 2
    step_bytes = int(kv_long / L_long * mean_len) + 2 * M.n_params(cfg) \
        + 2 * nbytes(cache, ("ssm", "conv"))
    print(f"[4o c] {cfg.name} at {SSM_LONG_SHAPE} ({L_long} positions, "
          f"batch {B_long}): K/V {kv_long} bytes; {SSM_LONG_STEPS} decode "
          f"steps from a seeded cache {ms:.4f} ms a step, launches {got}, "
          f"finite at position {L_long - 1} {ok}; a step reads {step_bytes} "
          f"bytes, {1e3 * step_bytes / PEAK_BYTES_PER_S:.4f} ms at the HBM "
          f"peak ({1e3 * step_bytes / PEAK_BYTES_PER_S / ms:.4f} of the "
          f"step)")
    if got != want or not ok:
        raise AssertionError(f"phase 4o c: {cfg.name} launches {got}, "
                             f"expected {want}; finite {ok}")
    out["hybrid_long"] = {"step_ms": ms, "kv_bytes": kv_long,
                          "step_bytes": step_bytes}
    out["launches"]["hybrid_long"] = got
    del model, cache
    torch.cuda.empty_cache()

    # the decode kernel alone at long_500k against its plain version
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    length = L_long - SSM_LONG_STEPS
    err, (q, kc, vc, n) = check_decode(dev, B_long, L_long, H, K, hd, length,
                                       torch.bfloat16, torch.bfloat16)
    splits, chunk = da_kernel.split_plan(q, kc)
    nbytes_long = 2 * B_long * length * K * hd * kc.element_size() \
        + 2 * q.numel() * q.element_size()
    flops = 4 * B_long * H * hd * length
    t_bytes, t_ops = nbytes_long / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS
    mask = (torch.arange(L_long, device=dev) < length)[None, None, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out["decode_long"] = {
        "shape": [B_long, L_long, H, K, hd], "length": length,
        "splits": splits, "chunk": chunk, "max_abs_err": err,
        "ms": cuda_ms(lambda: da_kernel.decode_attention(q, kc, vc, n), 10),
        "plain_ms": cuda_ms(lambda: decode_attention_ref(q, kc, vc, n), 3),
        "bound_ms": 1e3 * max(t_bytes, t_ops),
        "bound_by": "operations" if t_ops > t_bytes else "bytes",
        "library_ms": cuda_ms(lambda: sdpa(
            q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2),
            attn_mask=mask, enable_gqa=True), 3)}
    d = out["decode_long"]
    print(f"[4o c] decode_attention at ({B_long}, {L_long}, {H} / {K}, "
          f"{hd}) bf16, length {length}: {splits} splits of {chunk} "
          f"positions; {d['ms']:.4f} ms against a bound of "
          f"{d['bound_ms']:.4f} ({d['bound_by']}), plain {d['plain_ms']:.4f}"
          f", SDPA {d['library_ms']:.4f}")
    del q, kc, vc
    torch.cuda.empty_cache()
    return out


def _whole_leaf_draw(cfg, generator, dev) -> dict:
    """``init_params``' draw as it was before a leaf could be drawn in
    slices: each leaf one f32 draw on the generator's device, scaled and
    cast (the plain version the card's draw of an unsliced config is held
    to, leaf for leaf)."""
    import math

    import torch

    from repro_torch.models import model as M

    flat = {}
    for path, spec in sorted(M.model_specs(cfg).items()):
        special = M._special_init(path, spec, generator)
        if special is not None:
            flat[path] = special.to(device=dev, dtype=spec.dtype)
        elif spec.fan_in == 0:
            flat[path] = torch.zeros(spec.shape, dtype=spec.dtype, device=dev)
        else:
            w = torch.randn(spec.shape, generator=generator,
                            dtype=torch.float32, device=generator.device)
            w *= 1.0 / math.sqrt(max(spec.fan_in, 1))
            flat[path] = w.to(device=dev, dtype=spec.dtype)
    return flat


def check_flash_tail(dev, B, S, H, K, d, rows, seed=0) -> float:
    """The bf16 flash kernel at (B, S, H / K, d) against the plain f32
    causal attention of its last ``rows`` query rows (over every key
    before them): the plain version of the whole S would not fit.  Returns
    max |error|."""
    import torch

    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.models.layers import _attention_chunk

    q = _randn(dev, (B, S, H, d), torch.bfloat16, seed)
    k = _randn(dev, (B, S, K, d), torch.bfloat16, seed + 1)
    v = _randn(dev, (B, S, K, d), torch.bfloat16, seed + 2)
    got = fa_kernel.flash_attention(q, k, v)[:, S - rows:]
    exp = _attention_chunk(q[:, S - rows:].float(), k.float(), v.float(),
                           S - rows).to(torch.bfloat16)
    err, ok, tol = attn_error("flash", got, exp)
    print(f"[4p flash_attention] q ({B}, {S}, {H}, {d}) kv heads {K} "
          f"bfloat16, its last {rows} rows against the plain f32 attention"
          f" of those rows: max|d| {err:.3e} (tolerance {tol})")
    if not ok:
        raise AssertionError("flash_attention kernel disagrees with the "
                             "plain attention of its last rows")
    return err


def _digest(*values) -> str:
    """sha256 of numpy arrays' bytes and dtypes and of other values' reprs:
    equal digests, equal values."""
    import hashlib

    h = hashlib.sha256()
    for v in values:
        if isinstance(v, np.ndarray):
            h.update(str(v.dtype).encode() + v.tobytes())
        else:
            h.update(repr(v).encode())
    return h.hexdigest()


def _pair_view(fields: dict, u, v) -> tuple:
    """A session's result as (scalar fields, {(u, v): (label,
    crowdsourced)}): comparable across candidate orders."""
    per_pair = {(int(a), int(b)): (bool(l), bool(c)) for a, b, l, c in zip(
        u, v, fields["labels"][1], fields["crowdsourced"][1])}
    return {k: x for k, x in fields.items()
            if k not in ("labels", "crowdsourced")}, per_pair


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def mesh_a2a_config():
    """The a2a layer's config: the arch at full width, at the reference
    test's capacity factor."""
    from repro_torch.configs import get

    return get(MESH_A2A_ARCH).replace(capacity_factor=MESH_A2A_CF,
                                      moe_impl="a2a")


def mesh_rank(mesh, corpora, cfg, tokens) -> dict:
    """Phase 4q in one rank of the mesh (``spawn``'s body): (a) the four
    corpora through ``sharded_candidates``, (b) corpus 0 served, (c) the
    a2a expert layer; its launch counts read in the rank, every rank's
    digests gathered, rank 0's values returned."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.crowd import PerfectCrowd
    from repro_torch.kernels.pair_scores import ops as ps_ops
    from repro_torch.kernels.pair_scores.sharded import sharded_candidates
    from repro_torch.kernels.union_deduce import ops as ud_ops
    from repro_torch.launch.mesh import all_gather
    from repro_torch.models.moe import moe_block, route
    from repro_torch.models.moe_a2a import a2a_capacity, moe_block_a2a
    from repro_torch.serve.join_service import JoinService

    dev = mesh.device
    out = {"rank": mesh.rank, "coordinate": mesh.coordinate,
           "device": str(dev), "mesh": repr(mesh)}
    tables = [(torch.from_numpy(ea).to(dev), torch.from_numpy(eb).to(dev))
              for _, ea, _, eb in corpora]
    _sync(dev)

    # (a) the machine phase on the mesh
    ps_ops.pair_scores.launches = 0
    t0 = time.perf_counter()
    cands = [sharded_candidates(a, b, THRESHOLD, mesh) for a, b in tables]
    out["a_s"] = time.perf_counter() - t0
    out["a_launches"] = ps_ops.pair_scores.launches
    out["cands"] = [(c.rows, c.cols, c.scores, c.n_dropped, c.capacity)
                    for c in cands]
    out["a_digest"] = _digest(*[x for c in out["cands"] for x in c])
    buf = torch.zeros(3 * cands[0].capacity + 1, dtype=torch.int32,
                      device=dev)
    all_gather(buf, mesh)
    _sync(dev)
    dist.barrier()
    t0 = time.perf_counter()
    all_gather(buf, mesh)
    _sync(dev)
    out["gather_ms"] = 1e3 * (time.perf_counter() - t0)
    out["gather_bytes"] = mesh.size * buf.numel() * buf.element_size()
    del buf

    # (b) corpus 0 served on the mesh, then run in the rank
    ids_a, _, ids_b, _ = corpora[0]
    ps_ops.pair_scores.launches = 0
    ud_ops.union_deduce.launches = 0
    t0 = time.perf_counter()
    svc = JoinService(lanes=1, device=dev)
    rid = svc.submit_embeddings(
        *tables[0], THRESHOLD, mesh, crowd=PerfectCrowd(),
        truth_fn=lambda r, c: ids_a[r] == ids_b[c],
        total_true_matches=int((ids_a[:, None] == ids_b[None, :]).sum()))
    pairs = svc.queue[-1].pairs
    out["b_pairs"] = (pairs.u, pairs.v)
    out["b_fields"] = result_fields(svc.run()[rid])
    out["b_s"] = time.perf_counter() - t0
    out["b_launches"] = {"pair_scores": ps_ops.pair_scores.launches,
                         "union_deduce": ud_ops.union_deduce.launches}
    out["b_digest"] = _digest(pairs.u, pairs.v,
                              sorted(out["b_fields"].items()))
    del svc, tables

    # (c) the all-to-all experts
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def draw(shape, fan_in):
        return (torch.randn(shape, generator=gen, device=dev)
                / math.sqrt(fan_in)).to(torch.bfloat16)

    p = {"router": draw((d, E), d), "wi_gate": draw((E, d, f), d),
         "wi_up": draw((E, d, f), d), "wo": draw((E, f, d), f)}
    B, S = tokens
    x = (0.5 * torch.randn((B, S, d), generator=gen, device=dev)).to(
        torch.bfloat16)
    moe_block_a2a(x, p, cfg, mesh)
    _sync(dev)
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        moe_block_a2a(x, p, cfg, mesh)
        _sync(dev)
        times.append(1e3 * (time.perf_counter() - t0))
    out["c_ms"] = times
    cap = a2a_capacity(cfg, B * S // mesh.size)
    out["c_cap"] = cap
    out["c_exchange_bytes"] = E * cap * d * x.element_size()
    xg = x.clone().requires_grad_()
    y, aux = moe_block_a2a(xg, p, cfg, mesh)
    y.float().sum().backward()
    aux = float(aux.detach())
    out["c_digest"] = _digest(y.detach().float().cpu().numpy(),
                              xg.grad.float().cpu().numpy(), aux)
    if mesh.rank == 0:
        # the aux loss: every rank's router estimate over its own tokens,
        # averaged over the mesh, computed here on one device
        xt = x.reshape(B * S, d)
        t_my = B * S // mesh.size
        plain_aux = torch.stack([
            route(xt[r * t_my:(r + 1) * t_my], p["router"], cfg).aux
            for r in range(mesh.size)]).mean()
        out["c_aux"] = (aux, float(plain_aux))
        x1 = x.clone().requires_grad_()
        y1, _ = moe_block(x1, p, cfg)
        y1.float().sum().backward()
        out["c_err"] = (float((y.detach().float() - y1.detach().float())
                              .abs().max()),
                        float((xg.grad.float() - x1.grad.float())
                              .abs().max()))
        out["c_scale"] = (float(y1.detach().float().abs().max()),
                          float(x1.grad.float().abs().max()))
    every = [None] * mesh.size
    dist.all_gather_object(every, {
        k: out[k] for k in ("rank", "coordinate", "device", "a_launches",
                            "a_digest", "gather_ms", "b_launches",
                            "b_digest", "c_ms", "c_digest")})
    out["ranks"] = every
    return out


def mesh_path(dev, corpora) -> dict:
    """Phase 4q: the (2, 2) mesh of four ranks on the one card, against
    phase 4's single-device candidates and a (1, 1) session of corpus 0."""
    import torch

    from repro_torch.core.crowd import PerfectCrowd
    from repro_torch.kernels.pair_scores.sharded import sharded_candidates
    from repro_torch.launch.mesh import choose_backend, spawn
    from repro_torch.serve.join_service import JoinService

    t_phase = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    singles = []
    for _, ea, _, eb in corpora:
        a, b = torch.from_numpy(ea).to(dev), torch.from_numpy(eb).to(dev)
        singles.append(sharded_candidates(a, b, THRESHOLD))
    ids_a, ea, ids_b, eb = corpora[0]
    one = JoinService(lanes=1, device=dev)
    rid = one.submit_embeddings(
        torch.from_numpy(ea).to(dev), torch.from_numpy(eb).to(dev),
        THRESHOLD, crowd=PerfectCrowd(),
        truth_fn=lambda r, c: ids_a[r] == ids_b[c],
        total_true_matches=int((ids_a[:, None] == ids_b[None, :]).sum()))
    one_pairs = one.queue[-1].pairs
    one_view = _pair_view(result_fields(one.run()[rid]), one_pairs.u,
                          one_pairs.v)
    del one
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    n = math.prod(MESH_SHAPE)
    backend = choose_backend(dev, n)
    print(f"[4q mesh] {MESH_SHAPE} mesh of {n} ranks on "
          f"{torch.cuda.device_count()} card(s), backend {backend} (chosen "
          "from the ranks and cards when the mesh is built)")
    t0 = time.perf_counter()
    cfg = mesh_a2a_config()
    out = spawn(mesh_rank, *MESH_SHAPE, device=dev.type,
                args=(corpora, cfg, MESH_A2A_TOKENS), timeout=MESH_TIMEOUT)
    spawn_s = time.perf_counter() - t0
    print(f"[4q mesh] rank 0's mesh {out['mesh']}; placement "
          + ", ".join(f"rank {r['rank']} at {tuple(r['coordinate'])} on "
                      f"{r['device']}" for r in out["ranks"])
          + f"; the ranks' wall {spawn_s:.1f} s")

    # (a)
    launches = [r["a_launches"] for r in out["ranks"]]
    same = len({r["a_digest"] for r in out["ranks"]}) == 1
    equal = True
    for (rows, cols, scores, dropped, cap), single in zip(out["cands"],
                                                          singles):
        key = np.lexsort((cols, rows))
        equal &= dropped == 0 and np.array_equal(rows[key], single.rows) \
            and np.array_equal(cols[key], single.cols) \
            and np.array_equal(scores[key].view(np.int32),
                               single.scores.view(np.int32))
    n_cand = [len(c[0]) for c in out["cands"]]
    print(f"[4q a] {len(corpora)} corpora of ({N_ROWS}, {DIM}) x ({N_ROWS}, "
          f"{DIM}) on the mesh: {n_cand} candidates, pair_scores launches "
          f"by rank {launches} on ({N_ROWS // MESH_SHAPE[0]}, "
          f"{N_ROWS // MESH_SHAPE[1]}) blocks, equal to phase 4's "
          f"single-device candidates bit for bit {equal}, identical on "
          f"every rank {same}; {out['a_s']:.4f} s on rank 0; the gather "
          f"{out['gather_ms']:.2f} ms for {out['gather_bytes']} bytes a "
          f"rank (per-device capacity {out['cands'][0][4]})")
    if launches != [len(corpora)] * n or not same or not equal:
        raise AssertionError("phase 4q (a): the mesh's candidates or its "
                             "launches are wrong")

    # (b)
    same = len({r["b_digest"] for r in out["ranks"]}) == 1
    mesh_view = _pair_view(out["b_fields"], *out["b_pairs"])
    diff = [k for k in one_view[0] if one_view[0][k] != mesh_view[0][k]]
    per_pair = one_view[1] == mesh_view[1]
    b_launch = [r["b_launches"] for r in out["ranks"]]
    print(f"[4q b] corpus 0 served on the mesh: "
          f"{len(out['b_pairs'][0])} pairs, {mesh_view[0]['n_rounds']} "
          f"rounds; every field identical on the four ranks {same}; against "
          f"the (1, 1) session: scalar fields differing {diff}, each pair's "
          f"label and crowdsourcing equal {per_pair}; launches by rank "
          f"{b_launch}; {out['b_s']:.4f} s on rank 0")
    if not same or diff or not per_pair \
            or min(x["union_deduce"] for x in b_launch) < 1:
        raise AssertionError("phase 4q (b): the mesh session is wrong")

    # (c)
    fwd_err, grad_err = out["c_err"]
    same = len({r["c_digest"] for r in out["ranks"]}) == 1
    ms = [round(t, 2) for r in out["ranks"] for t in r["c_ms"]]
    print(f"[4q c] moe_block_a2a at {cfg.name} (d {cfg.d_model}, "
          f"{cfg.n_experts} experts, top {cfg.top_k}, d_ff {cfg.d_ff}), "
          f"bf16, {MESH_A2A_TOKENS} tokens, capacity factor "
          f"{cfg.capacity_factor}: "
          f"capacity {out['c_cap']} a (source, expert), "
          f"{out['c_exchange_bytes']} bytes a rank an exchange (two a "
          f"forward); max |y - moe_block| {fwd_err:.3e} (scale "
          f"{out['c_scale'][0]:.3e}), max |dx - moe_block's| "
          f"{grad_err:.3e} (scale {out['c_scale'][1]:.3e}); aux "
          f"{out['c_aux'][0]:.7f}, the ranks' router estimates averaged on "
          f"one device {out['c_aux'][1]:.7f} (bar {MESH_AUX_TOL}); "
          f"identical on every rank {same}; ms a forward by rank {ms}")
    aux_err = abs(out["c_aux"][0] - out["c_aux"][1])
    if fwd_err > MESH_A2A_TOL or grad_err > MESH_A2A_TOL or not same \
            or aux_err > MESH_AUX_TOL:
        raise AssertionError("phase 4q (c): the a2a layer disagrees")
    wall = time.perf_counter() - t_phase
    print(f"[4q] phase wall {wall:.1f} s")
    return {"launches": {
        "pair_scores": sum(launches) + sum(x["pair_scores"]
                                          for x in b_launch),
        "union_deduce": sum(x["union_deduce"] for x in b_launch)},
        "pair_scores_by_rank": [a + b["pair_scores"]
                                for a, b in zip(launches, b_launch)],
        "gather_ms": out["gather_ms"], "gather_bytes": out["gather_bytes"],
        "wall_s": wall}


def accounting_path(dev) -> dict:
    """Phase 4p: the dry-run's cells against the card, and
    ``moonshot-v1-16b-a3b`` at full width.  Every kernel count is zeroed
    just before a path and read just after it.
    (a) moonshot drawn on the card from a seeded generator (its expert
    leaves, 35.4 GB each as one f32 draw, a layer at a time): init seconds
    and peak bytes (at most the bf16 parameters and the largest single f32
    draw); ``ServeEngine.generate`` of 8 requests of ``FAM_MOE_PROMPT``
    tokens, ``ACCT_NEW`` new: prefill s, ms a step, the flash kernel once
    a layer for the wave and the decode kernel once a layer a step; a
    profiled window of decode steps (the experts' ``bmm`` share of busy);
    ``decode == prefill(n + 1)`` at ``capacity_factor`` 8 as 4n (d).
    (b) each of ``ACCT_CELLS`` at its cut batch: its record from
    ``repro_torch.launch.dryrun.run_cell`` and its roofline terms, one
    step measured (a 32768-token prefill, or ``ACCT_DECODE_STEPS`` decode
    steps from a seeded cache ending at the last position), the measured
    fraction of the bound (which must not pass 1 / ``ACCT_BOUND_FLOOR``),
    the card's peak and ``fits_one_card``; the draw of ``ACCT_DRAW_ARCH``
    equal to the whole-leaf draw of before, leaf for leaf; the flash kernel
    at (1, 32768, 16 / 8, 128) (plain version at ``ACCT_FLASH_PLAIN_S``,
    the last rows at 32768) and the decode kernel at (8, 32768, 16 / 8,
    128) and at moonshot's heads against their plain versions.  (c) the
    roofline table of every arch x shape on one H100, computed on the
    host."""
    import torch

    from repro_torch.configs import ASSIGNED, get
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.kernels.decode_attention import kernel as da_kernel
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.launch import dryrun, roofline
    from repro_torch.models import model as M
    from repro_torch.serve.engine import ServeEngine

    out: dict = {"launches": {}, "cells": {}}
    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def param_bytes(cfg):
        return sum(math.prod(s.shape) * s.dtype.itemsize
                   for s in M.model_specs(cfg).values())

    # -- (a) moonshot at full width ------------------------------------------
    cfg = get(ACCT_MOE_ARCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = _draw_model(dev, cfg, "4p a")
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() - base
    specs = M.model_specs(cfg)
    pbytes = param_bytes(cfg)
    card = torch.cuda.get_device_properties(dev).total_memory
    sliced = sorted(p for p, s in specs.items()
                    if M._drawn_in_slices(s, pbytes, card))
    largest = max(4 * math.prod(s.shape[1:] if p in sliced else s.shape)
                  for p, s in specs.items() if s.fan_in)
    print(f"[4p a] {cfg.name} drawn in {init_s:.3f} s: parameters {pbytes} "
          f"bytes, init peak {init_peak} bytes ({init_peak - pbytes} above "
          f"them; the largest single f32 draw {largest} bytes); drawn a "
          f"layer at a time: {sliced}")
    if not sliced or init_peak > pbytes + largest + 2 ** 26:
        raise AssertionError(f"phase 4p a: init peak {init_peak} over the "
                             f"parameters {pbytes} and one draw {largest}")
    reqs = _family_requests(cfg.vocab, FAM_MOE_PROMPT, ACCT_NEW, SEED + 32)
    engine = ServeEngine(cfg, model, batch_lanes=LM_LANES,
                         max_len=LM_MAX_LEN)
    _warm_engine(engine, cfg.vocab, np.random.default_rng(SEED + 9))
    _zero_attn_counts()
    toks, pre_s, step_ms = _timed_generate(engine, reqs, ACCT_NEW)
    got = _attn_counts()
    want = {"flash_attention": cfg.n_layers,
            "decode_attention": cfg.n_layers * (ACCT_NEW - 1),
            "decode_attention_int8": 0}
    del engine
    S = max(len(r.prompt) for r in reqs)
    wave = np.zeros((LM_LANES, S), np.int32)
    for j, r in enumerate(reqs):
        wave[j, S - len(r.prompt):] = r.prompt
    cache, logits = M.prefill(model, {"tokens": torch.from_numpy(wave).to(
        dev)}, LM_MAX_LEN)
    cur = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    torch.cuda.empty_cache()    # the profiler's own buffers need room

    def step():
        nonlocal cache, cur
        logits, cache = M.decode_step(model, cache, {"tokens": cur[:, None]})
        cur = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)

    wall, busy, bmm, launches, _ = _profile_steps(step, FAM_PROFILE_STEPS)
    del cache, logits
    torch.cuda.empty_cache()
    print(f"[4p a] {cfg.name}: {LM_LANES} requests of {FAM_MOE_PROMPT[0]}-"
          f"{FAM_MOE_PROMPT[1]} tokens (longest {S}), {ACCT_NEW} new: "
          f"prefill {pre_s:.4f} s, decode {step_ms:.4f} ms a step; launches "
          f"{got}; profiled window of {FAM_PROFILE_STEPS} steps: wall "
          f"{wall:.4f} ms a step, device busy {busy:.4f} ms (busy share "
          f"{busy / wall:.4f}), the experts' bmm {bmm:.4f} ms "
          f"({bmm / max(busy, 1e-9):.4f} of busy), {launches:.1f} launches "
          f"a step")
    if got != want or any(len(t) != ACCT_NEW for t in toks.values()):
        raise AssertionError(f"phase 4p a: launches {got}, expected {want}")
    moe8 = M.Model(cfg.replace(capacity_factor=FAM_MOE_CF),
                   dict(model.named_leaves()))
    n = FAM_MOE_PROMPT[0]
    seqs = _moe_gap(moe8, torch.from_numpy(np.stack(
        [r.prompt[:n] for r in reqs])).to(dev))
    del moe8
    # over 48 layers of bf16 router logits every sequence's picks may part
    # somewhere at a near tie: the two paths must agree where the picks
    # do (the logits of a sequence none of whose picks part; the router
    # inputs up to and at the first layer where they part), and part only
    # at near ties
    agree = [g for g, parted, _, _ in seqs if not parted]
    ties = [m for _, parted, m, _ in seqs if parted]
    x_gap = max(x for _, _, _, x in seqs)
    gap = max(agree) if agree else float("nan")
    print(f"[4p a] decode == prefill(n+1) at capacity_factor {FAM_MOE_CF}, "
          f"n {n - 1}, {len(seqs)} sequences: (max|d logits| of their scale,"
          f" layers where the last token's picks part, the first such "
          f"layer's {cfg.top_k}th-to-{cfg.top_k + 1}th router probability "
          f"margin, max|d router input| of its scale up to that layer) "
          + ", ".join(f"({g:.3e}, {p}, "
                      f"{'-' if m is None else f'{m:.3e}'}, {x:.3e})"
                      for g, p, m, x in seqs)
          + f"; logits where every pick agrees at most {gap:.3e}, router "
          f"inputs where they agree at most {x_gap:.3e} (tolerance "
          f"{LM_BF16_TOL}), first partings at margins up to "
          f"{max(ties, default=0.0):.3e} (tolerance {FAM_MOE_TIE:.4f})")
    if not (gap <= LM_BF16_TOL or not agree) or not x_gap <= LM_BF16_TOL \
            or not all(m <= FAM_MOE_TIE for m in ties):
        raise AssertionError("phase 4p a: decode_step disagrees with "
                             "prefill under the experts")
    out["moonshot"] = {"init_s": init_s, "init_peak": init_peak,
                       "param_bytes": pbytes, "prefill_s": pre_s,
                       "step_ms": step_ms, "busy_ms": busy, "wall_ms": wall,
                       "bmm_ms": bmm, "gap": gap, "router_gap": x_gap,
                       "logit_gaps": [g for g, _, _, _ in seqs]}
    out["launches"]["moonshot"] = got
    # the kernels at moonshot's heads (16 / 16 of 128)
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    check_flash(dev, LM_LANES, S, H, K, hd, torch.bfloat16)
    check_decode(dev, LM_LANES, LM_MAX_LEN, H, K, hd, S + ACCT_NEW - 1,
                 torch.bfloat16, torch.bfloat16)

    # -- (b) the dry-run's cells against the card ---------------------------
    def measure_cell(model, arch, shape_name, batch):
        """One step of the cell on the card: (seconds, launches, peak)."""
        cfg = model.cfg
        shape = SHAPES[shape_name]
        S_ = shape.seq_len
        torch.cuda.empty_cache()
        if shape.kind == "prefill":
            toks = torch.randint(2, cfg.vocab, (batch, S_), generator=gen,
                                 device=dev, dtype=torch.int32)
            M.prefill(model, {"tokens": toks[:, :2048]}, S_)   # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _zero_attn_counts()
            t0 = time.perf_counter()
            cache, logits = M.prefill(model, {"tokens": toks}, S_)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            ok = bool(torch.isfinite(logits).all()) \
                and int(cache["length"]) == S_
            del cache, logits
        else:
            cache = M.make_cache(cfg, batch, S_, dev)
            for name in ("k", "v"):
                for j in range(cache[name].shape[0]):
                    cache[name][j].normal_(generator=gen)
            cache["length"].fill_(S_ - ACCT_DECODE_STEPS - 1)
            cur = torch.randint(2, cfg.vocab, (batch, 1), generator=gen,
                                device=dev, dtype=torch.int32)
            logits, cache = M.decode_step(model, cache, {"tokens": cur})
            cur = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _zero_attn_counts()
            t0 = time.perf_counter()
            for _ in range(ACCT_DECODE_STEPS):
                logits, cache = M.decode_step(model, cache, {"tokens": cur})
                cur = torch.argmax(logits[:, -1], dim=-1).to(
                    torch.int32)[:, None]
            torch.cuda.synchronize()
            secs = (time.perf_counter() - t0) / ACCT_DECODE_STEPS
            ok = bool(torch.isfinite(logits).all()) \
                and int(cache["length"]) == S_
            del cache, logits
        return secs, _attn_counts(), torch.cuda.max_memory_allocated(), ok

    def report(model, arch, shape_name, batch):
        cfg = model.cfg
        shape = SHAPES[shape_name]
        rec = dryrun.run_cell(arch, shape_name, batch=batch)
        terms = roofline.cell_terms(rec)
        secs, got, peak, ok = measure_cell(model, arch, shape_name, batch)
        frac = roofline.measured_fraction(terms, secs)
        n = ACCT_DECODE_STEPS
        want = ({"flash_attention": cfg.n_layers, "decode_attention": 0,
                 "decode_attention_int8": 0} if shape.kind == "prefill" else
                {"flash_attention": 0, "decode_attention": cfg.n_layers * n,
                 "decode_attention_int8": 0})
        mem = rec["memory"]
        tag = f"{arch} {shape_name}"
        acc = rec["accounting"]
        summary = {
            "arch": arch, "shape": shape_name, "global_batch": batch,
            "reduced": f"global_batch {shape.global_batch} -> {batch}",
            "compute_s": terms["compute_s"], "memory_s": terms["memory_s"],
            "collective_s": terms["collective_s"],
            "dominant": terms["dominant"], "measured_s": secs,
            "measured_fraction": frac, "model_flops": rec["model_flops"],
            "flops": terms["hlo_flops_dev"], "bytes": terms["hlo_bytes_dev"],
            "kernel": acc.get("flash_kernel") if shape.kind == "prefill"
            else acc.get("decode_kernel"),
            "cache_bytes": rec["cache_bytes"],
            "argument_bytes": mem["argument_bytes"],
            "output_bytes": mem["output_bytes"],
            "alias_bytes": mem["alias_bytes"],
            "fits_one_card": mem["fits_one_card"],
            "card_bytes": mem["card_bytes"],
            "card_bytes_from": mem["card_bytes_from"],
            "max_memory_allocated": peak, "launches": got,
            "trace_seconds": rec["trace_seconds"]}
        print(f"[4p b {tag}] " + json.dumps(summary))
        print(f"[4p b {tag}] batch {batch} (reduced from "
              f"{shape.global_batch}): bound {1e3 * max(terms['compute_s'], terms['memory_s']):.4f} ms "
              f"(compute {1e3 * terms['compute_s']:.4f} ms, memory "
              f"{1e3 * terms['memory_s']:.4f} ms, {terms['dominant']}); "
              f"measured {1e3 * secs:.4f} ms a "
              f"{'prefill' if shape.kind == 'prefill' else 'step'}, "
              f"fraction {frac:.4f}; card peak {peak} bytes of "
              f"{mem['card_bytes']}, fits_one_card {mem['fits_one_card']}")
        if frac > 1.0 / ACCT_BOUND_FLOOR:
            raise AssertionError(f"phase 4p b {tag}: measured {secs} s is "
                                 f"below {ACCT_BOUND_FLOOR} of the bound: "
                                 f"the accounting over-counts")
        if got != want or not ok or not mem["fits_one_card"]:
            raise AssertionError(f"phase 4p b {tag}: launches {got}, "
                                 f"expected {want}; finite {ok}; fits "
                                 f"{mem['fits_one_card']}")
        out["cells"][tag] = summary
        out["launches"][tag] = got

    for arch, shape_name, batch in ACCT_CELLS:
        if arch != model.cfg.name:
            del model
            torch.cuda.empty_cache()
            cfg = get(arch)
            model = _draw_model(dev, cfg, "4p b")
            if arch == ACCT_DRAW_ARCH:
                before = _whole_leaf_draw(cfg, torch.Generator(
                    device=dev).manual_seed(SEED), dev)
                same = [p for p, t in model.named_leaves()
                        if torch.equal(t.view(torch.int16),
                                       before[p].view(torch.int16))]
                print(f"[4p b] {cfg.name}'s card draw against the whole-"
                      f"leaf draw of before: {len(same)} of "
                      f"{len(before)} leaves equal bit for bit")
                n_leaves = len(before)
                del before
                if len(same) != n_leaves:
                    raise AssertionError(f"phase 4p b: {cfg.name}'s draw "
                                         f"changed")
        report(model, arch, shape_name, batch)
    del model
    torch.cuda.empty_cache()

    # the two kernels at the cells' shapes against their plain versions
    cfg = get("internlm2-1.8b")
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    L = SHAPES["prefill_32k"].seq_len
    fa_err, _ = check_flash(dev, 1, ACCT_FLASH_PLAIN_S, H, K, hd,
                            torch.bfloat16)
    torch.cuda.empty_cache()
    tail_err = check_flash_tail(dev, 1, L, H, K, hd, ACCT_FLASH_TAIL)
    q = _randn(dev, (1, L, H, hd), torch.bfloat16, 5)
    k = _randn(dev, (1, L, K, hd), torch.bfloat16, 6)
    v = _randn(dev, (1, L, K, hd), torch.bfloat16, 7)
    flops = 4 * H * hd * L * (L + 1) // 2
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    qs, ks, vs = (x[:, :ACCT_FLASH_PLAIN_S] for x in (q, k, v))
    from repro_torch.kernels.flash_attention.ref import mha_causal_ref
    out["flash_prefill_32k"] = {
        "shape": [1, L, H, K, hd], "max_abs_err": max(fa_err, tail_err),
        "ms": cuda_ms(lambda: fa_kernel.flash_attention(q, k, v), 3),
        "plain_ms": cuda_ms(lambda: mha_causal_ref(qs, ks, vs), 3),
        "plain_S": ACCT_FLASH_PLAIN_S,
        "bound_ms": 1e3 * max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops > t_bytes else "bytes",
        "library_ms": cuda_ms(lambda: sdpa(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True), 3)}
    del q, k, v, qs, ks, vs
    torch.cuda.empty_cache()
    B8 = {(a, s): b for a, s, b in ACCT_CELLS}[("internlm2-1.8b",
                                                 "decode_32k")]
    length = L - ACCT_DECODE_STEPS
    da_err, (q, kc, vc, n) = check_decode(dev, B8, L, H, K, hd, length,
                                          torch.bfloat16, torch.bfloat16)
    nbytes = 2 * B8 * length * K * hd * 2 + 2 * q.numel() * 2
    flops = 4 * B8 * H * hd * length
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    mask = (torch.arange(L, device=dev) < length)[None, None, None]
    out["decode_decode_32k"] = {
        "shape": [B8, L, H, K, hd], "length": length, "max_abs_err": da_err,
        "splits": list(da_kernel.split_plan(q, kc)),
        "ms": cuda_ms(lambda: da_kernel.decode_attention(q, kc, vc, n), 10),
        "plain_ms": cuda_ms(lambda: decode_attention_ref(q, kc, vc, n), 3),
        "bound_ms": 1e3 * max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops > t_bytes else "bytes",
        "library_ms": cuda_ms(lambda: sdpa(
            q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2),
            attn_mask=mask, enable_gqa=True), 3)}
    del q, kc, vc
    torch.cuda.empty_cache()
    for name, d in (("flash_attention", out["flash_prefill_32k"]),
                    ("decode_attention", out["decode_decode_32k"])):
        print(f"[4p kernels] {name} at {tuple(d['shape'])}: {d['ms']:.4f} "
              f"ms against a bound of {d['bound_ms']:.4f} ({d['bound_by']})"
              f", plain {d['plain_ms']:.4f}"
              + (f" (at S {d['plain_S']})" if "plain_S" in d else "")
              + f", SDPA {d['library_ms']:.4f}")

    # -- (c) the roofline table of every arch x shape on one H100 -----------
    t0 = time.perf_counter()
    cells = []
    for arch in ASSIGNED:
        for shape_name in SHAPES:
            rec = dryrun.run_cell(arch, shape_name)
            cells.append(roofline.cell_terms(rec) or {
                "arch": arch, "shape": shape_name, "skipped": rec["status"]})
    table_s = time.perf_counter() - t0
    print(f"[4p c] the H100 roofline of {len(cells)} cells, traced on the "
          f"host in {table_s:.1f} s ({dryrun.card_bytes()[1]}):")
    for line in roofline.markdown_table(cells).splitlines():
        print(f"[4p c] {line}")
    for key, c in roofline.pick_hillclimb(cells).items():
        print(f"[4p c] {key}: {c['arch']} x {c['shape']} (dominant="
              f"{c['dominant']}, frac={c['roofline_frac']:.1%})")
    out["table_s"] = table_s
    return out


def _dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*")
               if f.is_file())


def recovery_path(dev, corpora, noisy_fields: dict, noisy_wall: float,
                  root: Path) -> dict:
    """Phase 4k: kill and restore on the card.  Every run is killed with
    ``_crash_after_checkpoints`` at a checkpoint mid-run (with a lane open,
    cents spent, less than the uninterrupted total), restored and finished.
    (a) phase 4e's service checkpointed every pass: an uninterrupted run
    whose fields equal phase 4e's (checkpoint ms and bytes a commit, its
    wall beside 4e's), then killed half way, restored (timed) and finished:
    every field but the wall clock phase 4e's, the same total spend, the
    cents a restart would pay again printed.  (b) ``RECOVERY_RUNS``: the
    paper's datasets alone under ``RECOVERY_SERVICE`` on phase 4h's
    platform, the uninterrupted run held to the reference's figures (passes
    and requeries too), killed after ``RECOVERY_KILL`` commits at the
    reference's cadence with the reference's cents committed, restored on
    the card with every field the uninterrupted run's; the product run
    restored once more from a copy of the same directory on the CPU, with
    identical fields.  (c) phase 4g's blocked session (65536 objects, int64
    keys) per round, killed after a checkpoint with answers folded: the
    restored lane's neg keys int64 with the int64 sentinel, the wide
    ``union_deduce`` launched after the restore, labels the truth and every
    field an uninterrupted per-round run's.  (d)
    ``bench_join_service.py``'s recovery stage, held to ``RECOVERY_BENCH``.
    Returns the phase's launches."""
    import shutil

    import torch

    from repro_torch.convert import embeddings_from_numpy
    from repro_torch.core.cluster_graph import UNKNOWN
    from repro_torch.core.crowd import LatencyModel, NoisyCrowd, PerfectCrowd
    from repro_torch.core.graph import key_sentinel
    from repro_torch.data.entities import make_session_pairsets
    from repro_torch.kernels.pair_scores import blocking
    from repro_torch.kernels.pair_scores import ops as ps_ops
    from repro_torch.kernels.union_deduce import ops as ud_ops
    from repro_torch.serve import join_service, recovery
    from repro_torch.train.checkpoint import CheckpointManager

    JoinService = join_service.JoinService

    def killed(svc, k):
        svc._crash_after_checkpoints = k
        try:
            svc.run()
        except join_service.ServiceKilled:
            return
        raise AssertionError("the run ended before its kill")

    def restore(path, device=dev):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        svc = JoinService.restore(str(path), device=device)
        torch.cuda.synchronize()
        return svc, time.perf_counter() - t0

    def check_kill(tag, info, total):
        print(f"[4k {tag}] killed at step {info['step']}: {info['n_lanes']} "
              f"lanes open, {info['n_queued']} queued, {info['n_results']} "
              f"finished, {info['in_flight']} tickets in flight, "
              f"{info['spent_cents']} of {total} cents committed (a restart "
              f"pays them again: {info['spent_cents'] / total:.4f} saved)")
        if not (info["n_lanes"] >= 1 and 0 < info["spent_cents"] < total):
            raise AssertionError(f"phase 4k {tag}: the kill did not land "
                                 f"mid-run: {info}")

    for counter in (ps_ops.pair_scores, ps_ops.pair_scores_compact,
                    ud_ops.union_deduce):
        counter.launches = 0
    ud_ops.union_deduce.wide_launches = 0

    # (a) phase 4e's service, a checkpoint every pass; each commit split
    # into the capture (flush, lanes to the host, state dicts) and the
    # write (npz, sidecar JSON, renames)
    commits = {"n": 0, "s": 0.0, "bytes": 0, "capture": 0.0, "write": 0.0}

    def timed(fn, key):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                commits[key] += time.perf_counter() - t0
        return call

    capture, write = recovery.capture_service, CheckpointManager._write

    def timed_commits(svc):
        now = svc._checkpoint_now

        def commit(active, gateway):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                now(active, gateway)
            finally:
                torch.cuda.synchronize()
                commits["s"] += time.perf_counter() - t0
                commits["n"] += 1
                commits["bytes"] += _dir_bytes(
                    svc._ckpt.dir / f"step_{svc._ckpt_step - 1:08d}")
        svc._checkpoint_now = commit

    svc = noisy_service(dev, corpora, checkpoint_dir=str(root / "a_full"))
    timed_commits(svc)
    recovery.capture_service = timed(capture, "capture")
    CheckpointManager._write = timed(write, "write")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        full = svc.run()
        torch.cuda.synchronize()
        ckpt_wall = time.perf_counter() - t0
    finally:
        recovery.capture_service, CheckpointManager._write = capture, write
    same = {rid: result_fields(res) for rid, res in full.items()} \
        == noisy_fields
    n_commits = commits["n"]
    print(f"[4k a] phase 4e's run() with a checkpoint every pass: "
          f"{ckpt_wall:.4f} s against 4e's {noisy_wall:.4f} s without; "
          f"{n_commits} commits, {1e3 * commits['s'] / n_commits:.2f} ms and "
          f"{commits['bytes'] / n_commits / 2 ** 20:.2f} MiB a commit "
          f"(capture {1e3 * commits['capture'] / n_commits:.2f} ms, write "
          f"{1e3 * commits['write'] / n_commits:.2f} ms); every field equal "
          f"to 4e's {same}")
    if not same:
        raise AssertionError("phase 4k a: checkpointing changed phase 4e's "
                             "results")
    total = sum(f["n_spent_cents"] for f in noisy_fields.values())
    svc = noisy_service(dev, corpora, checkpoint_dir=str(root / "a_kill"))
    killed(svc, n_commits // 2)
    restored, restore_s = restore(root / "a_kill")
    check_kill("a", restored.last_recovery, total)
    t0 = time.perf_counter()
    rec = restored.run()
    torch.cuda.synchronize()
    finish_s = time.perf_counter() - t0
    same = {rid: result_fields(res) for rid, res in rec.items()} \
        == noisy_fields
    print(f"[4k a] restore {1e3 * restore_s:.2f} ms, finish {finish_s:.4f} "
          f"s; every field but the wall equal to 4e's uninterrupted run "
          f"{same}; recovered total "
          f"{sum(r.n_spent_cents for r in rec.values())} cents of {total}")
    if not same:
        raise AssertionError("phase 4k a: the restored run differs from "
                             "phase 4e's")
    out = {"a": {"restore_ms": 1e3 * restore_s,
                 "commit_ms": 1e3 * commits["s"] / n_commits,
                 "commit_bytes": commits["bytes"] / n_commits,
                 "wall_with": ckpt_wall, "wall_without": noisy_wall}}

    # (b) the hard configuration at the paper's datasets' full size
    for name, (passes, every, at_kill, figures) in RECOVERY_RUNS.items():
        k = ("paper", "product").index(name)  # the crowd's seed offset
        ds, pairs = _pipeline_candidates(name, ASYNC_TAU)

        def service(path, every, device=dev):
            svc = JoinService(lanes=ASYNC_LANES,
                              latency=LatencyModel(**ASYNC_LATENCY),
                              **RECOVERY_SERVICE, checkpoint_dir=str(path),
                              checkpoint_every=every, device=device)
            crowd = NoisyCrowd(**dict(REQUERY_CROWD,
                                      seed=REQUERY_CROWD["seed"] + k))
            return svc, svc.submit(pairs, crowd,
                                   total_true_matches=ds.total_true_matches)

        svc, rid = service(root / f"b_{name}_count", 10 ** 9)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        base = svc.run()[rid]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = (svc._ckpt_tick, econ_figures(base))
        print(f"[4k b {name}] uninterrupted: {len(pairs)} pairs, "
              f"{base.n_crowdsourced} crowdsourced, {base.n_requeried} "
              f"requeried, {base.n_spent_cents} cents, sim_minutes "
              f"{base.sim_minutes!r}, {got[0]} run-loop passes, run() "
              f"{wall:.4f} s; the reference's figures {got == (passes, figures)}")
        if got != (passes, figures) or base.n_requeried < 1:
            raise AssertionError(f"phase 4k b {name}: {got} against the "
                                 f"reference's {(passes, figures)}")
        kill_dir = root / f"b_{name}_kill"
        svc, _ = service(kill_dir, every)
        killed(svc, RECOVERY_KILL)
        if name == "product":
            shutil.copytree(kill_dir, root / "b_product_cpu")
        restored, restore_s = restore(kill_dir)
        info = restored.last_recovery
        check_kill(f"b {name}", info, base.n_spent_cents)
        if info["spent_cents"] != at_kill:
            raise AssertionError(f"phase 4k b {name}: {info['spent_cents']}"
                                 f" cents at the kill, the reference's "
                                 f"{at_kill}")
        rec = restored.run()[rid]
        same = result_fields(rec) == result_fields(base)
        print(f"[4k b {name}] a checkpoint every {every} passes, killed "
              f"after {RECOVERY_KILL}: restore {1e3 * restore_s:.2f} ms, "
              f"every field equal to the uninterrupted run's {same}")
        if not same:
            raise AssertionError(f"phase 4k b {name}: the restored run "
                                 f"differs")
        out[f"b_{name}"] = {"restore_ms": 1e3 * restore_s, "wall": wall}
        if name == "product":
            t0 = time.perf_counter()
            cpu = JoinService.restore(str(root / "b_product_cpu"),
                                      device="cpu").run()[rid]
            same = result_fields(cpu) == result_fields(base)
            print(f"[4k b product] restored on the CPU: every field equal "
                  f"{same} ({time.perf_counter() - t0:.4f} s)")
            if not same:
                raise AssertionError("phase 4k b: the product run restored "
                                     "on the CPU differs")

    # (c) phase 4g's blocked session, int64 keys, per round
    cfg = blocking.BlockingConfig(**BLOCKING)
    ids_a, ea, ids_b, eb = make_corpus(LARGE_SEED, LARGE_ROWS, DIM)
    svc = JoinService(lanes=1, fused_rounds=False, device=dev,
                      checkpoint_dir=str(root / "c"))
    rid = svc.submit_embeddings(
        embeddings_from_numpy(ea, dev), embeddings_from_numpy(eb, dev),
        THRESHOLD, crowd=PerfectCrowd(),
        truth_fn=lambda r, c: ids_a[r] == ids_b[c], blocking=cfg)
    ps = svc.queue[-1].pairs
    killed(svc, 3)
    restored, restore_s = restore(root / "c")
    (lane,), _ = restored._resume
    keys = lane.state.neg_keys
    pad = keys == key_sentinel(torch.int64)
    folded = int(lane.state.rounds)
    print(f"[4k c] {len(ps)} pairs among {ps.n_objects} objects, killed "
          f"after round {folded}: {int((lane.labels_host != UNKNOWN).sum())}"
          f" pairs labelled, neg keys {keys.dtype} ({int((~pad).sum())} "
          f"keys, {int(pad.sum())} int64 sentinels); restore "
          f"{1e3 * restore_s:.2f} ms")
    if keys.dtype != torch.int64 or not bool(pad.any()) or folded < 1 \
            or not bool((~pad).any()):
        raise AssertionError("phase 4k c: the restored lane lost its int64 "
                             "keys or holds no folded answer")
    wide = ud_ops.union_deduce.wide_launches
    res = restored.run()[rid]
    wide = ud_ops.union_deduce.wide_launches - wide
    one = JoinService(lanes=1, fused_rounds=False, device=dev)
    one_rid = one.submit(ps, PerfectCrowd())
    base = one.run()[one_rid]
    check_kill("c", restored.last_recovery, base.n_spent_cents)
    same = result_fields(base) == result_fields(res)
    truth = np.array_equal(res.labels, ps.truth)
    print(f"[4k c] after the restore: {wide} wide union_deduce launches, "
          f"labels the truth {truth}, every field the uninterrupted "
          f"per-round run's {same}")
    if wide < 1 or not truth or not same:
        raise AssertionError("phase 4k c: the restored int64 lane failed")
    out["c"] = {"restore_ms": 1e3 * restore_s, "wide_after_restore": wide}

    # (d) the recovery stage of benchmarks/bench_join_service.py
    for n, expected in RECOVERY_BENCH.items():
        got = recovery_bench(join_service, NoisyCrowd, make_session_pairsets,
                             n, str(root / f"d_{n}"), device=dev)
        print(f"[4k d] bench recovery stage, {n} sessions: restart "
              f"{got['restart_cents']} cents, {got['at_kill']} committed at "
              f"the kill ({got['at_kill'] / got['restart_cents']:.4f} saved),"
              f" labels identical {got['identical']}, restore "
              f"{1e3 * got['restore_s']:.2f} ms")
        if (got["restart_cents"], got["at_kill"]) != expected \
                or not got["identical"] \
                or got["recovered_cents"] != got["restart_cents"]:
            raise AssertionError(f"phase 4k d: {got} against {expected}")
    out["launches"] = {
        "pair_scores": ps_ops.pair_scores.launches,
        "pair_scores_compact": ps_ops.pair_scores_compact.launches,
        "union_deduce": ud_ops.union_deduce.launches,
        "union_deduce_wide": ud_ops.union_deduce.wide_launches}
    print(f"[4k recovery] launches {out['launches']}")
    return out


def plan_path(dev, corpora, root: Path) -> dict:
    """Phase 4l: the plan layer.  (a) ``bench_plan.py``'s three stages at
    its CI and full sizes, each figure the reference's (``PLAN_RUNS``):
    the warm repeat crowdsources nothing and keeps the cold signature,
    pushdown keeps the signature on fewer candidates, the greedy order and
    its cost.  (b) three collections of one ``make_corpus`` family
    (``PLAN_WIDE_ROWS`` rows x 384) under a filtered ``MultiJoin`` at
    ``THRESHOLD``, cold, then warm over the cache saved to disk: the warm
    run crowdsources 0 pairs with the cold signature.  (c) a
    ``JoinService(cache_path=, checkpoint_dir=)`` of phase 4's corpora 0 and
    1 through ``submit_embeddings``, killed after 2 commits and restored:
    the restored service reloads the cache, deposits into it, and a repeat
    of corpus 0 on it crowdsources nothing; the cache file and every field
    equal an uninterrupted service's.  Returns the phase's launches."""
    import torch

    import repro_torch.plan as tp
    from repro_torch.convert import embeddings_from_numpy
    from repro_torch.core.crowd import PerfectCrowd
    from repro_torch.kernels.pair_scores import ops as ps_ops
    from repro_torch.kernels.union_deduce import ops as ud_ops
    from repro_torch.serve import join_service

    for counter in (ps_ops.pair_scores, ud_ops.union_deduce):
        counter.launches = 0
    out = {}

    def executor(cache, optimize_plans):
        return tp.PlanExecutor(cache=cache, optimize_plans=optimize_plans,
                               device=dev)

    # (a) bench_plan.py's stages
    for size in PLAN_SIZES:
        figures, secs = plan_bench(tp, executor, size)
        (cold, warm, hits, cents, _, cands, sig), pushdown, order = \
            (figures[k] for k in ("repeat", "pushdown", "ordering"))
        print(f"[4l a {size}] repeat: cold {cold} crowdsourced ({cents} "
              f"cents, {cands} candidates), warm {warm} with {hits} cache "
              f"hits, saved {1 - warm / max(cold, 1):.4f}, signature equal "
              f"{sig}; pushdown: {pushdown[0]} -> {pushdown[1]} candidates "
              f"({1 - pushdown[1] / pushdown[0]:.4f} fewer), crowdsourced "
              f"{pushdown[2]} -> {pushdown[3]}; order {order[0]} cost "
              f"{order[1]} (best {order[2]}, worst {order[3]}); walls "
              + ", ".join(f"{k} {v:.4f} s" for k, v in secs.items())
              + f"; the reference's {figures == PLAN_RUNS[size]}")
        if figures != PLAN_RUNS[size] or warm or not sig:
            raise AssertionError(f"phase 4l a {size}: {figures} against "
                                 f"{PLAN_RUNS[size]}")
        out[size] = secs

    # (b) at the join cells' width
    n_a, n_b, n_c = PLAN_WIDE_ROWS
    ids_a, ea, ids_b, eb, ((ids_c, ec),) = make_corpus(SEED + 30, n_a, DIM,
                                                       more=(n_c,))
    colls = [tp.Collection(name, emb, attrs={"oid": np.arange(len(emb)),
                                             "g": np.arange(len(emb)) % 3},
                           entities=ids)
             for name, emb, ids in (("a", ea, ids_a), ("b", eb, ids_b),
                                    ("c", ec, ids_c))]
    plan = tp.Filter(tp.Cmp("a.g", "<", 2),
                     tp.MultiJoin([tp.Scan(c) for c in colls], THRESHOLD))
    path = root / "plan_cache.json"
    cache = tp.ClusterCache()
    t0 = time.perf_counter()
    cold = executor(cache, True).execute(plan)
    cold_s = time.perf_counter() - t0
    cache.save(str(path))
    t0 = time.perf_counter()
    warm = executor(tp.ClusterCache.load(str(path)), True).execute(plan)
    warm_s = time.perf_counter() - t0
    sig = warm.signature() == cold.signature()
    print(f"[4l b] {PLAN_WIDE_ROWS} rows x {DIM}: {cold.n_candidates} "
          f"candidates in {len(cold.stages)} stages, cold {cold.n_crowdsourced}"
          f" crowdsourced ({cold.spent_cents} cents, {len(cold.tuples)} "
          f"tuples) in {cold_s:.4f} s; warm over the saved cache "
          f"{warm.n_crowdsourced} crowdsourced, {warm.n_cache_hits} hits, "
          f"{warm_s:.4f} s; signature equal {sig}")
    if warm.n_crowdsourced or not sig or not cold.n_crowdsourced:
        raise AssertionError("phase 4l b: the warm repeat paid again or "
                             "changed the result")
    out["wide"] = {"cold_s": cold_s, "warm_s": warm_s}

    # (c) the service's cache wiring across a kill
    def service(tag, **kw):
        svc = join_service.JoinService(
            lanes=1, cache_path=str(root / f"svc_{tag}.json"), device=dev,
            **kw)
        return svc

    def submit(svc, i):
        ids_a, ea, ids_b, eb = corpora[i]
        return svc.submit_embeddings(
            embeddings_from_numpy(ea, dev), embeddings_from_numpy(eb, dev),
            THRESHOLD, crowd=PerfectCrowd(),
            truth_fn=lambda r, c: ids_a[r] == ids_b[c])

    base = service("base")
    for i in (0, 1):
        submit(base, i)
    base.run()
    repeat = submit(base, 0)
    base_res = base.run()
    svc = service("kill", checkpoint_dir=str(root / "svc_ckpt"))
    for i in (0, 1):
        submit(svc, i)
    svc._crash_after_checkpoints = 2
    try:
        svc.run()
        raise AssertionError("phase 4l c: the run ended before its kill")
    except join_service.ServiceKilled:
        pass
    restored = join_service.JoinService.restore(str(root / "svc_ckpt"),
                                                device=dev)
    reloaded = restored.cluster_cache.n_objects
    restored.run()
    again = submit(restored, 0)
    res = restored.run()
    same = {r: result_fields(x) for r, x in res.items()} == \
        {r: result_fields(x) for r, x in base_res.items()}
    files = (root / "svc_base.json").read_bytes() == \
        (root / "svc_kill.json").read_bytes()
    print(f"[4l c] killed at step {restored.last_recovery['step']}: the "
          f"restored service reloaded {reloaded} cached objects; the repeat "
          f"crowdsourced {res[again].n_crowdsourced} with "
          f"{res[again].n_cache_hits} cache hits; every field equal to the "
          f"uninterrupted service's {same}; cache files equal {files}")
    if not (reloaded and same and files and again == repeat
            and res[again].n_crowdsourced == 0):
        raise AssertionError("phase 4l c: the restored service's cache "
                             "differs")
    torch.cuda.synchronize()
    out["launches"] = {"pair_scores": ps_ops.pair_scores.launches,
                       "union_deduce": ud_ops.union_deduce.launches}
    print(f"[4l plan] launches {out['launches']}")
    return out


def _same_state(a, b) -> list:
    """The paths where two train states differ (dtype or any bit)."""
    import torch

    from repro_torch.train.optim import tree_leaves
    from repro_torch.train.train_step import state_tree

    return [p for (p, x), (_, y) in zip(tree_leaves(state_tree(a)),
                                        tree_leaves(state_tree(b)))
            if x.dtype != y.dtype or not torch.equal(x, y)]


def _sync_split(step_fn, state, batch) -> dict:
    """One train step with the forward (``loss_fn``), the backward (the
    top-level ``torch.autograd.grad``), the compression round trip and
    AdamW each timed on the host clock between two synchronizes: seconds
    by part, device time included."""
    import torch

    from repro_torch.models import model as M
    from repro_torch.train import train_step

    spent = {"forward": 0.0, "backward": 0.0, "compress": 0.0,
             "optimizer": 0.0}
    depth = [0]

    def timed(fn, key):
        def call(*args, **kwargs):
            if depth[0]:
                return fn(*args, **kwargs)
            depth[0] += 1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
            finally:
                depth[0] -= 1
            spent[key] += time.perf_counter() - t0
            return out
        return call

    saved = [(M, "loss_fn"), (torch.autograd, "grad"),
             (train_step, "compress_tree"), (train_step, "decompress_tree"),
             (train_step, "adamw_update")]
    old = [getattr(mod, name) for mod, name in saved]
    keys = ["forward", "backward", "compress", "compress", "optimizer"]
    for (mod, name), fn, key in zip(saved, old, keys):
        setattr(mod, name, timed(fn, key))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step_fn(state, batch)
        torch.cuda.synchronize()
        spent["step"] = time.perf_counter() - t0
    finally:
        for (mod, name), fn in zip(saved, old):
            setattr(mod, name, fn)
    return spent


def _train_profile(tag: str, step_fn, state, batch, wall_s: float) -> None:
    """One step under ``torch.profiler``: device busy, idle share against
    the unprofiled step's ``wall_s``, launches and host syncs, the top
    kernels; then a synchronized host-clock split of one more step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step_fn(state, batch)
        torch.cuda.synchronize()
    on_card, busy, syncs, launches = profile_counts(prof)
    attn = sum(dev_us(e) for e in on_card
               if "flash_attention" in e.key) / 1e3
    print(f"[4m {tag} profile] one step ({torch.cuda.get_device_name(0)})"
          f": device busy {1e3 * busy:.4f} ms "
          f"(idle share {1 - busy / wall_s:.4f} of the unprofiled "
          f"{1e3 * wall_s:.4f} ms), flash_attention kernels {attn:.4f} ms;"
          f" {launches} kernel launches, {syncs} host syncs a step")
    for e in sorted(on_card, key=dev_us, reverse=True)[:8]:
        print(f"[4m {tag} profile]   {dev_us(e) / 1e3:9.4f} ms  "
              f"x{e.count:<5d} {e.key[:90]}")
    split = _sync_split(step_fn, state, batch)
    total = split.pop("step")
    print(f"[4m {tag} split] synchronized step {1e3 * total:.4f} ms: "
          + ", ".join(f"{k} {1e3 * v:.4f} ms ({v / total:.3f})"
                      for k, v in split.items())
          + f", rest {1e3 * (total - sum(split.values())):.4f} ms")


def train_path(dev, root: Path) -> dict:
    """Phase 4m: the port's training on the card.  (a) ``paper-scorer`` at
    full width (163,597,056 bf16 parameters, f32 moments) through the
    ``Runner`` on the paper dataset's record corpus at seq ``TRAIN_SEQ``,
    batch ``TRAIN_BATCH``: ``TRAIN_STEPS`` steps with a checkpoint every
    ``TRAIN_EVERY``, the same steps with a failure injected at
    ``TRAIN_FAIL``, and once more uninterrupted; the three final states
    (parameters and moments) equal bit for bit, the loss falling, the
    flash kernel launched 2 x n_layers a step (remat recomputes each
    layer's forward).  (b) one reduced ``init_state`` drawn on the CPU and
    moved to the card: ``TRAIN_CPU_STEPS`` steps on each, the losses within
    ``TRAIN_LOSS_RTOL``; ``FlashAttentionFn``'s backward at
    ``TRAIN_ATTN_SHAPE`` in bf16 and f32 against the plain version's
    autograd gradients on the card.  (c) full width at ``TRAIN_BIG``
    (microbatches, int8 compression): ms a step, tokens a second, peak
    memory, and a profile and a split of one step.  Returns the flash
    launches of (a)'s first run."""
    import shutil

    import torch

    from repro_torch.configs import get
    from repro_torch.convert import (train_state_from_numpy,
                                     train_state_to_numpy)
    from repro_torch.data.entities import make_paper_dataset
    from repro_torch.data.tokens import TokenPipeline, corpus_from_records
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import mha_causal_ref
    from repro_torch.models.layers import FlashAttentionFn
    from repro_torch.models.model import n_params
    from repro_torch.train.fault import FailureInjector
    from repro_torch.train.optim import AdamWConfig
    from repro_torch.train.runner import Runner, RunnerConfig
    from repro_torch.train.train_step import init_state, make_train_step

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    cfg = get("paper-scorer")
    records = make_paper_dataset().records
    rows = corpus_from_records(records, cfg.vocab, TRAIN_SEQ)
    ocfg = AdamWConfig(lr=3e-4, total_steps=TRAIN_STEPS,
                       warmup_steps=max(2, TRAIN_STEPS // 20))
    per_step = 2 * cfg.n_layers

    # -- (a) the runner: uninterrupted, failed and resumed, again ----------
    def run(tag, fail=()):
        d = root / f"train_{tag}"
        runner = Runner(cfg, ocfg, RunnerConfig(
            total_steps=TRAIN_STEPS, checkpoint_every=TRAIN_EVERY,
            checkpoint_dir=str(d), log_every=TRAIN_STEPS), dev,
            TokenPipeline(rows, TRAIN_BATCH),
            injector=FailureInjector(fail_at_steps=fail),
            log=lambda m: print(f"[4m a {tag}] {m}"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = runner.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        shutil.rmtree(d, ignore_errors=True)
        return out, wall

    fa_ops.flash_attention.launches = 0
    first, wall_1 = run("first")
    launches = fa_ops.flash_attention.launches
    failed, wall_2 = run("failed", (TRAIN_FAIL,))
    again, wall_3 = run("again")
    hist = first["history"]
    step_ms = sorted(h["s"] for h in hist[1:])[len(hist[1:]) // 2] * 1e3
    print(f"[4m a] paper-scorer {n_params(cfg)} parameters, {len(rows)} "
          f"packed rows of {TRAIN_SEQ}, batch {TRAIN_BATCH}: {TRAIN_STEPS} "
          f"steps in {wall_1:.3f} s (checkpoints every {TRAIN_EVERY} "
          f"included), {step_ms:.4f} ms a step (median host clock of steps "
          f"2-{TRAIN_STEPS}, a loss read each); loss {hist[0]['loss']:.4f} "
          f"-> {hist[-1]['loss']:.4f}; flash_attention {launches} launches,"
          f" {launches / TRAIN_STEPS:.1f} a step ({smi})")
    print(f"[4m a] failed at step {TRAIN_FAIL} and resumed: "
          f"{len(failed['history'])} steps run in {wall_2:.3f} s; again "
          f"uninterrupted in {wall_3:.3f} s")
    if first["final_step"] != TRAIN_STEPS or failed["final_step"] \
            != TRAIN_STEPS:
        raise AssertionError("a training run stopped short")
    if launches != per_step * TRAIN_STEPS:
        raise AssertionError(f"flash_attention launched {launches} times in "
                             f"{TRAIN_STEPS} steps, not {per_step} a step")
    if not hist[-1]["loss"] < hist[0]["loss"]:
        raise AssertionError("the training loss did not fall")
    for name, other in (("resumed", failed), ("second", again)):
        diff = _same_state(first["state"], other["state"])
        print(f"[4m a] {name} run against the first: "
              f"{'bit for bit' if not diff else 'differs in ' + str(diff)}")
        if diff:
            raise AssertionError(f"the {name} training run differs from "
                                 f"the first in {diff}")
    if [h["loss"] for h in again["history"]] != \
            [h["loss"] for h in hist]:
        raise AssertionError("two uninterrupted runs' losses differ")
    batch = TokenPipeline(rows, TRAIN_BATCH).batch_at(0)
    state = first["state"]
    step_fn = make_train_step(cfg, ocfg)
    del failed, again
    _train_profile("a", step_fn, state, batch, step_ms / 1e3)
    del first, state

    # -- (b) the card against the CPU; FlashAttentionFn's backward ----------
    small = cfg.reduced()
    host = init_state(small, torch.Generator().manual_seed(SEED),
                      device="cpu")
    card = train_state_from_numpy(small, train_state_to_numpy(host), dev)
    small_step = make_train_step(small, ocfg)
    pipe = TokenPipeline(corpus_from_records(records, small.vocab,
                                             TRAIN_SEQ), TRAIN_BATCH)
    losses = {}
    for name, state in (("cpu", host), ("card", card)):
        losses[name] = [float(small_step(state, pipe.batch_at(i))[1]["loss"])
                        for i in range(TRAIN_CPU_STEPS)]
    worst = max(abs(a - b) / b for a, b in zip(losses["card"],
                                                losses["cpu"]))
    print(f"[4m b] reduced config, {TRAIN_CPU_STEPS} steps: card "
          f"{losses['card']} against cpu {losses['cpu']}; worst relative "
          f"difference {worst:.3e} (bound {TRAIN_LOSS_RTOL})")
    if worst > TRAIN_LOSS_RTOL:
        raise AssertionError("training on the card and on the CPU disagree")
    B, S, H, K, d = TRAIN_ATTN_SHAPE
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (_randn(dev, (B, S, n, d), dtype, SEED + i)
                   .requires_grad_() for i, n in enumerate((H, K, K)))
        g = _randn(dev, (B, S, H, d), dtype, SEED + 3)
        got = torch.autograd.grad(FlashAttentionFn.apply(
            q, k, v, cfg.attn_chunk_q), (q, k, v), g)
        exp = torch.autograd.grad(mha_causal_ref(q, k, v), (q, k, v), g)
        for name, a, b in zip("qkv", got, exp):
            err, ok, tol = attn_error("flash", a, b)
            print(f"[4m b] FlashAttentionFn d{name} {TRAIN_ATTN_SHAPE} "
                  f"{str(dtype).split('.')[-1]}: max|d| {err:.3e} "
                  f"(tolerance {tol})")
            if not ok:
                raise AssertionError("FlashAttentionFn's gradient disagrees "
                                     "with the plain version's")
    del host, card

    # -- (c) a card-sized batch --------------------------------------------
    big = TokenPipeline(rows, TRAIN_BIG["batch"])
    torch.cuda.reset_peak_memory_stats()
    state = init_state(cfg, torch.Generator(device=dev).manual_seed(SEED),
                       True, dev)
    step_fn = make_train_step(cfg, ocfg, TRAIN_BIG["microbatches"], True)
    times, big_losses = [], []
    before = fa_ops.flash_attention.launches
    for i in range(TRAIN_BIG["steps"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, met = step_fn(state, big.batch_at(i))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        big_losses.append(float(met["loss"]))
    big_launches = fa_ops.flash_attention.launches - before
    med = sorted(times[1:])[len(times[1:]) // 2]
    tokens = TRAIN_BIG["batch"] * TRAIN_SEQ
    print(f"[4m c] full width, batch {TRAIN_BIG['batch']} x {TRAIN_SEQ} in "
          f"{TRAIN_BIG['microbatches']} microbatches, int8 compression: "
          f"{1e3 * med:.4f} ms a step (median of steps 2-"
          f"{TRAIN_BIG['steps']}; first {1e3 * times[0]:.4f} ms), "
          f"{tokens / med:.1f} tokens/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; loss "
          f"{big_losses[0]:.4f} -> {big_losses[-1]:.4f}; flash_attention "
          f"{big_launches / TRAIN_BIG['steps']:.1f} launches a step "
          f"({smi})")
    if big_launches != per_step * TRAIN_BIG["microbatches"] \
            * TRAIN_BIG["steps"]:
        raise AssertionError("the microbatched step skipped the flash kernel")
    _train_profile("c", step_fn, state, big.batch_at(0), med)
    return {"launches": launches}


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
    from repro_torch.core.graph import key_sentinel
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

    t_run = time.perf_counter()
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
                 torch.full_like(path_u, key_sentinel(torch.int32)), n_path)
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
    # the wide kernel (past 46340 objects, int64 keys): a path graph of
    # 65536 objects and stacked lanes with neg keys and a conflict
    n_wide = 2 * 32768
    wide_u = torch.arange(n_wide - 1, dtype=torch.int32, device=dev)[None]
    wide_path = (torch.arange(n_wide, dtype=torch.int32, device=dev)[None],
                 wide_u, wide_u + 1, torch.ones_like(wide_u, dtype=torch.bool),
                 torch.full_like(wide_u, key_sentinel(torch.int64),
                                 dtype=torch.int64), n_wide)
    wide_args = wide_lanes(dev, n_wide, 131072, 3, seed=SEED + 3)
    wide_plan = ud_kernel.plan(n_wide, 131072, 3)
    print(f"[3 union_deduce wide] launch plan at (3, {n_wide}, 131072): "
          f"wide {wide_plan.wide}, a cluster of {wide_plan.cluster} blocks a"
          f" lane, {wide_plan.smem_bytes} B of dynamic shared memory, the "
          f"forest in global memory, a hash set of {wide_plan.table_size} "
          f"64-bit slots a lane")
    if not wide_plan.wide:
        raise AssertionError("the plan past 46340 objects is not the wide "
                             "kernel's")
    for name, args in (("path graph", wide_path),
                       ("stacked lanes", wide_args)):
        check_union_deduce("3 union_deduce wide", name, args)
    if not bool(union_deduce_ref(*wide_args)[2][0]):
        raise AssertionError("the wide kernel's stacked lanes do not "
                             "conflict")
    for name, args in (("round-1 screen", screen_args),
                       ("round-1 deduce", deduce_args),
                       ("wide stacked lanes", wide_args)):
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
    # the int8 cache path: the serving shape at the same lengths, head dims
    # 32 and 128, bf16 and f32 queries; then under scales of 1
    d8_err, d8_args = 0.0, None
    for length in sorted(set(DECODE_LENGTHS) | {min(da_chunk, LM_MAX_LEN),
                                                min(da_chunk + 1,
                                                    LM_MAX_LEN)}):
        for q_dt in (torch.bfloat16, torch.float32):
            err, args = check_decode_int8(dev, LM_LANES, LM_MAX_LEN, H, K, hd,
                                          length, q_dt, seed=length)
            if q_dt == torch.bfloat16:
                d8_err = max(d8_err, err)
                if length == LM_MAX_LEN:
                    d8_args = args
    for shape in DECODE_INT8_SHAPES:
        for q_dt in (torch.bfloat16, torch.float32):
            check_decode_int8(dev, *shape, q_dt, seed=3)
    for shape in ((LM_LANES, LM_MAX_LEN, H, K, hd, 1337),) \
            + DECODE_INT8_SHAPES:
        check_decode_int8(dev, *shape, torch.float32, seed=4,
                          unit_scales=True)
    repeats = [da_kernel.decode_attention(*d8_args) for _ in range(5)]
    d8_repeat = all(torch.equal(x.view(torch.int16), repeats[0].view(
        torch.int16)) for x in repeats[1:])
    print(f"[3 decode_attention int8] five calls at length "
          f"{int(d8_args[3])} equal bit for bit {d8_repeat}")
    if not d8_repeat:
        raise AssertionError("decode_attention's int8 path differs between "
                             "calls")
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

    print(f"[4-4b] phases 3-4b {time.perf_counter() - t_run:.1f} s")

    # -- 4c. the LM serving path ---------------------------------------------
    t0 = time.perf_counter()
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
    print(f"[4c/4d] phase wall {time.perf_counter() - t0:.1f} s")

    # -- 4e. the noisy dense path --------------------------------------------
    t0 = time.perf_counter()
    noisy_launches, noisy_fields, noisy_wall = noisy_path(dev, corpora)
    print(f"[4e] phase wall {time.perf_counter() - t0:.1f} s")

    # -- 4f. the paper's pipeline -------------------------------------------
    t0 = time.perf_counter()
    pipeline = paper_pipeline(dev)
    pl_args = []    # (lanes, call, args) at the pipeline's shapes
    for call, args in zip(("screen", "deduce"), pipeline_round_args(dev)):
        for lanes in (1, args[0].shape[0]):
            lane_args = tuple(x[:lanes] for x in args[:5]) + (args[5],)
            check_union_deduce("4f union_deduce",
                               f"the sweep's round-1 {call}, {lanes} lanes",
                               lane_args)
            pl_args.append((lanes, call, lane_args))
    print(f"[4f] phase wall {time.perf_counter() - t0:.1f} s")

    # -- 4g. a universe past 46340 objects ----------------------------------
    t0 = time.perf_counter()
    large = large_universe(dev)
    print(f"[4g] phase wall {time.perf_counter() - t0:.1f} s")

    # -- 6, taken here: one call's device time by kernel --------------------
    # torch.profiler on the card drops device records for a while after a
    # profile taken with the card nearly full (phase 4p a profiles
    # moonshot's decode beside its 56 GB of weights), so these splits are
    # taken before the LM phases; they are printed under phase 6's tag
    wide_screen = large["screen_args"]
    print("[6 pair_scores] one call's device time by kernel: "
          + device_split(lambda: ps_kernel.pair_scores(*ps_args, THRESHOLD,
                                                       N_ROWS)))
    ud_split = device_split(lambda: ud_kernel.launch(*screen_args))
    print("[6 union_deduce] one call's device time by kernel: " + ud_split)
    if ud_split.count(" a call: ") != 1:
        raise AssertionError("union_deduce's launch runs more than its kernel")
    wide_split = device_split(lambda: ud_kernel.launch(*wide_screen))
    print("[6 union_deduce wide] one call's device time by kernel: "
          + wide_split)
    if wide_split.count(" a call: ") != 1:
        raise AssertionError("the wide union_deduce's launch runs more than "
                             "its kernel")
    print("[6 pair_scores_compact] one call's device time by kernel: "
          + device_split(lambda: ps_kernel.pair_scores_compact(
              *chunk_args, THRESHOLD, c_call, bn, bm)))
    print("[6 decode_attention] one call's device time by kernel: "
          + device_split(lambda: da_kernel.decode_attention(*da_args)))
    print("[6 decode_attention int8] one call's device time by kernel: "
          + device_split(lambda: da_kernel.decode_attention(*d8_args)))

    # -- 4h. asynchronous ID/NF serving on a latency-modelled crowd ---------
    t0 = time.perf_counter()
    async_run = async_path(dev)
    print(f"[4h] phase wall {time.perf_counter() - t0:.1f} s")

    # -- 4i. the service's crowd economics ----------------------------------
    econ = econ_path(dev, corpora)

    # -- 4j. streaming ingest -----------------------------------------------
    stream = streaming_path(dev, corpora, large["signatures_s"])
    s_launch = stream["launches"]

    # -- 4k. kill and restore on the card; 4l. the plan layer; 4m. training -
    import shutil
    import tempfile

    (ROOT / "build").mkdir(exist_ok=True)
    scratch = Path(tempfile.mkdtemp(prefix="chip_smoke_", dir=ROOT / "build"))
    try:
        t0 = time.perf_counter()
        recovery = recovery_path(dev, corpora, noisy_fields, noisy_wall,
                                 scratch)
        t_4k = time.perf_counter() - t0
        t0 = time.perf_counter()
        plan = plan_path(dev, corpora, scratch)
        print(f"[4k/4l] phase 4k {t_4k:.1f} s, phase 4l "
              f"{time.perf_counter() - t0:.1f} s")

        # -- 4m. training -----------------------------------------------
        t0 = time.perf_counter()
        train = train_path(dev, scratch)
        print(f"[4m] phase 4m {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    r_launch, p_launch = recovery["launches"], plan["launches"]

    # -- 4n. the LM stack's other families at full width --------------------
    t0 = time.perf_counter()
    fam = lm_families_path(dev)
    print(f"[4n] phase 4n {time.perf_counter() - t0:.1f} s")
    fam_launch = fam["launches"]

    # -- 4o. the SSM and hybrid families at full width -----------------------
    t0 = time.perf_counter()
    ssm = ssm_families_path(dev)
    print(f"[4o] phase 4o {time.perf_counter() - t0:.1f} s")
    ssm_launch = ssm["launches"]

    # -- 4p. the dry-run's cells against the card; moonshot at full width ---
    t0 = time.perf_counter()
    acct = accounting_path(dev)
    print(f"[4p] phase 4p {time.perf_counter() - t0:.1f} s")
    acct_launch = acct["launches"]

    # -- 4q. the (data, model) mesh of ranks on the card ---------------------
    mesh_run = mesh_path(dev, corpora)

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
    def ud_bytes_of(lanes, n, P, key_bytes=4):
        """Forest in and roots out; u, v, the mask and the keys in, the
        deduced labels out; the conflict flags out."""
        return lanes * (4 * n * 2 + P * (4 + 4 + 1 + key_bytes + 4) + 4)

    # the wide kernel at phase 4g's round-1 screen
    wide_B, wide_n = wide_screen[0].shape
    wide_P = wide_screen[1].shape[1]

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
    # the int8 path at the same shape and length: the int8 rows and their
    # two-byte scales up to length, q and o
    d8q, d8k, d8v, d8n, d8ks, d8vs = d8_args
    d8_len = int(d8n)
    d8_bytes = 2 * LM_LANES * d8_len * K * (hd * d8k.element_size()
                                            + d8ks.element_size()) \
        + 2 * d8q.numel() * d8q.element_size()
    d8_bound, d8_by = bound(4 * LM_LANES * H * hd * d8_len, d8_bytes,
                            d8q.dtype)
    sdpa_bf16_ms = cuda_ms(lambda: sdpa(
        dq[:, :, None], dk.transpose(1, 2), dv.transpose(1, 2),
        attn_mask=da_mask, enable_gqa=True))
    fam_flash = sum(v["flash_attention"] for v in fam_launch.values())
    fam_decode = sum(v["decode_attention"] for v in fam_launch.values())
    ssm_flash = sum(v["flash_attention"] for v in ssm_launch.values())
    ssm_decode = sum(v["decode_attention"] for v in ssm_launch.values())
    cell_launch = [v for k, v in acct_launch.items() if k != "moonshot"]
    cell_flash = sum(v["flash_attention"] for v in cell_launch)
    cell_decode = sum(v["decode_attention"] for v in cell_launch)

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
             "noisy_dense": noisy_launches["pair_scores"],
             "crowd_economics": econ["pair_scores"],
             "streaming": s_launch["dense"]["pair_scores"],
             "recovery": r_launch["pair_scores"],
             "plan": p_launch["pair_scores"],
             "mesh": mesh_run["launches"]["pair_scores"]},
         "mesh_by_rank": mesh_run["pair_scores_by_rank"],
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
         "launches_by_path": {
             "blocked": blocked_launches["pair_scores_compact"],
             "large_universe": large["launches"]["pair_scores_compact"],
             "streaming": s_launch["blocked"]["pair_scores_compact"],
             "recovery": r_launch["pair_scores_compact"]},
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
             "paper_pipeline": pipeline["launches"]["union_deduce"],
             "async_serving": async_run["launches"],
             "crowd_economics": econ["union_deduce"],
             "streaming": s_launch["dense"]["union_deduce"]
             + s_launch["pairs"]["union_deduce"]
             + s_launch["blocked"]["union_deduce"],
             "recovery": r_launch["union_deduce"],
             "plan": p_launch["union_deduce"],
             "mesh": mesh_run["launches"]["union_deduce"]},
         "crowd_economics_by_run": econ["union_deduce_by_run"],
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
        {"name": "union_deduce_wide", "route": "cuda",
         "source": "src/repro_torch/csrc/union_deduce.cu",
         "replaces": "src/repro/kernels/union_deduce/kernel.py:129",
         "launches": large["launches"]["union_deduce_wide"],
         "launches_by_path": {
             "large_universe": large["launches"]["union_deduce_wide"],
             "large_pairs": large["large_pairs_wide"],
             "streaming": s_launch["blocked"]["union_deduce_wide"]
             + s_launch["large_pairs_wide"],
             "recovery": r_launch["union_deduce_wide"],
             "recovery_after_restore": recovery["c"]["wide_after_restore"]},
         "max_abs_err": 0.0,
         "cluster": ud_plan.cluster,
         "shape": [wide_B, wide_n, wide_P],
         "ms": cuda_ms(lambda: ud_kernel.launch(*wide_screen)),
         "plain_ms": cuda_ms(lambda: union_deduce_ref(*wide_screen), 5),
         "bound_ms": 1e3 * ud_bytes_of(wide_B, wide_n, wide_P, 8)
         / PEAK_BYTES_PER_S,
         "bound_by": "bytes", "library_ms": None},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention_wgmma.cu",
         "source_f32": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:72",
         "launches": serving["launches"]["flash_attention"],
         "launches_by_path": {
             "lm_serving": serving["launches"]["flash_attention"],
             "lm_machine_phase": machine["launches"]["flash_attention"],
             "training": train["launches"],
             "lm_families": fam_flash,
             "ssm_hybrid": ssm_flash,
             "moonshot": acct_launch["moonshot"]["flash_attention"],
             "dryrun_cells": cell_flash},
         "max_abs_err": fa_err,
         "ms": cuda_ms(lambda: fa_kernel.flash_attention(fq, fk, fv)),
         "plain_ms": cuda_ms(lambda: mha_causal_ref(fq, fk, fv), 5),
         "bound_ms": fa_bound, "bound_by": fa_by,
         "library_ms": cuda_ms(lambda: sdpa(
             fq.transpose(1, 2), fk.transpose(1, 2), fv.transpose(1, 2),
             is_causal=True, enable_gqa=True)),
         "at_prefill_32k": acct["flash_prefill_32k"]},
        {"name": "decode_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/decode_attention.cu",
         "replaces": "src/repro/kernels/decode_attention/kernel.py:65",
         "launches": serving["launches"]["decode_attention"],
         "launches_by_path": {
             "lm_serving": serving["launches"]["decode_attention"],
             "lm_families": fam_decode,
             "ssm_hybrid": ssm_decode,
             "moonshot": acct_launch["moonshot"]["decode_attention"],
             "dryrun_cells": cell_decode},
         "splits": da_splits, "max_abs_err": da_err,
         "ms": cuda_ms(lambda: da_kernel.decode_attention(dq, dk, dv, dn)),
         "plain_ms": cuda_ms(lambda: decode_attention_ref(dq, dk, dv, dn)),
         "bound_ms": da_bound, "bound_by": da_by,
         "library_ms": sdpa_bf16_ms,
         "at_long_500k": ssm["decode_long"],
         "at_decode_32k": acct["decode_decode_32k"]},
        {"name": "decode_attention_int8", "route": "cuda",
         "source": "src/repro_torch/csrc/decode_attention.cu",
         "replaces": "src/repro/kernels/decode_attention/kernel.py:65",
         "launches": fam_launch["kv_quant"]["decode_attention_int8"],
         "max_abs_err": d8_err,
         "ms": cuda_ms(lambda: da_kernel.decode_attention(*d8_args)),
         "plain_ms": cuda_ms(lambda: decode_attention_ref(*d8_args)),
         "bound_ms": d8_bound, "bound_by": d8_by,
         # no one PyTorch call reads an int8 cache; SDPA over the bf16
         # cache at the same shape, for scale
         "library_ms": None, "sdpa_over_bf16_cache_ms": sdpa_bf16_ms},
    ]
    print(f"recorded, not measured here: flash_attention (8, 1491, 12, 64)"
          f" bf16 took {FLASH_MS_BEFORE} ms with the SIMT kernel"
          f" (PERF.md section 6, row 4; H100 80GB HBM3, 700 W)")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
