"""The reference's figures for ``chip_smoke.py`` phases 4k and 4l.

Runs, through the JAX package on the CPU, what those phases give the port:

* ``RECOVERY_RUNS``: each dataset of phase 4k (b) at ``ASYNC_TAU`` alone
  through ``JoinService(lanes=2, latency=LatencyModel(**ASYNC_LATENCY),
  **RECOVERY_SERVICE)`` under ``NoisyCrowd(**REQUERY_CROWD)`` with seed
  10 + k: the uninterrupted run (its run-loop passes counted), then a run
  checkpointed every tenth of them, killed after ``RECOVERY_KILL`` commits,
  restored and finished, which must equal it;
* ``RECOVERY_BENCH``: ``benchmarks/bench_join_service.py``'s recovery stage
  at 2 and 4 sessions;
* ``PLAN_RUNS``: ``benchmarks/bench_plan.py``'s three stages at
  ``PLAN_SIZES``' CI and full sizes.

Each is printed as a Python literal to paste into ``chip_smoke.py``.  Run
from the root of a checkout::

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/recovery_reference.py \\
        [--only paper product bench ci full]
"""
from __future__ import annotations

import argparse
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402


def recovery_runs(only=None) -> None:
    from repro.core import LatencyModel, NoisyCrowd
    from repro.data.entities import make_paper_dataset, make_product_dataset
    from repro.serve.join_service import JoinService, ServiceKilled

    data = {"paper": make_paper_dataset, "product": make_product_dataset}
    for k, name in enumerate(("paper", "product")):
        if only and name not in only:
            continue
        ds = data[name]()
        pairs = ds.pairs.above(cs.ASYNC_TAU)

        def service(**kw):
            svc = JoinService(lanes=cs.ASYNC_LANES,
                              latency=LatencyModel(**cs.ASYNC_LATENCY),
                              **cs.RECOVERY_SERVICE, **kw)
            crowd = NoisyCrowd(**dict(cs.REQUERY_CROWD,
                                      seed=cs.REQUERY_CROWD["seed"] + k))
            return svc, svc.submit(pairs, crowd,
                                   total_true_matches=ds.total_true_matches)

        tmp = tempfile.mkdtemp(prefix="recovery_reference_")
        try:
            # one commit at the first pass: the tick counter counts passes
            svc, rid = service(checkpoint_dir=f"{tmp}/count",
                               checkpoint_every=10 ** 9)
            t0 = time.perf_counter()
            base = svc.run()[rid]
            passes = svc._ckpt_tick
            every = max(1, passes // 10)
            print(f"# {name}: {time.perf_counter() - t0:.1f} s, {passes} "
                  f"passes", flush=True)
            svc, _ = service(checkpoint_dir=f"{tmp}/kill",
                             checkpoint_every=every)
            svc._crash_after_checkpoints = cs.RECOVERY_KILL
            try:
                svc.run()
                raise AssertionError(f"{name}: the run ended before the kill")
            except ServiceKilled:
                pass
            restored = JoinService.restore(f"{tmp}/kill")
            at_kill = restored.last_recovery["spent_cents"]
            rec = restored.run()[rid]
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        figures = cs.econ_figures(base)
        if cs.econ_figures(rec) != figures:
            raise AssertionError(f"{name}: the restored run differs")
        print(f"{name!r}: ({passes}, {every}, {at_kill!r}, {figures!r}),",
              flush=True)


def recovery_bench() -> None:
    from repro.core import NoisyCrowd
    from repro.data.entities import make_session_pairsets
    from repro.serve import join_service

    for n in (2, 4):
        tmp = tempfile.mkdtemp(prefix="recovery_bench_")
        try:
            got = cs.recovery_bench(join_service, NoisyCrowd,
                                    make_session_pairsets, n, tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        if not got["identical"] or \
                got["recovered_cents"] != got["restart_cents"]:
            raise AssertionError(f"bench recovery at {n} sessions: {got}")
        print(f"{n}: ({got['restart_cents']!r}, {got['at_kill']!r}),  "
              f"# saved {got['at_kill'] / got['restart_cents']!r}",
              flush=True)


def plan_runs(only=None) -> None:
    import repro.plan as ns

    def executor(cache, optimize_plans):
        return ns.PlanExecutor(cache=cache, optimize_plans=optimize_plans)

    for size in cs.PLAN_SIZES:
        if only and size not in only:
            continue
        t0 = time.perf_counter()
        figures, _ = cs.plan_bench(ns, executor, size)
        print(f"# plan {size}: {time.perf_counter() - t0:.1f} s", flush=True)
        print(f"{size!r}: {figures!r},", flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--only", nargs="*", default=None,
                        help="datasets (paper, product), 'bench' and plan "
                             "sizes (ci, full) to compute")
    args = parser.parse_args()
    only = args.only
    recovery_runs(only)
    if not only or "bench" in only:
        recovery_bench()
    plan_runs(only)


if __name__ == "__main__":
    main()
