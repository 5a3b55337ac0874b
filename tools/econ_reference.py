"""The reference's figures for ``chip_smoke.py`` phase 4i.

Runs every session of ``chip_smoke.ECON_RUNS`` and ``chip_smoke.WORKER_RUNS``
through the JAX package's ``JoinService`` on the CPU, with the options and
data the phase gives the port, and prints each session's ``econ_figures``
as a Python literal to paste into ``chip_smoke.py``.  With ``--dense`` it
also prints the cents phase 4's session 0 spends unbudgeted (the port on the
CPU: the machine phase of a (4096, 384) corpus), which ``ECON_DENSE_BUDGET``
halves.

Run from the root of a checkout::

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/econ_reference.py [--dense]
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402


def reference_runs(only=None) -> None:
    from repro.core import CostModel, LatencyModel, NoisyCrowd, PerfectCrowd
    from repro.data.entities import make_paper_dataset, make_product_dataset
    from repro.serve.join_service import JoinService

    data = {"paper": make_paper_dataset(), "product": make_product_dataset()}

    def crowd(kind):
        if kind == "perfect":
            return PerfectCrowd()
        return NoisyCrowd(**cs.REQUERY_CROWD)

    for tag, (names, svc_opts, req_opts, kind, _) in cs.ECON_RUNS.items():
        if only and tag not in only:
            continue
        opts = dict(svc_opts)
        if opts.pop("latency", False):
            opts["latency"] = LatencyModel(**cs.ASYNC_LATENCY)
        svc = JoinService(lanes=cs.ECON_LANES, **opts)
        rids = [svc.submit(data[n].pairs.above(cs.ECON_TAU), crowd(kind),
                           total_true_matches=data[n].total_true_matches,
                           **req_opts) for n in names]
        t0 = time.perf_counter()
        res = svc.run()
        print(f"# {tag}: {time.perf_counter() - t0:.1f} s", flush=True)
        for n, rid in zip(names, rids):
            print(f"{tag!r} {n!r}: {cs.econ_figures(res[rid])!r},",
                  flush=True)

    if only and "workers" not in only:
        return
    ds = data["paper"]
    pairs = ds.pairs.above(cs.ECON_TAU)
    cost = CostModel()
    quantum = cost.cents_per_assignment / cost.pairs_per_hit
    for name, (opts, _) in cs.WORKER_RUNS.items():
        svc = JoinService(lanes=1, **opts)
        rid = svc.submit(pairs, NoisyCrowd(**cs.WORKER_CROWD),
                         cost_per_assignment=quantum,
                         total_true_matches=ds.total_true_matches)
        t0 = time.perf_counter()
        r = svc.run()[rid]
        print(f"# workers {name}: {time.perf_counter() - t0:.1f} s, cents "
              f"a resolved pair {r.n_spent_cents / len(pairs)!r}", flush=True)
        print(f"{name!r}: {cs.econ_figures(r)!r},", flush=True)


def dense_session_cents() -> None:
    import torch

    from repro_torch.convert import embeddings_from_numpy
    from repro_torch.core.crowd import PerfectCrowd
    from repro_torch.serve.join_service import JoinService

    dev = torch.device("cpu")
    ids_a, ea, ids_b, eb = cs.make_corpus(cs.SEED, cs.N_ROWS, cs.DIM)
    svc = JoinService(lanes=1, device=dev)
    rid = svc.submit_embeddings(
        embeddings_from_numpy(ea, dev), embeddings_from_numpy(eb, dev),
        cs.THRESHOLD, crowd=PerfectCrowd(),
        truth_fn=lambda r, c: ids_a[r] == ids_b[c])
    res = svc.run()[rid]
    print(f"# phase 4 session 0: P {len(res.labels)} crowdsourced "
          f"{res.n_crowdsourced} spent {res.n_spent_cents!r} cents")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--dense", action="store_true")
    parser.add_argument("--only", nargs="*", default=None,
                        help="run tags (and 'workers') to compute")
    args = parser.parse_args()
    if args.dense:
        dense_session_cents()
    reference_runs(args.only)


if __name__ == "__main__":
    main()
