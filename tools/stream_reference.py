"""The reference's figures for ``chip_smoke.py`` phase 4j (b).

Runs every session of ``chip_smoke.STREAM_RUNS`` through the JAX package's
``JoinService`` on the CPU: the paper's datasets at the phase's threshold,
each split into ``STREAM_K`` arrival epochs by the reference's
``benchmarks/common.py::split_epochs`` (checked equal to the copy in
``chip_smoke.py``) and queued with ``submit_stream`` under the run's
options.  Prints each session's ``econ_figures`` as a Python literal to
paste into ``STREAM_RUNS``.

Run from the root of a checkout::

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/stream_reference.py \
        [--only <run tags>]
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402


def reference_epochs(ps, seed: int):
    """The reference's epochs of ``ps``, checked against the port's copy of
    the splitter on the same pairs."""
    from benchmarks.common import split_epochs

    from repro_torch.core.pairs import PairSet

    epochs = split_epochs(ps, cs.STREAM_K, seed)
    mine = cs.split_epochs(PairSet(ps.u, ps.v, ps.likelihood, ps.truth,
                                   ps.n_objects), cs.STREAM_K, seed)
    for e, m in zip(epochs, mine):
        for f in ("u", "v", "likelihood", "truth"):
            if not np.array_equal(getattr(e, f), getattr(m, f)):
                raise AssertionError(f"split_epochs copy differs in {f}")
        if e.n_objects != m.n_objects:
            raise AssertionError("split_epochs copy differs in n_objects")
    return epochs


def reference_runs(only=None) -> None:
    from repro.core import LatencyModel, NoisyCrowd, PerfectCrowd
    from repro.data.entities import make_paper_dataset, make_product_dataset
    from repro.serve.join_service import JoinService

    data = {"paper": make_paper_dataset(), "product": make_product_dataset()}

    def crowd(kind):
        return (PerfectCrowd() if kind == "perfect"
                else NoisyCrowd(**cs.ASYNC_NOISY))

    for tag, (names, svc_opts, sub_opts, kind, _) in cs.STREAM_RUNS.items():
        if only and tag not in only:
            continue
        opts = dict(svc_opts)
        if opts.pop("latency", False):
            opts["latency"] = LatencyModel(**cs.ASYNC_LATENCY)
        svc = JoinService(lanes=cs.ECON_LANES, **opts)
        rids = []
        for i, n in enumerate(names):
            ds = data[n]
            epochs = reference_epochs(ds.pairs.above(cs.ASYNC_TAU),
                                      cs.STREAM_SPLIT_SEED + i)
            rids.append(svc.submit_stream(
                epochs, crowd(kind),
                total_true_matches=ds.total_true_matches, **sub_opts))
        t0 = time.perf_counter()
        res = svc.run()
        print(f"# {tag}: {time.perf_counter() - t0:.1f} s", flush=True)
        for n, rid in zip(names, rids):
            print(f"{tag!r} {n!r}: {cs.econ_figures(res[rid])!r},",
                  flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--only", nargs="*", default=None,
                        help="run tags to compute")
    reference_runs(parser.parse_args().only)


if __name__ == "__main__":
    main()
