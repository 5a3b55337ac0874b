"""Quickstart on the PyTorch port: the crowdsourced join with transitive
relations, ``examples/quickstart.py``'s four steps with ``repro_torch``, and
a fifth that labels through the array engine on a device.

    PYTHONPATH=src python examples/torch_quickstart.py               # card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
from __future__ import annotations

import argparse

from repro_torch.core.crowd import NoisyCrowd, PerfectCrowd
from repro_torch.core.join import crowdsourced_join
from repro_torch.data.entities import make_paper_dataset


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="where the engine labeler runs: cuda (the default) "
                         "or cpu")
    args = ap.parse_args(argv)

    # 1) machine phase: candidate pairs + matching likelihoods (synthetic
    #    Cora-like dataset)
    ds = make_paper_dataset()
    candidates = ds.pairs.above(0.3)
    print(f"dataset: {ds.n_objects} records, {len(candidates)} candidate "
          f"pairs")

    # 2) human phase WITHOUT transitive relations: crowdsource everything
    baseline = crowdsourced_join(candidates, PerfectCrowd(), labeler="all")
    print(f"non-transitive: {baseline.n_crowdsourced} pairs, "
          f"{baseline.n_hits} HITs, {baseline.cost_cents/100:.2f}$")

    # 3) human phase WITH transitive relations (the paper): sort by
    #    likelihood, label in parallel, deduce the rest
    ours = crowdsourced_join(candidates, PerfectCrowd(), order="expected",
                             labeler="parallel")
    print(f"transitive:     {ours.n_crowdsourced} pairs, {ours.n_hits} HITs, "
          f"{ours.cost_cents/100:.2f}$ in {ours.n_iterations} parallel rounds "
          f"({1 - ours.n_crowdsourced/baseline.n_crowdsourced:.0%} saved)")

    # 4) with a noisy crowd (majority vote of 3), quality loss stays small
    noisy = crowdsourced_join(candidates, NoisyCrowd(error_rate=0.08),
                              order="expected", labeler="parallel",
                              total_true_matches=ds.total_true_matches)
    print(f"noisy crowd:    {noisy.quality.row()}")

    # 5) the same join through the array engine (priority-Borůvka frontier,
    #    union_deduce fold) on the device
    engine = crowdsourced_join(candidates, PerfectCrowd(), order="expected",
                               labeler="torch", device=args.device)
    print(f"engine:         {engine.n_crowdsourced} pairs in "
          f"{engine.n_iterations} rounds "
          f"({1 - engine.n_crowdsourced/baseline.n_crowdsourced:.0%} saved, "
          f"{engine.wall_seconds:.3f} s)")


if __name__ == "__main__":
    main()
