"""End-to-end hybrid human-machine join on the PyTorch port:
``examples/crowdsourced_join.py`` with ``repro_torch``.  The paper's full
pipeline with a real machine phase: an LM scorer embeds the records on the
card (the flash-attention kernel in its backbone), the ``pair_scores``
kernel produces the likelihood matrix, and the transitive labeling
framework drives a simulated AMT deployment, then the join service
(per-worker reliability, cluster tasks) and the wall-clock simulators.

    PYTHONPATH=src python examples/torch_crowdsourced_join.py [--records 300]
    PYTHONPATH=src python examples/torch_crowdsourced_join.py --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get
from repro_torch.core import (CostModel, LatencyModel, NoisyCrowd, PairSet,
                              PerfectCrowd, crowdsourced_join, get_order,
                              simulate_wallclock_parallel_id,
                              simulate_wallclock_sequential)
from repro_torch.data.entities import make_product_dataset
from repro_torch.device import pick_device
from repro_torch.models.model import init_params
from repro_torch.serve.engine import score_pairs_with_lm
from repro_torch.serve.join_service import JoinService


def main(argv=None, model=None, likelihood=None) -> None:
    """``model``: the reduced ``paper-scorer`` to score with (by default one
    drawn from a seeded generator on the device); ``likelihood``: the LM's
    (records a, records b) likelihood matrix to use in place of scoring."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--records", type=int, default=256)
    ap.add_argument("--threshold", type=float, default=0.62)
    ap.add_argument("--device", default=None,
                    help="where the scorer and the service run: cuda (the "
                         "default) or cpu")
    args = ap.parse_args(argv)
    dev = pick_device(args.device)

    # ---- records: bipartite product catalogs ------------------------------
    ds = make_product_dataset()
    n_a = min(args.records, 1081)
    n_b = min(args.records, 1092)
    texts_a = ds.records[:n_a]
    texts_b = ds.records[1081:1081 + n_b]
    ents_a = ds.entity_of[:n_a]
    ents_b = ds.entity_of[1081:1081 + n_b]

    # ---- machine phase: LM embeddings -> pair_scores kernel ---------------
    cfg = get("paper-scorer").reduced()
    if model is None:
        model = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
    t0 = time.time()
    lik = score_pairs_with_lm(cfg, model, texts_a, texts_b) \
        if likelihood is None else np.asarray(likelihood, np.float32)
    print(f"[machine] scored {n_a}x{n_b} pairs with the LM + pair_scores "
          f"kernel in {time.time()-t0:.1f}s")

    # hash-tokenized random-init embeddings are weak scorers; blend with the
    # dataset's calibrated likelihood to emulate a TRAINED scorer (the paper
    # takes machine likelihoods as given from [25])
    iu, ju = np.meshgrid(np.arange(n_a), np.arange(n_b), indexing="ij")
    base = np.zeros((n_a, n_b), np.float32)
    truth = ents_a[iu] == ents_b[ju]
    rng = np.random.default_rng(0)
    base[truth] = rng.beta(3.2, 2.2, size=int(truth.sum()))
    base[~truth] = rng.beta(1.0, 16.0, size=int((~truth).sum()))
    lik = 0.3 * lik + 0.7 * base

    keep = lik >= args.threshold
    cand = PairSet(iu[keep].astype(np.int32),
                   (ju[keep] + n_a).astype(np.int32),
                   lik[keep].astype(np.float32),
                   truth[keep], n_objects=n_a + n_b)
    print(f"[machine] {len(cand)} candidates above {args.threshold} "
          f"({int(cand.truth.sum())} true matches)")

    # ---- human phase: transitive parallel labeling on simulated AMT -------
    res = crowdsourced_join(cand, NoisyCrowd(error_rate=0.08),
                            order="expected", labeler="parallel",
                            total_true_matches=int(truth.sum()))
    print(f"[human]   crowdsourced {res.n_crowdsourced}/{len(cand)} pairs in "
          f"{res.n_iterations} rounds -> {res.n_hits} HITs, "
          f"{res.cost_cents/100:.2f}$")
    if res.quality:
        print(f"[quality] {res.quality.row()}")

    # ---- §15 serving: per-worker reliability + cluster tasks --------------
    # the same candidates through the serving layer, over a heterogeneous
    # worker pool: EM aggregation learns who to trust, and mixed scheduling
    # posts multi-pair cluster tasks whenever they beat the pair rate
    def pool():
        return NoisyCrowd(error_rate=0.1, n_assignments=3, seed=1,
                          n_workers=25, worker_concentration=3.0,
                          qualification=False)

    for tag, kw in (("majority pairs", {}),
                    ("em + clusters", {"aggregation": "em",
                                       "cluster_tasks": True})):
        svc = JoinService(lanes=1, device=dev, **kw)
        rid = svc.submit(cand, pool(), total_true_matches=int(truth.sum()))
        r = svc.run()[rid]
        print(f"[serve]   {tag:14s} F={r.quality.f_measure:.3f} "
              f"spent={r.n_spent_cents:.0f}c "
              f"cluster_tasks={r.n_cluster_tasks} "
              f"cluster_pairs={r.n_cluster_pairs}")

    # ---- wall-clock: Parallel(ID) vs Non-Parallel on the AMT simulator ----
    order = get_order(cand, "expected")
    cost, lat = CostModel(), LatencyModel(n_workers=20)
    par = simulate_wallclock_parallel_id(cand, order, PerfectCrowd(), cost,
                                         lat)
    seq_h = simulate_wallclock_sequential(par.hits, cost, lat)
    print(f"[latency] Non-Parallel {seq_h:.1f}h vs Parallel(ID) "
          f"{par.hours:.1f}h ({seq_h/max(par.hours, 1e-9):.1f}x)")


if __name__ == "__main__":
    main()
