"""Scale-out join pipeline on the PyTorch port (DESIGN.md §7, §8):
``examples/sharded_join.py`` with ``repro_torch``, embeddings in, labels out.

The machine phase runs on a (data, model) mesh of ranks
(``repro_torch.launch.mesh.spawn``: one process a rank, gloo between ranks
on the CPU or sharing a card, NCCL with a card a rank): each rank scores its
block of the grid with the pair-score kernel and the candidates are gathered
to every rank.  The human phase then runs in every rank over the same
candidates, through the batched crowd gateway, two-lane round-barrier
serving, the blocked (LSH) machine phase, and asynchronous instant-decision
/ non-matching-first serving against a latency-modelled crowd.  Every rank
must print the same rows, and the rows are the same on every mesh: only the
first line, the mesh's, differs between ``--mesh 1x1`` and ``--mesh 4x2``.

    PYTHONPATH=src python examples/torch_sharded_join.py                # card
    PYTHONPATH=src python examples/torch_sharded_join.py --device cpu --mesh 4x2
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core.crowd import LatencyModel, NoisyCrowd, PerfectCrowd
from repro_torch.kernels.pair_scores.blocking import BlockingConfig
from repro_torch.launch.mesh import spawn
from repro_torch.serve.join_service import JoinService


def pipeline(mesh, device=None) -> list:
    """The example's rows on ``mesh`` (``None``: one device on ``device``);
    on a mesh, every rank's rows, checked equal."""
    dev = mesh.device if mesh is not None else device
    rng = np.random.default_rng(0)
    # two record sets sharing 64 ground-truth entities, embedded with noise
    n_ent, D = 64, 32
    cents = rng.normal(size=(n_ent, D))
    a_ids = rng.integers(0, n_ent, 300)
    b_ids = rng.integers(0, n_ent, 280)
    emb_a = torch.from_numpy((cents[a_ids] + 0.6 * rng.normal(
        size=(300, D))).astype(np.float32)).to(dev)
    emb_b = torch.from_numpy((cents[b_ids] + 0.6 * rng.normal(
        size=(280, D))).astype(np.float32)).to(dev)
    shape = dict(zip(mesh.mesh_dim_names, mesh.shape)) if mesh is not None \
        else {"data": 1, "model": 1}
    lines = [f"mesh: {shape}"]

    def truth_fn(r, c):
        return a_ids[r] == b_ids[c]

    # -- round-barrier serving: lanes advance in lockstep engine rounds -----
    svc = JoinService(lanes=2, device=dev)
    r1 = svc.submit_embeddings(emb_a, emb_b, 0.55, mesh,
                               crowd=PerfectCrowd(), truth_fn=truth_fn)
    r2 = svc.submit_embeddings(emb_a, emb_b, 0.7, mesh,
                               crowd=NoisyCrowd(error_rate=0.08),
                               truth_fn=truth_fn)
    results = svc.run()
    for rid, tag in ((r1, "tau=0.55 perfect"), (r2, "tau=0.70 noisy  ")):
        r = results[rid]
        lines.append(f"{tag}: {len(r.labels)} candidates, "
                     f"{r.n_crowdsourced} crowdsourced + {r.n_deduced} "
                     f"deduced in {r.n_rounds} rounds — {r.quality.row()}")

    # -- blocked machine phase (DESIGN.md §12): on each rank's device -------
    cfg = BlockingConfig.for_recall(0.95, threshold=0.7, n_bits=5)
    svc_b = JoinService(lanes=1, device=dev)
    rb = svc_b.submit_embeddings(emb_a, emb_b, 0.7, mesh,
                                 crowd=PerfectCrowd(), truth_fn=truth_fn,
                                 blocking=cfg)
    r = svc_b.run()[rb]
    lines.append(f"blocked tau=0.70 ({cfg.n_tables} tables): "
                 f"{len(r.labels)} candidates, {r.n_crowdsourced} "
                 f"crowdsourced + {r.n_deduced} deduced — {r.quality.row()}")

    # -- async ID/NF against the round barrier on a simulated platform ------
    def latency():
        return LatencyModel(n_workers=8, mean_minutes=30.0, seed=7)

    sim_minutes = {}
    for name, kwargs in (("round barrier", dict(async_mode=False)),
                         ("async id+nf ", dict(async_mode=True, nf=True))):
        sim = JoinService(lanes=2, latency=latency(), device=dev, **kwargs)
        rids = [sim.submit_embeddings(emb_a, emb_b, 0.55, mesh,
                                      crowd=PerfectCrowd(),
                                      truth_fn=truth_fn)]
        res = sim.run()
        sim_minutes[name] = max(res[r].sim_minutes for r in rids)
        lines.append(f"{name}: workload done in {sim_minutes[name]:.0f} "
                     "simulated min")
    speedup = sim_minutes["round barrier"] / sim_minutes["async id+nf "]
    lines.append(f"async gateway speedup: {speedup:.2f}x")
    if mesh is not None:
        import torch.distributed as dist

        every = [None] * mesh.size
        dist.all_gather_object(every, lines)
        if any(other != lines for other in every):
            raise RuntimeError("the mesh's ranks printed different rows")
    return lines


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="where every rank runs: cuda (the default) or cpu")
    ap.add_argument("--mesh", default="1x1",
                    help="DATAxMODEL ranks, e.g. 4x2 (1x1: one device, no "
                         "process group)")
    args = ap.parse_args(argv)
    data, model = (int(n) for n in args.mesh.split("x"))
    if (data, model) == (1, 1):
        from repro_torch.device import pick_device

        lines = pipeline(None, pick_device(args.device))
    else:
        lines = spawn(pipeline, data, model, device=args.device)
    for line in lines:
        print(line)
    return lines


if __name__ == "__main__":
    main()
