"""Roofline analysis over the H100 accounting records
(:mod:`repro_torch.launch.dryrun`): the port's counterpart of the JAX
package's ``launch/roofline.py``, with one NVIDIA H100 SXM in place of the
TPU v5e pod.

Terms per (arch, shape) cell on one card, from the peaks of NVIDIA's data
sheet for the H100 SXM at its 700 W limit (peaks, not measurements):

  compute    = FLOPs / 989e12       (bf16 dense, tensor cores)
  memory     = bytes / 3.35e12      (HBM3)
  collective = collective bytes / 450e9   (NVLink 4, per direction)

The FLOPs and bytes are the accounting's per-layer decomposition
(outer + L x layer [+ shared] + the optimizer's and the kernels' analytic
costs), one rank's on a mesh.  The collective bytes are the bytes one
step moves from the rank, counted by the collectives of
``repro_torch.launch.mesh`` as the dry-run traces the step (the
accounting's ``collectives``; 0 on one card); NVLink's rate stands for
every link, so a mesh wider than one NVLink domain reads optimistic.  The
roofline fraction is the reference's:

  frac = (MODEL_FLOPS / devices / PEAK_FLOPS) / max(terms)

and for decode shapes the MBU-style must-read bytes (active parameters in
bf16 and the KV cache, read once) over the same bound.  ``python -m
repro_torch.launch.roofline`` prints the table and the hillclimb picks;
:func:`measured_fraction` sets a measured time beside the bound.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, List, Optional

PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
LINK_BW = 450e9

# the analytic kernel entries of an accounting record: the flash kernel's
# (the reference's ``flash_kernel``) and the decode kernel's
KERNEL_KEYS = ("flash_kernel", "decode_kernel")


def cell_terms(rec: dict) -> Optional[dict]:
    """The roofline terms of one accounting record (None for a skipped or
    failed cell), with the reference's keys."""
    if rec.get("status") != "ok" or "accounting" not in rec:
        return None
    acc = rec["accounting"]
    L = acc["n_layers"]
    scale = acc.get("layer_scale", 1.0)
    lay = acc["layer"]
    f = lay["flops"] * L * scale
    b = lay["bytes"] * L * scale
    c = lay["collectives"]["total"] * L * scale
    if "shared" in acc:
        ns = acc.get("n_shared", 0)
        f += acc["shared"]["flops"] * ns
        b += acc["shared"]["bytes"] * ns
        c += acc["shared"]["collectives"]["total"] * ns
    f += acc["outer"]["flops"]
    b += acc["outer"]["bytes"]
    c += acc["outer"]["collectives"]["total"]
    if "collectives" in acc:     # the whole step's, on a mesh
        c = acc["collectives"]["total"]
    f += acc.get("optimizer_flops_analytic", 0.0)
    for key in KERNEL_KEYS:
        if key in acc:
            f += acc[key]["flops"]
            b += acc[key]["bytes"]
    n_dev = rec["n_devices"]
    model_flops_dev = rec["model_flops"] / n_dev
    terms = {
        "compute_s": f / PEAK_FLOPS,
        "memory_s": b / HBM_BW,
        "collective_s": c / LINK_BW,
    }
    dominant = max(terms, key=terms.get)
    shape_kind = ("decode" if rec["shape"].startswith(("decode", "long"))
                  else "other")
    if shape_kind == "decode":
        # decode is bandwidth-limited by construction: the roofline fraction
        # is MBU-style — must-read bytes (params + cache once) / bound time
        ideal_bytes = (2.0 * rec.get("n_active_params", rec["n_params"]) +
                       rec.get("cache_bytes", 0.0)) / n_dev
        if "cache_bytes" not in rec:
            # estimate cache bytes from memory_analysis arguments
            ideal_bytes = rec.get("memory", {}).get("argument_bytes", 0.0)
        frac = (ideal_bytes / HBM_BW) / max(max(terms.values()), 1e-12)
    else:
        frac = (model_flops_dev / PEAK_FLOPS) / max(max(terms.values()), 1e-12)
    return {
        "arch": rec["arch"],
        "shape": rec["shape"],
        "rules": rec.get("rules", "fsdp_tp"),
        "hlo_flops_dev": f,
        "hlo_bytes_dev": b,
        "coll_bytes_dev": c,
        **terms,
        "dominant": dominant.replace("_s", ""),
        "model_flops": rec["model_flops"],
        "useful_ratio": model_flops_dev / max(f, 1e-9),
        "roofline_frac": frac,
        "mem_gb_dev": (rec.get("memory", {}).get("temp_bytes", 0)
                       + rec.get("memory", {}).get("argument_bytes", 0)) / 1e9,
        "fallbacks": rec.get("sharding_fallbacks", []),
    }


def measured_fraction(terms: dict, seconds: float) -> float:
    """The bound, ``max(compute_s, memory_s, collective_s)``, over a
    measured time of the same work: 1.0 at the roofline, below it slower.
    Above 1 the measurement beat the bound, so the accounting over-counts."""
    bound = max(terms["compute_s"], terms["memory_s"], terms["collective_s"])
    return bound / seconds


def load_cells(art_dir: Path, tag: str = "", mesh: str = "h100x1"
               ) -> List[dict]:
    """The terms of every ``<arch>__<shape>__<mesh>[__<rules>]<tag>.json``
    record in ``art_dir``, skipped cells as ``{"skipped": reason}``."""
    cells = []
    rules = "" if mesh == "h100x1" else "__*"
    for p in sorted(art_dir.glob(f"*__{mesh}{rules}{tag}.json")):
        rec = json.loads(p.read_text())
        t = cell_terms(rec)
        if t:
            cells.append(t)
        elif rec.get("status", "").startswith("skipped"):
            cells.append({"arch": rec["arch"], "shape": rec["shape"],
                          "rules": rec.get("rules", "fsdp_tp"),
                          "skipped": rec["status"]})
    return cells


def markdown_table(cells: List[dict]) -> str:
    hdr = ("| arch | shape | compute (ms) | memory (ms) | collective (ms) | "
           "dominant | useful FLOP ratio | roofline frac | fallbacks |\n"
           "|---|---|---|---|---|---|---|---|---|")
    rows = [hdr]
    for c in cells:
        if "skipped" in c:
            rows.append(f"| {c['arch']} | {c['shape']} | — | — | — | "
                        f"{c['skipped'].split('(')[0]} | — | — | — |")
            continue
        rows.append(
            f"| {c['arch']} | {c['shape']} | {c['compute_s']*1e3:.1f} | "
            f"{c['memory_s']*1e3:.1f} | {c['collective_s']*1e3:.1f} | "
            f"**{c['dominant']}** | {c['useful_ratio']:.2f} | "
            f"{c['roofline_frac']:.1%} | "
            f"{', '.join(c['fallbacks']) or '—'} |")
    return "\n".join(rows)


def pick_hillclimb(cells: List[dict]) -> Dict[str, dict]:
    live = [c for c in cells if "skipped" not in c]
    worst = min(live, key=lambda c: c["roofline_frac"])
    coll = max(live, key=lambda c: c["collective_s"] /
               max(c["compute_s"] + c["memory_s"], 1e-12))
    # representative of the paper's technique: the scorer serving shape —
    # batched prefill is what the machine phase of the join pipeline runs
    reps = [c for c in live if c["shape"] == "prefill_32k"]
    rep = max(reps, key=lambda c: c["model_flops"]) if reps else live[0]
    return {"worst_roofline": worst, "most_collective_bound": coll,
            "paper_representative": rep}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--artifacts", default="build/dryrun_h100")
    ap.add_argument("--tag", default="")
    ap.add_argument("--mesh", default="h100x1",
                    help="the records' mesh tag, e.g. h100x16x16")
    args = ap.parse_args(argv)
    cells = load_cells(Path(args.artifacts), args.tag, args.mesh)
    print(markdown_table(cells))
    print()
    picks = pick_hillclimb(cells)
    for k, c in picks.items():
        print(f"{k}: {c['arch']} x {c['shape']} "
              f"(dominant={c['dominant']}, frac={c['roofline_frac']:.1%})")


if __name__ == "__main__":
    main()
