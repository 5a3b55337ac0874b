"""How far apart four runs of ``tests/test_torch_mesh_train_moe.py``'s cases
stand, two train steps each from the same f32 state and batches:

* ``pm``: the port's ``jit_train_step`` on gloo CPU ranks (rank 0's
  parameters; the worst rank's loss and ``grad_norm``);
* ``po``: the port's one-device ``make_train_step`` (under
  ``moe_impl="gspmd"`` for the all-to-all cases);
* ``rm``: the reference's ``jit_train_step`` on the forced host mesh;
* ``rj``: the reference's jitted one-device ``make_train_step`` (under
  ``moe_impl="gspmd"`` for the all-to-all cases).

For each case it prints the largest relative distance of the two losses,
of the two ``grad_norm``\\ s, and of the parameters (the worst leaf's
||delta|| / ||ref||) for pm-rm, po-rm, rj-rm and pm-po.  The test's bars
come from this table.

Run from the root of a checkout (about two minutes on 8 CPU cores)::

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/mesh_train_spread.py
"""
from __future__ import annotations

import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]


def reference_one_device(ins: dict, case: dict) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.configs import get
    from repro.train import train_step as TS
    from repro.train.optim import AdamWConfig

    cfg = get(case["arch"]).reduced().replace(
        **{**case["replace"], "moe_impl": "gspmd"})
    state = jax.tree.map(jnp.asarray, ins["states"][case["key"]])
    if case["compress"]:
        state["err"] = jax.tree.map(jnp.zeros_like, state["params"])
    step = jax.jit(TS.make_train_step(cfg, AdamWConfig(**ins["ocfg"]),
                                      case["mb"], case["compress"]))
    out = {"loss": [], "grad_norm": []}
    for b in ins["batches"][case["key"]]:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
    flat = jax.tree_util.tree_flatten_with_path(state["params"])[0]
    out["params"] = {"/".join(k.key for k in kp): np.asarray(v)
                     for kp, v in flat}
    return out


def main() -> int:
    import test_torch_mesh_train_moe as T

    ins = T.make_inputs()
    with tempfile.TemporaryDirectory() as tmp:
        ref, port = T.run_mesh_cases(ins, Path(tmp))

    def scalar(runs, key, want):
        return max(abs(a - b) / abs(b) for run in runs
                   for a, b in zip(run[key], want[key]))

    def params(got, want):
        return max(T._rel(got[p], want[p]) for p in want)

    for case in T.CASES:
        i = case["id"]
        ranks = [r["cases"][i] for r in port[tuple(case["shape"])]]
        po = next(r["one_device"][i] for r in port[tuple(case["shape"])]
                  if i in r["one_device"])
        rm = ref[i]
        rj = reference_one_device(ins, case)
        cells = []
        for key in ("loss", "grad_norm"):
            cells.append(" ".join(f"{s:.1e}" for s in (
                scalar(ranks, key, rm), scalar([po], key, rm),
                scalar([rj], key, rm), scalar(ranks, key, po))))
        cells.append(" ".join(f"{s:.1e}" for s in (
            params(ranks[0]["params"], rm["params"]),
            params(po["params"], rm["params"]),
            params(rj["params"], rm["params"]),
            params(ranks[0]["params"], po["params"]))))
        print(f"{i:32s} loss {cells[0]} | grad_norm {cells[1]} | "
              f"params {cells[2]}   (pm-rm po-rm rj-rm pm-po)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
