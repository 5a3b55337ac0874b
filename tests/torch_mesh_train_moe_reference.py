"""The JAX package's side of ``tests/test_torch_mesh_train_moe.py``, run as
a subprocess from the repository root:

    python tests/torch_mesh_train_moe_reference.py IN.pkl OUT.pkl

It forces 8 host devices (before JAX is imported), reads the cases and
their inputs from IN.pkl (each case's config, mesh shape, rule set,
microbatches and compression; each config's f32 train state and two
batches as numpy), and runs the reference's ``jit_train_step`` for two
steps on each case's host mesh, with the mesh set as the current one.  It
pickles ``{case id: {"loss", "grad_norm", "params"}}`` to OUT.pkl, or
``{"error": ...}`` for a case the reference cannot run.  pytest does not
collect it.
"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import pickle
import sys
import traceback

sys.path.insert(0, "src")
import jax
import jax.numpy as jnp
import numpy as np
from repro.configs import get
from repro.launch.mesh import make_host_mesh
from repro.sharding import set_current_mesh
from repro.train import train_step as TS
from repro.train.optim import AdamWConfig


def paths(tree):
    return {"/".join(k.key for k in kp): v
            for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def run(case, ins):
    cfg = get(case["arch"]).reduced().replace(**case["replace"])
    mesh = make_host_mesh(*case["shape"])
    state = jax.tree.map(jnp.asarray, ins["states"][case["key"]])
    if case["compress"]:
        state["err"] = jax.tree.map(jnp.zeros_like, state["params"])
    batches = ins["batches"][case["key"]]
    specs = {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
             for k, v in batches[0].items()}
    set_current_mesh(mesh, case["rules"])
    try:
        step, s_shard, _ = TS.jit_train_step(
            cfg, AdamWConfig(**ins["ocfg"]), mesh,
            jax.eval_shape(lambda: state), specs, case["rules"], case["mb"],
            case["compress"])
        state = jax.tree.map(jax.device_put, state, s_shard)
        losses, norms = [], []
        for b in batches:
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    finally:
        set_current_mesh(None)
    return {"loss": losses, "grad_norm": norms,
            "params": {p: np.asarray(v)
                       for p, v in paths(state["params"]).items()}}


def main(in_path, out_path):
    with open(in_path, "rb") as f:     # written by the test process
        ins = pickle.load(f)
    out = {}
    for case in ins["cases"]:
        try:
            out[case["id"]] = run(case, ins)
        except Exception as e:      # recorded: the test names the error
            out[case["id"]] = {"error": f"{type(e).__name__}: {e}",
                               "traceback": traceback.format_exc()}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
    print("REF_OK")


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
