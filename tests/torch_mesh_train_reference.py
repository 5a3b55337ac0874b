"""The JAX package's side of ``tests/test_torch_mesh_train.py``, run as a
subprocess from the repository root:

    python tests/torch_mesh_train_reference.py OUT.pkl REF_CKPT_DIR

It forces 8 host devices (before JAX is imported), runs the reference's
``jit_train_step`` on the 4 x 2 and 2 x 2 host meshes (the reduced
``paper-scorer`` with f32 parameters, 2 steps, one microbatch, and two
with int8 compression), records each state leaf's
``NamedSharding.devices_indices_map`` blocks by mesh coordinate, writes a
checkpoint of its 4 x 2 state (bf16 parameters) to REF_CKPT_DIR, and
pickles (inputs, results) to OUT.pkl.  pytest does not collect it.
"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import pickle
import sys

sys.path.insert(0, "src")
import jax
import jax.numpy as jnp
import numpy as np
from repro.configs import get
from repro.launch.mesh import make_host_mesh
from repro.sharding import sharding_tree
from repro.train import train_step as TS
from repro.train.checkpoint import CheckpointManager
from repro.train.optim import AdamWConfig

out_path, ref_dir = sys.argv[1], sys.argv[2]
cfg = get("paper-scorer").reduced()
OCFG = dict(lr=3e-3, warmup_steps=1, total_steps=10)
CASES = [(1, False), (2, True)]
B, S = 16, 32
rng = np.random.default_rng(7)
batches = []
for _ in range(2):
    toks = rng.integers(2, cfg.vocab, size=(B, S + 1)).astype(np.int32)
    tgt = toks[:, 1:].copy()
    tgt[:, -1] = -1
    tgt[rng.random((B, S)) < 0.1] = -1
    batches.append({"tokens": toks[:, :-1].copy(), "targets": tgt})

def paths(tree):
    return {"/".join(k.key for k in kp): v
            for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

state0 = TS.init_state(cfg, jax.random.PRNGKey(0), True)
state0["params"] = jax.tree.map(lambda x: x.astype(jnp.float32), state0["params"])
state0["err"] = jax.tree.map(lambda x: jnp.zeros(x.shape, jnp.float32), state0["params"])
np_state = jax.tree.map(np.asarray, {k: v for k, v in state0.items() if k != "err"})
zeros = jax.tree.map(np.asarray, state0["err"])
specs = {k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in batches[0].items()}
ins = {"state": np_state, "zeros": zeros, "batches": batches, "ocfg": OCFG,
       "cases": CASES, "slices": {}}
ref = {}
for shape in ((4, 2), (2, 2)):
    mesh = make_host_mesh(*shape)
    full_shapes = jax.eval_shape(lambda: state0)
    sh = sharding_tree(mesh, TS.state_axes(cfg, True), full_shapes, "fsdp_tp")
    sl = {}
    for path, s in paths(sh).items():
        shp = paths(full_shapes)[path].shape
        sl[path] = {}
        for dev, idx in s.devices_indices_map(shp).items():
            pos = tuple(int(i) for i in np.argwhere(mesh.devices == dev)[0])
            sl[path][pos] = [(x.start or 0, shp[d] if x.stop is None else x.stop)
                             for d, x in enumerate(idx)]
    ins["slices"][shape] = sl
    for mb, comp in CASES:
        st = {k: v for k, v in state0.items() if comp or k != "err"}
        st_shapes = jax.eval_shape(lambda: st)
        step, s_shard, b_shard = TS.jit_train_step(
            cfg, AdamWConfig(**OCFG), mesh, st_shapes, specs, "fsdp_tp", mb, comp)
        st = jax.tree.map(lambda a, s: jax.device_put(a, s), st, s_shard)
        losses, norms = [], []
        for b in batches:
            st, m = step(st, {k: jnp.asarray(v) for k, v in b.items()})
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        ref[(shape, mb, comp)] = {"loss": losses, "grad_norm": norms,
            "params": {p: np.asarray(v) for p, v in paths(st["params"]).items()}}

# the reference's checkpoint from its 4x2 state (bf16 parameters)
mesh = make_host_mesh(4, 2)
st = TS.init_state(cfg, jax.random.PRNGKey(1))
sh = sharding_tree(mesh, TS.state_axes(cfg), jax.eval_shape(lambda: st))
CheckpointManager(ref_dir).save(0, jax.tree.map(lambda a, s: jax.device_put(a, s), st, sh))
with open(out_path, "wb") as f:
    pickle.dump((ins, ref), f)
print("REF_OK")
