"""The JAX package's side of ``tests/test_torch_dryrun_mesh.py``, run as a
subprocess from the repository root:

    python tests/torch_dryrun_mesh_reference.py OUT.pkl

It forces 256 host devices (before JAX is imported) and, for every arch x
shape on the reference's 16 x 16 production mesh, computes the sharding
fallbacks as ``launch/dryrun.py::lower_full`` records them (its
``sharding_tree`` calls over the parameters, and over the cache for
prefill and decode, at the shape's global batch and length), without
lowering or compiling, and the parameter bytes one device holds.  It
pickles ``{(arch, shape): (fallbacks or None, parameter bytes)}`` to
OUT.pkl.  pytest does not collect it.
"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=256"
import math
import pickle
import sys

sys.path.insert(0, "src")
import jax

from repro.configs import ARCHS, get
from repro.configs.shapes import SHAPES, shape_applicable
from repro.launch.mesh import make_production_mesh
from repro.models import model as M
from repro.sharding import sharding_tree

mesh = make_production_mesh()
out = {}
for arch in ARCHS:
    cfg = get(arch)
    params = M.abstract_params(cfg)
    blocks = sharding_tree(mesh, M.param_axes(cfg), params, "fsdp_tp")
    nbytes = sum(math.prod(s.shard_shape(p.shape)) * p.dtype.itemsize
                 for s, p in zip(jax.tree.leaves(blocks),
                                 jax.tree.leaves(params)))
    for shape_name, shape in SHAPES.items():
        if shape_applicable(cfg, shape_name):
            out[arch, shape_name] = (None, nbytes)
            continue
        fallbacks = []
        sharding_tree(mesh, M.param_axes(cfg), params, "fsdp_tp", fallbacks)
        if shape.kind != "train":
            cache = jax.eval_shape(lambda: M.make_cache(
                cfg, shape.global_batch, shape.seq_len))
            sharding_tree(mesh, M.cache_axes(cfg), cache, "fsdp_tp",
                          fallbacks)
        out[arch, shape_name] = (
            [f"{n}:dim{d}%{e}" for n, s, d, e in fallbacks], nbytes)
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
print("REF_OK")
