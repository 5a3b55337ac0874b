"""The port's mesh (``repro_torch.launch.mesh``) and sharding rules
(``repro_torch.sharding``) on the CPU.

* ``spec_for`` and its fallbacks equal the reference's for every arch's
  parameter axes and shapes, under every rule set, on 4 x 2, 2 x 4,
  16 x 16 and 2 x 16 x 16 meshes.  The reference's ``spec_for`` reads only
  a mesh's ``axis_names`` and ``devices.shape``, so it gets a stand-in
  with those two (no forced devices); the port's an ``AbstractMesh``.
* The launcher's contract: rank 0's value comes back; a raising rank fails
  the call and carries its traceback; a timeout fails the call; a world
  size that does not match ``make_host_mesh`` is refused; a mesh asked for
  on the card without one raises; the backend is chosen from the arguments
  (gloo on the CPU and for ranks sharing a card, NCCL for a card a rank)
  and shown in the mesh's repr.
* The collectives on 8 gloo ranks (4 x 2): values in rank order and the
  gradients of the SPMD reading (``launch/mesh.py``'s docstring), a bf16
  gather included.

The rank bodies are ``tests/torch_mesh_ranks.py``.
"""
import types

import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from repro import sharding as J
from repro.configs import ARCHS as JAX_ARCHS
from repro.models import model as JM
from repro_torch import sharding as S
from repro_torch.configs import ARCHS, get
from repro_torch.launch import mesh as M
from repro_torch.models import model as TM

MESHES = {"4x2": (("data", "model"), (4, 2)),
          "2x4": (("data", "model"), (2, 4)),
          "16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("rules", sorted(S.RULE_SETS))
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_spec_for_matches_the_reference(mesh, rules):
    names, shape = MESHES[mesh]
    ref_mesh = types.SimpleNamespace(axis_names=names,
                                     devices=np.empty(shape, object))
    port_mesh = S.AbstractMesh(names, shape)
    assert S.RULE_SETS == J.RULE_SETS
    n_leaves = 0
    for arch in sorted(ARCHS):
        cfg = get(arch)
        specs = TM.model_specs(cfg)
        ref_axes = dict(_flat(JM.param_axes(JAX_ARCHS[arch])))
        ref_fb, port_fb = [], []
        for path, spec in specs.items():
            assert tuple(ref_axes[path]) == tuple(spec.axes), path
            want = J.spec_for(ref_mesh, spec.axes, spec.shape,
                              J.RULE_SETS[rules], ref_fb)
            got = S.spec_for(port_mesh, spec.axes, spec.shape,
                             S.RULE_SETS[rules], port_fb)
            assert got == tuple(want), (arch, path)
            n_leaves += 1
        assert port_fb == ref_fb, arch
    assert n_leaves > 100


def test_sharding_tree_and_placements():
    """sharding_tree over the model's axes and meta shapes, batch_sharding
    and replicated, and placements_for: Shard on the axes a dim lists (a dim
    over two axes in the mesh's order, major first), Replicate elsewhere; a
    dim listing axes out of the mesh's order has no layout."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = S.AbstractMesh(("data", "model"), (4, 2))
    cfg = get("olmoe-1b-7b")
    fb = []
    tree = S.sharding_tree(mesh, TM.param_axes(cfg), TM.abstract_params(cfg),
                           "fsdp_tp", fb)
    assert tree["layers"]["moe"]["wi_gate"].spec == (None, "model", "data",
                                                     None)
    assert tree["layers"]["moe"]["wi_gate"].placements == (Shard(2),
                                                           Shard(1))
    batch = S.batch_sharding(mesh, {"tokens": torch.empty(8, 16,
                                                          device="meta")},
                             "dp")
    assert batch["tokens"].spec == (("data", "model"), None)
    assert batch["tokens"].placements == (Shard(0), Shard(0))
    assert S.replicated(mesh).placements == (Replicate(), Replicate())
    with pytest.raises(ValueError, match="order"):
        S.placements_for(mesh, (("model", "data"),))
    assert S.constrain(torch.ones(2), ("batch",)).tolist() == [1.0, 1.0]


@pytest.fixture(scope="module")
def collectives():
    return M.spawn(ranks.collectives, 4, 2, device="cpu", timeout=300)


def test_launcher_returns_rank_0_s_value():
    assert M.spawn(ranks.rank_value, 2, 1, device="cpu") == ("rank", 0, 2)


def test_a_raising_rank_fails_the_call_with_its_traceback():
    with pytest.raises(RuntimeError) as err:
        M.spawn(ranks.one_rank_raises, 1, 2, device="cpu", timeout=120)
    assert "rank 1 raised" in str(err.value)
    assert "ValueError: rank one fails on purpose" in str(err.value)


def test_a_timeout_fails_the_call():
    with pytest.raises(RuntimeError, match="timeout"):
        M.spawn(ranks.sleeps, 1, 1, device="cpu", args=(120.0,), timeout=5)


def test_mesh_shape_and_world_size(collectives):
    out = collectives
    assert out["repr"] == ("HostMesh(data=4, model=2, backend='gloo', "
                           "device='cpu', rank=0)")
    assert out["coords"] == [(r // 2, r % 2) for r in range(8)]
    assert "needs 16 ranks but the process group has 8" in \
        out["wrong_world"]


def test_collectives_values_and_gradients(collectives):
    """Rank 0 at (0, 0): the gather over the mesh in rank order, its
    gradient this rank's slice of the weights; the bf16 gather over its
    model row; its chunk of a replicated tensor, whose gradient is every
    rank's (r + 1) on its chunk; the all-to-all over the model row and its
    reverse exchange of the gradient; the sum over the data column, its
    gradient passed through; replicate's gradient summed over the mesh."""
    out = collectives
    assert out["gather"] == [float(r) for r in range(8)]
    assert out["gather_grad"] == [[1.0] * 3] * 2
    assert out["gather_model"] == [0.0, 1.0]
    assert out["gather_model_grad"] == [1.0] * 4
    assert out["shard"] == [0.0, 4.0, 8.0, 12.0]
    assert out["shard_grad"] == [float(r // 4 + 1) for r in range(32)]
    assert out["a2a"] == [0.0, 100.0]
    assert out["a2a_grad"] == [1.0, 1.0]
    assert out["reduce"] == [0.0 + 2.0 + 4.0 + 6.0]
    assert out["reduce_grad"] == [1.0]
    assert out["replicate_grad"] == [36.0, 36.0]


def test_host_mesh_without_a_process_group():
    assert M.make_host_mesh(1, 1) is None
    with pytest.raises(RuntimeError, match="spawn"):
        M.make_host_mesh(2, 1)
    with pytest.raises(RuntimeError, match=r"needs 256 devices but only 1"):
        M.make_production_mesh()
    with pytest.raises(RuntimeError, match=r"\(2, 16, 16\) needs 512"):
        M.make_production_mesh(multi_pod=True)


def test_backend_is_named_from_the_arguments(monkeypatch):
    """gloo on the CPU and for ranks that share a card, NCCL for a card a
    rank; NCCL asked for where ranks share a card is refused; a mesh on
    the card without one raises before any rank starts."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert M.choose_backend(cpu, 8) == "gloo"
    assert M.choose_backend(cuda, 4) == "gloo"
    assert M.choose_backend(cuda, 1) == "nccl"
    with pytest.raises(ValueError, match="NCCL refuses"):
        M.choose_backend(cuda, 4, "nccl")
    with pytest.raises(ValueError, match="NCCL refuses"):
        M.choose_backend(cpu, 1, "nccl")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.spawn(ranks.rank_value, 2, 2, device="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.spawn(ranks.rank_value, 2, 2, device=None)


def test_a2a_refuses_tokens_or_experts_that_do_not_split():
    """moe_block_a2a raises ValueError where the reference would fail
    obscurely: tokens (B * S) that do not split over the mesh's ranks, or
    experts over its model axis (a stand-in mesh: the checks come before
    any collective)."""
    from repro_torch.models.moe_a2a import moe_block_a2a

    cfg = get("olmoe-1b-7b").reduced()
    mesh = types.SimpleNamespace(size=8, shape=(4, 2),
                                 extent={"data": 4, "model": 2}.get)
    x = torch.zeros(3, 5, cfg.d_model)
    with pytest.raises(ValueError, match="B \\* S = 15"):
        moe_block_a2a(x, {}, cfg, mesh)
    mesh3 = types.SimpleNamespace(size=3, shape=(1, 3),
                                  extent={"data": 1, "model": 3}.get)
    with pytest.raises(ValueError, match="4 experts"):
        moe_block_a2a(torch.zeros(3, 4, cfg.d_model), {}, cfg, mesh3)
