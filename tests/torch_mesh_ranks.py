"""Rank bodies of the port's mesh tests (``tests/test_torch_mesh.py``,
``tests/test_torch_sharded.py``).

Each function here runs in every rank that
``repro_torch.launch.mesh.spawn`` starts.  The spawn start method unpickles a
function by its module, so the bodies live in this module, which imports
only ``torch``, ``numpy`` and ``repro_torch``: a body defined in a test file
would make every rank import that file's JAX.  pytest does not collect this
file (its name does not start with ``test_``).
"""
from __future__ import annotations

import dataclasses
import hashlib
import pickle
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.launch import mesh as M


def everyone(value):
    """Every rank's ``value``, in rank order, on every rank."""
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, value)
    return out


def digest(value) -> str:
    return hashlib.sha256(pickle.dumps(value)).hexdigest()


# ---------------------------------------------------------------------------
# launcher and collectives (test_torch_mesh.py)
# ---------------------------------------------------------------------------
def collectives(mesh):
    """The collectives' values and gradients on this rank, the mesh's
    repr and coordinates, and make_host_mesh's refusal of a wrong world
    size."""
    r = mesh.rank
    dd, dm = mesh.extent("data"), mesh.extent("model")
    out = {"repr": repr(mesh), "coord": mesh.coordinate,
           "coords": everyone(mesh.coordinate)}
    x = torch.full((2, 3), float(r), requires_grad=True)
    g = M.all_gather(x, mesh)
    (g * torch.arange(1.0, mesh.size + 1)[:, None, None]).sum().backward()
    out["gather"] = g[:, 0, 0].tolist()
    out["gather_grad"] = x.grad.tolist()
    xm = torch.full((4,), float(r), dtype=torch.bfloat16, requires_grad=True)
    gm = M.all_gather(xm, mesh, "model")
    gm.float().sum().backward()
    out["gather_model"] = gm[:, 0].float().tolist()
    out["gather_model_grad"] = xm.grad.float().tolist()
    full = torch.arange(16.0 * mesh.size).reshape(mesh.size * 4, 4)
    full.requires_grad_()
    part = M.shard(full, mesh)
    (part * (r + 1)).sum().backward()
    out["shard"] = part[:, 0].tolist()
    out["shard_grad"] = full.grad[:, 0].tolist()
    blocks = torch.stack([torch.full((3,), 100.0 * r + j) for j in range(dm)])
    blocks.requires_grad_()
    got = M.all_to_all(blocks, mesh, "model")
    (got * torch.arange(1.0, dm + 1)[:, None]).sum().backward()
    out["a2a"] = got[:, 0].tolist()
    out["a2a_grad"] = blocks.grad[:, 0].tolist()
    y = torch.tensor([float(r)], requires_grad=True)
    red = M.all_reduce(y, mesh, "data")
    red.sum().backward()
    out["reduce"] = red.tolist()
    out["reduce_grad"] = y.grad.tolist()
    w = torch.ones(2, requires_grad=True)
    (M.replicate(w, mesh) * (r + 1)).sum().backward()
    out["replicate_grad"] = w.grad.tolist()
    try:
        M.make_host_mesh(dd * dm, 2)
        out["wrong_world"] = None
    except RuntimeError as e:
        out["wrong_world"] = str(e)
    return out


def rank_value(mesh):
    return ("rank", mesh.rank, mesh.size)


def one_rank_raises(mesh):
    if mesh.rank == 1:
        raise ValueError("rank one fails on purpose")
    dist.barrier()
    return mesh.rank


def sleeps(mesh, seconds: float):
    time.sleep(seconds)
    return mesh.rank


# ---------------------------------------------------------------------------
# the sharded machine phase, the served join and the a2a experts
# (test_torch_sharded.py)
# ---------------------------------------------------------------------------
def _cand(c) -> dict:
    return {"rows": c.rows, "cols": c.cols, "scores": c.scores,
            "n_dropped": c.n_dropped, "capacity": c.capacity}


def _fields(res) -> dict:
    out = {}
    for f in dataclasses.fields(res):
        if f.name == "wall_seconds":
            continue
        val = getattr(res, f.name)
        if isinstance(val, np.ndarray):
            val = (str(val.dtype), val.tolist())
        elif dataclasses.is_dataclass(val):
            val = dataclasses.asdict(val)
        out[f.name] = val
    return out


def request_pairs(svc, rids) -> list:
    """Each queued request's (u, v) in its pair order, a streamed request's
    queued arrival epochs after its first."""
    out = []
    for req, rid in zip(svc.queue, rids):
        epochs = [req.pairs, *svc._pending_arrivals.get(rid, ())]
        out.append((np.concatenate([e.u for e in epochs]).tolist(),
                    np.concatenate([e.v for e in epochs]).tolist()))
    return out


def serve(mesh, ins: dict) -> dict:
    """The reference's sharded_join session on ``mesh`` (``None``: one
    device): two lanes, a perfect and a noisy crowd, and a streamed request
    whose second epoch arrives through append_embeddings."""
    from repro_torch.core.crowd import NoisyCrowd, PerfectCrowd
    from repro_torch.serve.join_service import JoinService

    ea, eb = torch.from_numpy(ins["ea"]), torch.from_numpy(ins["eb"])
    ia, ib = ins["ia"], ins["ib"]
    tau = float(ins["tau"])

    def truth(r, c):
        return ia[r] == ib[c]

    svc = JoinService(lanes=2, device="cpu")
    total = int((ia[:, None] == ib[None, :]).sum())
    rids = [svc.submit_embeddings(ea, eb, tau, mesh, crowd=PerfectCrowd(),
                                  truth_fn=truth, total_true_matches=total),
            svc.submit_embeddings(ea, eb, tau, mesh,
                                  crowd=NoisyCrowd(error_rate=0.08),
                                  truth_fn=truth)]
    half = int(ins["half"])
    rids.append(svc.submit_embeddings(
        ea[:half], eb[:half], tau, mesh, crowd=PerfectCrowd(),
        truth_fn=truth, streaming=True))
    svc.append_embeddings(rids[-1], ea[half:], eb[half:])
    pairs = request_pairs(svc, rids)
    res = svc.run()
    return {"fields": [_fields(res[r]) for r in rids], "pairs": pairs}


def sharded_case(mesh, ins: dict) -> dict:
    """Everything the port computes on one mesh shape, with every rank's
    digest of it (all equal when the ranks agree)."""
    from repro_torch.kernels.pair_scores.sharded import (
        StreamingCandidateIndex, sharded_candidates, sharded_pair_scores)
    from repro_torch.sharding import placements_for

    a, b = torch.from_numpy(ins["a"]), torch.from_numpy(ins["b"])
    tau = float(ins["cand_tau"])
    out = {"lossless": _cand(sharded_candidates(a, b, tau, mesh)),
           "small": _cand(sharded_candidates(a, b, tau, mesh,
                                             capacity=int(ins["small_cap"])))}
    s, cnt = sharded_pair_scores(a, b, tau, mesh)
    out["dense"], out["counts"] = s.numpy(), cnt.numpy()
    if mesh.shape == (4, 2):
        na, nb = int(ins["epoch_a"]), int(ins["epoch_b"])
        idx = StreamingCandidateIndex(tau, mesh, device="cpu")
        out["epochs"] = [_cand(idx.append(a[:na], b[:nb])),
                         _cand(idx.append(a[na:], b[nb:]))]
        out["session"] = serve(mesh, ins)
        ok = []
        for full_np, spec, slices in ins["dtensor_cases"]:
            from torch.distributed.tensor import distribute_tensor

            full = torch.from_numpy(full_np)
            local = distribute_tensor(full, mesh.device_mesh,
                                      placements_for(mesh, spec)).to_local()
            want = full[tuple(slice(*ab) for ab in slices[mesh.coordinate])]
            ok.append(bool(torch.equal(local, want)))
        out["dtensor_ok"] = everyone(ok)
    out["a2a"] = a2a(mesh, ins)
    if mesh.shape == (2, 4):
        out["backbone"] = backbone_a2a(mesh, ins)
    out["digests"] = everyone(digest(out))
    return out


def card_candidates(mesh, ea, eb, tau: float) -> dict:
    """sharded_candidates on the rank's card, with every rank's launches
    of the pair_scores kernel and digest."""
    from repro_torch.kernels.pair_scores import ops
    from repro_torch.kernels.pair_scores.sharded import sharded_candidates

    a = torch.from_numpy(ea).to(mesh.device)
    b = torch.from_numpy(eb).to(mesh.device)
    ops.pair_scores.launches = 0
    cand = _cand(sharded_candidates(a, b, tau, mesh))
    return {"cand": cand, "mesh": repr(mesh),
            "launches": everyone(ops.pair_scores.launches),
            "digests": everyone(digest(cand))}


def a2a(mesh, ins: dict) -> dict:
    """moe_block_a2a's forward and input gradient (bf16, the reference's
    test setup), and in f32 its output and the router's and the experts'
    gradients, every one also through the one-device moe_block."""
    from repro_torch.configs import get
    from repro_torch.models.moe import moe_block
    from repro_torch.models.moe_a2a import moe_block_a2a
    from repro_torch.sharding import set_current_mesh

    cfg = get("olmoe-1b-7b").reduced().replace(
        capacity_factor=float(ins["capacity_factor"]), moe_impl="a2a")
    set_current_mesh(mesh)
    out = {}
    dev = mesh.device
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        p = {k: torch.from_numpy(ins[f"moe_{k}"]).to(dev, dtype)
             for k in ("router", "wi_gate", "wi_up", "wo")}
        for impl in ("a2a", "one"):
            x = torch.from_numpy(ins["moe_x"]).to(dev, dtype)
            x.requires_grad_()
            ps = {k: v.clone().requires_grad_() for k, v in p.items()}
            if impl == "a2a":
                y, aux = moe_block_a2a(x, ps, cfg, mesh)
            else:
                y, aux = moe_block(x, ps, cfg)
            y.float().sum().backward()
            out[f"{tag}_{impl}"] = {
                "y": y.detach().float().cpu().numpy(),
                "aux": float(aux.detach()),
                "x_grad": x.grad.float().cpu().numpy(),
                **{f"{k}_grad": v.grad.float().cpu().numpy()
                   for k, v in ps.items()}}
    set_current_mesh(None)
    return out


def backbone_a2a(mesh, ins: dict) -> dict:
    """A reduced olmoe-1b-7b under ``moe_impl="a2a"`` with the mesh set as
    the current one: the backbone's logits and the loss (0.01 x the expert
    layers' aux included), in f32, from the reference's parameters."""
    from repro_torch.configs import get
    from repro_torch.convert import model_params_from_numpy
    from repro_torch.models import model as MM
    from repro_torch.sharding import set_current_mesh

    cfg = get("olmoe-1b-7b").reduced().replace(moe_impl="a2a")
    model = model_params_from_numpy(cfg, ins["bb_params"],
                                    mesh.device).float()
    toks = torch.from_numpy(ins["bb_tokens"]).to(mesh.device)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    set_current_mesh(mesh)
    try:
        with torch.no_grad():
            x, pos = MM._embed_inputs(model, batch)
            logits = MM._logits(model, MM.backbone(model, x, pos))
            loss = MM.loss_fn(model, batch)
    finally:
        set_current_mesh(None)
    return {"logits": logits.float().cpu().numpy(), "loss": float(loss)}
