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

import contextlib
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


# ---------------------------------------------------------------------------
# the trainer on the mesh (test_torch_mesh_train.py)
# ---------------------------------------------------------------------------
def _tree_to_torch(tree):
    if isinstance(tree, dict):
        return {k: _tree_to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _blocks_match(mesh, blocks: dict, full: dict, slices: dict) -> dict:
    """Each leaf of this rank's blocks against ``full`` cut at the
    reference's slices of the rank's device: equal, bit for bit."""
    out = {}
    for path, block in blocks.items():
        idx = tuple(slice(a, b) for a, b in slices[path][mesh.coordinate])
        want = np.asarray(full[path])[idx]
        out[path] = block.shape == want.shape and \
            block.dtype == want.dtype and block.tobytes() == want.tobytes()
    return out


def _flat_numpy(tree) -> dict:
    from repro_torch.train.optim import tree_leaves

    return {p: (x.view(torch.int16).numpy().view(np.uint16)
                if x.dtype == torch.bfloat16 else x.numpy()).copy()
            for p, x in tree_leaves(tree)}


def _specs(batch: dict) -> dict:
    return {k: torch.empty(v.shape, dtype=torch.int32, device="meta")
            for k, v in batch.items()}


def train_mesh(mesh, ins: dict, dirs: dict) -> dict:
    """The mesh step's cases against the reference's inputs; the state
    blocks against the reference's device slices; one bf16 step's
    collective counters; the checkpoint saves and restores ``dirs`` asks
    for; the failure-injected Runner against its uninterrupted run."""
    from repro_torch.configs import get
    from repro_torch.launch.mesh import (collective_bytes,
                                         reset_collective_bytes)
    from repro_torch.sharding import local_block
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.optim import AdamWConfig
    from repro_torch.train.train_step import (abstract_state,
                                              gather_state, init_mesh_state,
                                              jit_train_step, shard_state)

    cfg = get("paper-scorer").reduced()
    ocfg = AdamWConfig(**ins["ocfg"])
    shape = (mesh.extent("data"), mesh.extent("model"))
    slices = ins["slices"][shape]
    specs = _specs(ins["batches"][0])

    def cut(batch, b_shard):
        return {k: local_block(torch.from_numpy(v), b_shard[k])
                for k, v in batch.items()}

    out = {"coord": mesh.coordinate, "cases": {}}
    for mb, comp in ins["cases"]:
        step, s_shard, b_shard = jit_train_step(
            cfg, ocfg, mesh, abstract_state(cfg, comp), specs, "fsdp_tp",
            mb, comp)
        full = _tree_to_torch(ins["state"])
        if comp:
            full["err"] = {k: v for k, v in _tree_to_torch(
                ins["zeros"]).items()}
        state = shard_state(full, s_shard)
        rec = {"loss": [], "grad_norm": []}
        for batch in ins["batches"]:
            state, m = step(state, cut(batch, b_shard))
            rec["loss"].append(float(m["loss"]))
            rec["grad_norm"].append(float(m["grad_norm"]))
        got = _flat_numpy(gather_state(state, s_shard))
        rec["blocks_ok"] = _blocks_match(mesh, _flat_numpy(state), got,
                                         slices)
        if mesh.rank == 0:
            rec["params"] = {p: v for p, v in got.items()
                             if p.startswith("params/")}
        out["cases"][(mb, comp)] = rec
        if (mb, comp) == (1, False) and "save" in dirs:
            CheckpointManager(dirs["save"], mesh=mesh).save(
                2, state, shardings=s_shard)
            out["saved_step_2"] = got if mesh.rank == 0 else None

    # one bf16 step at the dry-run's cut shape: the collective counters
    step, s_shard, b_shard = jit_train_step(cfg, AdamWConfig(), mesh,
                                            abstract_state(cfg), specs)
    state = init_mesh_state(cfg, torch.Generator().manual_seed(0), s_shard,
                            device="cpu")
    reset_collective_bytes()
    step(state, cut(ins["batches"][0], b_shard))
    out["counters"] = collective_bytes()

    # elastic restores: onto this mesh, every rank its device's block
    s_shard = jit_train_step(cfg, ocfg, mesh, abstract_state(cfg), specs)[1]
    if "restore" in dirs:
        _, state, _ = CheckpointManager(dirs["restore"], mesh=mesh).restore(
            shardings=s_shard)
        host = CheckpointManager(dirs["restore"]).restore()[1]
        out["restore_ok"] = _blocks_match(mesh, _flat_numpy(state),
                                          _flat_numpy(host), slices)
        if "resave" in dirs:
            CheckpointManager(dirs["resave"], mesh=mesh).save(
                4, state, shardings=s_shard)

    if "runner" in dirs:
        out["runner"] = [_runner_run(mesh, ins, f"{dirs['runner']}_{tag}",
                                     fail)
                         for tag, fail in (("plain", ()), ("failed", (3,)))]
    return everyone(out)


def _runner_run(mesh, ins: dict, ckpt_dir: str, fail) -> dict:
    from repro_torch.configs import get
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.train.fault import FailureInjector
    from repro_torch.train.optim import AdamWConfig
    from repro_torch.train.runner import Runner, RunnerConfig
    from repro_torch.train.train_step import gather_state

    logs = []
    runner = Runner(
        get("paper-scorer").reduced(),
        AdamWConfig(total_steps=20, warmup_steps=2),
        RunnerConfig(total_steps=6, checkpoint_every=2,
                     checkpoint_dir=ckpt_dir, log_every=100),
        mesh, TokenPipeline(ins["rows"], 8),
        injector=FailureInjector(fail_at_steps=fail), log=logs.append)
    res = runner.run()
    full = _flat_numpy(gather_state(res["state"], runner.s_shard))
    return {"final_step": res["final_step"],
            "losses": {h["step"]: h["loss"] for h in res["history"]},
            "entries": len(res["history"]),
            "digest": digest(sorted((p, v.tobytes()) for p, v in
                                    full.items())),
            "restored": any("restarting" in line for line in logs)}


def card_train(mesh, batches: list) -> dict:
    """The reduced paper-scorer's mesh step on the card, twice from the
    same draw: each run's losses, its final state's digest, and the flash
    kernel's launches in this rank."""
    from repro_torch.configs import get
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.sharding import local_block
    from repro_torch.train.optim import AdamWConfig
    from repro_torch.train.train_step import (abstract_state, gather_state,
                                              init_mesh_state,
                                              jit_train_step)

    cfg = get("paper-scorer").reduced()
    step, s_shard, b_shard = jit_train_step(
        cfg, AdamWConfig(warmup_steps=1), mesh, abstract_state(cfg),
        _specs(batches[0]))
    out = {"runs": []}
    fa_ops.flash_attention.launches = 0
    for _ in range(2):
        gen = torch.Generator(device=mesh.device).manual_seed(0)
        state = init_mesh_state(cfg, gen, s_shard, device=mesh.device)
        losses = []
        for b in batches:
            state, m = step(state, {k: local_block(
                torch.from_numpy(v).to(mesh.device), b_shard[k])
                for k, v in b.items()})
            losses.append(float(m["loss"]))
        full = _flat_numpy(_to_cpu(gather_state(state, s_shard)))
        out["runs"].append({"losses": losses, "digest": digest(sorted(
            (p, v.tobytes()) for p, v in full.items()))})
    out["launches"] = fa_ops.flash_attention.launches
    return everyone(out)


def _zeros(tree):
    if isinstance(tree, dict):
        return {k: _zeros(v) for k, v in tree.items()}
    return torch.zeros_like(tree)


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.detach().cpu()


# ---------------------------------------------------------------------------
# the mesh step for every rule set and family (test_torch_mesh_train_moe.py)
# ---------------------------------------------------------------------------
def case_config(case: dict):
    from repro_torch.configs import get

    return get(case["arch"]).reduced().replace(**case["replace"])


def one_device(ins: dict, case: dict) -> dict:
    """The port's one-device ``make_train_step`` on the case's f32 state
    and batches: each step's loss and grad_norm, the final parameters."""
    from repro_torch.convert import train_state_from_numpy
    from repro_torch.train.optim import AdamWConfig, tree_leaves
    from repro_torch.train.train_step import make_train_step

    cfg = case_config(case)
    state = train_state_from_numpy(cfg, ins["states"][case["key"]], "cpu")
    state["params"] = state["params"].float()
    if case["compress"]:
        state["err"] = _zeros(state["params"].params)
    step = make_train_step(cfg, AdamWConfig(**ins["ocfg"]), case["mb"],
                           case["compress"])
    out = {"loss": [], "grad_norm": []}
    for b in ins["batches"][case["key"]]:
        state, m = step(state, b)
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
    out["params"] = {p: x.detach().numpy().copy()
                     for p, x in tree_leaves(state["params"].params)}
    return out


def train_mesh_cases(mesh, ins: dict) -> dict:
    """Every case of ``ins["cases"]`` on this mesh's shape, two steps from
    the case's f32 state: each step's loss and grad_norm, and the final
    parameters gathered whole (rank 0's); the cases' one-device steps
    (:func:`one_device`, under ``moe_impl="gspmd"``), shared out over the
    ranks; each of ``ins["row_archs"]``' ``rank_rows`` under ``fsdp_tp``;
    on 2 x 2 one bf16 step of ``ins["count_arch"]`` at its batch, its
    collective counters.

    Every rank computes on ``ins["threads"]`` threads, one unless
    :func:`c11_cases` asks for more: one thread is kept only for the time
    it saves the spawned ranks.  At two, about one run in twenty once had
    a rank whose step differed in its last bits (MKL's first two-thread
    cos of the process, in RoPE), which the expert routing and AdamW's
    near-zero gradients carried to 2.5e-4 of the parameters; importing
    ``repro_torch`` now warms those functions on one thread
    (``device.warm_cpu_math``), and 21 two-thread runs after it matched
    the first bit for bit (ROADMAP C11)."""
    from repro_torch.launch.mesh import (collective_bytes,
                                         reset_collective_bytes)
    from repro_torch.sharding import batch_sharding, local_block, \
        set_current_mesh
    from repro_torch.train.optim import AdamWConfig
    from repro_torch.train.train_step import (abstract_state, gather_state,
                                              init_mesh_state,
                                              jit_train_step, rank_rows,
                                              shard_state)

    torch.set_num_threads(ins.get("threads", 1))
    shape = (mesh.extent("data"), mesh.extent("model"))

    def cut(batch, b_shard):
        return {k: local_block(torch.from_numpy(v), b_shard[k])
                for k, v in batch.items()}

    def specs_of(batch):
        return {k: torch.empty(v.shape, dtype=torch.from_numpy(v).dtype,
                               device="meta") for k, v in batch.items()}

    out = {"coord": mesh.coordinate, "cases": {}, "rows": {},
           "one_device": {}}
    ocfg = AdamWConfig(**ins["ocfg"])
    for case in ins["cases"]:
        if tuple(case["shape"]) != shape:
            continue
        cfg, comp = case_config(case), case["compress"]
        batches = ins["batches"][case["key"]]
        set_current_mesh(mesh, case["rules"])
        try:
            step, s_shard, b_shard = jit_train_step(
                cfg, ocfg, mesh, abstract_state(cfg, comp),
                specs_of(batches[0]), case["rules"], case["mb"], comp)
            full = _tree_to_torch(ins["states"][case["key"]])
            if comp:
                full["err"] = _zeros(full["params"])
            state = shard_state(full, s_shard)
            rec = {"loss": [], "grad_norm": []}
            # the C11 hunt's op trace of one case (c11_cases), else nothing
            trace = None if ins.get("trace") != case["id"] else \
                _LightTrace() if ins.get("light") else _op_trace_mode()
            with trace or contextlib.nullcontext():
                for batch in batches:
                    state, m = step(state, cut(batch, b_shard))
                    rec["loss"].append(float(m["loss"]))
                    rec["grad_norm"].append(float(m["grad_norm"]))
            if trace is not None:
                out["trace"] = trace.ops
            got = _flat_numpy(gather_state(state["params"],
                                           s_shard["params"]))
        finally:
            set_current_mesh(None)
        if mesh.rank == 0:
            rec["params"] = got
        out["cases"][case["id"]] = rec

    mine = [c for c in ins["cases"] if tuple(c["shape"]) == shape]
    for case in mine[mesh.rank::mesh.size]:
        out["one_device"][case["id"]] = one_device(ins, dict(
            case, replace={**case["replace"], "moe_impl": "gspmd"}))

    B = ins["B"]
    tokens = batch_sharding(mesh, {"tokens": torch.empty(
        (B, 1), dtype=torch.int32, device="meta")}, "fsdp_tp")["tokens"]
    for arch in ins["row_archs"]:
        cfg = case_config({"arch": arch, "replace": {}})
        for impl in ("gspmd", "a2a") if cfg.is_moe else ("gspmd",):
            out["rows"][(arch, impl)] = rank_rows(
                cfg.replace(moe_impl=impl), mesh, tokens, B)

    if shape == (2, 2):
        arch = ins["count_arch"]
        cfg = case_config({"arch": arch, "replace": {}})
        batch = ins["batches"][arch][0]
        step, s_shard, b_shard = jit_train_step(
            cfg, AdamWConfig(), mesh, abstract_state(cfg), specs_of(batch))
        state = init_mesh_state(cfg, torch.Generator().manual_seed(0),
                                s_shard, device="cpu")
        reset_collective_bytes()
        step(state, cut(batch, b_shard))
        out["counters"] = collective_bytes()
    return everyone(out)


# ---------------------------------------------------------------------------
# the two-thread hunt (ROADMAP C11); opt in, no test calls it
# ---------------------------------------------------------------------------
def _op_trace_mode():
    """A dispatch mode that records, for every ATen op the step runs, its
    name and digests of its tensor inputs and outputs."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    def dig(x):
        if not isinstance(x, torch.Tensor) or x.device.type == "meta":
            return None
        b = x.detach().contiguous().reshape(-1).view(torch.uint8)
        return hashlib.blake2b(b.numpy().tobytes(), digest_size=8).hexdigest()

    class Trace(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            ins = tuple(dig(x) for x in tree_flatten((args, kwargs))[0]
                        if isinstance(x, torch.Tensor))
            out = func(*args, **kwargs)
            if str(func).startswith("c10d."):   # its result once it lands
                for w in tree_flatten(out)[0]:
                    if isinstance(w, torch.ScriptObject):
                        w.wait()
            # an empty tensor's bits are whatever the allocator held
            outs = () if "empty" in str(func) else tuple(
                dig(x) for x in tree_flatten(out)[0]
                if isinstance(x, torch.Tensor))
            self.ops.append((str(func), ins, outs))
            return out

    return Trace()


class _LightTrace:
    """Digests of the inputs and outputs of the model's layer functions
    (``layer_step``, ``rmsnorm``, ``attention_block``, ``moe_block``,
    looked up by name in ``models/model.py`` at each call) and of each
    ``all_reduce``'s input and result that the step binds after it is
    entered, in call order: the step's own timing, with no dispatch mode
    in its way."""

    NAMES = ("layer_step", "rmsnorm", "attention_block", "moe_block")

    def __init__(self):
        self.ops = []

    @staticmethod
    def _dig(value):
        from torch.utils._pytree import tree_flatten

        out = []
        for x in tree_flatten(value)[0]:
            if isinstance(x, torch.Tensor):
                b = x.detach().contiguous().reshape(-1).view(torch.uint8)
                out.append(hashlib.blake2b(b.numpy().tobytes(),
                                           digest_size=8).hexdigest())
        return tuple(out)

    def __enter__(self):
        from repro_torch.launch import mesh as mesh_mod
        from repro_torch.models import model as model_mod

        self._saved = {n: getattr(model_mod, n) for n in self.NAMES}
        self._reduce = mesh_mod.all_reduce

        def wrap(name, fn):
            def traced(*a, **k):
                before = self._dig((a, k))
                out = fn(*a, **k)
                self.ops.append((name, before, self._dig(out)))
                return out
            return traced

        for n, fn in self._saved.items():
            setattr(model_mod, n, wrap(n, fn))
        mesh_mod.all_reduce = wrap("all_reduce", self._reduce)
        return self

    def __exit__(self, *exc):
        from repro_torch.launch import mesh as mesh_mod
        from repro_torch.models import model as model_mod

        for n, fn in self._saved.items():
            setattr(model_mod, n, fn)
        mesh_mod.all_reduce = self._reduce
        return False


def c11_cases(runs: int = 20, threads: int = 2, shape=(2, 2),
              trace: str | None = None, light: bool = False) -> list:
    """``runs`` spawns of :func:`train_mesh_cases` on ``shape`` with every
    case of ``tests/test_torch_mesh_train_moe.py`` at ``threads`` threads a
    rank; prints, for each run, the (rank, mesh step or one-device step,
    case, field) whose value differs bit for bit from the first run's;
    with ``trace`` a case id, every rank's first op of that case whose
    outputs differ from the first run's (every ATen op, or with ``light``
    the model's layer functions, :class:`_LightTrace`).  Run from
    ``tests/`` with ``src`` on ``PYTHONPATH``: ``python -c "import
    torch_mesh_ranks as r; r.c11_cases(trace='olmoe-2x2-mb1',
    light=True)"`` (about 15 s a run).  Before ``device.warm_cpu_math``
    three of 55 runs differed, the light trace naming rank 3's first
    ``attention_block`` (its RoPE's ``torch.cos``) on equal inputs."""
    import test_torch_mesh_train_moe as T

    ins = dict(T.make_inputs(), threads=threads, trace=trace, light=light)
    first, first_trace, differ = None, None, []
    for run in range(runs):
        t0 = time.time()
        got = M.spawn(train_mesh_cases, *shape, device="cpu", timeout=900,
                      args=(ins,))
        digests = {(rank, part, case, field): digest(value)
                   for rank, r in enumerate(got)
                   for part in ("cases", "one_device")
                   for case, rec in r[part].items()
                   for field, value in rec.items()}
        if first is None:
            first = digests
        bad = sorted(k for k, v in digests.items() if first.get(k) != v)
        differ.append(bad)
        print(f"run {run}: differ {bad} ({time.time() - t0:.1f} s)",
              flush=True)
        if trace:
            ops = [r.get("trace", []) for r in got]
            first_trace = first_trace or ops
            for rank, (a_ops, b_ops) in enumerate(zip(ops, first_trace)):
                hit = next(((i, a[0], a[1] == b[1]) for i, (a, b)
                            in enumerate(zip(a_ops, b_ops))
                            if a[2] != b[2]), None)
                if hit is not None:
                    print(f"  rank {rank}: first op whose output differs "
                          f"(index, op, inputs equal) {hit}", flush=True)
    return differ

