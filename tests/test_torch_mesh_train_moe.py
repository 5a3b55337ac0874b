"""The port's mesh train step against the JAX package's for the expert
configs, every rule set and every family, on the CPU.

The cases (all ``.reduced()``, f32 parameters, two steps, a batch of 16 x
32 from a numpy seed with a tenth of the targets masked):

* ``olmoe-1b-7b`` under ``fsdp_tp`` on 2 x 2 and 4 x 2, one microbatch,
  and two with int8 compression.  The reference's expert layer routes the
  whole microbatch's tokens at once, so the port's step computes the whole
  batch in every rank for a config with experts;
* ``olmoe-1b-7b`` under ``moe_impl="a2a"`` on 2 x 2 with one expert a rank
  (two experts over the two ``model`` ranks): past one expert a rank the
  reference's all-to-all layer is wrong (ROADMAP R8);
* ``paper-scorer`` under the other five rule sets on 2 x 2;
* ``zamba2-1.2b`` and ``rwkv6-3b`` under ``fsdp_tp`` on 2 x 2;
* ``granite-3-2b`` (GQA) under ``fsdp_tp`` on 4 x 2 with two microbatches;
* ``qwen2-vl-2b`` under ``fsdp_tp`` on 2 x 2, its batch with
  ``prefix_embeds`` and ``positions3`` (the reference's vision stub's
  layout, ``configs/shapes.py::dummy_batch``);
* ``musicgen-medium`` under ``fsdp_tp`` on 2 x 2, its batch with its
  conditioning frames as ``prefix_embeds``; ``moonshot-v1-16b-a3b``
  (experts: the whole batch in every rank) and ``internlm2-1.8b`` under
  ``fsdp_tp`` on 2 x 2.

The test process draws each config's state with the port's ``init_state``
(seed 0) and hands it, as numpy, to one reference subprocess
(``tests/torch_mesh_train_moe_reference.py``, which forces 8 host devices
before JAX is imported) and, at the same time, to one ``spawn`` of gloo CPU
ranks a mesh shape that runs every case of that shape (the rank body is
``tests/torch_mesh_ranks.py::train_mesh_cases``).

Bars.  Against the port's one-device ``make_train_step`` on the same state
and batches (the same library's arithmetic, so only the sums' order over
the ranks differs): loss and ``grad_norm`` of both steps within 1e-5
relative on every rank, the final parameters within 1e-4 in ||delta|| /
||ref||, the bars of ``tests/test_torch_mesh_train.py`` (measured: 1.4e-7,
5.8e-7 and 4.5e-5).  A mesh step that routes its expert layers over each
rank's rows misses the loss bar by 100 to 400 times (1.0e-3 to 4.1e-3).
Against the reference's mesh step: the loss within 1e-5 (measured 1.1e-6),
but ``grad_norm`` within 5e-5 and the parameters within 1e-3 (measured
1.6e-5 and 3.1e-4, both ``rwkv6-3b``).  Two steps of AdamW move an element
by about lr whatever the size of its gradient, so an element whose
gradient is near zero moves on the arithmetic's noise, and the norm scales
start at zero, so their ||ref|| is a few lr.  XLA and PyTorch sum in other
orders: the reference's own jitted one-device step stands 1.5e-5 in
``grad_norm`` (``rwkv6-3b``) and 2.7e-3 in the parameters (``olmoe-1b-7b``
with int8 compression) from its mesh step (ROADMAP C10).
``tools/mesh_train_spread.py`` measures every one of these distances.

The ranks' rows (``rank_rows``) and the dry-run's olmoe train cell (its
rows and its collective bytes against a real rank's counters) are pinned
too.
"""
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from repro_torch.convert import train_state_to_numpy
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import spawn
from repro_torch.sharding import AbstractMesh
from repro_torch.train.train_step import init_state

ROOT = Path(__file__).resolve().parent.parent
REF = Path(__file__).resolve().parent / "torch_mesh_train_moe_reference.py"
B, S = 16, 32
OCFG = dict(lr=3e-3, warmup_steps=1, total_steps=10)
STEP_TOL = 1e-5
PARAM_TOL = 1e-4
REF_NORM_TOL = 5e-5
REF_PARAM_TOL = 1e-3
A2A = {"moe_impl": "a2a", "n_experts": 2}


def _case(id_, arch, shape, rules="fsdp_tp", mb=1, compress=False,
          replace=None):
    replace = replace or {}
    key = "-".join([arch] + [f"{k}={v}" for k, v in sorted(replace.items())])
    return {"id": id_, "arch": arch, "shape": shape, "rules": rules,
            "mb": mb, "compress": compress, "replace": replace, "key": key}


CASES = [
    _case("olmoe-2x2-mb1", "olmoe-1b-7b", (2, 2)),
    _case("olmoe-2x2-mb2-compress", "olmoe-1b-7b", (2, 2), mb=2,
          compress=True),
    _case("olmoe-4x2-mb1", "olmoe-1b-7b", (4, 2)),
    _case("olmoe-4x2-mb2-compress", "olmoe-1b-7b", (4, 2), mb=2,
          compress=True),
    _case("olmoe-a2a-2x2-mb1", "olmoe-1b-7b", (2, 2), replace=A2A),
    _case("olmoe-a2a-2x2-mb2", "olmoe-1b-7b", (2, 2), mb=2, replace=A2A),
    *[_case(f"paper-scorer-2x2-{r}", "paper-scorer", (2, 2), rules=r)
      for r in ("dp", "fsdp2d", "fsdp_tp_kvseq", "fsdp2d_rv",
                "fsdp_tp_seq")],
    _case("zamba2-2x2", "zamba2-1.2b", (2, 2)),
    _case("rwkv6-2x2", "rwkv6-3b", (2, 2)),
    _case("granite-4x2-mb2", "granite-3-2b", (4, 2), mb=2),
    _case("qwen2-vl-2x2", "qwen2-vl-2b", (2, 2)),
    _case("musicgen-2x2", "musicgen-medium", (2, 2)),
    _case("moonshot-2x2", "moonshot-v1-16b-a3b", (2, 2)),
    _case("internlm2-2x2", "internlm2-1.8b", (2, 2)),
]
IDS = [c["id"] for c in CASES]
ROW_ARCHS = ("olmoe-1b-7b", "paper-scorer", "zamba2-1.2b", "rwkv6-3b")
COUNT_ARCH = "olmoe-1b-7b"


def _batches(cfg, rng) -> list:
    """Two batches of B rows and S positions; under a prefix front end the
    first positions are the prefix's (masked targets, embeddings of 0.02
    scale, and under M-RoPE the vision stub's grid positions)."""
    n_prefix = cfg.n_patch_tokens + cfg.n_cond_tokens
    out = []
    for _ in range(2):
        toks = rng.integers(2, cfg.vocab, size=(B, S + 1 - n_prefix)
                            ).astype(np.int32)
        tgt = np.full((B, S), -1, np.int32)
        tgt[:, n_prefix:] = toks[:, 1:]
        tgt[:, -1] = -1
        tgt[rng.random((B, S)) < 0.1] = -1
        batch = {"tokens": toks[:, :-1].copy(), "targets": tgt}
        if n_prefix:
            batch["prefix_embeds"] = (0.02 * rng.standard_normal(
                (B, n_prefix, cfg.d_model))).astype(np.float32)
        if cfg.mrope:
            side = max(int(cfg.n_patch_tokens ** 0.5), 1)
            idx = np.arange(S)
            text = idx - n_prefix + side
            pos = np.stack([np.where(idx >= n_prefix, text, 0),
                            np.where(idx >= n_prefix, text, idx // side),
                            np.where(idx >= n_prefix, text, idx % side)],
                           axis=-1).astype(np.int32)
            batch["positions3"] = np.broadcast_to(pos, (B, S, 3)).copy()
        out.append(batch)
    return out


def make_inputs() -> dict:
    """The cases and, for each config, its f32 train state (the port's
    ``init_state`` from seed 0, as the reference's numpy tree) and two
    batches."""
    rng = np.random.default_rng(7)
    ins = {"cases": CASES, "ocfg": OCFG, "B": B, "row_archs": ROW_ARCHS,
           "count_arch": COUNT_ARCH, "states": {}, "batches": {}}
    for case in CASES:
        if case["key"] in ins["states"]:
            continue
        cfg = ranks.case_config(case)
        ins["states"][case["key"]] = train_state_to_numpy(init_state(
            cfg, torch.Generator().manual_seed(0), device="cpu"))
        ins["batches"][case["key"]] = _batches(cfg, rng)
    return ins


def run_mesh_cases(ins: dict, tmp: Path) -> tuple:
    """(the reference's results by case, the port's ranks by mesh shape):
    the reference subprocess runs beside the port's ranks."""
    in_path, out_path = tmp / "in.pkl", tmp / "ref.pkl"
    with open(in_path, "wb") as f:
        pickle.dump(ins, f)
    proc = subprocess.Popen([sys.executable, str(REF), str(in_path),
                             str(out_path)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            cwd=str(ROOT))
    try:
        port = {shape: spawn(ranks.train_mesh_cases, *shape, device="cpu",
                             timeout=600, args=(ins,))
                for shape in ((2, 2), (4, 2))}
        out, err = proc.communicate(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert "REF_OK" in out, out[-2000:] + err[-4000:]
    with open(out_path, "rb") as f:     # written by the subprocess above
        return pickle.load(f), port


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(inputs, the reference's results by case, the port's ranks by mesh
    shape)."""
    ins = make_inputs()
    ref, port = run_mesh_cases(ins, tmp_path_factory.mktemp("mesh_moe"))
    return ins, ref, port


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def _one_device_run(port, case) -> dict:
    runs = [r["one_device"][case["id"]] for r in port[case["shape"]]
            if case["id"] in r["one_device"]]
    assert len(runs) == 1
    return runs[0]


def _check(got_ranks, case, want, step_tol, norm_tol, param_tol):
    assert len(got_ranks) == case["shape"][0] * case["shape"][1]
    for rank in got_ranks:
        got = rank["cases"][case["id"]]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=step_tol,
                                   atol=0)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                   rtol=norm_tol, atol=0)
    params = got_ranks[0]["cases"][case["id"]]["params"]
    assert sorted(params) == sorted(want["params"])
    for path, arr in want["params"].items():
        assert _rel(params[path], arr) < param_tol, path


@pytest.mark.parametrize("case", [c for c in CASES
                                  if c["replace"].get("moe_impl") != "a2a"],
                         ids=[c["id"] for c in CASES
                              if c["replace"].get("moe_impl") != "a2a"])
def test_mesh_step_is_the_one_device_step(world, case):
    """Every rank's loss and grad_norm of both steps within 1e-5 relative
    of the port's one-device make_train_step on the same state and batches,
    the final parameters within 1e-4; the steps moved the parameters far
    beyond that bar.  (The all-to-all layer's aux is its shards' mean, not
    the one-device layer's: those cases are held to the reference only.)"""
    ins, _, port = world
    want = _one_device_run(port, case)
    _check(port[case["shape"]], case, want, STEP_TOL, STEP_TOL, PARAM_TOL)
    start = ins["states"][case["key"]]["params"]["embed"]["table"]
    got = port[case["shape"]][0]["cases"][case["id"]]["params"]
    assert _rel(got["embed/table"], start) > 100 * PARAM_TOL


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_mesh_step_matches_the_reference(world, case):
    """Every rank's loss of both steps within 1e-5 relative of the
    reference's mesh step, grad_norm within 5e-5, the final parameters
    within 1e-3 (the reference's own one-device and mesh steps stand as
    far apart: see the module docstring)."""
    _, ref, port = world
    want = ref[case["id"]]
    assert "error" not in want, want.get("traceback")
    _check(port[case["shape"]], case, want, STEP_TOL, REF_NORM_TOL,
           REF_PARAM_TOL)


@pytest.mark.parametrize("shape", [(2, 2), (4, 2)], ids=["2x2", "4x2"])
@pytest.mark.parametrize("arch", ROW_ARCHS)
def test_rank_rows(world, arch, shape):
    """A config with experts computes the whole batch in every rank under
    either expert layer; a dense, SSM or hybrid config keeps its part of
    the batch under fsdp_tp: the batch block over ``data``, split again
    over ``model``, so each rank its own B / world rows in mesh order."""
    _, _, port = world
    world_size = shape[0] * shape[1]
    for rank in port[shape]:
        rows = rank["rows"]
        if arch == "olmoe-1b-7b":
            assert rows[(arch, "gspmd")] == rows[(arch, "a2a")] == (0, B)
        else:
            d, m = rank["coord"]
            n = B // world_size
            assert rows[(arch, "gspmd")] == ((d * shape[1] + m) * n, n)


def test_account_cell_counts_the_moe_ranks_collectives(world):
    """account_cell of the reduced olmoe-1b-7b's train cell on
    AbstractMesh((2, 2)) at the ranks' batch accounts the whole batch a
    rank and counts the bytes by kind, and the calls, that every rank's
    counters recorded in one real bf16 step of the same shape; the batch
    gather is among them."""
    _, _, port = world
    acc = D.account_cell(ranks.case_config({"arch": COUNT_ARCH,
                                            "replace": {}}), "train_4k",
                         AbstractMesh.of((2, 2)), batch=B, seq=S)
    assert acc["rows"] == B
    for rank in port[(2, 2)]:
        got = rank["counters"]
        assert {k: got[k] for k in acc["collectives"]} == acc["collectives"]
    assert acc["collectives"]["all-gather"] > 0
    assert acc["collectives"]["all-reduce"] > 0
