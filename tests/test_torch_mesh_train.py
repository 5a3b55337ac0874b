"""The port's trainer on the (data, model) mesh against the JAX package's on
host meshes, on the CPU: ``jit_train_step`` on 4 x 2 and 2 x 2, the state's
blocks, the elastic checkpoint re-shard, the ``Runner`` with a failure
injected, ``launch/train.py --production-mesh``, and the dry-run's
collective count against a real step's counters.

One module-scoped reference subprocess (``XLA_FLAGS`` forcing 8 host
devices, set before JAX is imported) runs the reference's
``jit_train_step`` on each mesh and writes a checkpoint of its 4 x 2
state; one ``spawn`` of gloo CPU ranks a mesh shape runs every check of
that shape in the same ranks (the rank bodies are
``tests/torch_mesh_ranks.py``): 2 x 2 first, which restores the
reference's 4 x 2 directory and saves it again, then 4 x 2, which
restores what the 2 x 2 ranks saved.  Every rank computes distinct rows of the 16-row batch
(2 rows on 4 x 2, 4 on 2 x 2, after the split over ``model``), and a
tenth of the targets are masked, so the ranks' gradients must be summed
and their counts weighed to give the reference's.

Bars: the reduced ``paper-scorer`` with f32 parameters, 2 steps, one
microbatch and two microbatches with int8 compression: loss and
``grad_norm`` within 1e-5 relative (sums in another order, as
``tests/test_torch_train.py`` holds the one-device step's loss), the
parameters within ``tests/test_torch_train.py``'s 1e-4 in ||delta|| /
||ref|| for f32 steps; each rank's blocks exactly the reference's
``NamedSharding.devices_indices_map`` block of its device, cut from the
gathered state; restores and resumed runs bit for bit; the counted
collective bytes equal.
"""
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import torch_mesh_ranks as ranks
from repro_torch.configs import get
from repro_torch.data import tokens
from repro_torch.data.entities import make_paper_dataset
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import spawn
from repro_torch.sharding import AbstractMesh
from repro_torch.train.checkpoint import CheckpointManager

ROOT = Path(__file__).resolve().parent.parent
REF = Path(__file__).resolve().parent / "torch_mesh_train_reference.py"
SHAPES = [(4, 2), (2, 2)]
IDS = ["4x2", "2x2"]
STEP_TOL = 1e-5
PARAM_TOL = 1e-4


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(inputs, the reference's results, the port's by mesh shape,
    directories)."""
    tmp = tmp_path_factory.mktemp("mesh_train")
    dirs = {k: str(tmp / k) for k in ("ref", "c42", "c22", "runner")}
    path = tmp / "ref.pkl"
    r = subprocess.run([sys.executable, str(REF), str(path), dirs["ref"]],
                       capture_output=True, text=True, cwd=str(ROOT),
                       timeout=900)
    assert "REF_OK" in r.stdout, r.stdout[-2000:] + r.stderr[-4000:]
    with open(path, "rb") as f:   # written by the subprocess above
        ins, ref = pickle.load(f)
    cfg = get("paper-scorer").reduced()
    ins["rows"] = tokens.corpus_from_records(make_paper_dataset().records,
                                             cfg.vocab, 32)
    port = {(2, 2): spawn(ranks.train_mesh, 2, 2, device="cpu",
                          timeout=600, args=(ins, {
                              "restore": dirs["ref"], "resave": dirs["c22"],
                              "runner": dirs["runner"]}))}
    port[(4, 2)] = spawn(ranks.train_mesh, 4, 2, device="cpu", timeout=600,
                         args=(ins, {"save": dirs["c42"],
                                     "restore": dirs["c22"]}))
    return ins, ref, port, dirs


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


@pytest.mark.parametrize("case", [(1, False), (2, True)],
                         ids=["mb1", "mb2-compress"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_mesh_step_matches_the_reference(world, shape, case):
    """Loss and grad_norm of both steps within 1e-5 relative on every
    rank; the final parameters within 1e-4."""
    ins, ref, port, _ = world
    want = ref[(shape, *case)]
    for rank in port[shape]:
        got = rank["cases"][case]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=STEP_TOL,
                                   atol=0)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                   rtol=STEP_TOL, atol=0)
    params = port[shape][0]["cases"][case]["params"]
    assert sorted(params) == sorted(f"params/{p}" for p in want["params"])
    for path, arr in want["params"].items():
        assert _rel(params[f"params/{path}"], arr) < PARAM_TOL, path
    # the steps moved every matrix far beyond the bar
    start = ins["state"]["params"]["layers"]["attn"]["wq"]
    assert _rel(params["params/layers/attn/wq"], start) > 100 * PARAM_TOL


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_state_blocks_are_the_reference_device_blocks(world, shape):
    """Every leaf of every rank's state (parameters, moments, step, error
    buffers) is the block the reference's NamedSharding gives the device
    at the rank's coordinate, cut from the gathered state, exactly; the
    ranks cover every coordinate of the mesh."""
    ins, _, port, _ = world
    coords = {rank["coord"] for rank in port[shape]}
    assert len(coords) == shape[0] * shape[1]
    paths = set(ins["slices"][shape])
    for rank in port[shape]:
        for (_, comp), got in rank["cases"].items():
            ok = got["blocks_ok"]
            assert all(ok.values()), [p for p, v in ok.items() if not v]
            assert set(ok) == {p for p in paths
                               if comp or not p.startswith("err/")}


def test_elastic_restore_4x2_to_2x2_and_back(world):
    """The reference's checkpoint of its 4 x 2 state (bf16 parameters as
    raw bits) restores onto 2 x 2 ranks, each holding its device's block
    of the saved arrays bit for bit; saved again from the 2 x 2 ranks, the
    directory holds the same arrays and restores onto 4 x 2 ranks, each
    rank its device's block, bit for bit.  The 4 x 2 ranks' own save holds
    their gathered state bit for bit."""
    _, _, port, dirs = world
    for shape in SHAPES:
        for rank in port[shape]:
            ok = rank["restore_ok"]
            assert ok and all(ok.values()), (shape, ok)
    a = ranks._flat_numpy(CheckpointManager(dirs["ref"]).restore()[1])
    b = ranks._flat_numpy(CheckpointManager(dirs["c22"]).restore()[1])
    assert sorted(a) == sorted(b)
    for path in a:
        assert a[path].dtype == b[path].dtype and \
            np.array_equal(a[path], b[path]), path
    mine = ranks._flat_numpy(CheckpointManager(dirs["c42"]).restore()[1])
    saved = port[(4, 2)][0]["saved_step_2"]
    assert sorted(mine) == sorted(saved)
    for path, arr in saved.items():
        assert np.array_equal(mine[path], arr), path


def test_runner_with_a_failure_resumes_bit_for_bit(world):
    """2 x 2, 6 steps, a checkpoint every 2, a SimulatedFailure at step 3:
    the restored run's losses and final state (the gathered leaves'
    digest) equal the uninterrupted run's on every rank."""
    _, _, port, _ = world
    for rank in port[(2, 2)]:
        plain, failed = rank["runner"]
        assert plain["final_step"] == failed["final_step"] == 6
        assert plain["losses"] == failed["losses"]   # each step's last
        assert plain["digest"] == failed["digest"]
        # the failed run stepped again from the step-2 checkpoint
        assert failed["entries"] == plain["entries"] + 1
    assert port[(2, 2)][0]["runner"][1]["restored"]
    assert len({r["runner"][0]["digest"] for r in port[(2, 2)]}) == 1


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_account_cell_counts_the_ranks_collectives(world, shape):
    """account_cell on AbstractMesh(shape) at the ranks' cut shape (train,
    batch 16, seq 32) counts the bytes by kind, and the calls, that every
    rank's counters recorded in one real bf16 step."""
    _, _, port, _ = world
    acc = D.account_cell(get("paper-scorer").reduced(), "train_4k",
                         AbstractMesh.of(shape), batch=16, seq=32)
    for rank in port[shape]:
        got = rank["counters"]
        assert {k: got[k] for k in acc["collectives"]} == \
            acc["collectives"]
    assert acc["collectives"]["all-gather"] > 0
    assert acc["collectives"]["all-reduce"] > 0


def test_production_mesh_launcher_names_the_rank_count(tmp_path):
    from repro_torch.launch.train import main

    with pytest.raises(RuntimeError, match="needs 256 devices but only 1"):
        main(["--production-mesh", "--device", "cpu", "--checkpoint-dir",
              str(tmp_path)])
