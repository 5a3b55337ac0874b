"""The dry-run's mesh terms (``repro_torch.launch.dryrun`` on an
``AbstractMesh``) against the JAX package's, on the CPU.

One module-scoped reference subprocess (``XLA_FLAGS`` forcing 256 host
devices, set before JAX is imported: the reference's ``launch/dryrun.py``
itself is never imported, since it forces 512 at import) computes, for
every arch x shape on the 16 x 16 production mesh, the sharding fallbacks
as the reference's ``lower_full`` records them (its ``sharding_tree``
calls, without compiling) and the parameter bytes one device holds
(``tests/torch_dryrun_mesh_reference.py``).  Bars: the fallback lists
equal, order included, and the bytes equal.  The collective counts are
held to a real step's counters in ``tests/test_torch_mesh_train.py``;
here the records and the roofline's collective term.
"""
import json
import pickle
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.configs import ARCHS, get
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import dryrun as D
from repro_torch.launch import roofline as R
from repro_torch.sharding import AbstractMesh

ROOT = Path(__file__).resolve().parent.parent
REF = Path(__file__).resolve().parent / "torch_dryrun_mesh_reference.py"
MESH = AbstractMesh.of((16, 16))
CELLS = [(a, s) for a in ARCHS for s in SHAPES]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("dryrun_mesh") / "ref.pkl"
    r = subprocess.run([sys.executable, str(REF), str(path)],
                       capture_output=True, text=True, cwd=str(ROOT),
                       timeout=600)
    assert "REF_OK" in r.stdout, r.stdout[-2000:] + r.stderr[-4000:]
    with open(path, "rb") as f:   # written by the subprocess above
        return pickle.load(f)


@pytest.mark.parametrize("arch", ARCHS)
def test_fallbacks_and_parameter_blocks_are_the_references(reference, arch):
    """Every shape of the arch: the port's ``sharding_fallbacks`` are the
    reference's list (skipped cells have none), and a rank's parameter
    bytes in ``mem_summary`` are one device's block bytes."""
    cfg = get(arch)
    for shape in SHAPES:
        want, nbytes = reference[arch, shape]
        if want is not None:
            assert D.sharding_fallbacks(cfg, shape, MESH) == want, shape
        assert D.mem_summary(cfg, shape, mesh=MESH)[
            "parameter_bytes"] == nbytes, shape
    assert {s for a, s in reference if a == arch} == set(SHAPES)


def test_some_cells_fall_back(reference):
    """The comparison has teeth: GQA caches whose kv heads do not divide
    16 fall back on some cells, and most cells do not."""
    listed = [v[0] for v in reference.values() if v[0] is not None]
    assert any(listed) and sum(map(bool, listed)) < len(listed)


def test_mesh_record_and_its_roofline(tmp_path):
    """A 16 x 16 record: a rank's rows, its blocks' memory below one card's
    whole parameters, the fallbacks, one step's collectives by kind; the
    roofline's collective term is that step's bytes over NVLink's rate,
    above 0, and its table lists the fallbacks."""
    D.main(["--mesh", "16x16", "--arch", "internlm2-1.8b", "--shape",
            "decode_32k", "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "internlm2-1.8b__decode_32k__h100x16x16"
                      "__fsdp_tp.json").read_text())
    one = D.run_cell("internlm2-1.8b", "decode_32k")
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    assert rec["sharding_fallbacks"] == D.sharding_fallbacks(
        get("internlm2-1.8b"), "decode_32k", MESH) != []
    assert rec["memory"]["parameter_bytes"] * 64 <= \
        one["memory"]["parameter_bytes"]
    coll = rec["full_collectives"]
    assert coll == rec["accounting"]["collectives"]
    assert coll["all-gather"] > 0 and coll["all-to-all"] == 0
    assert rec["accounting"]["rows"] == 8          # 128 rows over data
    cells = R.load_cells(tmp_path, mesh="h100x16x16")
    assert len(cells) == 1
    terms = cells[0]
    assert terms["coll_bytes_dev"] == coll["total"] > 0
    assert terms["collective_s"] == coll["total"] / R.LINK_BW
    assert "kv_cache_heads:dim3%16" in R.markdown_table(cells)
    assert R.cell_terms(one)["collective_s"] == 0.0


def test_multi_pod_records_memory_fallbacks_and_collectives(tmp_path):
    """The (2, 16, 16) mesh: no per-layer accounting (as the reference's
    record), the memory, the fallbacks and a train step's collectives."""
    D.main(["--multi-pod", "--arch", "granite-3-2b", "--shape", "train_4k",
            "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "granite-3-2b__train_4k__h100x2x16x16"
                      "__fsdp_tp.json").read_text())
    assert rec["status"] == "ok" and "accounting" not in rec
    assert rec["n_devices"] == 512
    assert rec["sharding_fallbacks"] == D.sharding_fallbacks(
        get("granite-3-2b"), "train_4k", AbstractMesh.of((2, 16, 16)))
    coll = rec["full_collectives"]
    assert coll["all-gather"] > 0 and coll["all-reduce"] > 0
    assert rec["memory"]["parameter_bytes"] > 0
