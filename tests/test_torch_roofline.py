"""The port's roofline (``repro_torch.launch.roofline``) against the JAX
package's ``launch/roofline.py``, which imports no JAX and so runs in this
process.  On one record the two differ only by their peaks: the H100's
989e12 FLOP/s, 3.35e12 B/s and 450e9 B/s of NVLink against the TPU v5e's
197e12, 819e9 and 50e9.  The port's records carry the decode kernel's
analytic entry beside the reference's ``flash_kernel``; the comparisons
take records without it, and it is checked on its own."""
import copy

import pytest

from repro.launch import roofline as RR
from repro_torch.launch import dryrun as D
from repro_torch.launch import roofline as R

CELLS = [("internlm2-1.8b", "prefill_32k"), ("olmoe-1b-7b", "train_4k"),
         ("zamba2-1.2b", "prefill_32k"), ("rwkv6-3b", "train_4k"),
         ("deepseek-67b", "decode_32k"), ("zamba2-1.2b", "long_500k")]
SCALE = {"compute_s": RR.PEAK_FLOPS / R.PEAK_FLOPS,
         "memory_s": RR.HBM_BW / R.HBM_BW,
         "collective_s": RR.ICI_BW / R.LINK_BW}


@pytest.fixture(scope="module")
def records():
    out = {}
    for arch, shape in CELLS:
        rec = D.run_cell(arch, shape)
        rec["accounting"].pop("decode_kernel", None)
        # a collective term, so all three terms scale
        rec["accounting"]["outer"]["collectives"]["total"] = 1e6
        out[(arch, shape)] = rec
    return out


def test_peaks_are_the_h100_sxms():
    assert (R.PEAK_FLOPS, R.HBM_BW, R.LINK_BW) == (989e12, 3.35e12, 450e9)


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: f"{c[0]}-{c[1]}")
def test_cell_terms_are_the_references_scaled_by_the_peaks(records, cell):
    rec = records[cell]
    mine, ref = R.cell_terms(rec), RR.cell_terms(rec)
    for key, scale in SCALE.items():
        assert mine[key] == pytest.approx(ref[key] * scale, rel=1e-12)
    for key in ("hlo_flops_dev", "hlo_bytes_dev", "coll_bytes_dev",
                "model_flops", "useful_ratio", "mem_gb_dev", "arch",
                "shape"):
        assert mine[key] == ref[key]
    terms = {k: mine[k] for k in SCALE}
    assert mine["dominant"] == max(terms, key=terms.get).replace("_s", "")
    bound = max(terms.values())
    if cell[1].startswith(("decode", "long")):
        ideal = 2.0 * rec["n_active_params"] + rec["cache_bytes"]
        assert mine["roofline_frac"] == pytest.approx(
            ideal / R.HBM_BW / bound, rel=1e-12)
    else:
        assert mine["roofline_frac"] == pytest.approx(
            rec["model_flops"] / R.PEAK_FLOPS / bound, rel=1e-12)


def test_decode_kernel_entry_adds_its_costs():
    rec = D.run_cell("internlm2-1.8b", "decode_32k", batch=8)
    dk = rec["accounting"]["decode_kernel"]
    bare = copy.deepcopy(rec)
    del bare["accounting"]["decode_kernel"]
    with_k, without = R.cell_terms(rec), R.cell_terms(bare)
    assert with_k["hlo_flops_dev"] == without["hlo_flops_dev"] + dk["flops"]
    assert with_k["hlo_bytes_dev"] == without["hlo_bytes_dev"] + dk["bytes"]
    assert with_k["dominant"] == "memory"


def _synthetic(arch, shape, flops, nbytes, coll):
    """A record whose one layer holds the given terms."""
    piece = {"flops": flops, "bytes": nbytes, "collectives": {"total": coll}}
    zero = {"flops": 0.0, "bytes": 0.0, "collectives": {"total": 0.0}}
    return {"arch": arch, "shape": shape, "status": "ok", "n_devices": 1,
            "model_flops": flops / 2, "n_params": 10, "cache_bytes": 0.0,
            "accounting": {"n_layers": 1, "layer": piece, "outer": zero}}


def test_table_and_picks_are_the_references():
    """On records whose terms keep their order under either set of peaks
    (one term each, or one far ahead), the table's rows (arch, shape,
    dominant) and the hillclimb picks are the reference's."""
    recs = [_synthetic("a", "prefill_32k", 1e15, 1e6, 0.0),
            _synthetic("b", "train_4k", 1e9, 1e13, 0.0),
            _synthetic("c", "prefill_32k", 1e12, 1e6, 1e12),
            _synthetic("d", "decode_32k", 1e6, 1e11, 0.0),
            {"arch": "e", "shape": "long_500k", "status": "skipped(x)"}]
    mine = [R.cell_terms(r) for r in recs[:-1]]
    ref = [RR.cell_terms(r) for r in recs[:-1]]
    skipped = {"arch": "e", "shape": "long_500k", "rules": "fsdp_tp",
               "skipped": "skipped(x)"}

    def rows(table):
        return [tuple(c.strip() for c in line.split("|")[1:3]) + (
            line.split("|")[6].strip(),) for line in table.splitlines()[2:]]

    assert rows(R.markdown_table(mine + [skipped])) == \
        rows(RR.markdown_table(ref + [skipped]))
    pm, pr = R.pick_hillclimb(mine), RR.pick_hillclimb(ref)
    assert {k: (v["arch"], v["shape"]) for k, v in pm.items()} == \
        {k: (v["arch"], v["shape"]) for k, v in pr.items()}


def test_measured_fraction():
    terms = {"compute_s": 0.2, "memory_s": 0.05, "collective_s": 0.0}
    assert R.measured_fraction(terms, 0.4) == pytest.approx(0.5)
    assert R.measured_fraction(terms, 0.2) == pytest.approx(1.0)


def test_main_prints_the_table(tmp_path, capsys):
    D.main(["--arch", "internlm2-1.8b", "--out", str(tmp_path)])
    capsys.readouterr()
    R.main(["--artifacts", str(tmp_path)])
    out = capsys.readouterr().out
    assert "| internlm2-1.8b | decode_32k |" in out
    assert "| internlm2-1.8b | long_500k | — |" in out
    assert "worst_roofline: internlm2-1.8b" in out
    cells = R.load_cells(tmp_path)
    assert len(cells) == 4 and sum("skipped" in c for c in cells) == 1
