"""The port's H100 accounting (``repro_torch.launch.dryrun``) against the
JAX package's dry-run, on the CPU.

The reference's ``launch/dryrun.py`` sets ``XLA_FLAGS`` to 512 host devices
when it is imported, so it is reached only in one subprocess (the pattern
of ``tests/test_sharding.py``), run once by a module fixture: it prints the
reference's ``model_flops``, ``flash_kernel_costs`` and
``attn_score_hbm_bytes`` for every assigned arch x shape x ``n_dev`` in
{1, 256}, and its ``account_cell(..., flash=True)`` on a (1, 1) host mesh
for one reduced config a family (dense, MoE, SSM, hybrid) at ``SMALL``'s
shapes.

* The three analytic functions equal the reference's exactly.
* The traced counts agree with XLA's ``cost_analysis`` within tolerances
  measured on this tree (``FLOP_TOL``): XLA counts FLOPs after its own
  rewriting (fused elementwise chains, transcendentals, small dots as
  multiplies and reductions), the port counts each product as ``2 M N K``
  and one FLOP a result element of each elementwise op as the ops run.
  Where products dominate (train and prefill of the dense, MoE and hybrid
  families) the two agree within 10% (measured 0.914-1.024); at decode's
  one token a lane and in RWKV's elementwise time scan XLA counts 1.1-2x
  the port's.
* A layer's matrix-product FLOPs equal a closed form of its products.
* Every arch x shape traces at full width on meta tensors.
"""
import json
import math
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import repro_torch.configs.shapes as S
from repro_torch.configs import ARCHS, get
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.launch import dryrun as D
from repro_torch.models import model as M
from repro_torch.models.moe import capacity
from repro_torch.models.ssm import ssd_chunk

ROOT = Path(__file__).resolve().parent.parent
ASSIGNED = [a for a in ARCHS if a != "paper-scorer"]
SHAPE_NAMES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
# the reduced cells' shapes, (seq_len, global_batch): small enough that
# XLA compiles RWKV's unrolled time scan in seconds
SMALL = {"train_4k": (32, 4), "prefill_32k": (32, 2),
         "decode_32k": (64, 2), "long_500k": (128, 1)}
FAMILY_ARCHS = ("internlm2-1.8b", "olmoe-1b-7b", "rwkv6-3b", "zamba2-1.2b")
# the port's FLOPs over XLA's, (low, high) by (family, shape kind): see the
# module docstring; the decode layer's includes the decode kernel's FLOPs,
# which the reference counts inside its layer
FLOP_TOL = {"products": (0.90, 1.10), "decode": (0.35, 1.0),
            "rwkv": (0.45, 1.0)}
# the reference's record keys that mean the same in the port's
RECORD_KEYS = {"arch", "shape", "mesh", "status", "n_devices", "memory",
               "model_flops", "attn_score_hbm_bytes", "n_params",
               "n_active_params", "accounting", "wall_seconds"}

SUB = textwrap.dedent("""
    import json, sys, time
    sys.path.insert(0, "src")
    t_start = time.time()
    import repro.launch.dryrun as D      # sets XLA_FLAGS in this process
    import repro.configs.shapes as S
    from repro.configs import ARCHS, get
    from repro.launch.mesh import make_host_mesh
    from repro.sharding import set_current_mesh

    out = {"analytic": {}, "account": {}}
    for arch in ARCHS:
        if arch == "paper-scorer":
            continue
        cfg = get(arch)
        for shape in S.SHAPES:
            for n_dev in (1, 256):
                out["analytic"][f"{arch}|{shape}|{n_dev}"] = {
                    "model_flops": D.model_flops(cfg, shape),
                    "flash": D.flash_kernel_costs(cfg, shape, n_dev),
                    "attn_score": D.attn_score_hbm_bytes(cfg, shape, n_dev)}
    SMALL = %r
    for name, (s, b) in SMALL.items():
        S.SHAPES[name] = S.Shape(name, s, b, S.SHAPES[name].kind)
    mesh = make_host_mesh(1, 1)
    set_current_mesh(mesh, "fsdp_tp")
    for arch in %r:
        cfg = get(arch).reduced()
        for shape in S.SHAPES:
            if S.shape_applicable(cfg, shape):
                continue
            out["account"][f"{arch}|{shape}"] = D.account_cell(
                cfg, shape, mesh, "fsdp_tp", flash=True)
    out["seconds"] = time.time() - t_start
    print("DRYRUN_REF " + json.dumps(out))
""" % (SMALL, FAMILY_ARCHS))


@pytest.fixture(scope="module")
def reference():
    """The reference's figures, from one subprocess (about 25 s)."""
    r = subprocess.run([sys.executable, "-c", SUB], capture_output=True,
                       text=True, cwd=str(ROOT), timeout=600)
    assert "DRYRUN_REF " in r.stdout, r.stdout[-2000:] + r.stderr[-3000:]
    return json.loads(r.stdout.split("DRYRUN_REF ", 1)[1])


@pytest.fixture
def small_shapes(monkeypatch):
    for name, (s, b) in SMALL.items():
        monkeypatch.setitem(S.SHAPES, name,
                            S.Shape(name, s, b, S.SHAPES[name].kind))


@pytest.mark.parametrize("n_dev", [1, 256])
@pytest.mark.parametrize("shape", SHAPE_NAMES)
@pytest.mark.parametrize("arch", ASSIGNED)
def test_analytic_functions_equal_the_reference(reference, arch, shape,
                                                n_dev):
    ref = reference["analytic"][f"{arch}|{shape}|{n_dev}"]
    cfg = get(arch)
    assert D.model_flops(cfg, shape) == ref["model_flops"]
    assert D.flash_kernel_costs(cfg, shape, n_dev) == ref["flash"]
    assert D.attn_score_hbm_bytes(cfg, shape, n_dev) == ref["attn_score"]


def _ratio_band(cfg, kind):
    if cfg.rwkv:
        return FLOP_TOL["rwkv"]
    return FLOP_TOL["decode" if kind == "decode" else "products"]


@pytest.mark.parametrize("cell", [f"{a}|{s}" for a in FAMILY_ARCHS
                                  for s in SHAPE_NAMES
                                  if not (s == "long_500k" and a in (
                                      "internlm2-1.8b", "olmoe-1b-7b"))])
def test_traced_counts_agree_with_xla(reference, small_shapes, cell):
    arch, shape = cell.split("|")
    ref = reference["account"][cell]
    cfg = get(arch).reduced()
    mine = D.account_cell(cfg, shape)
    kind = S.SHAPES[shape].kind
    # the reference's decomposition, with the decode kernel where the
    # reference's layer (or zamba2's shared block) holds its attention
    assert set(ref) <= set(mine) | {"flash_kernel"}
    assert mine["n_layers"] == ref["n_layers"]
    assert mine["layer_scale"] == ref["layer_scale"]
    assert mine.get("n_shared") == ref.get("n_shared")
    if "optimizer_flops_analytic" in ref:
        assert mine["optimizer_flops_analytic"] == \
            ref["optimizer_flops_analytic"]
    if kind != "decode":
        assert mine["flash_kernel"] == ref["flash_kernel"]
    dk = mine.get("decode_kernel", {"flops": 0.0})["flops"]
    n_attn = cfg.n_shared_attn if cfg.family == "hybrid" else cfg.n_layers
    lo, hi = _ratio_band(cfg, kind)
    for part in ("layer", "shared", "outer"):
        if part not in ref:
            continue
        got = mine[part]["flops"]
        if kind == "decode" and cfg.n_heads and part == (
                "shared" if cfg.family == "hybrid" else "layer"):
            got += dk / n_attn
        band = (FLOP_TOL["decode"] if kind == "decode" and part == "outer"
                else (lo, hi))
        ratio = got / ref[part]["flops"]
        assert band[0] <= ratio <= band[1], (part, ratio)
        assert mine[part]["collectives"]["total"] == 0.0


def _layer_matmuls(cfg, kind_cell):
    """The closed form of one forward layer's matrix-product FLOPs."""
    B, S_ = kind_cell
    T = B * S_
    d = cfg.d_model
    if cfg.rwkv:
        f, r, hd = cfg.d_ff, cfg.rwkv_decay_rank, cfg.ssm_head_dim
        time_mix = 5 * d * d + 2 * d * r
        return 2 * T * (time_mix + 2 * d * f + d * d) + 2 * T * d * hd
    if cfg.family == "hybrid":
        di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads, \
            cfg.ssm_head_dim
        in_dim = 2 * di + 2 * N + H
        Q = ssd_chunk(S_, cfg.ssm_chunk)
        nc = S_ // Q
        ssd = 2 * B * nc * (Q * Q * N + H * Q * Q * P + 2 * H * N * P * Q)
        return 2 * T * (d * in_dim + di * d) + ssd
    H, K, hd, f = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff
    attn = 2 * T * (d * H * hd + 2 * d * K * hd + H * hd * d)
    if cfg.is_moe:
        C = capacity(cfg, T)
        return attn + 2 * T * d * cfg.n_experts \
            + 3 * 2 * cfg.n_experts * C * d * f
    return attn + 2 * T * 3 * d * f


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "olmoe-1b-7b",
                                  "zamba2-1.2b", "rwkv6-3b",
                                  "zamba2-1.2b:shared"])
def test_layer_products_equal_their_closed_form(arch):
    """At full width and prefill_32k's shape (RWKV traced at 256 tokens and
    scaled by 128), and zamba2's shared block at full S: the dense layer's
    seven products, MoE's router and every expert's three (as the port runs
    them, over (E, C, .)), Mamba2's projections and the SSD's four
    einsums, RWKV6's projections and its WKV scan's r.S products."""
    name, _, part = arch.partition(":")
    cfg = get(name)
    shape = S.SHAPES["prefill_32k"]
    acc = D.account_cell(cfg, "prefill_32k")
    B = shape.global_batch
    if part == "shared":
        d, H, K, hd, f = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, \
            cfg.d_ff
        T = B * shape.seq_len
        want = 2 * T * (2 * d * (H * hd + 2 * K * hd) + H * hd * d
                        + 3 * d * f)
        assert acc["shared"]["matmul_flops"] == want
        return
    s_acc = min(shape.seq_len, D.RWKV_S_ACC) if cfg.rwkv else shape.seq_len
    assert acc["layer"]["matmul_flops"] == _layer_matmuls(cfg, (B, s_acc))
    assert acc["layer_scale"] == shape.seq_len / s_acc


def test_train_layer_is_forward_recompute_and_backward():
    """A dense layer under ``remat="block"``: the forward, its recompute
    (which stops before the last product, whose output the backward never
    needs) and the backward's two products for each forward one."""
    cfg = get("internlm2-1.8b")
    shape = S.SHAPES["train_4k"]
    T = shape.global_batch * shape.seq_len
    fwd = _layer_matmuls(cfg, (shape.global_batch, shape.seq_len))
    last = 2 * T * cfg.d_ff * cfg.d_model
    acc = D.account_cell(cfg, "train_4k")
    assert acc["layer"]["matmul_flops"] == 4 * fwd - last
    assert acc["optimizer_flops_analytic"] == 14.0 * M.n_params(cfg)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_decode_kernel_costs_equal_the_plain_versions_products(
        small_shapes, kv_quant):
    """``decode_kernel_costs`` against ``FlopCounterMode`` over the plain
    decode on real CPU tensors at (2, 64, 4 / 2, 32), the whole cache
    valid, once a layer; its bytes are q, o and each cache entry once."""
    cfg = get("internlm2-1.8b").reduced().replace(kv_quant=kv_quant)
    B, S_ = S.SHAPES["decode_32k"].global_batch, S.SHAPES["decode_32k"].seq_len
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    g = torch.Generator().manual_seed(0)
    q = torch.randn((B, H, hd), generator=g).to(torch.bfloat16)
    kc = torch.randn((B, S_, K, hd), generator=g).to(torch.bfloat16)
    vc = torch.randn((B, S_, K, hd), generator=g).to(torch.bfloat16)
    with FlopCounterMode(display=False) as fc:
        decode_attention_ref(q, kc, vc, S_)
    costs = D.decode_kernel_costs(cfg, "decode_32k", 1)
    assert costs["flops"] == cfg.n_layers * fc.get_total_flops()
    cache = M.make_cache(cfg, B, S_, "cpu")
    entries = [cache[n] for n in ("k", "v", "k_scale", "v_scale")
               if n in cache]
    per_layer = sum(t[0].numel() * t.element_size() for t in entries)
    assert costs["bytes"] == cfg.n_layers * (per_layer + 2 * q.numel() * 2)
    assert D.decode_kernel_costs(cfg, "prefill_32k", 1)["flops"] == 0.0


@pytest.mark.parametrize("shape", SHAPE_NAMES)
@pytest.mark.parametrize("arch", ASSIGNED)
def test_every_cell_traces_at_full_width(arch, shape):
    rec = D.run_cell(arch, shape)
    skip = S.shape_applicable(get(arch), shape)
    if skip:
        assert rec["status"] == skip
        return
    assert rec["status"] == "ok"
    assert RECORD_KEYS - {"wall_seconds"} <= set(rec)
    assert rec["mesh"] == "h100x1" and rec["n_devices"] == 1
    acc = rec["accounting"]
    for part in ("layer", "outer") + (("shared",) if "shared" in acc
                                      else ()):
        assert acc[part]["flops"] > 0 and acc[part]["bytes"] > 0
    mem = rec["memory"]
    assert mem["argument_bytes"] > mem["parameter_bytes"] > 0
    if arch == "deepseek-67b":
        assert not mem["fits_one_card"]
    assert rec["cache_bytes"] == sum(
        math.prod(s) * dt.itemsize for s, dt in
        M.cache_specs(get(arch), rec["global_batch"],
                      S.SHAPES[shape].seq_len).values())


def test_fits_one_card_at_the_measured_cells():
    """``internlm2-1.8b`` at decode_32k batch 8 fits one 80 GB card (3.8 GB
    of weights, 25.8 GB of cache, updated in place); ``moonshot-v1-16b-a3b``
    at batch 1 (56.1 GB of weights, 12.9 GB of cache) too, at batch 128 not."""
    rec = D.run_cell("internlm2-1.8b", "decode_32k", batch=8)
    assert rec["memory"]["fits_one_card"]
    assert rec["cache_bytes"] == 25769803780
    moon = D.run_cell("moonshot-v1-16b-a3b", "decode_32k", batch=1)
    assert moon["memory"]["fits_one_card"]
    assert moon["memory"]["parameter_bytes"] == 2 * 28057995264
    assert moon["cache_bytes"] == 12884901892
    assert not D.run_cell("moonshot-v1-16b-a3b", "decode_32k")[
        "memory"]["fits_one_card"]


def test_cache_bytes_are_make_caches(small_shapes):
    for arch in ("internlm2-1.8b", "rwkv6-3b", "zamba2-1.2b"):
        for kv in (False, True):
            cfg = get(arch).reduced().replace(
                kv_quant=kv and arch == "internlm2-1.8b")
            real = M.make_cache(cfg, 2, 64, "cpu")
            assert D.cache_bytes(cfg, 2, 64) == sum(
                t.numel() * t.element_size() for t in real.values())


def test_main_writes_a_record_a_cell_and_refuses_the_mesh(tmp_path):
    D.main(["--arch", "granite-3-2b", "--out", str(tmp_path)])
    names = sorted(p.name for p in tmp_path.glob("*.json"))
    assert names == sorted(f"granite-3-2b__{s}__h100x1.json"
                           for s in SHAPE_NAMES)
    rec = json.loads((tmp_path / names[0]).read_text())
    assert "wall_seconds" in rec
    # the mesh serves now: --multi-pod accounts the (2, 16, 16) mesh (no
    # per-layer accounting there, as in the reference), --moe-a2a the
    # all-to-all experts on the 16 x 16 mesh; each writes its record
    D.main(["--multi-pod", "--arch", "granite-3-2b", "--shape",
            "decode_32k", "--out", str(tmp_path)])
    D.main(["--moe-a2a", "--arch", "olmoe-1b-7b", "--shape", "prefill_32k",
            "--out", str(tmp_path)])
    pod = json.loads((tmp_path / "granite-3-2b__decode_32k__h100x2x16x16"
                      "__fsdp_tp.json").read_text())
    a2a = json.loads((tmp_path / "olmoe-1b-7b__prefill_32k__h100x16x16"
                      "__fsdp_tp.json").read_text())
    assert pod["status"] == a2a["status"] == "ok"
    assert pod["n_devices"] == 512 and "accounting" not in pod
    assert pod["full_collectives"]["all-gather"] > 0
    assert a2a["moe_impl"] == "a2a" and a2a["full_collectives"][
        "all-to-all"] > 0
    acc = D.account_cell(get("granite-3-2b"), "decode_32k",
                         D.mesh_of((16, 16)))
    assert acc["collectives"]["total"] > 0 and acc["rows"] == 8


def test_port_tally_counts_indexed_writes_by_their_rows():
    """An in-place write of one position into a (2, 4096, 8, 128) cache
    moves the token's rows, not the cache."""
    cache = torch.empty((2, 4096, 8, 128), dtype=torch.bfloat16,
                        device="meta")
    tok = torch.empty((2, 1, 8, 128), dtype=torch.bfloat16, device="meta")
    slot = torch.empty((1,), dtype=torch.int64, device="meta")
    with D.count() as c:
        cache.index_copy_(1, slot, tok)
    assert c.result()["bytes"] == 2 * tok.numel() * 2 + 8
    table = torch.empty((1000, 64), dtype=torch.bfloat16, device="meta")
    idx = torch.empty((3, 1), dtype=torch.int64, device="meta")
    with D.count() as c:
        table[idx]
    assert c.result()["bytes"] == 3 * 8 + 2 * 3 * 64 * 2
    assert np.isclose(c.result()["flops"], 0.0)
