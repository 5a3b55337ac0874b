"""The port stands alone and never drops to its plain versions on its own:

* nothing under ``src/repro_torch/``, nor ``chip_smoke.py``, ``chip_ab.py``,
  ``examples/torch_quickstart.py`` or
  ``examples/torch_train_likelihood_model.py``, imports ``jax``
  or the JAX package ``repro`` (checked on the syntax tree, so lazy imports
  inside functions count too);
* each kernel wrapper, given tensors that do not lie on the CPU, goes to its
  CUDA kernel and raises there when no CUDA device can take them — it never
  computes the plain version instead — and the entry points' default device
  (the join service's, the model's, the LM launcher's) is the card.
"""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py", ROOT / "chip_ab.py",
     ROOT / "examples" / "torch_quickstart.py",
     ROOT / "examples" / "torch_train_likelihood_model.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module and _forbidden(node.module):
            bad.append(node.module)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_kernel_wrappers_raise_instead_of_computing(monkeypatch):
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import kernel as da_kernel
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.pair_scores import kernel as ps_kernel
    from repro_torch.kernels.pair_scores import ops as ps_ops
    from repro_torch.kernels.union_deduce import kernel as ud_kernel
    from repro_torch.kernels.union_deduce import ops as ud_ops

    def no_plain(*args, **kwargs):
        raise AssertionError("a wrapper fell back to its plain version")

    monkeypatch.setattr(ps_ops, "pair_scores_ref", no_plain)
    monkeypatch.setattr(ps_ops, "pair_scores_compact_ref", no_plain)
    monkeypatch.setattr(ud_ops, "union_deduce_ref", no_plain)
    monkeypatch.setattr(fa_ops, "mha_causal_ref", no_plain)
    monkeypatch.setattr(da_ops, "decode_attention_ref", no_plain)
    monkeypatch.setattr(_build, "extension", no_plain)
    meta = torch.device("meta")
    a = torch.empty(128, 16, device=meta)
    with pytest.raises(ValueError, match="CUDA"):
        ps_ops.pair_scores(a, a, 0.5)
    ids = torch.empty(128, 1, dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match="CUDA"):
        ps_ops.pair_scores_compact(a, a, ids, ids, 0.5, 64, 128, 128)
    forest = torch.empty(1, 8, dtype=torch.int32, device=meta)
    pairs = torch.empty(1, 4, dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match="CUDA"):
        ud_ops.union_deduce(forest, pairs, pairs, pairs.bool(), pairs, 8)
    q = torch.empty(2, 64, 4, 64, device=meta)
    kv = torch.empty(2, 64, 2, 64, device=meta)
    with pytest.raises(ValueError, match="CUDA"):
        fa_ops.flash_attention(q, kv, kv)
    for length in (5, torch.tensor(5, dtype=torch.int32),
                   torch.empty((), dtype=torch.int32, device=meta)):
        with pytest.raises(ValueError, match="CUDA"):
            da_ops.decode_attention(q[:, 0], kv, kv, length)
    # the kernels themselves refuse CPU tensors rather than compute
    with pytest.raises(ValueError, match="CUDA"):
        ps_kernel.pair_scores(torch.zeros(128, 16), torch.zeros(128, 16),
                              0.5, 128)
    with pytest.raises(ValueError, match="CUDA"):
        ps_kernel.pair_scores_compact(
            torch.zeros(128, 16), torch.zeros(128, 16),
            torch.zeros(128, 1, dtype=torch.int32),
            torch.zeros(128, 1, dtype=torch.int32), 0.5, 64, 128, 128)
    with pytest.raises(ValueError, match="CUDA"):
        ud_kernel.union_deduce(torch.zeros(1, 8, dtype=torch.int32),
                               torch.zeros(1, 4, dtype=torch.int32),
                               torch.zeros(1, 4, dtype=torch.int32),
                               torch.zeros(1, 4, dtype=torch.bool),
                               torch.zeros(1, 4, dtype=torch.int32), 8)
    with pytest.raises(ValueError, match="CUDA"):
        fa_kernel.flash_attention(torch.zeros(1, 8, 2, 64),
                                  torch.zeros(1, 8, 2, 64),
                                  torch.zeros(1, 8, 2, 64))
    with pytest.raises(ValueError, match="CUDA"):
        da_kernel.decode_attention(torch.zeros(1, 2, 64),
                                   torch.zeros(1, 8, 2, 64),
                                   torch.zeros(1, 8, 2, 64),
                                   torch.tensor(3, dtype=torch.int32))
    assert fa_ops.flash_attention.launches == 0
    assert da_ops.decode_attention.launches == 0
    assert ps_ops.pair_scores.launches == 0
    assert ps_ops.pair_scores_compact.launches == 0
    assert ud_ops.union_deduce.launches == 0


def test_entry_points_default_to_the_card(monkeypatch):
    from repro_torch.configs import get
    from repro_torch.core.graph import make_session_state
    from repro_torch.device import pick_device
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.models.model import init_params, make_cache
    from repro_torch.serve.join_service import JoinService

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pick_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        JoinService()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_session_state([0], [1], 2)
    cfg = get("paper-scorer").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_main([])
    assert pick_device("cpu") == torch.device("cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert not \
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction


def test_pipeline_entry_points_default_to_the_card(monkeypatch):
    """The engine labeler and the from-scratch wrappers run on the card
    unless asked for the CPU; the host labelers need no device."""
    from repro_torch.core import graph
    from repro_torch.core.crowd import PerfectCrowd
    from repro_torch.core.join import crowdsourced_join
    from repro_torch.data.entities import make_session_pairsets

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ps = make_session_pairsets(1, seed=0)[0]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        crowdsourced_join(ps, PerfectCrowd(), labeler="torch")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        graph.label_parallel_torch(ps.u, ps.v, ps.n_objects,
                                   lambda idx: idx * 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        graph.connected_components(ps.u, ps.v, ps.truth, ps.n_objects)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        graph.boruvka_frontier(ps.u, ps.v, ps.u * 0 - 1, ps.truth,
                               ps.n_objects)
    for labeler in ("sequential", "parallel", "all"):
        res = crowdsourced_join(ps, PerfectCrowd(), labeler=labeler)
        assert np.array_equal(res.labels, ps.truth)
    res = crowdsourced_join(ps, PerfectCrowd(), labeler="torch",
                            device="cpu")
    assert np.array_equal(res.labels, ps.truth)
