"""The port's examples (``examples/torch_*.py``) against the reference's
examples of the same names, on the CPU (``--device cpu``).

* ``torch_sharded_join.py``: at ``--mesh 1x1`` its seven lines equal
  ``sharded_join.py``'s on its 1 x 1 host mesh (two lanes, the blocked
  run, async against the round barrier); at ``--mesh 4x2`` (8 gloo CPU
  ranks) the same rows after its mesh line.
* ``torch_streaming_join.py``: its three lines equal
  ``streaming_join.py``'s (numpy-seeded embeddings, ``PerfectCrowd``; the
  reference's 1 x 1 host mesh is the port's ``mesh=None``).
* ``torch_query_plan.py``: every line equal ``query_plan.py``'s, the plan
  descriptions included (the two packages' plan classes share their
  names).
* ``torch_crowdsourced_join.py``: the reduced ``paper-scorer`` carried
  across from the reference's ``init_params(PRNGKey(0))``, bf16 as the
  example runs it.  The port's likelihood matrix over the 256 x 256
  records is the reference's within
  ``tests/test_torch_engine.py::test_score_pairs_with_lm_matches_reference``'s
  bf16 tolerance, 2e-2; on its own matrix each side finds 42 candidates
  above 0.62 (41 true matches).  With the reference's matrix injected
  through ``main`` (so that a pair within a bf16 ulp of the threshold
  cannot change the candidate set), every ``[machine]`` candidate,
  ``[human]``, ``[quality]``, ``[serve]`` and ``[latency]`` line equals the
  reference's; only the first line's scoring time differs.
* ``torch_serve_llm.py`` (``internlm2-1.8b`` and ``rwkv6-3b`` reduced, 6
  requests over 3 lanes, 8 new tokens): the reference engine's multi-step
  decode drops the decoded tokens' keys and values (ROADMAP R5), so the
  port's tokens are held as ``tests/test_torch_engine.py`` holds them: with
  f32 parameters and caches on both sides (the reference's bf16 prefill
  cache cast to f32, ROADMAP R6), the first two tokens of every request
  equal the reference example's, and every token is greedy over the
  reference model's own forward of the wave so far.  RWKV's reference
  decode keeps its states, so there every token equals the reference
  example's.
"""
import ast
import importlib.util
import io
import runpy
import sys
from contextlib import redirect_stdout
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jax_get
from repro.models import model as JM
from repro_torch.configs import get
from repro_torch.convert import model_params_from_numpy
from repro_torch.models import model as M

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"


def _np32(x):
    return np.asarray(x, np.float32)


def _load(script: str, name: str):
    """An example as a module, its ``main`` not run."""
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / script)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lines(fn) -> list:
    buf = io.StringIO()
    with redirect_stdout(buf):
        fn()
    return buf.getvalue().splitlines()


@pytest.mark.parametrize("name", ["streaming_join", "query_plan"])
def test_join_example_prints_the_reference_example(name):
    ref = _lines(lambda: runpy.run_path(str(EXAMPLES / f"{name}.py"),
                                        run_name="reference_example"))
    port = _lines(lambda: runpy.run_path(
        str(EXAMPLES / f"torch_{name}.py"),
        run_name="example")["main"](["--device", "cpu"]))
    assert len(ref) == (3 if name == "streaming_join" else 21)
    assert port == ref


def test_sharded_join_example_prints_the_reference_rows(monkeypatch):
    """``torch_sharded_join.py`` at ``--mesh 1x1`` prints the reference
    example's rows on its 1 x 1 host mesh, and at ``--mesh 4x2`` (8 gloo
    ranks on the CPU) the same rows after its mesh line."""
    ref = _lines(lambda: runpy.run_path(str(EXAMPLES / "sharded_join.py"),
                                        run_name="reference_example"))
    # the ranks import the example by name
    monkeypatch.syspath_prepend(str(EXAMPLES))
    import torch_sharded_join as example

    one = _lines(lambda: example.main(["--device", "cpu"]))
    mesh = _lines(lambda: example.main(["--device", "cpu", "--mesh", "4x2"]))
    assert len(ref) == 7 and ref[0] == "mesh: {'data': 1, 'model': 1}"
    assert one == ref
    assert mesh[0] == "mesh: {'data': 4, 'model': 2}" and mesh[1:] == ref[1:]


def test_crowdsourced_join_example_matches_the_reference(monkeypatch):
    ref_mod = _load("crowdsourced_join.py", "reference_crowdsourced_join")
    port_mod = _load("torch_crowdsourced_join.py", "torch_crowdsourced_join")
    seen = {}

    def spy(module, key):
        real = module.score_pairs_with_lm

        def wrapped(*args, **kwargs):
            seen[key] = real(*args, **kwargs)
            return seen[key]
        monkeypatch.setattr(module, "score_pairs_with_lm", wrapped)

    spy(ref_mod, "ref")
    spy(port_mod, "port")
    monkeypatch.setattr(sys, "argv", ["crowdsourced_join.py"])
    ref = _lines(ref_mod.main)
    params = JM.init_params(jax_get("paper-scorer").reduced(),
                            jax.random.PRNGKey(0))
    model = model_params_from_numpy(get("paper-scorer").reduced(),
                                    jax.tree.map(_np32, params), "cpu")
    own = _lines(lambda: port_mod.main(["--device", "cpu"], model=model))
    injected = _lines(lambda: port_mod.main(["--device", "cpu"], model=model,
                                            likelihood=seen["ref"]))
    assert seen["port"].shape == seen["ref"].shape == (256, 256)
    np.testing.assert_allclose(seen["port"], seen["ref"], rtol=0, atol=2e-2)
    assert ref[1] == own[1] == \
        "[machine] 42 candidates above 0.62 (41 true matches)"
    assert len(ref) == len(injected) == 7
    for lines in (ref, injected):
        assert lines[0].startswith("[machine] scored 256x256 pairs with the "
                                   "LM + pair_scores kernel in ")
    assert injected[1:] == ref[1:]


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "rwkv6-3b"])
def test_serve_llm_example_holds_the_reference_model(monkeypatch, arch):
    jcfg, cfg = jax_get(arch).reduced(), get(arch).reduced()
    p32 = jax.tree.map(lambda x: x.astype(jnp.float32),
                       JM.init_params(jcfg, jax.random.PRNGKey(0)))
    # the reference example under f32 parameters, its prefill cache as f32
    ref_mod = _load("serve_llm.py", "reference_serve_llm")
    monkeypatch.setattr(ref_mod, "init_params", lambda c, k: p32)
    prefill = JM.prefill

    def prefill_f32_cache(*args, **kwargs):
        cache, logits = prefill(*args, **kwargs)
        return {n: t if n == "length" else t.astype(jnp.float32)
                for n, t in cache.items()}, logits

    monkeypatch.setattr(JM, "prefill", prefill_f32_cache)
    monkeypatch.setattr(sys, "argv", ["serve_llm.py", "--arch", arch])
    ref = _lines(ref_mod.main)
    monkeypatch.setattr(JM, "prefill", prefill)

    make_cache = M.make_cache
    monkeypatch.setattr(M, "make_cache", lambda *a, **k: {
        n: t if n == "length" else t.float()
        for n, t in make_cache(*a, **k).items()})
    model = model_params_from_numpy(cfg, jax.tree.map(_np32, p32),
                                    "cpu").float()
    port_mod = _load("torch_serve_llm.py", "torch_serve_llm")
    port = _lines(lambda: port_mod.main(["--device", "cpu", "--arch", arch],
                                        model=model))

    def tokens(lines):
        return {int(line.split()[2]):
                ast.literal_eval(line.split("-> tokens ")[1])
                for line in lines}

    got, ref_tok = tokens(port), tokens(ref)
    assert sorted(got) == sorted(ref_tok) == list(range(6))
    assert all(line.startswith(f"[{arch}] request ") for line in port)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(2, cfg.vocab, size=int(rng.integers(
        4, 20))).astype(np.int32) for _ in range(6)]
    for w in range(0, 6, 3):
        wave = list(range(w, w + 3))
        S = max(len(prompts[i]) for i in wave)
        seq = np.zeros((3, S + 8), np.int32)
        for j, i in enumerate(wave):
            seq[j, S - len(prompts[i]):S] = prompts[i]
            seq[j, S:] = got[i]
        x, pos = JM._embed_inputs(p32, {"tokens": jnp.asarray(seq)}, jcfg)
        logits = np.asarray(JM._logits(p32, JM.backbone(p32, x, pos, jcfg)[0],
                                       jcfg))[:, S - 1:S + 7]
        for j, i in enumerate(wave):
            for step in range(8):
                if logits[j, step].argmax() != got[i][step]:
                    top = np.sort(logits[j, step])[-2:]
                    pytest.fail(f"request {i} diverges from the reference "
                                f"model at step {step}: top-2 margin "
                                f"{top[1] - top[0]:.3e}")
    for i in range(6):
        assert len(got[i]) == 8
        assert got[i][:2] == ref_tok[i][:2]
    if cfg.rwkv:
        # the reference's RWKV decode keeps its states (no R5): every token
        assert got == ref_tok
