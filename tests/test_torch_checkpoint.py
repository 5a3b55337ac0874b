"""The port's ``CheckpointManager`` (ROADMAP A10): the checkpoint cases of
``tests/test_train.py`` on torch tensors — the bit-exact round trip, gc and
latest, a background failure surfacing, a crash at the commit keeping the
previous step, a leftover ``.tmp``, bf16 without ``ml_dtypes``, gc during a
background save, dataclass statics — and the refusal of a class path outside
``repro_torch`` (a manifest written by the JAX package names its own
classes; importing one would load JAX inside the port).  The mesh case waits
for A8.  The on-disk layout is the reference's: the same tree gives the same
manifest keys and dtypes in both packages."""
import json
import os
import threading

import numpy as np
import pytest
import torch

from repro_torch.configs import get
from repro_torch.core.graph import SessionState, make_session_state
from repro_torch.models.model import init_params
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train.checkpoint import CheckpointManager

CFG = get("paper-scorer").reduced()


def test_checkpoint_roundtrip_bitexact(tmp_path):
    """The reduced paper-scorer's bf16 and f32 parameters come back with
    their dtypes, bit for bit, and the manifest lists the reference's
    parameter paths with the bf16 leaves recorded as ``"bfloat16"``."""
    import jax

    from repro.models.model import init_params as jax_init_params
    from repro.train.checkpoint import CheckpointManager as JaxManager

    model = init_params(CFG, torch.Generator().manual_seed(0), "cpu")
    state = {"params": model.params, "step": torch.tensor(3)}
    cm = CheckpointManager(tmp_path / "port", keep=2)
    cm.save(3, state, extra={"cursor": 3})
    step, restored, extra = cm.restore()
    assert step == 3 and extra["cursor"] == 3
    flat = ckpt_mod._flatten(state)
    got = ckpt_mod._flatten(restored)
    assert sorted(flat) == sorted(got)
    for k, a in flat.items():
        b = got[k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a, b.view(torch.int16)
                           if b.dtype == torch.bfloat16 else b), k
    jax_params = jax_init_params(CFG, jax.random.PRNGKey(0))
    JaxManager(tmp_path / "ref").save(3, {"params": jax_params,
                                          "step": np.asarray(3)})
    manifests = [json.loads((tmp_path / d / "step_00000003" /
                             "manifest.json").read_text())
                 for d in ("port", "ref")]
    assert manifests[0]["keys"] == manifests[1]["keys"]
    assert manifests[0]["dtypes"] == manifests[1]["dtypes"]
    assert "bfloat16" in manifests[0]["dtypes"].values()


def test_checkpoint_gc_and_latest(tmp_path):
    cm = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        cm.save(s, {"x": torch.ones(3)})
    assert cm.all_steps() == [3, 4]
    assert cm.latest_step() == 4


def test_background_save_failure_surfaces(tmp_path, monkeypatch):
    """A failed background write re-raises from ``wait()``; the manager
    stays usable once the cause clears."""
    cm = CheckpointManager(tmp_path, keep=2)

    def boom(*a, **k):
        raise OSError("disk full (injected)")

    monkeypatch.setattr(ckpt_mod.np, "savez", boom)
    cm.save(1, {"x": torch.ones(3)}, background=True)
    with pytest.raises(RuntimeError, match="background checkpoint save"):
        cm.wait()
    monkeypatch.undo()
    cm.save(2, {"x": torch.ones(3)}, background=True)
    cm.wait()
    assert cm.latest_step() == 2


def test_background_failure_surfaces_from_next_save_and_restore(
        tmp_path, monkeypatch):
    """Without a ``wait()``, the next ``save`` or ``restore`` re-raises a
    background failure, and a background save copies tensors the caller
    changes in place afterwards."""
    cm = CheckpointManager(tmp_path, keep=3)
    monkeypatch.setattr(ckpt_mod.np, "savez",
                        lambda *a, **k: (_ for _ in ()).throw(OSError("x")))
    cm.save(1, {"x": torch.ones(3)}, background=True)
    cm._thread.join()  # the writer has failed; nothing has asked yet
    monkeypatch.undo()
    with pytest.raises(RuntimeError, match="background checkpoint save"):
        cm.save(2, {"x": torch.ones(3)})
    x = torch.zeros(4)
    cm.save(3, {"x": x}, background=True)
    x += 7.0
    cm.save(4, {"x": torch.ones(2)}, background=True)
    _, state, _ = cm.restore(3)
    assert torch.equal(state["x"], torch.zeros(4))
    monkeypatch.setattr(ckpt_mod.np, "savez",
                        lambda *a, **k: (_ for _ in ()).throw(OSError("y")))
    cm.save(5, {"x": torch.ones(3)}, background=True)
    cm._thread.join()
    monkeypatch.undo()
    with pytest.raises(RuntimeError, match="background checkpoint save"):
        cm.restore()


def test_crash_at_commit_preserves_previous_checkpoint(tmp_path,
                                                       monkeypatch):
    """Re-saving a step parks the old dir at ``.old`` first, so a crash at
    the commit rename still leaves a restorable checkpoint."""
    cm = CheckpointManager(tmp_path, keep=2)
    cm.save(5, {"x": torch.full((3,), 1.0)})
    real_rename = os.rename

    def crash_at_commit(src, dst):
        if str(src).endswith(".tmp"):
            raise OSError("killed at commit (injected)")
        return real_rename(src, dst)

    monkeypatch.setattr(ckpt_mod.os, "rename", crash_at_commit)
    with pytest.raises(OSError, match="killed at commit"):
        cm.save(5, {"x": torch.full((3,), 2.0)})
    monkeypatch.undo()
    assert cm.all_steps() == [5]
    _, state, _ = cm.restore()
    assert torch.equal(state["x"], torch.full((3,), 1.0))
    cm.save(5, {"x": torch.full((3,), 3.0)})
    _, state, _ = cm.restore()
    assert torch.equal(state["x"], torch.full((3,), 3.0))
    assert not (tmp_path / "step_00000005.old").exists()


def test_restore_ignores_leftover_tmp(tmp_path):
    """A crash mid-write leaves a ``.tmp`` dir: invisible to ``all_steps``
    and ``restore``, clobbered by a later save of the same step."""
    cm = CheckpointManager(tmp_path, keep=3)
    cm.save(1, {"x": torch.ones(2)})
    stray = tmp_path / "step_00000002.tmp"
    stray.mkdir()
    (stray / "arrays.npz").write_bytes(b"truncated")
    assert cm.all_steps() == [1]
    assert cm.latest_step() == 1
    cm.save(2, {"x": torch.full((2,), 2.0)})
    assert cm.all_steps() == [1, 2]
    _, state, _ = cm.restore(2)
    assert torch.equal(state["x"], torch.full((2,), 2.0))


def test_checkpoint_bfloat16_roundtrip(tmp_path):
    """bf16 leaves round-trip bit-exact through their uint16 bits, with no
    ``ml_dtypes``; a bf16 leaf the reference saved restores as bf16."""
    x = torch.linspace(-3, 3, 16).to(torch.bfloat16)
    cm = CheckpointManager(tmp_path)
    cm.save(0, {"x": x, "y": torch.ones(4, dtype=torch.float32)})
    _, state, _ = cm.restore()
    assert state["x"].dtype == torch.bfloat16
    assert torch.equal(x.view(torch.int16), state["x"].view(torch.int16))
    assert state["y"].dtype == torch.float32
    with np.load(tmp_path / "step_00000000" / "arrays.npz") as z:
        assert z["x"].dtype == np.uint16
    import jax.numpy as jnp

    from repro.train.checkpoint import CheckpointManager as JaxManager
    ref = jnp.asarray(np.linspace(-3, 3, 16), dtype=jnp.bfloat16)
    JaxManager(tmp_path / "ref").save(0, {"x": ref})
    _, state, _ = CheckpointManager(tmp_path / "ref").restore()
    assert state["x"].dtype == torch.bfloat16
    assert np.array_equal(state["x"].view(torch.int16).numpy(),
                          np.asarray(ref).view(np.int16))


def test_gc_spares_latest_during_background_save(tmp_path):
    """keep=1 with a background save in flight: the previous step survives
    until the new one commits."""
    cm = CheckpointManager(tmp_path, keep=1)
    cm.save(1, {"x": torch.ones(2)})
    gate = threading.Event()
    real_savez = np.savez

    def slow_savez(path, **arrays):
        gate.wait(timeout=30)
        return real_savez(path, **arrays)

    ckpt_mod.np.savez = slow_savez
    try:
        cm.save(2, {"x": torch.full((2,), 2.0)}, background=True)
        assert cm.all_steps() == [1]
    finally:
        gate.set()
        cm.wait()
        ckpt_mod.np.savez = real_savez
    assert cm.all_steps() == [2]


@pytest.mark.parametrize("n_objects", [3, 50000], ids=["int32", "int64"])
def test_checkpoint_dataclass_statics_roundtrip(tmp_path, n_objects):
    """``SessionState`` subtrees: tensor fields ride the npz, ``n_objects``
    the manifest, and restore rebuilds the instance — its keys in the dtype
    they were saved in (int64 with the int64 sentinel past 46340 objects),
    on the device asked for."""
    state = make_session_state(
        np.array([0, 1], np.int32), np.array([1, 2], np.int32), n_objects,
        pair_capacity=8, object_capacity=8, device="cpu")
    cm = CheckpointManager(tmp_path)
    cm.save(0, {"session": state, "extra": torch.ones(2)})
    _, restored, _ = cm.restore(device="cpu")
    got = restored["session"]
    assert isinstance(got, SessionState)
    assert got.n_objects == state.n_objects
    assert got.neg_keys.dtype == (torch.int32 if n_objects < 46341
                                  else torch.int64)
    for f in SessionState.TENSOR_FIELDS:
        a, b = getattr(state, f), getattr(got, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f
    manifest = json.loads((tmp_path / "step_00000000" /
                           "manifest.json").read_text())
    assert manifest["classes"] == {
        "session": "repro_torch.core.graph.SessionState"}
    assert manifest["statics"] == {"session/n_objects": state.n_objects}


def test_class_outside_repro_torch_is_refused(tmp_path):
    """A manifest naming a class outside ``repro_torch`` — the reference's
    ``SessionState`` above all — is refused with a ``ValueError`` before
    anything is imported."""
    from repro.core.jax_graph import make_session_state as jax_make
    from repro.train.checkpoint import CheckpointManager as JaxManager

    JaxManager(tmp_path).save(0, {"session": jax_make(
        np.array([0], np.int32), np.array([1], np.int32), 2,
        pair_capacity=8, object_capacity=8)})
    with pytest.raises(ValueError, match="outside repro_torch"):
        CheckpointManager(tmp_path).restore()
    for name in ("repro.core.jax_graph.SessionState", "jax.numpy.ndarray",
                 "os.path.join"):
        with pytest.raises(ValueError, match="outside repro_torch"):
            ckpt_mod._resolve_class(name)
    assert ckpt_mod._resolve_class(
        "repro_torch.core.graph.SessionState") is SessionState
