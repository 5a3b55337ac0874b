"""The port's CPU results do not depend on which intra-op thread runs first
(ROADMAP C11).

MKL's vector math library, which ATen calls for ``torch.cos``, ``sin``,
``exp`` and the other elementwise functions of ``device._VML_OPS`` on the
CPU, can compute a worker thread's share of its first call in a process
with another implementation when that call runs on several threads at
once: at two threads, the worker's half of the (16, 32, 16) RoPE angle
table of the reduced ``olmoe-1b-7b`` step came out up to 2534 ulps off in
about one fresh process in 40, and a CPU mesh rank's layer input with it
(found by ``tests/torch_mesh_ranks.py::c11_cases``).  Importing
``repro_torch`` now calls each of those functions once on one thread
(``device.warm_cpu_math``), so no later call is a first call.

The fault is a race, so a test cannot make it happen on demand: the
fresh-process test below runs the first two-thread cos in 12 processes.
Without the warm-up the same script differed in 3 of 240 processes (so
about one run of the test in seven would fail), with it in none of 320.
Its bar is exact equality with the same call on one thread.
"""
import os
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch import device
from repro_torch.models.layers import apply_rope

SRC = Path(__file__).resolve().parent.parent / "src"
PROCESSES = 12

# in a fresh process: the port imported, two intra-op threads, then the
# reduced olmoe step's (16, 32, 16) RoPE angle table through ``torch.cos``
# on the two threads (the process's first multi-threaded cos), then again
# on one thread
FIRST_CALL = r"""
import torch
import repro_torch
torch.set_num_threads(2)
pos = torch.arange(32, dtype=torch.float32)[None, :, None].expand(16, 32, 1)
freqs = 1.0 / (10000.0 ** (torch.arange(0, 32, 2, dtype=torch.float32) / 32))
ang = pos * freqs
two = torch.cos(ang)
torch.set_num_threads(1)
print("same" if torch.equal(two, torch.cos(ang)) else "DIFF")
"""


def test_first_two_thread_cos_is_the_one_thread_result():
    procs = [subprocess.Popen([sys.executable, "-c", FIRST_CALL],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True,
                              env={**os.environ, "PYTHONPATH": str(SRC)})
             for _ in range(PROCESSES)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e[-2000:] for _, e in outs]
    assert [o.strip() for o, _ in outs] == ["same"] * PROCESSES


def test_warm_cpu_math_covers_rope_and_repeats_nothing_new():
    """The warm-up calls RoPE's cos and sin; calling it again leaves a
    two-thread RoPE equal to a one-thread one."""
    assert torch.cos in device._VML_OPS and torch.sin in device._VML_OPS
    device.warm_cpu_math()
    x = torch.randn(16, 32, 4, 32, generator=torch.Generator().manual_seed(0))
    pos = torch.arange(32)[None, :].expand(16, 32)
    threads = torch.get_num_threads()
    try:
        torch.set_num_threads(2)
        two = apply_rope(x, pos, 10000.0)
        torch.set_num_threads(1)
        one = apply_rope(x, pos, 10000.0)
    finally:
        torch.set_num_threads(threads)
    assert torch.equal(two, one)
