"""Builds the port's CUDA kernels at first use.

All sources under ``repro_torch/csrc`` go to one
``torch.utils.cpp_extension.load`` call, compiled for ``sm_90a`` (Hopper)
into ``build/torch_kernels/`` at the root of the checkout, which
``.gitignore`` lists.  Only ``bindings.cpp`` includes PyTorch's headers; the
``.cu`` files expose plain C entry points, so nvcc never parses PyTorch.
Nothing here runs at import: the CPU tests import every module.
"""
from __future__ import annotations

import functools
import re
import subprocess
from pathlib import Path

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_SOURCES = ("bindings.cpp", "pair_scores.cu", "pair_scores_compact.cu",
            "union_deduce.cu", "flash_attention.cu",
            "flash_attention_wgmma.cu", "decode_attention.cu")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"


@functools.cache
def extension():
    """The compiled extension module (built on the first call)."""
    from torch.utils.cpp_extension import load

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return load(
        name="repro_torch_kernels",
        sources=[str(_CSRC / s) for s in _SOURCES],
        build_directory=str(BUILD_DIR),
        extra_cflags=["-O2"],
        extra_cuda_cflags=["-O3", "-gencode=arch=compute_90a,code=sm_90a"],
        extra_ldflags=["-ldl"],   # dlsym of libcuda's tensor-map encoder
        verbose=False,
    )


def _cuobjdump(flag: str) -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    return subprocess.run(
        [str(Path(CUDA_HOME) / "bin" / "cuobjdump"), flag,
         extension().__file__],
        capture_output=True, text=True, check=True).stdout


def resources(name: str) -> dict:
    """Registers, stack bytes and the like (``{"REG": 127, "STACK": 0,
    ...}``) of the first built kernel whose mangled name contains ``name``,
    as ``cuobjdump -res-usage`` prints them."""
    found = resources_all(name)
    if not found:
        raise KeyError(f"no built kernel named like {name!r}")
    return next(iter(found.values()))


def resources_all(name: str) -> dict:
    """:func:`resources` of every built kernel whose mangled name contains
    ``name`` (each instance of a template), by mangled name, in the order
    ``cuobjdump`` lists them."""
    lines = _cuobjdump("-res-usage").splitlines()
    return {head.strip().split(None, 1)[1].rstrip(":"):
            {k: int(v) for k, v in
             re.findall(r"([A-Z]+(?:\[\d+\])?):(\d+)", usage)}
            for head, usage in zip(lines, lines[1:])
            if head.strip().startswith("Function ") and name in head}


def sass(name: str) -> str:
    """The SASS of the built extension's kernels whose mangled name contains
    ``name``, as the CUDA toolkit's ``cuobjdump -sass`` prints it: how a
    reader can see which instructions (``HGMMA``, ``UTMALDG``) a kernel
    really runs."""
    dump = _cuobjdump("-sass")
    return "".join(f for f in dump.split("Function : ")[1:]
                   if name in f.split("\n", 1)[0])
