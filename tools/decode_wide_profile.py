#!/usr/bin/env python3
"""Profile the decode kernel past head dim 256 on one CUDA card, each
variant of ``decode_attention.cu`` built alone.

    python3 tools/decode_wide_profile.py [--variant NAME=REPL ...]

Each variant is ``src/repro_torch/csrc/decode_attention.cu`` with some of
its constants replaced (``--variant budget128=kBudget:128`` sets
``kBudget`` to 128; several ``name:value`` pairs joined by ``,``; ``text:``
one of ``TEXT``, a piece of the kernel left out for timing only), built
with ``nvcc`` into a ``ctypes`` library under ``build/decode_profile/``
(all builds started together, ``-Xptxas -v`` kept beside it), checked
against the plain version (``decode_attention_ref``) over bf16, f32 and
int8 caches at head dims 320 and 512 and timed with CUDA events
(``chip_smoke.cuda_ms``, three times) at 8 lanes over (2048, 2, d) with 8
query heads, length 2048.  The source as it stands is the variant
``base``.  The card's name and power limit come first."""
import argparse
import ctypes
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
SRC = ROOT / "src" / "repro_torch" / "csrc" / "decode_attention.cu"
OUT = ROOT / "build" / "decode_profile"
CONSTANTS = ("kBudget", "kWideBlocksPerSM", "kStages",  # a variant sets
             "kStageBytes")
# timing-only variants (their outputs are wrong): one piece of the wide
# kernel left out, ``text:NAME``
TEXT = {"no_combine": ("  if (!sm_last) return;", "  return;"),
        "no_main": ("    const int steps = (c1 - c0 + NG * U - 1) / (NG * U);",
                    "    const int steps = 0;")}


def build(name: str, repl: dict) -> Path:
    text = SRC.read_text()
    for const, value in repl.items():
        if const == "text":
            head, tail = text.split("decode_attention_wide_kernel(const TQ*")
            old, new = TEXT[value]
            if old not in tail:
                raise SystemExit(f"{value}: text not found")
            text = (head + "decode_attention_wide_kernel(const TQ*"
                    + tail.replace(old, new, 1))
            continue
        if const not in CONSTANTS:
            raise SystemExit(f"{const}: not one of {CONSTANTS}")
        text, n = re.subn(rf"(constexpr int {const} = )\d+;",
                          rf"\g<1>{int(value)};", text)
        if n != 1:
            raise SystemExit(f"{const} not found once in {SRC}")
    OUT.mkdir(parents=True, exist_ok=True)
    src, lib = OUT / f"{name}.cu", OUT / f"lib{name}.so"
    src.write_text(text)
    out = subprocess.run(
        ["/usr/local/cuda/bin/nvcc", "-gencode=arch=compute_90a,code=sm_90a",
         "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
         "-Xptxas", "-v", "-o", str(lib), str(src)],
        capture_output=True, text=True)
    (OUT / f"{name}.ptxas.txt").write_text(out.stderr)
    if out.returncode:
        raise SystemExit(f"{name}: nvcc failed\n{out.stderr[-3000:]}")
    return lib


def wide_registers(name: str) -> list:
    """(template arguments, registers, spill stores) of each instance of
    the wide kernel in variant ``name``'s ``-Xptxas -v`` output."""
    out, fn = [], None
    for line in (OUT / f"{name}.ptxas.txt").read_text().splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif fn and "decode_attention_wide_kernel" in fn:
            if "spill stores" in line:
                spill = line.split("bytes spill stores")[0].split()[-1]
            if "Used" in line and "registers" in line:
                regs = line.split("Used ")[1].split(" ")[0]
                out.append((fn.split("wide_kernel")[1][:24], regs, spill))
                fn = None
    return out


def bind(lib_path: Path):
    lib = ctypes.CDLL(str(lib_path))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.decode_attention_plan.argtypes = [ci] * 6 + [ctypes.POINTER(ci)] * 2
    lib.decode_attention_plan.restype = ci
    lib.decode_attention_partial.argtypes = [ci]
    lib.decode_attention_partial.restype = ctypes.c_longlong
    lib.decode_attention_launch.argtypes = (
        [vp] * 9 + [ctypes.c_longlong] + [ci] * 7
        + [vp, ctypes.c_float, vp])
    lib.decode_attention_launch.restype = ci
    return lib


def caller(lib, q, kc, vc, n, ks=None, vs=None):
    """A function launching ``lib``'s kernel on these tensors, and its
    output tensor."""
    import torch

    code = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
    B, H, d = q.shape
    S, K = kc.shape[1], kc.shape[2]
    splits, chunk = ctypes.c_int(), ctypes.c_int()
    if not lib.decode_attention_plan(code[kc.dtype], B, S, H, K, d,
                                     ctypes.byref(splits),
                                     ctypes.byref(chunk)):
        raise SystemExit("no plan")
    ws = torch.empty(B * H * splits.value * lib.decode_attention_partial(d),
                     dtype=torch.float32, device=q.device)
    counters = torch.zeros(B * H * 8, dtype=torch.int32, device=q.device)
    o = torch.empty_like(q)
    st = [q.stride(0), q.stride(1), *kc.stride()[:3], *vc.stride()[:3],
          o.stride(0), o.stride(1)]
    st += [*ks.stride(), *vs.stride()] if ks is not None else [0] * 6
    strides = (ctypes.c_longlong * 16)(*st)

    def call():
        err = lib.decode_attention_launch(
            q.data_ptr(), kc.data_ptr(), vc.data_ptr(),
            ks.data_ptr() if ks is not None else None,
            vs.data_ptr() if vs is not None else None, n.data_ptr(),
            o.data_ptr(), ws.data_ptr(), counters.data_ptr(),
            counters.numel(), code[q.dtype], code[kc.dtype], B, S, H, K, d,
            strides, d ** -0.5, torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"launch failed: {err}")

    return call, o, (splits.value, chunk.value)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variant", action="append", default=[])
    args = ap.parse_args()
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    variants = {"base": {}}
    for v in args.variant:
        name, spec = v.split("=", 1)
        variants[name] = dict(p.split(":") for p in spec.split(","))
    with ThreadPoolExecutor(len(variants)) as ex:
        libs = dict(zip(variants, ex.map(lambda kv: build(*kv),
                                         variants.items())))
    dev = torch.device("cuda")
    L, S, H, K = 8, 2048, 8, 2
    n = torch.tensor(S, dtype=torch.int32, device=dev)
    for d in (320, 512):
        cases = {}
        for dt in (torch.bfloat16, torch.float32):
            cases[str(dt).split(".")[-1]] = (
                cs._randn(dev, (L, H, d), dt, 0),
                cs._randn(dev, (L, S, K, d), dt, 1),
                cs._randn(dev, (L, S, K, d), dt, 2))
        kc, ks = cs.int8_cache(dev, L, S, K, d, S, 1)
        vc, vs = cs.int8_cache(dev, L, S, K, d, S, 2)
        cases["int8"] = (cs._randn(dev, (L, H, d), torch.bfloat16, 0), kc,
                         vc, ks, vs)
        for tag, args_ in cases.items():
            q, kc, vc = args_[:3]
            exp = decode_attention_ref(q, kc, vc, S, *args_[3:])
            for name, path in libs.items():
                call, o, plan = caller(bind(path), q, kc, vc, n, *args_[3:])
                call()
                err, ok, tol = cs.attn_error("decode", o, exp)
                ms = [cs.cuda_ms(call) for _ in range(3)]
                print(f"[{name}] d {d} {tag}: (splits, chunk) {plan}, "
                      + " ".join(f"{t:.4f}" for t in ms)
                      + f" ms, max|d| {err:.3e} ok {ok}", flush=True)
                if not ok and "text" not in variants[name]:
                    raise SystemExit(f"{name} disagrees at d {d} {tag}")
    for name in libs:
        print(f"[{name}] ptxas (instance, registers, spill bytes): "
              f"{wide_registers(name)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
