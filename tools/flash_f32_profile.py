#!/usr/bin/env python3
"""Profile f32 flash-attention kernels on one CUDA card, each built alone.

    python3 tools/flash_f32_profile.py [--parent FILE] [--new FILE]
                                       [--variants] [--sdpa]

Each source (a ``flash_attention.cu`` with the C entry point
``flash_attention_launch``) is built with ``nvcc`` into a ``ctypes``
library under ``build/flash_profile/`` (all builds started together), its
``-Xptxas -v`` lines printed, checked against the plain version
(``mha_causal_ref``) within 2e-5 at a few shapes and timed with CUDA events
(``--calls`` launches after a spin, ``--repeat`` times) at the kernel
table's shape (8, 1491, 12 / 12, 64) and at deepseek-67b's head layout
(1, 2048, 64 / 8, 128).  ``--parent`` takes a source of the SIMT kernel
with the 12-argument entry point and a 4 x 4 score patch; ``--new`` one
whose entry point also takes kernel.py's ``f32_plan`` (more files after it
are timed beside it under their stems).  ``--variants``
also builds the parent with one function body swapped at a time, for
timing only (their outputs are wrong): the score products from registers
instead of shared memory (``qk_regs``), the P.V products likewise
(``pv_regs``), both, the products' shared loads hoisted out of their
loops (``*_hoisted``: no load and no added instruction), no ``expf`` in
the softmax (``no_exp``), and the k / v tiles staged from constants
instead of global memory (``no_kv_load``); ``--new-variants`` the new
kernel likewise (``NEW_VARIANTS``).  ``--sass`` writes the SASS of the
parent and the new kernel beside their libraries and prints
an instruction count by kernel.
``--sdpa`` times PyTorch's ``scaled_dot_product_attention`` on the same
f32 inputs (``is_causal``, ``enable_gqa``) under its default choice and
pinned to each of ``EFFICIENT_ATTENTION`` and ``MATH``.  The card's name
and power limit come first.
"""
import argparse
import ctypes
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
OUT = ROOT / "build" / "flash_profile"
SHAPES = {"table": (8, 1491, 12, 12, 64), "deepseek": (1, 2048, 64, 8, 128)}
CHECKS = ((2, 1, 4, 1, 64), (3, 200, 6, 2, 32), (1, 65, 2, 2, 128),
          (2, 129, 4, 2, 64), (1, 300, 8, 1, 128), (2, 255, 8, 8, 32))
TOL = 2e-5
# the parent's text, and what each variant puts in its place
VARIANTS = {
    "qk_regs": [
        ("qv[i] = qs[(4 * ty + i) * LD + c];",
         "qv[i] = __int_as_float(0x3f000000 + c + i);"),
        ("kv[j] = ks[(tx + 16 * j) * LD + c];",
         "kv[j] = __int_as_float(0x3e000000 + 3 * c + j);")],
    "pv_regs": [
        ("pv[i] = ps[(4 * ty + i) * (kBK + 1) + j];",
         "pv[i] = __int_as_float(0x3f000000 + j + i);"),
        ("const float vv = vs[j * LD + tx + 16 * c];",
         "const float vv = __int_as_float(0x3e000000 + 3 * j + c);")],
    "no_exp": [
        ("const float alpha = expf(m_run - m_new);",
         "const float alpha = m_run - m_new;"),
        ("const float p = expf(prow[j] - m_new);",
         "const float p = prow[j] - m_new;")],
    "no_kv_load": [
        ("ks[r * LD + c] = in ? kb[pos * st.ks + c] : 0.f;",
         "ks[r * LD + c] = in ? 0.5f : 0.f;"),
        ("vs[r * LD + c] = in ? vb[pos * st.vs + c] : 0.f;",
         "vs[r * LD + c] = in ? 0.25f : 0.f;")],
}
VARIANTS["qk_pv_regs"] = VARIANTS["qk_regs"] + VARIANTS["pv_regs"]
# the same products with their operands' addresses fixed across the loop,
# so the compiler hoists the shared loads out of it and adds no instruction
VARIANTS["qk_hoisted"] = [
    ("qv[i] = qs[(4 * ty + i) * LD + c];", "qv[i] = qs[(4 * ty + i) * LD];"),
    ("kv[j] = ks[(tx + 16 * j) * LD + c];", "kv[j] = ks[(tx + 16 * j) * LD];")]
VARIANTS["pv_hoisted"] = [
    ("pv[i] = ps[(4 * ty + i) * (kBK + 1) + j];",
     "pv[i] = ps[(4 * ty + i) * (kBK + 1)];"),
    ("const float vv = vs[j * LD + tx + 16 * c];",
     "const float vv = vs[tx + 16 * c];")]
VARIANTS["qk_pv_hoisted"] = VARIANTS["qk_hoisted"] + VARIANTS["pv_hoisted"]
# the new kernel's, for ``--new-variants``: the parent's expf in the
# softmax, no exponential at all, each product (its loads and FMAs) left
# out, another plan, the product loops unrolled otherwise, K^T not written
NEW_VARIANTS = {
    "expf": [("const float alpha = exp2_approx(fmaf(m_run[i], kLog2e, -ml));",
              "const float alpha = expf(m_run[i] - m_new);"),
             ("s[i][j] = exp2_approx(fmaf(s[i][j], kLog2e, -ml));",
              "s[i][j] = expf(s[i][j] - m_new);")],
    "no_exp": [("const float alpha = exp2_approx(fmaf(m_run[i], kLog2e, -ml));",
                "const float alpha = m_run[i] - ml;"),
               ("s[i][j] = exp2_approx(fmaf(s[i][j], kLog2e, -ml));",
                "s[i][j] = s[i][j] - ml;")],
    "no_qk": [("s[i][j] = fmaf(qv[i], kv[j], s[i][j]);", ";")],
    "no_pv": [("acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);", ";")],
    # another plan: d = 64 at 256 q rows a block (256 threads, one block an
    # SM); kernel.py's plan check taken out
    "d64_bq256": [("struct Plan<64> {\n  static constexpr int kThreads = 128",
                   "struct Plan<64> {\n  static constexpr int kThreads = 256"),
                  ("    return cudaErrorInvalidValue;  // kernel.py's plan",
                   "    ;  // kernel.py's plan")],
    "qk_unroll1": [("#pragma unroll 8\n  for (int c = 0; c < D; ++c)",
                    "#pragma unroll 1\n  for (int c = 0; c < D; ++c)")],
    "qk_unroll4": [("#pragma unroll 8\n  for (int c = 0; c < D; ++c)",
                    "#pragma unroll 4\n  for (int c = 0; c < D; ++c)")],
    "qk_unroll16": [("#pragma unroll 8\n  for (int c = 0; c < D; ++c)",
                     "#pragma unroll 16\n  for (int c = 0; c < D; ++c)")],
    "pv_unroll2": [("#pragma unroll 1\n  for (int j0 = 0; j0 < T::BK; j0 += 8)",
                    "#pragma unroll 2\n  for (int j0 = 0; j0 < T::BK; j0 += 8)")],
    "no_transpose": [("      Kt[(c + 0) * BK + r] = x.x;", "      Kt[r] = x.x;"),
                     ("      Kt[(c + 1) * BK + r] = x.y;", ""),
                     ("      Kt[(c + 2) * BK + r] = x.z;", ""),
                     ("      Kt[(c + 3) * BK + r] = x.w;", "")],
}
SASS_OPS = ("FFMA", "FMUL", "FADD", "LDS", "STS", "LDGSTS", "LDG", "STG",
            "BAR", "SHFL", "MUFU", "IMAD", "IADD3", "LOP3", "ISETP", "BRA",
            "LDL", "STL", "HMMA", "HGMMA")


def swapped(text: str, name: str, subs) -> str:
    """``text`` with each (old, new) of ``subs`` replaced, once each."""
    for old, new in subs:
        if old not in text:
            raise SystemExit(f"variant {name}: {old!r} not in its source")
        text = text.replace(old, new)
    return text


def sass_counts(so: Path, name: str) -> None:
    """Write the library's SASS beside it (``NAME.sass``) and print
    each kernel's count of the instructions in ``SASS_OPS``."""
    import re

    from torch.utils.cpp_extension import CUDA_HOME

    dump = subprocess.run([str(Path(CUDA_HOME) / "bin" / "cuobjdump"),
                           "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    so.with_suffix(".sass").write_text(dump)
    for fn in dump.split("Function : ")[1:]:
        head, body = fn.split("\n", 1)
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)",
                         body)
        counts = {op: sum(o == op for o in ops) for op in SASS_OPS}
        print(f"[sass] {name} {head.strip()[:60]}: {len(ops)} instructions, "
              + ", ".join(f"{k} {v}" for k, v in counts.items() if v),
              flush=True)


def build(sources: dict) -> dict:
    """{name: (library path, ptxas lines)}, every nvcc started together."""
    from torch.utils.cpp_extension import CUDA_HOME

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        cu, so = OUT / f"{name}.cu", OUT / f"{name}.so"
        cu.write_text(text)
        procs[name] = (so, subprocess.Popen(
            [str(Path(CUDA_HOME) / "bin" / "nvcc"), "-gencode",
             "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
             "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (so, p) in procs.items():
        log = p.communicate()[0]
        lines = [x.strip() for x in log.splitlines()
                 if "registers" in x or "spill" in x or "error" in x]
        if p.returncode != 0:
            print(f"[build] {name}: nvcc failed\n{log[-3000:]}", flush=True)
            continue
        out[name] = (so, lines)
    return out


class Kernel:
    """A built library's ``flash_attention_launch`` as a Python call."""

    def __init__(self, so: Path, with_plan: bool):
        self.lib = ctypes.CDLL(str(so))
        self.fn = self.lib.flash_attention_launch
        args = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p, ctypes.c_float]
        if with_plan:
            args += [ctypes.c_int] * 4
        self.fn.argtypes = args + [ctypes.c_void_p]
        self.fn.restype = ctypes.c_int
        self.with_plan = with_plan

    def __call__(self, q, k, v):
        import torch

        from repro_torch.kernels.flash_attention.kernel import f32_plan

        B, S, H, d = q.shape
        o = torch.empty((B, S, H, d), dtype=q.dtype, device=q.device)
        strides = (ctypes.c_longlong * 12)(
            *[x.stride(i) for x in (q, k, v, o) for i in range(3)])
        extra = []
        if self.with_plan:
            p = f32_plan(B, S, H, d)
            extra = [p.q_rows, p.kv_rows, p.threads, p.smem_bytes]
        err = self.fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                      B, S, H, k.shape[2], d,
                      ctypes.cast(strides, ctypes.c_void_p),
                      1.0 / math.sqrt(d), *extra,
                      torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"flash_attention_launch returned {err}")
        return o


def inputs(B, S, H, K, d, seed=0):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn((B, S, n, d), generator=gen, device="cuda")
            for n in (H, K, K)]


def time_ms(fn, calls: int) -> float:
    """CUDA-event mean of ``calls`` calls after a warm call and a spin."""
    import torch

    fn()
    torch.cuda._sleep(int(2e7))
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def check(name, kern) -> bool:
    import torch

    from repro_torch.kernels.flash_attention.ref import mha_causal_ref

    ok = True
    for shape in CHECKS + tuple(SHAPES.values()):
        q, k, v = inputs(*shape, seed=sum(shape))
        got = kern(q, k, v)
        err = float((got - mha_causal_ref(q, k, v)).abs().max())
        torch.cuda.synchronize()
        good = err <= TOL and bool(torch.isfinite(got).all())
        ok &= good
        print(f"[check] {name} {shape}: max|d| {err:.3e} "
              f"{'ok' if good else 'FAIL'}", flush=True)
    # q, k and v as views of one fused projection, rows of 65 floats: not
    # a multiple of 16 bytes
    for width in (8 * 64, 8 * 64 + 1):
        qkv = torch.randn((2, 300, width), device="cuda")
        x = qkv[..., :8 * 64].unflatten(-1, (8, 64))
        q, k, v = x[:, :, :4], x[:, :, 4:6], x[:, :, 6:]
        got = kern(q, k, v)
        exp = mha_causal_ref(q.contiguous(), k.contiguous(), v.contiguous())
        err = float((got - exp).abs().max())
        good = err <= TOL
        ok &= good
        print(f"[check] {name} strided views, sequence stride "
              f"{q.stride(1)}: max|d| {err:.3e} "
              f"{'ok' if good else 'FAIL'}", flush=True)
    return ok


def sdpa_ms(qt, kt, vt, backend, args) -> str:
    """SDPA's times on (B, H, S, d) views under ``backend`` (None: its own
    choice), with ``enable_gqa``; where the backend refuses that, with k
    and v expanded to every query head, said so."""
    import contextlib

    import torch
    from torch.nn.attention import sdpa_kernel

    sdpa = torch.nn.functional.scaled_dot_product_attention
    ctx = contextlib.nullcontext if backend is None \
        else (lambda: sdpa_kernel(backend))
    G = qt.shape[1] // kt.shape[1]
    for gqa in (True, False):
        k2, v2 = (kt, vt) if gqa else (x.repeat_interleave(G, dim=1)
                                       for x in (kt, vt))
        try:
            with ctx():
                ms = [time_ms(lambda: sdpa(qt, k2, v2, is_causal=True,
                                           enable_gqa=gqa), args.calls)
                      for _ in range(args.repeat)]
        except RuntimeError as e:
            if not gqa:
                return f"refused ({str(e)[:200]})"
            continue
        return " ".join(f"{t:.4f}" for t in ms) + " ms" + (
            "" if gqa else f" (enable_gqa refused: k, v expanded {G}x)")
    return "refused"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--new", type=Path, nargs="+", default=[])
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--new-variants", action="store_true")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--sdpa", action="store_true")
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--repeat", type=int, default=3)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("flash_f32_profile: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    sources, plan_abi = {}, {}
    if args.parent:
        text = args.parent.read_text()
        sources["parent"], plan_abi["parent"] = text, False
        for name, subs in VARIANTS.items() if args.variants else ():
            sources[f"parent_{name}"] = swapped(text, name, subs)
            plan_abi[f"parent_{name}"] = False
    for other in args.new[1:]:
        sources[other.stem], plan_abi[other.stem] = other.read_text(), True
    if args.new:
        text = args.new[0].read_text()
        sources["new"], plan_abi["new"] = text, True
        for name, subs in NEW_VARIANTS.items() if args.new_variants else ():
            sources[f"new_{name}"] = swapped(text, name, subs)
            plan_abi[f"new_{name}"] = True
    built = build(sources)
    failed = len(built) < len(sources)
    for name, (so, lines) in built.items():
        print(f"[ptxas] {name}: " + " | ".join(lines), flush=True)
        if args.sass and name in ("parent", "new"):
            sass_counts(so, name)
    kernels = {name: Kernel(so, plan_abi[name])
               for name, (so, _) in built.items()}
    for name in ["parent", "new"] + [x.stem for x in args.new[1:]]:
        if name in kernels and not check(name, kernels[name]):
            failed = True
    flops = {}
    for tag, (B, S, H, K, d) in SHAPES.items():
        q, k, v = inputs(B, S, H, K, d)
        flops[tag] = 4 * B * H * d * S * (S + 1) // 2
        bound = 1e3 * flops[tag] / 67e12
        print(f"[shape] {tag} ({B}, {S}, {H} / {K}, {d}) f32: bound "
              f"{bound:.4f} ms (operations, 67 TFLOP/s)", flush=True)
        for name, kern in kernels.items():
            ms = [time_ms(lambda: kern(q, k, v), args.calls)
                  for _ in range(args.repeat)]
            print(f"[time] {tag} {name}: "
                  + " ".join(f"{t:.4f}" for t in ms)
                  + f" ms; {bound / min(ms):.3f} of the bound", flush=True)
        if args.sdpa:
            from torch.nn.attention import SDPBackend

            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            for label, backend in (("default", None),
                                   ("EFFICIENT_ATTENTION",
                                    SDPBackend.EFFICIENT_ATTENTION),
                                   ("MATH", SDPBackend.MATH)):
                print(f"[sdpa] {tag} {label}: "
                      f"{sdpa_ms(qt, kt, vt, backend, args)}", flush=True)
        del q, k, v
        torch.cuda.empty_cache()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
