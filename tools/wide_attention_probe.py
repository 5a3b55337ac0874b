#!/usr/bin/env python3
"""The attention kernels past head dim 256 on one CUDA card: their built
resources, their outputs against the plain versions, and the f32 flash
kernel's launch routes side by side.

    python3 tools/wide_attention_probe.py [--quick]

Prints, for every instance of ``flash_attention_wide_kernel`` and
``decode_attention_wide_kernel``, its registers and stack bytes
(``cuobjdump -res-usage``) and fails on a stack frame; checks f32 flash at
(2, 131, 4 / 2, d) and decode over bf16, f32 and int8 caches of (2, 300,
2, d) with 8 query heads (length 300 and 217) against their plain
versions at head dims past 256, each route included (the f32 cluster of
128- and 256-column slabs, the slab loop past 2048 columns; decode's
vectors and its chunked kernel past 1024); then times, with CUDA events
(``chip_smoke.cuda_ms``), f32 flash at (2, 1024, 8 / 2, d) for d = 320
and 512 on the planned cluster, on the other slab width and on the slab
loop (the route every d past 256 took before the cluster kernel), and
decode at 8 lanes over (2048, 2, d) with 8 query heads.  ``--quick`` stops
after the checks.  The card's name and power limit come first."""
import argparse
import dataclasses
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    import torch

    import chip_smoke as cs
    from repro_torch.kernels._build import extension, resources_all
    from repro_torch.kernels.decode_attention import kernel as da_kernel
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention.ref import mha_causal_ref

    if not torch.cuda.is_available():
        raise SystemExit("wide_attention_probe: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    extension()
    stack = []
    for name in ("flash_attention_wide_kernel",
                 "decode_attention_wide_kernel"):
        for fn, res in resources_all(name).items():
            print(f"[resources] {fn}: {res['REG']} registers, "
                  f"{res['STACK']} B stack, {res['LOCAL']} B local",
                  flush=True)
            if res["STACK"] or res["LOCAL"]:
                stack.append(fn)
    f32 = torch.float32
    for d in (264, 320, 512, 640, 1000, 2048, 2056):
        p = fa_kernel.f32_plan(2, 131, 4, d)
        print(f"[plan] f32 flash d {d}: width {p.width}, cluster "
              f"{p.cluster}, slabs {p.slabs}, {p.smem_bytes} B shared",
              flush=True)
        cs.check_flash(dev, 2, 131, 4, 2, d, f32, seed=d)
    for d in (264, 320, 512, 600, 1000, 1032):
        for dt in (torch.bfloat16, torch.float32):
            for length in (300, 217):
                cs.check_decode(dev, 2, 300, 8, 2, d, length, dt, dt,
                                seed=d + length)
        for length in (300, 217):
            cs.check_decode_int8(dev, 2, 300, 8, 2, d, length,
                                 torch.bfloat16, seed=d + length)
        print(f"[plan] decode d {d}: "
              + ", ".join(f"{str(dt).split('.')[-1]} "
                          f"{da_kernel.lane_layout(dt, d)}"
                          for dt in (torch.bfloat16, f32, torch.int8)),
              flush=True)
    # caches as views 3 elements into wider rows: no 16-byte copy fits
    for dt in (torch.bfloat16, f32, torch.int8):
        d, S = 320, 300
        q = cs._randn(dev, (2, 8, d), f32, 5)
        n = torch.tensor(217, dtype=torch.int32, device=dev)
        if dt == torch.int8:
            vals, sc = cs.int8_cache(dev, 2, S, 4, d + 8, 217, 6)
            kc = vals.view(2, S, 2, 2, d + 8)[:, :, :, 0, 3:3 + d]
            vc = vals.view(2, S, 2, 2, d + 8)[:, :, :, 1, 3:3 + d]
            extra = (sc.view(2, S, 2, 2)[..., 0], sc.view(2, S, 2, 2)[..., 1])
            exp = decode_attention_ref(q, kc.contiguous(), vc.contiguous(),
                                       217, *(x.contiguous() for x in extra))
        else:
            wide = cs._randn(dev, (2, S, 2, 2, d + 8), dt, 6)
            kc, vc = wide[:, :, :, 0, 3:3 + d], wide[:, :, :, 1, 3:3 + d]
            extra = ()
            exp = decode_attention_ref(q, kc, vc, 217)
        got = da_kernel.decode_attention(q, kc, vc, n, *extra)
        err, ok, tol = cs.attn_error("decode", got, exp)
        print(f"[3 decode_attention] d {d} {dt} cache a view 3 elements "
              f"into its rows: max|d| {err:.3e} (tolerance {tol})",
              flush=True)
        if not ok:
            raise SystemExit("decode_attention disagrees on a misaligned "
                             "view")
    if stack:
        raise SystemExit(f"wide_attention_probe: stack frames in {stack}")
    if args.quick:
        return 0
    B, S, H, K = 2, 1024, 8, 2
    for d in (320, 512):
        q, k, v = (cs._randn(dev, (B, S, n, d), f32, i)
                   for i, n in enumerate((H, K, K)))
        exp = mha_causal_ref(q, k, v)
        planned = fa_kernel.f32_plan(B, S, H, d)
        other = 256 if planned.width == 128 else 128
        c = -(-d // other)
        plans = {"planned": planned,
                 f"width {other}": _cluster_plan(fa_kernel, B, S, H, d,
                                                 other, c),
                 "slab loop": _cluster_plan(fa_kernel, B, S, H, d, 256, 1)}
        for tag, p in plans.items():
            o = torch.empty_like(q)

            def call(p=p, o=o):
                extension().flash_attention_f32(
                    q, k, v, o, d ** -0.5, p.q_rows, p.kv_rows, p.threads,
                    p.smem_bytes, p.width, p.cluster)

            call()
            err, ok, tol = cs.attn_error("flash", o, exp)
            ms = [cs.cuda_ms(call) for _ in range(3)]
            print(f"[time] f32 flash ({B}, {S}, {H} / {K}, {d}) {tag} "
                  f"(width {p.width}, cluster {p.cluster}): "
                  + " ".join(f"{t:.4f}" for t in ms)
                  + f" ms, max|d| {err:.3e} (tolerance {tol})", flush=True)
        del q, k, v, exp
        L, S2 = 8, 2048
        n = torch.tensor(S2, dtype=torch.int32, device=dev)
        for dt in (torch.bfloat16, f32):
            qd = cs._randn(dev, (L, H, d), dt, 0)
            kc = cs._randn(dev, (L, S2, K, d), dt, 1)
            vc = cs._randn(dev, (L, S2, K, d), dt, 2)
            ms = [cs.cuda_ms(lambda: da_kernel.decode_attention(
                qd, kc, vc, n)) for _ in range(3)]
            print(f"[time] decode ({L}, {H}, {d}) over ({L}, {S2}, {K}, "
                  f"{d}) {str(dt).split('.')[-1]}: "
                  + " ".join(f"{t:.4f}" for t in ms) + " ms", flush=True)
        qd = cs._randn(dev, (L, H, d), torch.bfloat16, 0)
        kc, ks = cs.int8_cache(dev, L, S2, K, d, S2, 1)
        vc, vs = cs.int8_cache(dev, L, S2, K, d, S2, 2)
        ms = [cs.cuda_ms(lambda: da_kernel.decode_attention(
            qd, kc, vc, n, ks, vs)) for _ in range(3)]
        print(f"[time] decode ({L}, {H}, {d}) over ({L}, {S2}, {K}, {d}) "
              f"int8: " + " ".join(f"{t:.4f}" for t in ms) + " ms",
              flush=True)
    return 0


def _cluster_plan(fa_kernel, B, S, H, d, width, cluster):
    """``f32_plan`` laid out at slab ``width`` on clusters of ``cluster``
    blocks (1: the slab loop's column chunks of 256)."""
    threads, bk = fa_kernel.F32_PLANS[width]
    bq = 8 * threads // (width // 8)
    smem = 4 * (width * bq + bk * (width + 4) + width * bk + bk * width
                + bk * bq + (bk * bq if cluster > 1 else 0))
    p = fa_kernel.f32_plan(B, S, H, d)
    return dataclasses.replace(p, width=width, q_rows=bq, kv_rows=bk,
                               threads=threads, smem_bytes=smem,
                               cluster=cluster)


if __name__ == "__main__":
    sys.exit(main())
