#!/usr/bin/env python3
"""Time the join and LM paths of two checkouts on one CUDA card.

    python3 chip_ab.py ROOT_A ROOT_B [--passes-each 2] [--whole | --kernels]
                       [--allow-differ REGEX ...]

Passes alternate A, B, B, A (with ``--passes-each 2``), each a subprocess
in that checkout, which builds its own kernels (kept in ``ROOT/build``
after its first pass).  By default a pass imports the checkout's
``chip_smoke`` and ``repro_torch``, makes phase 4's corpora and runs
``profile_run`` twice: four ``JoinService(lanes=4)`` sessions of (4096,
384) x (4096, 384) under a ``PerfectCrowd``, with the round engine and the
gateway replay on the host clock; the second, warm, run's summary line is
printed.  With ``--whole`` a pass runs the checkout's ``python3
chip_smoke.py`` and prints its summary lines of phases 4-4f, so each path
is read where the script drives it.  With ``--kernels`` a pass times the
kernels with CUDA events (``chip_smoke.cuda_ms``, 20 calls after a spin,
three times) on seeded inputs: the wide ``union_deduce`` on a
``wide_lanes`` lane of 65536 objects and 524288 pairs (phase 4g's round-1
screen size); ``pair_scores_compact`` on the first 256-tile chunk of 128 x
128 tiles of blocked session 0 (the kernel table's shape), then its band
kernel on chunks of that session's tiles at each ``chip_smoke.WIDE_TILES``
shape with the same cells (phase 3's wide-tile chunks); the int8 path
of ``decode_attention`` at the kernel table's shape (q (8, 12, 64) bf16
over an (8, 2048, 12, 64) int8 cache) and at phase 4n a's internlm2-1.8b
shape (q (8, 16, 128) over (8, 2048, 8, 128)), its bf16 and f32 paths at
the table's shape, length 2048; and both routes of ``flash_attention`` at
the kernel table's shape (8, 1491, 12 / 12, 64) and at deepseek-67b's head
layout (1, 2048, 64 / 8, 128); then, at head dims 12, 100, 320 and 512,
both flash routes at (2, 1024, 8 / 2) and decode over bf16, f32 and int8
caches of (8, 2048, 2) with 8 query heads (a checkout whose kernels refuse
a call prints that and moves on), the f32 flash calls past 256 with their
plain version and SDPA's own choice timed beside them (no digest).  Each
kernel call's line ends in a digest of its outputs, and after the passes
each kernel's digests must agree across the checkouts (the outputs bit
for bit), else it exits non-zero; a call whose name matches an
``--allow-differ`` pattern (one whose summation order a change alters on
purpose) is listed apart and may differ between the checkouts, but not
between two passes of one.  The card's name and power limit come first,
each line is tagged with its checkout, and a failed pass exits non-zero.
"""
import argparse
import re
import subprocess
import sys
from pathlib import Path

PASS = r"""
import sys
root = sys.argv[1]
sys.path[:0] = [root, root + "/src"]
import torch
import chip_smoke as cs
from repro_torch.device import set_precision
from repro_torch.kernels._build import extension
set_precision()
extension()
dev = torch.device("cuda")
corpora = [cs.make_corpus(cs.SEED + i, cs.N_ROWS, cs.DIM)
           for i in range(cs.N_SESSIONS)]
cs.profile_run(dev, corpora)  # warm-up: first loads, allocator growth
print("=== warm ===", flush=True)
cs.profile_run(dev, corpora)
"""

KERNELS = r"""
import hashlib
import sys
root = sys.argv[1]
sys.path[:0] = [root, root + "/src"]
import numpy as np
import torch
import chip_smoke as cs
from repro_torch.convert import embeddings_from_numpy
from repro_torch.kernels._build import extension
from repro_torch.kernels.decode_attention import kernel as da_kernel
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention.ref import mha_causal_ref
from repro_torch.kernels.pair_scores import blocking
from repro_torch.kernels.pair_scores import kernel as ps_kernel
from repro_torch.kernels.pair_scores import ops as ps_ops
from repro_torch.kernels.union_deduce import kernel as ud_kernel
extension()
dev = torch.device("cuda")


def line(name, fn):
    out = fn()
    out = out if isinstance(out, tuple) else (out,)
    h = hashlib.sha256()
    for x in out:
        h.update(x.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    ms = [cs.cuda_ms(fn) for _ in range(3)]
    print(f"[kernels] {name}: " + " ".join(f"{t:.4f}" for t in ms)
          + f" ms digest {h.hexdigest()[:16]}", flush=True)


wide = cs.wide_lanes(dev, 65536, 524288, 1, seed=cs.SEED + 3)
ud_kernel.union_deduce(*wide)   # raises on a failed lane
line("union_deduce_wide (1, 65536, 524288)",
     lambda: ud_kernel.launch(*wide))
del wide
_, ea, _, eb = cs.make_corpus(cs.BLOCK_SEED, cs.BLOCK_ROWS, cs.DIM)
a = ps_ops.l2_normalize(embeddings_from_numpy(ea, dev))
b = ps_ops.l2_normalize(embeddings_from_numpy(eb, dev))
cfg = blocking.BlockingConfig(**cs.BLOCKING)
every = np.arange(cs.BLOCK_ROWS)
sigs = (blocking.signatures(a, cfg), blocking.signatures(b, cfg))
for bn, bm in ((cfg.bn, cfg.bm),) + tuple(cs.WIDE_TILES):
    ta, tb = blocking.block_pairs(sigs[0], every, sigs[1], every, bn, bm)
    T = min(len(ta), cfg.tiles_per_call * cfg.bn * cfg.bm // (bn * bm))
    chunk = cs.gather_chunk(a, b, ta[:T], tb[:T])
    line(f"pair_scores_compact {T} tiles of {bn} x {bm}, depth {cs.DIM}",
         lambda: ps_kernel.pair_scores_compact(*chunk, cs.THRESHOLD,
                                               T * bn * bm, bn, bm))
del a, b, chunk
for B, S, H, K, d in ((8, 2048, 12, 12, 64), (8, 2048, 16, 8, 128)):
    q = cs._randn(dev, (B, H, d), torch.bfloat16, 0)
    kc, ks = cs.int8_cache(dev, B, S, K, d, S, 1)
    vc, vs = cs.int8_cache(dev, B, S, K, d, S, 2)
    n = torch.tensor(S, dtype=torch.int32, device=dev)
    line(f"decode_attention_int8 q ({B}, {H}, {d}) bf16 cache ({B}, {S}, "
         f"{K}, {d}) length {S}",
         lambda: da_kernel.decode_attention(q, kc, vc, n, ks, vs))
B, S, H, K, d = 8, 2048, 12, 12, 64
for dt in (torch.bfloat16, torch.float32):
    q = cs._randn(dev, (B, H, d), dt, 0)
    kc = cs._randn(dev, (B, S, K, d), dt, 1)
    vc = cs._randn(dev, (B, S, K, d), dt, 2)
    n = torch.tensor(S, dtype=torch.int32, device=dev)
    line(f"decode_attention q ({B}, {H}, {d}) cache ({B}, {S}, {K}, {d}) "
         f"{dt} length {S}",
         lambda: da_kernel.decode_attention(q, kc, vc, n))
for dt in (torch.bfloat16, torch.float32):
    for B, S, H, K, d in ((8, 1491, 12, 12, 64), (1, 2048, 64, 8, 128)):
        q, k, v = (cs._randn(dev, (B, S, n, d), dt, i)
                   for i, n in enumerate((H, K, K)))
        line(f"flash_attention {dt} q ({B}, {S}, {H}, {d}) kv heads {K}",
             lambda: fa_kernel.flash_attention(q, k, v))


def taken(name, fn):
    # line(), or a note where this checkout's kernels refuse the call
    try:
        fn()
    except ValueError as e:
        print(f"[kernels] {name}: refused here ({str(e)[:80]})", flush=True)
        return
    line(name, fn)


def yardstick(name, fn):
    # a call that is no kernel of the port, timed beside one: no digest
    ms = [cs.cuda_ms(fn) for _ in range(3)]
    print(f"[kernels] {name}: " + " ".join(f"{t:.4f}" for t in ms)
          + " ms", flush=True)


# the head dims the Pallas kernels take past the first widths
# (chip_smoke.HEAD_DIM_TIMED), at phase 3's timed shapes; past 256 the f32
# route's plain version and SDPA's own choice beside it
for d in (12, 100, 320, 512):
    B, S, H, K = 2, 1024, 8, 2
    for dt in (torch.bfloat16, torch.float32):
        q, k, v = (cs._randn(dev, (B, S, n, d), dt, i)
                   for i, n in enumerate((H, K, K)))
        taken(f"flash_attention {dt} q ({B}, {S}, {H}, {d}) kv heads {K}",
              lambda: fa_kernel.flash_attention(q, k, v))
        if dt == torch.float32 and d > 256:
            yardstick(f"plain mha_causal_ref {dt} q ({B}, {S}, {H}, {d})",
                      lambda: mha_causal_ref(q, k, v))
            yardstick(f"SDPA {dt} q ({B}, {S}, {H}, {d})",
                      lambda: torch.nn.functional.scaled_dot_product_attention(
                          q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), is_causal=True,
                          enable_gqa=True))
    B, S, H, K = 8, 2048, 8, 2
    n = torch.tensor(S, dtype=torch.int32, device=dev)
    for dt in (torch.bfloat16, torch.float32):
        q = cs._randn(dev, (B, H, d), dt, 0)
        kc = cs._randn(dev, (B, S, K, d), dt, 1)
        vc = cs._randn(dev, (B, S, K, d), dt, 2)
        taken(f"decode_attention q ({B}, {H}, {d}) cache ({B}, {S}, {K}, "
              f"{d}) {dt} length {S}",
              lambda: da_kernel.decode_attention(q, kc, vc, n))
    q = cs._randn(dev, (B, H, d), torch.bfloat16, 0)
    kc, ks = cs.int8_cache(dev, B, S, K, d, S, 1)
    vc, vs = cs.int8_cache(dev, B, S, K, d, S, 2)
    taken(f"decode_attention_int8 q ({B}, {H}, {d}) bf16 cache ({B}, {S}, "
          f"{K}, {d}) length {S}",
          lambda: da_kernel.decode_attention(q, kc, vc, n, ks, vs))
"""

# the summary lines of chip_smoke.py's paths, by their prefixes
WHOLE_LINES = ("[4 main path]", "[4b blocked path]", "[4c serving]",
               "[4d machine phase]", "[4e noisy path]", "[4e split]",
               "[4f paper pipeline]", "[4f split paper 0.1]")


def run_pass(root: Path, whole: bool, kernels: bool = False) -> list:
    cmd = ([sys.executable, "chip_smoke.py"] if whole
           else [sys.executable, "-c", KERNELS if kernels else PASS,
                 str(root)])
    out = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                         timeout=1200)
    if out.returncode != 0:
        sys.stderr.write(out.stdout[-4000:] + out.stderr[-4000:])
        raise SystemExit(f"chip_ab: pass in {root} failed "
                         f"(exit {out.returncode})")
    if whole or kernels:
        return [line[:300] for line in out.stdout.splitlines()
                if line.startswith(("[kernels]",) if kernels
                                   else WHOLE_LINES)]
    warm = out.stdout.split("=== warm ===", 1)[1]
    return [next(line for line in warm.splitlines()
                 if line.startswith("[4 profile] run() wall"))]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("root_a", type=Path)
    ap.add_argument("root_b", type=Path)
    ap.add_argument("--passes-each", type=int, default=2)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--whole", action="store_true",
                      help="run each checkout's chip_smoke.py end to end")
    mode.add_argument("--kernels", action="store_true",
                      help="time the kernels at the kernel table's "
                      "shapes and the band kernel at the wide tiles")
    ap.add_argument("--allow-differ", action="append", default=[],
                    metavar="REGEX",
                    help="kernel calls whose outputs may differ between "
                    "the checkouts (each checkout's passes must agree)")
    args = ap.parse_args()
    roots = [args.root_a.resolve(), args.root_b.resolve()]
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    order = []
    for k in range(args.passes_each):
        order += roots if k % 2 == 0 else roots[::-1]
    digests: dict = {}
    for n, root in enumerate(order):
        for line in run_pass(root, args.whole, args.kernels):
            print(f"[pass {n}] {root.name}: {line}", flush=True)
            if " digest " in line:
                name = line.split(": ", 1)[0]
                digests.setdefault(name, {}).setdefault(root, set()).add(
                    line.rsplit(" ", 1)[1])
    allowed = [name for name in digests
               if any(re.search(r, name) for r in args.allow_differ)]
    differ = [name for name, by_root in digests.items()
              if len(set().union(*by_root.values())) > 1
              and (name not in allowed
                   or any(len(d) > 1 for d in by_root.values()))]
    if args.kernels:
        changed = {name: "differ" if len(set().union(
            *digests[name].values())) > 1 else "equal" for name in allowed}
        print(f"[digests] {len(digests)} kernel calls, outputs equal bit for "
              f"bit across the passes but {differ}; allowed to differ "
              f"between the checkouts: {changed}")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
