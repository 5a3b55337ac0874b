#!/usr/bin/env python3
"""Time the join and LM paths of two checkouts on one CUDA card.

    python3 chip_ab.py ROOT_A ROOT_B [--passes-each 2] [--whole]

Passes alternate A, B, B, A (with ``--passes-each 2``), each a subprocess
in that checkout, which builds its own kernels (kept in ``ROOT/build``
after its first pass).  By default a pass imports the checkout's
``chip_smoke`` and ``repro_torch``, makes phase 4's corpora and runs
``profile_run`` twice: four ``JoinService(lanes=4)`` sessions of (4096,
384) x (4096, 384) under a ``PerfectCrowd``, with the round engine and the
gateway replay on the host clock; the second, warm, run's summary line is
printed.  With ``--whole`` a pass runs the checkout's ``python3
chip_smoke.py`` and prints its summary lines of phases 4-4f, so each path
is read where the script drives it.  The card's name and power limit come
first, each line is tagged with its checkout, and a failed pass exits
non-zero.
"""
import argparse
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

# the summary lines of chip_smoke.py's paths, by their prefixes
WHOLE_LINES = ("[4 main path]", "[4 profile] run() wall", "[4b blocked path]",
               "[4c serving]", "[4c profile] decode step", "[4d machine phase]",
               "[4e noisy path]", "[4e split]", "[4f paper pipeline]",
               "[4f split paper 0.1]")


def run_pass(root: Path, whole: bool) -> list:
    cmd = ([sys.executable, "chip_smoke.py"] if whole
           else [sys.executable, "-c", PASS, str(root)])
    out = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                         timeout=1200)
    if out.returncode != 0:
        sys.stderr.write(out.stdout[-4000:] + out.stderr[-4000:])
        raise SystemExit(f"chip_ab: pass in {root} failed "
                         f"(exit {out.returncode})")
    if whole:
        return [line[:300] for line in out.stdout.splitlines()
                if line.startswith(WHOLE_LINES)]
    warm = out.stdout.split("=== warm ===", 1)[1]
    return [next(line for line in warm.splitlines()
                 if line.startswith("[4 profile] run() wall"))]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("root_a", type=Path)
    ap.add_argument("root_b", type=Path)
    ap.add_argument("--passes-each", type=int, default=2)
    ap.add_argument("--whole", action="store_true",
                    help="run each checkout's chip_smoke.py end to end")
    args = ap.parse_args()
    roots = [args.root_a.resolve(), args.root_b.resolve()]
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    order = []
    for k in range(args.passes_each):
        order += roots if k % 2 == 0 else roots[::-1]
    for n, root in enumerate(order):
        for line in run_pass(root, args.whole):
            print(f"[pass {n}] {root.name}: {line}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
