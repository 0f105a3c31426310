"""Time the dense-weight FTP kernels (1: full sums, 2: fused P-LIF; the
tensor-core instance of ``csrc/ftp_dense.cu``) of several source trees on
one card, in turns, so that two versions are compared within one session.

    python3 tools/dense_tc_ab.py OLD NEW     # turns: OLD, NEW, NEW, OLD

Each tree is a checkout or a ``git archive`` of this repository.  Every turn
runs in a subprocess that imports that tree's ``repro_torch``, builds only
its ``ftp_dense`` library (into the tree's ``build/kernels``) and times each
case with CUDA events: the L2 flushed before each call, the median of
``--reps`` calls, beside ``torch.matmul`` of the same bf16 planes (the
library yardstick) and the call's least time (``roofline.kernel_work``).
The inputs are made on the card from ``--seed``: llama3.2-1b's FFN weights
at their published widths (2048 -> 8192 -> 2048, random normal / sqrt(K),
bf16) and T-HFF's (3072 x 3072), spike words from ``direct_encode`` of
random activations.  Prints one JSON line per turn, then a summary line:
for each case and tree, the median over that tree's turns, with the card's
name and power limit.  Needs a CUDA card; exits 1 without one.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

# (case, kernel, M, K, N, T): kernel 2 on W_in, kernel 1 on W_out
CASES = [
    ("W_in M=4", 2, 4, 2048, 8192, 4),
    ("W_out M=4", 1, 4, 8192, 2048, 4),
    ("W_in M=512", 2, 512, 2048, 8192, 4),
    ("W_out M=512", 1, 512, 8192, 2048, 4),
    ("W_in M=512 T=16", 2, 512, 2048, 8192, 16),
    ("W_out M=512 T=16", 1, 512, 8192, 2048, 16),
    ("W_in M=512 T=32", 2, 512, 2048, 8192, 32),
    ("W_out M=512 T=32", 1, 512, 8192, 2048, 32),
    ("T-HFF kernel 1", 1, 784, 3072, 3072, 4),
    ("T-HFF kernel 2", 2, 784, 3072, 3072, 4),
]


def _time_ms(fn, reps, flush):
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(1_000_000)  # the host enqueues behind busy work
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def worker(tree: str, reps: int, seed: int) -> dict:
    """Times every case with the package of ``tree``; returns its row."""
    sys.path.insert(0, os.path.join(tree, "src"))
    import torch

    from repro_torch.core.lif import direct_encode
    from repro_torch.core.packing import pack_spikes, unpack_spikes
    from repro_torch.kernels import _build, ftp_spmm
    from repro_torch.roofline import kernel_work as kw

    if not torch.cuda.is_available():
        raise SystemExit("dense_tc_ab: no CUDA device is available")
    src = _build.sources()["ftp_dense"]
    _build.sources = lambda: {"ftp_dense": src}  # build this library alone
    built = _build.build()["ftp_dense"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    weights, rows = {}, []
    for case, kernel, M, K, N, T in CASES:
        if (K, N) not in weights:
            weights[K, N] = (torch.randn((K, N), generator=gen, device="cuda")
                             / K ** 0.5).to(torch.bfloat16)
        w = weights[K, N]
        x = torch.randn((M, K), generator=gen, device="cuda")
        a = pack_spikes(direct_encode(x.to(torch.bfloat16), T))
        fuse = kernel == 2
        call = ((lambda: ftp_spmm.ftp_spmm_fused_lif(a, w, T, instance="tc"))
                if fuse else (lambda: ftp_spmm.ftp_spmm(a, w, T, instance="tc")))
        planes = unpack_spikes(a, T, torch.bfloat16).reshape(-1, K)
        ftp_spmm.reset_launch_counts()
        ms = _time_ms(call, reps, flush)
        assert ftp_spmm.launch_counts()["ftp_dense_tc"] == reps + 1
        lib = _time_ms(lambda: torch.matmul(planes, w), reps, flush)
        bound, by = kw.bound_ms(*kw.dense_work(a, w, T, fuse))
        rows.append({"case": case, "kernel": kernel, "M": M, "K": K, "N": N,
                     "T": T, "ms": ms, "library_ms": lib, "bound_ms": bound,
                     "bound_by": by})
        print(f"  {tree}: {case}: {ms:.4f} ms, matmul {lib:.4f} ms, bound "
              f"{bound:.4f} ms ({by})", file=sys.stderr, flush=True)
    return {"tree": tree, "build_s": built["seconds"], "rows": rows}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", help="source trees, timed in turns")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.trees[0], args.reps, args.seed)))
        return
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    turns = args.trees + args.trees[::-1]
    results = []
    for tree in turns:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", tree,
             "--reps", str(args.reps), "--seed", str(args.seed)],
            stdout=subprocess.PIPE, text=True, check=True, timeout=1200)
        results.append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(json.dumps(results[-1]), flush=True)
    summary = {}
    for case, *_ in CASES:
        entry = {}
        for tree in args.trees:
            rows = [r for res in results if res["tree"] == tree
                    for r in res["rows"] if r["case"] == case]
            entry[tree] = {k: statistics.median(r[k] for r in rows)
                           for k in ("ms", "library_ms")}
            entry[tree]["over_library"] = (entry[tree]["ms"]
                                           / entry[tree]["library_ms"])
        entry["bound_ms"] = rows[0]["bound_ms"]
        entry["bound_by"] = rows[0]["bound_by"]
        summary[case] = entry
    print(json.dumps({"card": smi, "turns": turns, "summary": summary}))


if __name__ == "__main__":
    main()
