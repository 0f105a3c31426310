"""Time the tensor-core instances of the FTP kernels (the dense ones, 1:
full sums and 2: fused P-LIF, ``csrc/ftp_dense.cu``; the dual-sparse BSR
ones, 3: over a weight join plan, ``csrc/ftp_bsr.cu``) of several source
trees on one card, in turns, so that two versions are compared within one
session.

    python3 tools/ftp_tc_ab.py OLD NEW                 # turns: OLD, NEW, NEW, OLD
    python3 tools/ftp_tc_ab.py OLD NEW --kernels bsr   # the BSR cases alone

Each tree is a checkout or a ``git archive`` of this repository.  Every turn
runs in a subprocess that imports that tree's ``repro_torch``, builds only
the libraries its cases need (into the tree's ``build/kernels``) and times
each case with CUDA events: the L2 flushed before each call, the median of
``--reps`` calls, beside ``torch.matmul`` of the same bf16 planes and the
dense bf16 weight (the library yardstick; for a plan, the weight it stands
for, zeros where a block was pruned) and the call's least time
(``roofline.kernel_work``).  The inputs are made on the card from
``--seed``, spike words from ``direct_encode`` of random activations:

* dense: llama3.2-1b's FFN weights at their published widths (2048 -> 8192
  -> 2048, random normal / sqrt(K), bf16) and T-HFF's (3072 x 3072);
* bsr: the FFNs of llama3.2-1b, gemma-2b (2048 -> 16384) and qwen3-14b
  (5120 -> 17408) as the serve builds them (``init_spiking_ffn``: 128 x 128
  blocks pruned to density 0.3, bf16), W_in through kernel 3 with the fused
  LIF and W_out with full sums, and T-HFF (784 rows, 3072 x 3072) pruned
  unstructured to d_b 0.032 (every block joined) through the per-call plan.

Prints one JSON line per turn, then a summary line: for each case and tree,
the median over that tree's turns, with the card's name and power limit.
Needs a CUDA card; exits 1 without one.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

# (case, kind, kernel, M, K, N, T): dense kernel 2 on W_in, 1 on W_out;
# BSR kernel 3, W_in fused, W_out and T-HFF full sums
CASES = [
    ("W_in M=4", "dense", 2, 4, 2048, 8192, 4),
    ("W_out M=4", "dense", 1, 4, 8192, 2048, 4),
    ("W_in M=512", "dense", 2, 512, 2048, 8192, 4),
    ("W_out M=512", "dense", 1, 512, 8192, 2048, 4),
    ("W_in M=512 T=16", "dense", 2, 512, 2048, 8192, 16),
    ("W_out M=512 T=16", "dense", 1, 512, 8192, 2048, 16),
    ("W_in M=512 T=32", "dense", 2, 512, 2048, 8192, 32),
    ("W_out M=512 T=32", "dense", 1, 512, 8192, 2048, 32),
    ("T-HFF kernel 1", "dense", 1, 784, 3072, 3072, 4),
    ("T-HFF kernel 2", "dense", 2, 784, 3072, 3072, 4),
    ("bsr llama W_in M=4", "bsr", 3, 4, 2048, 8192, 4),
    ("bsr llama W_out M=4", "bsr", 3, 4, 8192, 2048, 4),
    ("bsr llama W_in M=512", "bsr", 3, 512, 2048, 8192, 4),
    ("bsr llama W_out M=512", "bsr", 3, 512, 8192, 2048, 4),
    ("bsr llama W_in M=512 T=16", "bsr", 3, 512, 2048, 8192, 16),
    ("bsr llama W_out M=512 T=16", "bsr", 3, 512, 8192, 2048, 16),
    ("bsr llama W_in M=512 T=32", "bsr", 3, 512, 2048, 8192, 32),
    ("bsr llama W_out M=512 T=32", "bsr", 3, 512, 8192, 2048, 32),
    ("bsr gemma-2b W_in M=4", "bsr", 3, 4, 2048, 16384, 4),
    ("bsr gemma-2b W_out M=4", "bsr", 3, 4, 16384, 2048, 4),
    ("bsr gemma-2b W_in M=512", "bsr", 3, 512, 2048, 16384, 4),
    ("bsr gemma-2b W_out M=512", "bsr", 3, 512, 16384, 2048, 4),
    ("bsr qwen3-14b W_in M=4", "bsr", 3, 4, 5120, 17408, 4),
    ("bsr qwen3-14b W_out M=4", "bsr", 3, 4, 17408, 5120, 4),
    ("bsr qwen3-14b W_in M=512", "bsr", 3, 512, 5120, 17408, 4),
    ("bsr qwen3-14b W_out M=512", "bsr", 3, 512, 17408, 5120, 4),
    ("bsr T-HFF unstructured", "bsr", 3, 784, 3072, 3072, 4),
]
LIBRARIES = {"dense": "ftp_dense", "bsr": "ftp_bsr"}
THFF_DENSITY = 0.032  # Table II's T-HFF weight density


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


def _plan_weight(plan, K, N):
    """The (K, N) bf16 weight a join plan stands for (zeros where a block
    was pruned): the library yardstick's operand."""
    import torch

    nnb, jmax = plan.kidx.shape
    _, bk, bn = plan.payload.shape
    nkb = plan.bmap.shape[0]
    dev = plan.payload.device
    w = torch.zeros((nkb, bk, nnb, bn), dtype=torch.bfloat16, device=dev)
    j, jj = (torch.arange(jmax, device=dev)[None] < plan.cnt[:, None].long()
             ).nonzero(as_tuple=True)
    w[plan.kidx[j, jj].long(), :, j, :] = plan.payload[plan.vidx[j, jj].long()]
    return w.reshape(nkb * bk, nnb * bn)[:K, :N]


def worker(tree: str, reps: int, seed: int, kinds: list[str]) -> dict:
    """Times every case of ``kinds`` with the package of ``tree``; returns
    its row."""
    sys.path.insert(0, os.path.join(tree, "src"))
    import torch

    from repro_torch.core.lif import direct_encode
    from repro_torch.core.packing import pack_spikes, unpack_spikes
    from repro_torch.core.snn_layers import init_spiking_ffn, prune_by_magnitude
    from repro_torch.kernels import _build, ftp_spmm, ops
    from repro_torch.kernels.join_plan import build_weight_plan
    from repro_torch.roofline import kernel_work as kw

    if not torch.cuda.is_available():
        raise SystemExit("ftp_tc_ab: no CUDA device is available")
    src = {LIBRARIES[k]: _build.sources()[LIBRARIES[k]] for k in kinds}
    _build.sources = lambda: src  # build these libraries alone
    built = _build.build()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    weights, plans, rows = {}, {}, []
    for case, kind, kernel, M, K, N, T in CASES:
        if kind not in kinds:
            continue
        x = torch.randn((M, K), generator=gen, device="cuda")
        a = pack_spikes(direct_encode(x.to(torch.bfloat16), T))
        planes = unpack_spikes(a, T, torch.bfloat16).reshape(-1, K)
        if kind == "dense":
            if (K, N) not in weights:
                weights[K, N] = (torch.randn((K, N), generator=gen, device="cuda")
                                 / K ** 0.5).to(torch.bfloat16)
            w = weights[K, N]
            fuse = kernel == 2
            call = ((lambda: ftp_spmm.ftp_spmm_fused_lif(a, w, T, instance="tc"))
                    if fuse else
                    (lambda: ftp_spmm.ftp_spmm(a, w, T, instance="tc")))
            nbytes, ops_ = kw.dense_work(a, w, T, fuse)
            count = "ftp_dense_tc"
        else:
            fuse = "W_in" in case
            key = (K, N, "T-HFF" in case)
            if key not in plans:
                if "T-HFF" in case:
                    w = prune_by_magnitude(
                        torch.randn((K, N), generator=gen, device="cuda"),
                        THFF_DENSITY).to(torch.bfloat16)
                else:
                    d, f = (K, N) if fuse else (N, K)
                    ffn = init_spiking_ffn(gen, d, f, weight_density=0.3,
                                           prune_block=(128, 128))
                    w = ffn["w_in" if fuse else "w_out"].to(torch.bfloat16)
                    del ffn
                plan = build_weight_plan(w)
                plans[key] = (plan, _plan_weight(plan, K, N))
                del w
            plan, w = plans[key]
            bm = ftp_spmm.pick_bm(M, T)
            args = (a, plan.payload, plan.kidx, plan.vidx, plan.cnt,
                    ops._activity(a, bm, plan), N, T)

            def call(args=args, bm=bm, fuse=fuse):
                return ftp_spmm.ftp_spmm_bsr(*args, bm=bm, fuse_lif=fuse,
                                             instance="tc")
            nbytes, ops_ = kw.bsr_work(*args, bm=bm, fuse_lif=fuse)
            count = "ftp_bsr_tc"
        ftp_spmm.reset_launch_counts()
        ms = _time_ms(call, reps, flush)
        assert ftp_spmm.launch_counts()[count] == reps + 1
        lib = _time_ms(lambda: torch.matmul(planes, w), reps, flush)
        bound, by = kw.bound_ms(nbytes, ops_)
        rows.append({"case": case, "kernel": kernel, "M": M, "K": K, "N": N,
                     "T": T, "ms": ms, "library_ms": lib, "bound_ms": bound,
                     "bound_by": by})
        print(f"  {tree}: {case}: {ms:.4f} ms, matmul {lib:.4f} ms, bound "
              f"{bound:.4f} ms ({by})", file=sys.stderr, flush=True)
    return {"tree": tree, "build_s": {k: b["seconds"] for k, b in built.items()},
            "rows": rows}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", help="source trees, timed in turns")
    ap.add_argument("--kernels", default="dense,bsr",
                    help="comma-separated: dense (kernels 1-2), bsr (3)")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    kinds = args.kernels.split(",")
    if not set(kinds) <= set(LIBRARIES):
        ap.error(f"--kernels takes {', '.join(LIBRARIES)}, got {args.kernels}")
    if args.worker:
        print(json.dumps(worker(args.trees[0], args.reps, args.seed, kinds)))
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
             "--reps", str(args.reps), "--seed", str(args.seed),
             "--kernels", args.kernels],
            stdout=subprocess.PIPE, text=True, check=True, timeout=1800)
        results.append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(json.dumps(results[-1]), flush=True)
    summary = {}
    for case, kind, *_ in CASES:
        if kind not in kinds:
            continue
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
