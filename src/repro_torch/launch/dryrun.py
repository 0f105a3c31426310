"""Dry run of every (arch x shape) cell for one H100 (port of
`repro.launch.dryrun`): each cell's step is counted on meta tensors, so at
the assignment's full widths and shapes without a card, values or memory,
and its record gives the memory the step would hold, its flops and bytes
(`roofline.op_stats`), whether it fits the card and its roofline terms.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3_2_1b --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --manifest   # list cells

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

Records go to experiments/dryrun_torch/<arch>__<shape>__h100.json; a cell
that fails is recorded with the exception text.

``--mesh single|multi|both`` records the cell on the reference's production
train meshes instead, 16x16 (data, model) and 2x16x16 (pod, data, model),
as <arch>__<shape>__<mesh>.json (``--mesh none``, the default, is the
one-device record above).  A mesh record holds each input's bytes on one
device (every leaf's part under its spec, `repro_torch.sharding`), the
fallback log, the work of one data group's step counted on meta tensors
(its rows: the batch over pod x data) and that work split evenly over the
model axis as the per-device work and temporaries, and whether one device
fits (its inputs' parts and its share of the temporaries within 90% of the
card).  ``--no-work`` skips the count (the fit then reads the inputs
alone).

The port's loops are Python loops that run every iteration: the layer
stack, the serving forward's 64-row blocks (`layers.row_blocks`), its
32-position query blocks and 4-row batch blocks, the recurrent scans, the
loss chunks.  The reference corrects a ``while`` loop by its trip count;
here a cell is counted at a few small depths, batches and sequence lengths
where every such loop keeps its full-size branch and block shapes, and the
counts are extrapolated to the full size along each axis (`plan`): in the
depth linearly (Zamba2 by groups of ``shared_attn_every`` layers plus
its tail layers), in the batch linearly (quadratically in a train step),
in the sequence linearly without attention and quadratically with it or in
a train step.  Each count is a polynomial of that
degree in its axis, so the extrapolation is exact for flops and bytes (the
CPU tests hold it to full counts).  The memory's peak of live
intermediates is extrapolated the same way, phase by phase of the step
(forward, backward, no-grad), through the two largest points of each
axis: an estimate, since a peak is a maximum, not a polynomial.
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import math
import os
import time
import traceback
from dataclasses import dataclass
from fractions import Fraction

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig, ShapeCell, applicable_shapes
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import build_cell, runnable_cells, skipped_cells
from repro_torch.models.layers import B_BLOCK, Q_BLOCK, ROW_BLOCK
from repro_torch.roofline.op_stats import OpCounter, OpStats
from repro_torch.roofline.report import (
    H100,
    device_peaks,
    model_flops_for,
    roofline_from_record,
)
from repro_torch.tree import tree_leaves

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")
# the share of the card's memory a cell may fill and still be said to fit
FIT_SHARE = 0.9


@dataclass(frozen=True)
class Axis:
    name: str            # "layers" | "batch" | "seq"
    target: int
    points: tuple        # the values counted
    coef: tuple          # integer weights of the counts at the target

    @property
    def mem_coef(self) -> tuple:
        """Weights of the memory's extrapolation: linear, through the two
        largest points (a peak is no polynomial; a quadratic fit through
        small points can swing far, even below zero)."""
        if len(self.points) < 3 or self.name == "layers":
            return self.coef
        *_, p, q = self.points
        return (0,) * (len(self.points) - 2) + _lagrange((p, q), self.target)


def _lagrange(points, x) -> tuple:
    """Integer weights of the polynomial through ``points`` evaluated at
    ``x`` (points k s, k = 1..d+1, with s | x: the weights are integers)."""
    out = []
    for i, p in enumerate(points):
        c = Fraction(1)
        for j, q in enumerate(points):
            if j != i:
                c *= Fraction(x - q, p - q)
        if c.denominator != 1:
            raise ValueError(f"non-integer weight {c} at {points} -> {x}")
        out.append(int(c))
    return tuple(out)


def _structure(cfg: ArchConfig, kind: str, B: int, S: int):
    """The shape-dependent branches the step takes at batch B and sequence
    S (a tuple), or None where some loop would pad a block, or round a
    capacity, so that counts stop being polynomials in B and S."""
    serving = kind == "prefill" and not cfg.encoder_only
    # the last-token unembed's row blocks and whether it pads one; a batch
    # of one (autograd and the library take other paths for a unit dim)
    out = [-(-B // ROW_BLOCK) if kind == "prefill" else 0,
           kind == "prefill" and B % ROW_BLOCK == 0, B > 1]
    if serving:
        if (B * S) % ROW_BLOCK or S % Q_BLOCK or B % B_BLOCK:
            return None
        # a single row or batch block skips the blocks' concatenation
        out += [B * S > ROW_BLOCK, B > B_BLOCK]
    if cfg.n_heads and (kind == "train" or cfg.encoder_only):
        # the plain forward's query chunks
        cq = cfg.attn_chunk
        out.append(bool(cq and S > cq and S % cq == 0))
    if kind == "train":
        c, ch = cfg.loss_chunk, cfg.ssm_chunk
        out.append(bool(c and (B * S) % c == 0 and B * S > c))
        out.append(bool(ch and S > ch and S % ch == 0))
    if cfg.ssm_state and cfg.family == "hybrid":
        ch = cfg.ssm_chunk
        out.append(bool(S > 1 and ch and S % ch == 0))
    if cfg.attn == "swa" and serving:
        if S > cfg.window and S % cfg.window:
            return None
        out.append(S > cfg.window)
    if cfg.n_experts:
        cap = Fraction(B * S * cfg.top_k) * Fraction(cfg.capacity_factor) / cfg.n_experts
        if cap.denominator != 1 or cap < 1:
            return None
    if cfg.n_img_tokens:
        out.append(S > cfg.n_img_tokens)
    return tuple(out)


# Rough aten ops of one count, by the loops that dominate it (measured on
# the smoke configs): a layer's fixed ops, each recurrent step of a layer
# (RWKV6's WKV per position, the SSD per chunk), each row block of a
# serving projection and each loss chunk of a train step.
_OPS = {"layer": 300, "scan": 8, "ssd": 30, "row_block": 12, "loss_chunk": 25,
        "count": 200}


def _ops_estimate(cfg, kind: str, layers: float, B: int, S: int) -> float:
    train = 3 if kind == "train" else 1   # forward, recompute, backward
    per_layer = _OPS["layer"] * train
    if cfg.family == "ssm":
        per_layer += _OPS["scan"] * train * S
    elif cfg.family == "hybrid" and S % cfg.ssm_chunk == 0:
        per_layer += _OPS["ssd"] * train * S / cfg.ssm_chunk
    if kind == "prefill":
        per_layer += _OPS["row_block"] * B * S / ROW_BLOCK
    loss = _OPS["loss_chunk"] * train * B * S / cfg.loss_chunk if (
        kind == "train" and cfg.loss_chunk) else 0
    return layers * per_layer + loss + _OPS["count"]


def _size_axes(cfg, cell, depth: float) -> list[Axis]:
    """The batch and sequence axes: batch points b, 2b (, 3b in a train
    step); sequence points s, 2s (, 3s where the counts are quadratic in S)
    from s >= S / 32 (so that the sequence-long
    tensors dominate the memory's peak as at full size); every combination
    of points takes the full size's branches.  Of the valid choices the one
    that costs the fewest ops to count (`_ops_estimate`, at ``depth``
    layers a count); none where nothing costs less than a full count."""
    B, S = cell.global_batch, cell.seq_len
    want = _structure(cfg, cell.kind, B, S)
    if want is None:
        return []
    # quadratic in S with attention; in a train step quadratic in B and S
    # (the backward of each chunk's slice of the sequence or of the tokens
    # is a full-length tensor)
    train = cell.kind == "train"
    n = 3 if (cfg.n_heads or cfg.shared_attn_every or train) else 2
    nb = 3 if train else 2
    batches = [None] + [tuple(k * b for k in range(1, nb + 1))
                        for b in range(1, B // (2 * nb) + 1) if B % b == 0]
    seqs = [None] + [tuple(k * s for k in range(1, n + 1))
                     for s in range(max(32, S // 32), S // (2 * n) + 1, 32)
                     if S % s == 0]
    def cost(bp, sp):
        return sum(_ops_estimate(cfg, cell.kind, depth, b, x)
                   for b in bp for x in sp)

    best, best_cost = [], cost((B,), (S,))
    for bp, sp in itertools.product(batches, seqs):
        if all(_structure(cfg, cell.kind, b, x) == want
               for b in (bp or (B,)) for x in (sp or (S,))):
            c = cost(bp or (B,), sp or (S,))
            if c < best_cost:
                best_cost = c
                best = ([Axis("batch", B, bp, _lagrange(bp, B))] if bp else []) + (
                    [Axis("seq", S, sp, _lagrange(sp, S))] if sp else [])
    return best


def plan(cfg: ArchConfig, cell: ShapeCell) -> list[Axis]:
    """The axes a cell is counted along (an empty list: one full count)."""
    axes = []
    L, e = cfg.n_layers, cfg.shared_attn_every
    if e:
        G, t = divmod(L, e)
        if G >= 2:
            axes.append(Axis("layers", L, (e, 2 * e) + ((e + 1,) if t else ()),
                             (2 - G - t, G - 1) + ((t,) if t else ())))
    elif L > 2:
        axes.append(Axis("layers", L, (1, 2), (2 - L, L - 1)))
    if cell.kind != "decode":
        depth = sum(axes[0].points) / len(axes[0].points) if axes else L
        axes += _size_axes(cfg, cell, depth)
    return axes


def _storages(tree) -> dict[int, int]:
    return {id(t.untyped_storage()): t.untyped_storage().nbytes()
            for t in tree_leaves(tree) if isinstance(t, torch.Tensor)}


def count_point(arch, shape, *, cfg=None, cell=None, **cut):
    """One counted run of the cell on meta tensors at ``cut`` (n_layers,
    batch, seq): (stats, memory dict, seconds)."""
    c = build_cell(arch, shape, cfg=cfg, cell=cell, **cut)
    args = _storages(c.args)
    t0 = time.perf_counter()
    with OpCounter(track_memory=True) as counter:
        out = c.fn(*c.args)
    seconds = time.perf_counter() - t0
    outs = _storages(out)
    alias = sum(n for k, n in outs.items() if k in args)
    created = sum(n for k, n in outs.items() if k not in args)
    mem = {"argument_bytes": sum(args.values()), "output_bytes": created + alias,
           "temp_bytes": max(counter.peak_bytes - created, 0),
           "alias_bytes": alias,
           "temp_by_phase": {ph: max(peak - created, 0)
                             for ph, peak in counter.peak_by_phase.items()}}
    return counter.stats, mem, seconds


def count_cell(arch: str, shape: str, *, cfg=None, cell=None, pool=None) -> dict:
    """The cell's stats and memory at full size, from the counts at every
    combination of `plan`'s points (in ``pool``'s processes when given, a
    `concurrent.futures` executor)."""
    cfg = cfg or get_config(arch)
    cell = cell or applicable_shapes(cfg)[shape]
    axes = plan(cfg, cell)
    combos = list(itertools.product(
        *(zip(a.points, a.coef, a.mem_coef) for a in axes)))
    cuts = [{{"layers": "n_layers"}.get(a.name, a.name): p
             for a, (p, _, _) in zip(axes, combo)} for combo in combos]
    if pool is None:
        counts = [count_point(arch, shape, cfg=cfg, cell=cell, **cut) for cut in cuts]
    else:
        futures = [pool.submit(count_point, arch, shape, cfg=cfg, cell=cell, **cut)
                   for cut in cuts]
        counts = [f.result() for f in futures]
    terms, mems, points = [], [], []
    for combo, cut, (stats, mem, seconds) in zip(combos, cuts, counts):
        coef = math.prod(c for _, c, _ in combo)
        terms.append((coef, stats))
        mems.append((math.prod(c for _, _, c in combo), mem))
        points.append(dict(cut, coef=coef, n_ops=stats.n_ops, count_s=seconds))
    stats = OpStats.combine(terms) if axes else terms[0][1]
    stats.repeats = [{"axis": a.name, "points": list(a.points), "target": a.target}
                     for a in axes]
    memory = {k: max(sum(c * m[k] for c, m in mems), 0)
              for k in ("output_bytes", "alias_bytes")}
    # the peak of each phase extrapolated on its own (a step's phases peak
    # on different tensors: a train step's optimizer on param-sized ones at
    # a small batch, its backward on the activations at a large one)
    phases = set.intersection(*(set(m["temp_by_phase"]) for _, m in mems))
    memory["temp_bytes"] = max([max(sum(c * m["temp_by_phase"][ph] for c, m in mems), 0)
                                for ph in phases] or [0])
    # the full-size inputs are built (meta: no memory) and measured directly
    full = build_cell(arch, shape, cfg=cfg, cell=cell)
    memory["argument_bytes"] = sum(_storages(full.args).values())
    memory["total_bytes"] = (memory["argument_bytes"] + memory["output_bytes"]
                             + memory["temp_bytes"] - memory["alias_bytes"])
    return {"stats": stats, "memory": memory, "points": points}


def run_cell(arch: str, shape: str, out_dir: str = OUT_DIR, *, cfg=None,
             cell=None, device: str = H100, pool=None) -> dict:
    """Count one cell (its points in ``pool`` when given), write its record
    and return it."""
    t0 = time.time()
    rec = {"arch": arch, "shape": shape, "device": device, "n_devices": 1,
           "ok": False}
    try:
        res = count_cell(arch, shape, cfg=cfg, cell=cell, pool=pool)
        mem = res["memory"]
        cap = device_peaks(device)["memory_bytes"]
        rec.update(ok=True, count_s=round(time.time() - t0, 2), memory=mem,
                   op_stats=res["stats"].asdict(), points=res["points"],
                   fits=mem["total_bytes"] <= FIT_SHARE * cap)
        if cell is not None:
            rec["cell"] = {"name": cell.name, "seq_len": cell.seq_len,
                           "global_batch": cell.global_batch, "kind": cell.kind}
        if cfg is not None:
            rec["model_flops"] = model_flops_for(cfg, cell or applicable_shapes(cfg)[shape])
        rec["roofline"] = roofline_from_record(rec)
        print(f"[ok] {arch} x {shape}: mem={mem['total_bytes'] / 2**30:.2f} GiB "
              f"flops={rec['op_stats']['flops']:.3e} "
              f"bytes={rec['op_stats']['bytes_accessed']:.3e} "
              f"{rec['roofline']['summary']} count={rec['count_s']:.1f}s", flush=True)
    except Exception as e:  # noqa: BLE001 — failures are data here
        rec.update(error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
        print(f"[FAIL] {arch} x {shape}: {type(e).__name__}: {e}", flush=True)
    finally:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"{arch}__{shape}__h100.json"), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


MESHES = {"single": (False,), "multi": (True,), "both": (False, True)}


def mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def mesh_memory(arch: str, shape: str, mesh) -> tuple[dict, list]:
    """({input name: its bytes on one device of ``mesh``}, the fallback log)
    of the cell's placed inputs (`specs.build_cell(mesh=)`)."""
    from repro_torch.sharding import device_bytes

    c = build_cell(arch, shape, mesh)
    return ({k: device_bytes(tree, sh) for k, (tree, sh) in c.placed.items()},
            c.fallback_log)


def run_mesh_cell(arch: str, shape: str, multi_pod: bool, out_dir: str = OUT_DIR,
                  *, work: bool = True, device: str = H100, pool=None) -> dict:
    """One cell's record on a production train mesh (see the module
    docstring): write it and return it."""
    t0 = time.time()
    name = mesh_name(multi_pod)
    rec = {"arch": arch, "shape": shape, "mesh": name, "device": device,
           "ok": False}
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
        rec["n_devices"] = mesh.size
        per, log = mesh_memory(arch, shape, mesh)
        state = sum(per.values())
        rec["memory"] = {"per_device_bytes": per, "per_device_input_bytes": state}
        rec["fallback_log"] = sorted(set(log))
        total = state
        if work:
            cfg = get_config(arch)
            cell = applicable_shapes(cfg)[shape]
            rows = mesh.n_rows
            B = cell.global_batch
            gb = B // rows if B % rows == 0 else B
            res = count_cell(arch, shape, cfg=cfg, cell=dataclasses.replace(
                cell, global_batch=gb))
            m = mesh.shape["model"]
            st = res["stats"]
            temp = res["memory"]["temp_bytes"]
            rec["group_work"] = {"rows": gb, "flops": st.flops,
                                 "bytes_accessed": st.bytes_accessed,
                                 "temp_bytes": temp}
            rec["per_device_work"] = {
                "flops": st.flops / m, "bytes_accessed": st.bytes_accessed / m,
                "temp_bytes": temp / m,
                "basis": "one data group's counted step split evenly over "
                         f"the model axis ({m})"}
            total = state + temp / m
        cap = device_peaks(device)["memory_bytes"]
        rec["memory"]["per_device_total_bytes"] = total
        rec.update(ok=True, fits=total <= FIT_SHARE * cap,
                   fits_basis="inputs + temporaries" if work else "inputs",
                   count_s=round(time.time() - t0, 2))
        print(f"[ok] {arch} x {shape} x {name}: "
              f"inputs/device={state / 2**30:.3f} GiB "
              f"total/device={total / 2**30:.3f} GiB fits={rec['fits']} "
              f"fallbacks={len(rec['fallback_log'])}", flush=True)
    except Exception as e:  # noqa: BLE001 — failures are data here
        rec.update(error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
        print(f"[FAIL] {arch} x {shape} x {name}: {type(e).__name__}: {e}",
              flush=True)
    finally:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"{arch}__{shape}__{name}.json"), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--manifest", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--mesh", default="none",
                    choices=["none", "single", "multi", "both"])
    ap.add_argument("--no-work", action="store_true",
                    help="mesh records: skip counting the data group's step")
    args = ap.parse_args(argv)

    if args.manifest:
        for a, s in runnable_cells():
            print(f"run  {a:24s} {s}")
        for a, s, r in skipped_cells():
            print(f"skip {a:24s} {s:12s} ({r})")
        return 0
    cells = runnable_cells()
    if args.arch:
        cells = [(a, s) for a, s in cells if a == args.arch]
    if args.shape:
        cells = [(a, s) for a, s in cells if s == args.shape]
    if not (cells and (args.all or args.arch or args.shape)):
        raise SystemExit("no cells matched (name --arch / --shape, or --all)")
    if args.mesh != "none":
        results = [run_mesh_cell(a, s, mp, args.out, work=not args.no_work)
                   for a, s in cells for mp in MESHES[args.mesh]]
    else:
        results = [run_cell(a, s, args.out) for a, s in cells]
    n_ok = sum(r["ok"] for r in results)
    print(f"\n{n_ok}/{len(results)} cells counted")
    return 0 if n_ok == len(results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
