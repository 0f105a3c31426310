"""Roofline terms of a dry-run or counted record (port of
`repro.roofline.report`, for one card instead of a TPU pod).

The card's numbers sit in `DEVICES`, keyed by the name ``nvidia-smi``
prints, at the power limit the data sheet assumes; a card that is not
there raises rather than take another card's numbers.  The record's stats
are per device:

  t_comp = sum over dtypes of flops[dtype] / peak[dtype]
           (bf16 products on the tensor cores, f32 ones outside them)
  t_mem  = bytes_accessed / HBM rate
  t_coll = collective_bytes / NVLink rate per direction (0 on one card)
"""
from __future__ import annotations

import re

from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES, ShapeCell

H100 = "NVIDIA H100 80GB HBM3"

# NVIDIA's data sheet, SXM part, dense rates without sparsity, at 700 W.
DEVICES = {
    H100: {
        "power_limit_w": 700.0,
        "flop_s": {"bf16": 989e12, "f16": 989e12, "f32": 67e12},
        "hbm_bytes_s": 3.35e12,
        "link_bytes_s": 450e9,   # NVLink 4, per direction
        "memory_bytes": 80 * 2**30,
    },
}


def device_peaks(name: str) -> dict:
    """The data-sheet numbers of the card ``name`` (as ``nvidia-smi``
    prints it), at the power limit ``power_limit_w`` they assume: a card set
    below it runs slower, so state its limit beside any share of these."""
    if name not in DEVICES:
        raise ValueError(f"no roofline numbers for {name!r} (known: {sorted(DEVICES)})")
    return DEVICES[name]


def parse_smi(line: str) -> tuple[str, float]:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``'s
    line -> (name, watts)."""
    name, power = (s.strip() for s in line.rsplit(",", 1))
    return name, float(power.split()[0])


def model_flops_for(cfg, cell: ShapeCell) -> float:
    """Analytic MODEL_FLOPS: 6 N D for training (2 forward + 4 backward),
    2 N_active D for inference, D = processed tokens; MoE counts active
    params."""
    n = cfg.active_params()
    if cell.kind == "train":
        return 6.0 * n * cell.global_batch * cell.seq_len
    if cell.kind == "prefill":
        return 2.0 * n * cell.global_batch * cell.seq_len
    return 2.0 * n * cell.global_batch  # decode: one token per sequence


def model_flops(arch: str, shape: str) -> float:
    return model_flops_for(get_config(arch), SHAPES[shape])


def _cell(rec: dict) -> ShapeCell:
    c = rec.get("cell")
    return ShapeCell(**c) if c else SHAPES[rec["shape"]]


def _score_shaped_bytes(rec: dict) -> float:
    """Measured bytes of attention-score-shaped tensors: output shapes whose
    trailing dim equals the cell's kv length and whose second-to-last dim is
    a query chunk (<= 1024).  Flash attention (kernels 5-6) keeps these on
    chip."""
    shapes = rec["op_stats"].get("bytes_by_shape") or {}
    skv = _cell(rec).seq_len
    total = 0.0
    for key, b in shapes.items():
        dims = [int(d) for d in re.search(r"\[([0-9,]*)\]", key).group(1).split(",") if d]
        if len(dims) >= 3 and dims[-1] == skv and dims[-2] <= 1024:
            total += b
    return total


def compute_time(flops_by_dtype: dict, peaks: dict) -> float:
    """Seconds of the counted products at the card's peak for each dtype;
    a dtype without a peak raises."""
    missing = set(flops_by_dtype) - set(peaks["flop_s"])
    if missing:
        raise ValueError(f"no peak for {sorted(missing)} products")
    return sum(f / peaks["flop_s"][dt] for dt, f in flops_by_dtype.items())


def roofline_from_record(rec: dict) -> dict:
    """The roofline terms of a record with ``op_stats``, ``memory`` and the
    card's name under ``device``; ``model_flops`` and ``cell`` may override
    the arch's and shape's."""
    st = rec["op_stats"]
    peaks = device_peaks(rec["device"])
    chips = rec.get("n_devices", 1)
    t_comp = compute_time(st["flops_by_dtype"], peaks)
    t_mem = st["bytes_accessed"] / peaks["hbm_bytes_s"]
    t_coll = st["collective_bytes"] / peaks["link_bytes_s"]
    terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
    bottleneck = max(terms, key=terms.get)
    t_total = max(terms.values())
    mf = rec.get("model_flops")
    if mf is None:
        mf = model_flops_for(get_config(rec["arch"]), _cell(rec))
    mf /= chips
    peak = peaks["flop_s"]["bf16"]
    useful = mf / max(st["flops"], 1.0)
    # roofline fraction: useful-compute time / bound-term time
    frac = (mf / peak) / max(t_total, 1e-12)
    mem_gib = rec["memory"]["total_bytes"] / 2**30
    cap_gib = peaks["memory_bytes"] / 2**30

    # flash projection: the score-shaped traffic flash keeps on chip
    score_b = _score_shaped_bytes(rec)
    t_mem_flash = max(st["bytes_accessed"] - score_b, 0.0) / peaks["hbm_bytes_s"]
    t_total_flash = max(t_comp, t_mem_flash, t_coll)
    frac_flash = (mf / peak) / max(t_total_flash, 1e-12)

    return {
        "t_comp_s": t_comp,
        "t_mem_s": t_mem,
        "t_coll_s": t_coll,
        "t_total_us": t_total * 1e6,
        "bottleneck": bottleneck,
        "model_flops_per_dev": mf,
        "useful_flops_ratio": useful,
        "roofline_fraction": frac,
        "score_bytes": score_b,
        "t_mem_flash_s": t_mem_flash,
        "roofline_fraction_flash": frac_flash,
        "mem_gib": mem_gib,
        "summary": (
            f"comp={t_comp*1e3:.3f}ms mem={t_mem*1e3:.3f}ms "
            f"coll={t_coll*1e3:.3f}ms bound={bottleneck} "
            f"useful_ratio={useful:.2f} roofline_frac={frac:.3f} "
            f"flash_frac={frac_flash:.3f} "
            f"mem={mem_gib:.1f}GiB fits80G={'Y' if mem_gib <= cap_gib else 'N'}"
        ),
    }
