"""The least work of one call of each hand-written kernel: the bytes it must
move (each input read once, each output written once) and the operations it
must do on these inputs.  Where the work depends on the data (spike-silent
words and blocks, silent timestep planes, masked attention pairs) it counts
what this call's data needs, not the most it could.  One definition, read
by the op counter (`op_stats.counted_kernel` at each kernel's entry) and by
``chip_smoke.py``'s bounds; `bound_ms` turns a work into the card's least
time for it.
"""
from __future__ import annotations

import torch

from .report import H100, device_peaks


def bound_ms(nbytes: float, ops: float, dtype: str = "bf16",
             device: str = H100) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the larger of the bytes over the
    card's memory rate and the operations over its peak for ``dtype``."""
    peaks = device_peaks(device)
    t_bytes, t_ops = nbytes / peaks["hbm_bytes_s"], ops / peaks["flop_s"][dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_values(a: torch.Tensor, what: str) -> None:
    """A kernel whose work depends on the data needs tensors with values."""
    from torch._subclasses.fake_tensor import is_fake

    if a.is_meta or is_fake(a):
        raise ValueError(f"the work of {what} depends on the spike words' "
                         "values: count it on real tensors, not meta or fake ones")


def bsr_work(a, payload, kidx, vidx, cnt, act, n_out, T, *, bm: int,
             fuse_lif: bool, tmap=None) -> tuple[int, int]:
    """(bytes, operations) of one dual-sparse BSR call (kernels 3 and 4):
    the spike words, the payload blocks that some live, spike-active join
    slot needs, the activity map, the join lists and the output, against
    the bf16 operations of those joins: 2 T' bn for every spike word that
    is not silent (a silent word needs no work) in the (row tile, k block)
    of a joined slot, over the T' planes that carry a spike (a silent plane
    adds nothing, with or without ``tmap``), less those ``tmap`` gates.
    Reads the words and maps (a device sync on the card)."""
    import torch.nn.functional as F

    from repro_torch.core.packing import timestep_activity_map

    M, K = a.shape
    nm, nkb = act.shape
    _, bk, bn = payload.shape
    kidx, vidx, cnt = kidx.long(), vidx.long(), cnt.long()
    live = torch.arange(kidx.shape[1], device=a.device)[None] < cnt[:, None]
    joined = (act[:, kidx] > 0) & live[None]              # (nm, nnb, jmax)
    words = F.pad((a != 0).int(), (0, nkb * bk - K, 0, nm * bm - M))
    words = words.reshape(nm, bm, nkb, bk).sum((1, 3))    # (nm, nkb)
    planes_live = timestep_activity_map(a, T)
    if tmap is not None:
        planes_live = planes_live & (tmap > 0)
    planes = int(planes_live.sum())
    ops = 2 * planes * bn * int((words[:, kidx] * joined).sum())
    used = torch.zeros(payload.shape[0], dtype=torch.bool, device=a.device)
    used[vidx[joined.any(0)]] = True
    out = M * n_out * 4 * (2 if fuse_lif else T + 1)
    nbytes = (a.numel() * 4 + int(used.sum()) * bk * bn * payload.element_size()
              + act.numel() * 4 + (kidx.numel() + vidx.numel() + cnt.numel()) * 4
              + out + (0 if tmap is None else tmap.numel() * 4))
    return nbytes, ops


def dense_work(a, w, T: int, fuse_lif: bool) -> tuple[int, int]:
    """(bytes, operations) of one dense-weight call (kernels 1 and 2): the
    words and the weight read once, the output written once, against 2 T N
    bf16 operations for every spike word that is not silent (a silent word
    needs no work).  Reads the words (a device sync on the card)."""
    M, K = a.shape
    N = w.shape[1]
    out = M * N * 8 if fuse_lif else T * M * N * 4
    nbytes = a.numel() * 4 + w.numel() * w.element_size() + out
    return nbytes, 2 * T * N * int((a != 0).sum())


def visible_pairs(S: int, Skv: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask leaves visible: the work the attention
    kernels need (a tile the mask fills adds nothing)."""
    from repro_torch.kernels.ref import _attn_mask

    return int(_attn_mask(S, Skv, causal, window, "cpu").sum())


def flash_work(q, Skv: int, causal: bool, window: int) -> dict[str, tuple[int, int]]:
    """{kernel: (bytes, operations)} of one attention call over (BH, S, dh)
    ``q`` and ``Skv`` keys: each input read once and each output written
    once, against 4 dh (forward), 6 dh (dq: s, dp, dq), 8 dh (dk/dv: s, dp,
    dk, dv) and 12 dh (forward and backward without recompute)
    multiply-adds x 2 per visible pair.  Needs only shapes."""
    BH, S, dh = q.shape
    e = q.element_size()
    pairs = BH * visible_pairs(S, Skv, causal, window)
    qo, kv, rows = BH * S * dh * e, BH * Skv * dh * e, BH * S * 4
    work = {"flash_fwd": (2 * qo + 2 * kv + rows, 4 * dh),
            "flash_bwd_dq": (3 * qo + 2 * kv + 2 * rows, 6 * dh),
            "flash_bwd_dkv": (2 * qo + 4 * kv + 2 * rows, 8 * dh),
            "flash_mha": (4 * qo + 4 * kv, 12 * dh)}
    return {name: (nbytes, per_pair * pairs)
            for name, (nbytes, per_pair) in work.items()}


def flash_dtype(q) -> str:
    """The peak a flash call's operations run at: the bf16 tensor cores for
    2-byte inputs, f32 otherwise."""
    return "bf16" if q.element_size() == 2 else "f32"
