"""Flash attention forward and backward: the wrappers of the hand-written
CUDA kernels and the autograd Function over them (port of
`repro.kernels.flash_mha`, kernels 5-7).

* `flash_mha_fwd`: online-softmax attention, causal / sliding-window / none,
  (BH, S, dh) -> (o, lse) (kernel 5, ``csrc/flash_mha.cu`` forward);
* `flash_mha_bwd`: dq per q tile (`flash_mha_bwd_dq`) and dk, dv per kv
  tile (`flash_mha_bwd_dkv`) from the saved lse (kernel 6, the two
  backward kernels of the same file); delta = rowsum(o * do) is plain
  torch, as the reference keeps it outside its kernels;
* `flash_mha`: a `torch.autograd.Function` over both (kernel 7, the
  reference's ``custom_vjp``).

Each wrapper launches its CUDA kernel for CUDA tensors and runs its plain
version (`ref.flash_mha_fwd_plain`, `ref.flash_mha_bwd_dq_plain`,
`ref.flash_mha_bwd_dkv_plain`) only for
tensors on the CPU; the reference's ``interpret`` switch is not ported.
There is no fallback: a CUDA input a kernel does not take raises.  The
reference's block sizes ``bq``/``bk`` are validated as the reference does
(``bq = min(bq, S)``, ``S % bq == 0``, ``Skv % bk == 0``); the kernels tile by
64 rows whatever they are, and no output depends on them beyond rounding.
`launch_counts()` counts kernel launches (not plain-version calls) and the
Function's backward passes that launched the backward kernels.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .ref import (
    flash_mha_bwd_dkv_plain,
    flash_mha_bwd_dq_plain,
    flash_mha_fwd_plain,
)

DEFAULT_BQ = 256
DEFAULT_BK = 256
HEAD_DIMS = (32, 64, 128)  # the kernels' template instances

FWD_LAUNCHES = 0        # kernel 5
DQ_LAUNCHES = 0         # kernel 6, dq
DKV_LAUNCHES = 0        # kernel 6, dk and dv
AUTOGRAD_BACKWARDS = 0  # kernel 7: backward passes that launched kernel 6


def launch_counts() -> dict[str, int]:
    return {"flash_fwd": FWD_LAUNCHES, "flash_bwd_dq": DQ_LAUNCHES,
            "flash_bwd_dkv": DKV_LAUNCHES, "flash_mha": AUTOGRAD_BACKWARDS}


def reset_launch_counts() -> None:
    global FWD_LAUNCHES, DQ_LAUNCHES, DKV_LAUNCHES, AUTOGRAD_BACKWARDS
    FWD_LAUNCHES = DQ_LAUNCHES = DKV_LAUNCHES = AUTOGRAD_BACKWARDS = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel library (built at first use) with its C signatures set."""
    lib = _build.load("flash_mha")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    geom = [i, i, i, i, i, f, i, i]  # BH, S, Skv, dh, bf16, scale, causal, window
    lib.flash_fwd_launch.argtypes = [p, p, p, *geom, p, p, p]
    lib.flash_bwd_dq_launch.argtypes = [p, p, p, p, p, p, *geom, p, p]
    lib.flash_bwd_dkv_launch.argtypes = [p, p, p, p, p, p, *geom, p, p, p]
    for fn in (lib.flash_fwd_launch, lib.flash_bwd_dq_launch,
               lib.flash_bwd_dkv_launch):
        fn.restype = i
    lib.flash_mha_error_string.argtypes = [i]
    lib.flash_mha_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        msg = _lib().flash_mha_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} ({msg})")


def _check(q, k, v, bq: int, bk: int, *extra) -> tuple[int, int, int, int]:
    """The reference's block validation plus what the kernels take; returns
    (BH, S, Skv, dh)."""
    if q.ndim != 3 or k.ndim != 3 or v.ndim != 3:
        raise ValueError("q, k, v must be (BH, S, dh) tensors")
    BH, S, dh = q.shape
    Skv = k.shape[1]
    if k.shape != (BH, Skv, dh) or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} do not share BH and dh")
    bq, bk = min(bq, S), min(bk, Skv)
    if bq < 1 or bk < 1 or S % bq or Skv % bk:
        raise ValueError(f"S={S} and Skv={Skv} must be multiples of the "
                         f"blocks bq={bq}, bk={bk}")
    for t in (k, v, *extra):
        if t.device != q.device:
            raise ValueError(f"a tensor is on {t.device}, q on {q.device}")
    return BH, S, Skv, dh


def _check_kernel(q, k, v, dh: int, *extra) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention kernel for device {q.device}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the kernels take bf16 or f32, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q, k, v must share one dtype")
    if dh not in HEAD_DIMS:
        raise ValueError(f"the kernels take dh in {HEAD_DIMS}, got {dh}")
    for t in (q, k, v, *extra):
        if not t.is_contiguous():
            raise ValueError("the kernels take contiguous tensors")


def _geometry(q, BH, S, Skv, dh, causal, window):
    return (BH, S, Skv, dh, int(q.dtype == torch.bfloat16), float(dh ** -0.5),
            int(bool(causal)), int(window))


def flash_mha_fwd(q, k, v, *, causal=True, window=0, bq=DEFAULT_BQ,
                  bk=DEFAULT_BK):
    """q (BH, S, dh), k, v (BH, Skv, dh) -> (o (BH, S, dh) in q's dtype,
    lse (BH, S) f32) (kernel 5)."""
    BH, S, Skv, dh = _check(q, k, v, bq, bk)
    if q.device.type == "cpu":
        return flash_mha_fwd_plain(q, k, v, causal, window)
    _check_kernel(q, k, v, dh)
    o = torch.empty_like(q)
    lse = torch.empty((BH, S), dtype=torch.float32, device=q.device)
    rc = _lib().flash_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        *_geometry(q, BH, S, Skv, dh, causal, window), o.data_ptr(),
        lse.data_ptr(), torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, "flash_fwd")
    global FWD_LAUNCHES
    FWD_LAUNCHES += 1
    return o, lse


def _check_bwd(q, k, v, do, lse, delta, bq, bk):
    BH, S, Skv, dh = _check(q, k, v, bq, bk, do, lse, delta)
    if do.shape != q.shape or lse.shape != (BH, S) or delta.shape != (BH, S):
        raise ValueError("do must be (BH, S, dh), lse and delta (BH, S)")
    if q.device.type != "cpu":
        _check_kernel(q, k, v, dh, do, lse, delta)
        if (do.dtype != q.dtype or lse.dtype != torch.float32
                or delta.dtype != torch.float32):
            raise ValueError("do must be in q's dtype, lse and delta f32")
    return BH, S, Skv, dh


def _bwd_args(q, k, v, do, lse, delta, BH, S, Skv, dh, causal, window):
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(),
            *_geometry(q, BH, S, Skv, dh, causal, window))


def flash_mha_bwd_dq(q, k, v, do, lse, delta, *, causal=True, window=0,
                     bq=DEFAULT_BQ, bk=DEFAULT_BK):
    """dq (BH, S, dh) in q's dtype from the forward's lse and delta =
    rowsum(o * do) (kernel 6, the dq kernel)."""
    BH, S, Skv, dh = _check_bwd(q, k, v, do, lse, delta, bq, bk)
    if q.device.type == "cpu":
        return flash_mha_bwd_dq_plain(q, k, v, do, lse, delta, causal, window)
    dq = torch.empty_like(q)
    rc = _lib().flash_bwd_dq_launch(
        *_bwd_args(q, k, v, do, lse, delta, BH, S, Skv, dh, causal, window),
        dq.data_ptr(), torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, "flash_bwd_dq")
    global DQ_LAUNCHES
    DQ_LAUNCHES += 1
    return dq


def flash_mha_bwd_dkv(q, k, v, do, lse, delta, *, causal=True, window=0,
                      bq=DEFAULT_BQ, bk=DEFAULT_BK):
    """(dk, dv) (BH, Skv, dh) in k's and v's dtypes (kernel 6, the dk/dv
    kernel)."""
    BH, S, Skv, dh = _check_bwd(q, k, v, do, lse, delta, bq, bk)
    if q.device.type == "cpu":
        return flash_mha_bwd_dkv_plain(q, k, v, do, lse, delta, causal, window)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    rc = _lib().flash_bwd_dkv_launch(
        *_bwd_args(q, k, v, do, lse, delta, BH, S, Skv, dh, causal, window),
        dk.data_ptr(), dv.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, "flash_bwd_dkv")
    global DKV_LAUNCHES
    DKV_LAUNCHES += 1
    return dk, dv


def flash_mha_bwd(q, k, v, o, lse, do, *, causal=True, window=0,
                  bq=DEFAULT_BQ, bk=DEFAULT_BK):
    """Gradients of ``sum(o * do)`` from the forward's o and lse -> (dq, dk,
    dv) in the inputs' dtypes (kernel 6: delta in plain torch, then the dq
    kernel and the dk/dv kernel)."""
    if o.shape != q.shape or o.device != q.device:
        raise ValueError("o must be (BH, S, dh) beside q")
    delta = (o.float() * do.float()).sum(-1)
    kw = dict(causal=causal, window=window, bq=bq, bk=bk)
    dq = flash_mha_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = flash_mha_bwd_dkv(q, k, v, do, lse, delta, **kw)
    return dq, dk, dv


class FlashMHA(torch.autograd.Function):
    """Attention whose backward is kernel 6 (the reference's custom_vjp):
    saves q, k, v, o, lse; the non-tensor arguments get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, bq, bk):
        o, lse = flash_mha_fwd(q, k, v, causal=causal, window=window, bq=bq,
                               bk=bk)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = dict(causal=causal, window=window, bq=bq, bk=bk)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_mha_bwd(q, k, v, o, lse, do.contiguous(), **ctx.opts)
        if do.is_cuda:
            global AUTOGRAD_BACKWARDS
            AUTOGRAD_BACKWARDS += 1
        return dq, dk, dv, None, None, None, None


def flash_mha(q, k, v, causal=True, window=0, bq=DEFAULT_BQ, bk=DEFAULT_BK):
    """Differentiable flash attention: (BH, S, dh) q and (BH, Skv, dh) k, v
    -> o (BH, S, dh) (kernel 7 over kernels 5 and 6)."""
    return FlashMHA.apply(q, k, v, causal, window, bq, bk)
