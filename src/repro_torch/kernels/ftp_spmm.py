"""Dual-sparse FTP spMspM: the Hopper kernel's wrapper and its plain torch
version (port of `repro.kernels.ftp_spmm.ftp_spmm_bsr` with ``tmap=None``).

`ftp_spmm_bsr` launches the CUDA kernel in ``csrc/ftp_bsr.cu`` for CUDA
tensors and runs `ftp_spmm_bsr_plain` only for tensors on the CPU.  There is
no fallback: a CUDA input the kernel does not take raises.  ``LAUNCHES``
counts kernel launches (not plain-version calls), so a run can show that its
main path went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.lif import DEFAULT_TAU, DEFAULT_VTH
from repro_torch.core.packing import unpack_spikes

from . import _build
from .ref import lif_ref

LAUNCHES = 0

# The kernel's row tile: bm = 4 warps x rows per thread.  Small tiles keep
# decode (M = batch rows) from computing masked rows; large tiles read each
# payload block once per 16 rows in prefill.
_SMALL_BM, _LARGE_BM = 4, 16
_MAX_T = 8        # accumulator depth compiled into the kernel
_COLS = 32        # output columns per thread block
_MAX_BK = 256     # keeps the kernel's shared memory under the 48 KB default


def pick_bm(M: int) -> int:
    """Row tile for M rows.  Outputs do not depend on it: the accumulation
    order of every output element is fixed by the join list alone."""
    return _LARGE_BM if M >= 256 else _SMALL_BM


@functools.cache
def _kernel_lib() -> ctypes.CDLL:
    """The kernel library (built at first use) with its C signature set."""
    lib = _build.load()
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ftp_bsr_launch.argtypes = [
        p, i, i, p, i, i, i, p, p, p, i, i, p, i, i, i, i, f, f, i, p, p, p,
    ]
    lib.ftp_bsr_launch.restype = i
    lib.ftp_bsr_error_string.argtypes = [i]
    lib.ftp_bsr_error_string.restype = ctypes.c_char_p
    return lib


def _check(a, payload, kidx, vidx, cnt, act, n_out, bm):
    dev = a.device
    for name, t in (("payload", payload), ("kidx", kidx), ("vidx", vidx),
                    ("cnt", cnt), ("act", act)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, spikes on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if a.dtype != torch.int32 or a.ndim != 2 or not a.is_contiguous():
        raise ValueError("spikes must be a contiguous (M, K) int32 tensor")
    for name, t in (("kidx", kidx), ("vidx", vidx), ("cnt", cnt), ("act", act)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    if payload.dtype not in (torch.bfloat16, torch.float32) or payload.ndim != 3:
        raise ValueError("payload must be (nnzb, bk, bn) bf16 or f32")
    M, K = a.shape
    _, bk, bn = payload.shape
    nnb, _ = kidx.shape
    if vidx.shape != kidx.shape or cnt.shape != (nnb,):
        raise ValueError("kidx/vidx must be (nnb, jmax) and cnt (nnb,)")
    if act.shape != (-(-M // bm), act.shape[1]) or K > act.shape[1] * bk:
        raise ValueError(f"act {tuple(act.shape)} does not tile {(M, K)} by bm={bm}")
    if not 0 < n_out <= nnb * bn:
        raise ValueError(f"n_out={n_out} outside the plan's {nnb * bn} columns")
    return M, K, bk, bn, nnb


def ftp_spmm_bsr(
    a: torch.Tensor,
    payload: torch.Tensor,
    kidx: torch.Tensor,
    vidx: torch.Tensor,
    cnt: torch.Tensor,
    act: torch.Tensor,
    n_out: int,
    T: int,
    v_th: float = DEFAULT_VTH,
    tau: float = DEFAULT_TAU,
    *,
    bm: int,
    fuse_lif: bool = True,
):
    """Dual-sparse FTP spMspM over a load-time weight join plan.

    a:       (M, K) int32 packed spikes (bit t = timestep t).
    payload: (nnzb, bk, bn) bf16/f32 non-zero weight blocks.
    kidx, vidx: (nnb, jmax) int32 join lists; cnt: (nnb,) int32 live slots.
    act:     (ceil(M/bm), nkb) int32 spike block-activity map for row tile
             ``bm`` (>0 where the (bm, bk) spike block has a non-silent word).

    Returns (packed spikes (M, n_out) int32, final U (M, n_out) f32) when
    ``fuse_lif``, else ((T, M, n_out) f32 full sums, zeros (M, n_out))."""
    M, K, bk, bn, nnb = _check(a, payload, kidx, vidx, cnt, act, n_out, bm)
    if a.device.type == "cpu":
        return ftp_spmm_bsr_plain(a, payload, kidx, vidx, cnt, act, n_out, T,
                                  v_th, tau, bm=bm, fuse_lif=fuse_lif)
    if a.device.type != "cuda":
        raise ValueError(f"no ftp_bsr kernel for device {a.device}")
    if bm not in (_SMALL_BM, _LARGE_BM):
        raise ValueError(f"the kernel's row tile is {_SMALL_BM} or {_LARGE_BM}, got {bm}")
    if not 1 <= T <= _MAX_T:
        raise ValueError(f"the kernel takes 1 <= T <= {_MAX_T}, got {T}")
    if bn % _COLS or bk > _MAX_BK or payload.data_ptr() % 16:
        raise ValueError(
            f"the kernel needs bn % {_COLS} == 0, bk <= {_MAX_BK} and a "
            f"16-byte aligned payload (bk={bk}, bn={bn})"
        )
    lib = _kernel_lib()
    if fuse_lif:
        out = torch.empty((M, n_out), dtype=torch.int32, device=a.device)
    else:
        out = torch.empty((T, M, n_out), dtype=torch.float32, device=a.device)
    u = torch.empty((M, n_out), dtype=torch.float32, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = lib.ftp_bsr_launch(
        a.data_ptr(), M, K, payload.data_ptr(),
        int(payload.dtype == torch.bfloat16), bk, bn,
        kidx.data_ptr(), vidx.data_ptr(), cnt.data_ptr(), nnb, kidx.shape[1],
        act.data_ptr(), act.shape[1], bm // 4, n_out, T, float(v_th),
        float(tau), int(fuse_lif), out.data_ptr(), u.data_ptr(), stream,
    )
    if rc != 0:
        msg = lib.ftp_bsr_error_string(rc).decode()
        raise RuntimeError(f"ftp_bsr kernel launch failed: CUDA error {rc} ({msg})")
    global LAUNCHES
    LAUNCHES += 1
    return out, u


def ftp_spmm_bsr_plain(
    a, payload, kidx, vidx, cnt, act, n_out, T,
    v_th=DEFAULT_VTH, tau=DEFAULT_TAU, *, bm, fuse_lif=True,
):
    """Plain torch version of the kernel: unpack -> per-join-slot block
    products in f32, ascending slot, every column block at once -> LIF.
    Skips exactly what the kernel skips: dead join slots and spike blocks
    the activity map marks silent."""
    M, K = a.shape
    _, bk, bn = payload.shape
    nnb, jmax = kidx.shape
    nkb = act.shape[1]
    planes = unpack_spikes(a, T, torch.float32)  # (T, M, K)
    if K < nkb * bk:
        planes = torch.nn.functional.pad(planes, (0, nkb * bk - K))
    planes = planes.reshape(T, M, nkb, bk)
    row_active = act.repeat_interleave(bm, dim=0)[:M] > 0  # (M, nkb)
    planes = planes * row_active[None, :, :, None]
    w = payload.to(torch.float32)
    live = torch.arange(jmax, device=a.device)[None, :] < cnt[:, None]
    acc = torch.zeros((T, M, nnb, bn), dtype=torch.float32, device=a.device)
    for jj in range(jmax):
        prod = torch.einsum(
            "tmjk,jkn->tmjn", planes[:, :, kidx[:, jj].long()],
            w[vidx[:, jj].long()],
        )
        acc = acc + prod * live[:, jj, None]
    o = acc.reshape(T, M, nnb * bn)[..., :n_out]
    if fuse_lif:
        return lif_ref(o, v_th=v_th, tau=tau)
    return o.contiguous(), torch.zeros((M, n_out), dtype=torch.float32,
                                       device=a.device)
