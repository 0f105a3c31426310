"""The FTP kernels' wrappers and their plain torch versions (port of
`repro.kernels.ftp_spmm`).

* `ftp_spmm` / `ftp_spmm_fused_lif`: packed spikes x dense weights, full
  sums or the fused P-LIF (kernels 1 and 2 of the reference, one CUDA
  source, ``csrc/ftp_dense.cu``, with two instances: ``tc`` on the tensor
  cores for bf16 weights, ``simt`` for f32 weights or an unaligned N;
  `dense_instance` picks one from the dtype, N and the alignment alone);
* `ftp_spmm_bsr`: dual-sparse, against a load-time weight join plan
  (kernel 3, ``csrc/ftp_bsr.cu``); with a timestep-activity map ``tmap`` it
  launches the adaptive form of the same kernel (kernel 4).  Two
  instances: ``tc`` on the tensor cores for bf16 payloads, ``simt`` for
  f32 payloads and small blocks; `bsr_instance` picks one from the dtype,
  the block shape and the alignment alone.

Each wrapper launches its CUDA kernel for CUDA tensors and runs its plain
version only for tensors on the CPU.  There is no fallback: a CUDA input a
kernel does not take raises.  One integer per kernel counts its launches
(not plain-version calls), so a run can show that its main path went
through the kernel: ``LAUNCHES`` (kernel 3), ``ADAPTIVE_LAUNCHES`` (4),
``SPMM_LAUNCHES`` (1) and ``SPMM_LIF_LAUNCHES`` (2); ``DENSE_TC_LAUNCHES``
and ``DENSE_SIMT_LAUNCHES`` count the launches of kernels 1 and 2 together
by the instance that ran, ``BSR_TC_LAUNCHES`` and ``BSR_SIMT_LAUNCHES``
those of kernels 3 and 4.

Under an active op counter (`repro_torch.roofline.op_stats`) each of
`ftp_spmm`, `ftp_spmm_fused_lif` and `ftp_spmm_bsr` counts one call by its
least work (`roofline.kernel_work`; it reads the words, so a counted call
waits for the device) and none of the aten ops inside it: the same stats on
the CPU as on the card.  The work depends on the spike words, so meta or
fake inputs raise there.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.lif import DEFAULT_TAU, DEFAULT_VTH
from repro_torch.core.packing import MAX_T, unpack_spikes
from repro_torch.roofline import kernel_work
from repro_torch.roofline.op_stats import DTYPE_NAMES, counted_kernel

from . import _build
from .ref import ftp_spmm_fused_lif_ref as ftp_spmm_fused_lif_plain
from .ref import ftp_spmm_ref as ftp_spmm_plain
from .ref import lif_ref

LAUNCHES = 0           # kernel 3: ftp_bsr, every timestep plane
ADAPTIVE_LAUNCHES = 0  # kernel 4: ftp_bsr gated by a timestep-activity map
SPMM_LAUNCHES = 0      # kernel 1: ftp_dense, full sums
SPMM_LIF_LAUNCHES = 0  # kernel 2: ftp_dense, fused P-LIF
DENSE_TC_LAUNCHES = 0    # kernels 1 + 2 through the tensor-core instance
DENSE_SIMT_LAUNCHES = 0  # kernels 1 + 2 through the SIMT instance
BSR_TC_LAUNCHES = 0      # kernels 3 + 4 through the tensor-core instance
BSR_SIMT_LAUNCHES = 0    # kernels 3 + 4 through the SIMT instance

KERNEL_NAMES = ("ftp_bsr", "ftp_bsr_adaptive", "ftp_spmm", "ftp_spmm_fused_lif")


def launch_counts() -> dict[str, int]:
    """{kernel name: launches} of the four kernels (`KERNEL_NAMES`), then
    the launches by instance: ``ftp_dense_tc`` / ``ftp_dense_simt`` (each
    launch of kernel 1 or 2 counts in one) and ``ftp_bsr_tc`` /
    ``ftp_bsr_simt`` (each launch of kernel 3 or 4 counts in one)."""
    return {"ftp_bsr": LAUNCHES, "ftp_bsr_adaptive": ADAPTIVE_LAUNCHES,
            "ftp_spmm": SPMM_LAUNCHES, "ftp_spmm_fused_lif": SPMM_LIF_LAUNCHES,
            "ftp_dense_tc": DENSE_TC_LAUNCHES,
            "ftp_dense_simt": DENSE_SIMT_LAUNCHES,
            "ftp_bsr_tc": BSR_TC_LAUNCHES, "ftp_bsr_simt": BSR_SIMT_LAUNCHES}


def reset_launch_counts() -> None:
    global LAUNCHES, ADAPTIVE_LAUNCHES, SPMM_LAUNCHES, SPMM_LIF_LAUNCHES
    global DENSE_TC_LAUNCHES, DENSE_SIMT_LAUNCHES
    global BSR_TC_LAUNCHES, BSR_SIMT_LAUNCHES
    LAUNCHES = ADAPTIVE_LAUNCHES = SPMM_LAUNCHES = SPMM_LIF_LAUNCHES = 0
    DENSE_TC_LAUNCHES = DENSE_SIMT_LAUNCHES = 0
    BSR_TC_LAUNCHES = BSR_SIMT_LAUNCHES = 0


# The kernels' row tile: bm = 4 warps x rows per thread.  Small tiles keep
# decode (M = batch rows) from computing masked rows; large tiles read each
# weight tile once per 16 (T <= 8) or 8 (T <= 32: the deeper accumulator
# leaves room for fewer rows per thread) rows in prefill.
_SMALL_BM = 4
_COLS = 32        # output columns per thread block
_MAX_BK = 256     # keeps the BSR SIMT instance's shared memory under 48 KB
_MAX_ROW_TILES = 65535  # the grid's row-tile extent (its y)


def _large_bm(T: int) -> int:
    return 16 if T <= 8 else 8


def pick_bm(M: int, T: int) -> int:
    """Row tile for M rows at T timesteps.  Outputs do not depend on it: the
    accumulation order of every output element is fixed by k alone."""
    return _large_bm(T) if M >= 256 else _SMALL_BM


def _check_T(T: int) -> None:
    if not 1 <= T <= MAX_T:
        raise ValueError(f"the kernels take 1 <= T <= {MAX_T}, got {T}")


@functools.cache
def _kernel_lib(name: str) -> ctypes.CDLL:
    """A kernel library (built at first use) with its C signatures set."""
    lib = _build.load(name)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if name == "ftp_bsr":
        lib.ftp_bsr_launch.argtypes = [
            p, i, i, p, i, i, i, p, p, p, i, i, p, i, p, i, i, i, f, f, i,
            p, p, p,
        ]
        lib.ftp_bsr_launch.restype = i
        lib.ftp_bsr_tc_launch.argtypes = [
            p, i, i, i, p, i, i, i, p, p, p, i, i, p, i, i, p, i, i, i, i, i,
            i, f, f, i, p, p, p,
        ]
        lib.ftp_bsr_tc_launch.restype = i
    else:
        lib.ftp_dense_launch.argtypes = [
            p, i, i, p, i, i, i, i, i, f, f, i, p, p, p,
        ]
        lib.ftp_dense_launch.restype = i
        lib.ftp_dense_tc_launch.argtypes = [
            p, i, i, i, p, i, i, i, i, i, i, f, f, i, p, p, p,
        ]
        lib.ftp_dense_tc_launch.restype = i
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [i]
    err.restype = ctypes.c_char_p
    return lib


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        msg = getattr(_kernel_lib(name), f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} ({msg})")


# ---------------------------------------------------------------------------
# kernels 1 and 2: packed spikes x dense weights
# ---------------------------------------------------------------------------

def _check_dense(a: torch.Tensor, b: torch.Tensor, T: int):
    if a.dtype != torch.int32 or a.ndim != 2 or not a.is_contiguous():
        raise ValueError("spikes must be a contiguous (M, K) int32 tensor")
    if b.device != a.device:
        raise ValueError(f"weights are on {b.device}, spikes on {a.device}")
    if b.dtype not in (torch.bfloat16, torch.float32) or b.ndim != 2:
        raise ValueError(f"weights must be (K, N) bf16 or f32, got {b.dtype}")
    if not b.is_contiguous():
        raise ValueError("weights must be contiguous")
    if b.shape[0] != a.shape[1]:
        raise ValueError(f"spikes {tuple(a.shape)} do not meet weights "
                         f"{tuple(b.shape)}")
    _check_T(T)


# The tensor-core instances' launch shapes (csrc/ftp_dense.cu and
# csrc/ftp_bsr.cu, namespace tc)
_TC_BN = 64            # BSR: the narrower column tile; bn must be a multiple
_TC_WIDE_BN = 128      # BSR: the column tile where bn is a multiple of it
_TC_BK = 64            # K depth of a ring stage; split boundaries are multiples
_TC_MAX_SPLITS = 8     # a portable thread-block cluster
_TC_MIN_BLOCKS = 64    # BSR: splits fill this many blocks at the smallest M ...
_TC_MIN_SLOTS = 4      # BSR: ... while every rank keeps this many join slots
_TC_WAVE = 132         # BSR: 256-row blocks only for a grid of a wave of SMs
_DENSE_TC_BN = 128     # dense: output columns per block, m64n128k16
_DENSE_TC_MMA = "m64n128k16"
_DENSE_TC_MIN_BLOCKS = 64   # dense: K splits fill this many blocks at the smallest M


def dense_instance(dtype: torch.dtype, N: int, aligned: bool) -> str:
    """The dense kernels' instance for (K, N) weights of ``dtype`` whose
    base is 16-byte ``aligned``: ``"tc"`` (tensor cores) for bf16 with a
    16-byte aligned base and rows of a multiple of 16 bytes (what the tc
    instance's TMA tensor map needs of the weight's base and row stride),
    else ``"simt"``.  A function of these three alone, never of M or of a
    failed launch."""
    if dtype == torch.bfloat16 and aligned and (N * 2) % 16 == 0:
        return "tc"
    return "simt"


def dense_tc_shape(M: int, K: int, N: int, T: int) -> dict:
    """The tensor-core instance's launch shape.

    ``bn`` (columns per block), ``mma`` (the instruction), ``splits`` (the
    cluster's K splits, in ascending rank order) and ``k_split`` (each
    split's depth) depend on (K, N) alone, so every output element is
    summed in the same order for any M: splits double while
    ``ceil(N / bn) * splits`` launches fewer than 64 blocks, up to 8 and to
    the number of 64-deep K steps.  Only the block's rows grow with M:
    ``rows`` MMA rows (64, one consumer warpgroup of one m64 tile, while
    M * T' <= 64; else 256, two warpgroups of two) hold ``bm`` = rows / T'
    spike rows, T' = T rounded up to a power of two, at least 4."""
    n_cols = -(-N // _DENSE_TC_BN)
    k_steps = -(-K // _TC_BK)
    splits = 1
    while (splits < _TC_MAX_SPLITS and n_cols * splits < _DENSE_TC_MIN_BLOCKS
           and 2 * splits <= k_steps):
        splits *= 2
    per_split = -(-K // splits)
    k_split = -(-per_split // _TC_BK) * _TC_BK
    t_pad = max(4, 1 << (T - 1).bit_length())
    rows = 64 if M * t_pad <= 64 else 256
    return {"bn": _DENSE_TC_BN, "mma": _DENSE_TC_MMA, "splits": splits,
            "k_split": k_split, "rows": rows, "bm": rows // t_pad}


def _dense_launch(a, b, T, v_th, tau, fuse_lif, instance=None, parent_n=None):
    if a.device.type != "cuda":
        raise ValueError(f"no ftp_dense kernel for device {a.device}")
    M, K = a.shape
    N = b.shape[1]
    aligned = b.data_ptr() % 16 == 0
    route = dense_instance(b.dtype, N, aligned)
    if instance is None:
        instance = route
    elif instance == "tc" and route != "tc":
        raise ValueError(f"the tc instance takes bf16 weights with a 16-byte "
                         f"aligned base and N * 2 % 16 == 0, got {b.dtype}, N={N}")
    elif instance not in ("tc", "simt"):
        raise ValueError(f"no ftp_dense instance {instance!r}")
    # a column slab sums in its parent's order: the launch shape of the
    # whole weight's N (splits and k_split depend on (K, N) alone)
    shape = (dense_tc_shape(M, K, N if parent_n is None else parent_n, T)
             if instance == "tc" else None)
    bm = shape["bm"] if shape else pick_bm(M, T)
    if min(M, K, N) < 1 or -(-M // bm) > _MAX_ROW_TILES:
        raise ValueError(f"the kernel takes 1 <= M <= {_MAX_ROW_TILES} row "
                         f"tiles of {bm} and K, N >= 1, got {(M, K, N)}")
    if fuse_lif:
        out = torch.empty((M, N), dtype=torch.int32, device=a.device)
        u = torch.empty((M, N), dtype=torch.float32, device=a.device)
    else:
        out = torch.empty((T, M, N), dtype=torch.float32, device=a.device)
        u = None
    stream = torch.cuda.current_stream(a.device).cuda_stream
    lib = _kernel_lib("ftp_dense")
    u_ptr = None if u is None else u.data_ptr()
    with _build.on_card(a.device):  # launch on the tensors' card
        if instance == "tc":
            a_vec = a.data_ptr() % 16 == 0 and K % 4 == 0
            rc = lib.ftp_dense_tc_launch(
                a.data_ptr(), M, K, int(a_vec), b.data_ptr(), N, T,
                shape["rows"], bm, shape["splits"], shape["k_split"],
                float(v_th), float(tau), int(fuse_lif), out.data_ptr(), u_ptr,
                stream)
        else:
            vec_ok = aligned and (N * b.element_size()) % 16 == 0
            rc = lib.ftp_dense_launch(
                a.data_ptr(), M, K, b.data_ptr(),
                int(b.dtype == torch.bfloat16), N, int(vec_ok), bm // 4, T,
                float(v_th), float(tau), int(fuse_lif), out.data_ptr(), u_ptr,
                stream)
    _raise_on(rc, "ftp_dense")
    global DENSE_TC_LAUNCHES, DENSE_SIMT_LAUNCHES
    if instance == "tc":
        DENSE_TC_LAUNCHES += 1
    else:
        DENSE_SIMT_LAUNCHES += 1
    return out, u


def _dense_work(name: str, fuse_lif: bool):
    def work(a, b, T, *args, **kwargs):
        kernel_work.check_values(a, name)
        nbytes, ops = kernel_work.dense_work(a, b, T, fuse_lif)
        return name, DTYPE_NAMES[b.dtype], ops, nbytes
    return work


@counted_kernel(_dense_work("ftp_spmm", False))
def ftp_spmm(a: torch.Tensor, b: torch.Tensor, T: int, *,
             instance: str | None = None,
             parent_n: int | None = None) -> torch.Tensor:
    """(M, K) int32 packed spikes x (K, N) bf16/f32 dense weights -> (T, M,
    N) f32 full sums (kernel 1).  ``instance`` ("tc" or "simt") overrides
    `dense_instance`'s choice, to measure one instance against the other;
    an instance the weights do not fit raises.  ``parent_n``: when ``b`` is
    a column slab of a wider weight (a model shard), that weight's column
    count; the tc instance then launches with the whole weight's shape, so
    every element is summed in the order the unsharded call sums it."""
    _check_dense(a, b, T)
    if a.device.type == "cpu":
        return ftp_spmm_plain(a, b, T)
    out, _ = _dense_launch(a, b, T, DEFAULT_VTH, DEFAULT_TAU, False, instance,
                           parent_n)
    global SPMM_LAUNCHES
    SPMM_LAUNCHES += 1
    return out


@counted_kernel(_dense_work("ftp_spmm_fused_lif", True))
def ftp_spmm_fused_lif(
    a: torch.Tensor,
    b: torch.Tensor,
    T: int,
    v_th: float = DEFAULT_VTH,
    tau: float = DEFAULT_TAU,
    *,
    instance: str | None = None,
):
    """(M, K) int32 packed spikes x (K, N) dense weights -> (packed spikes
    (M, N) int32, final U (M, N) f32): kernel 1 with the hard-reset P-LIF
    fused into its epilogue (kernel 2); the full sums never reach device
    memory.  ``instance`` as for `ftp_spmm`."""
    _check_dense(a, b, T)
    if a.device.type == "cpu":
        return ftp_spmm_fused_lif_plain(a, b, T, v_th, tau)
    out = _dense_launch(a, b, T, v_th, tau, True, instance)
    global SPMM_LIF_LAUNCHES
    SPMM_LIF_LAUNCHES += 1
    return out


# ---------------------------------------------------------------------------
# kernels 3 and 4: dual-sparse, against a load-time weight join plan
# ---------------------------------------------------------------------------

def _check(a, payload, kidx, vidx, cnt, act, n_out, bm, T, tmap):
    dev = a.device
    named = [("payload", payload), ("kidx", kidx), ("vidx", vidx),
             ("cnt", cnt), ("act", act)]
    if tmap is not None:
        named.append(("tmap", tmap))
        if tmap.shape != (T,):
            raise ValueError(f"tmap must be ({T},), got {tuple(tmap.shape)}")
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, spikes on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if a.dtype != torch.int32 or a.ndim != 2 or not a.is_contiguous():
        raise ValueError("spikes must be a contiguous (M, K) int32 tensor")
    for name, t in named[1:]:
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
    _check_T(T)
    return M, K, bk, bn, nnb


def bsr_instance(dtype: torch.dtype, bk: int, bn: int, aligned: bool) -> str:
    """The BSR kernels' instance for a (nnzb, bk, bn) payload of ``dtype``
    whose base is 16-byte ``aligned``: ``"tc"`` (tensor cores) for bf16
    with a 16-byte aligned base, ``bk % 16 == 0`` and ``bn % 64 == 0``,
    else ``"simt"``.  A function of these four alone, never of M or of a
    failed launch."""
    if (dtype == torch.bfloat16 and aligned and bk % 16 == 0
            and bn % _TC_BN == 0):
        return "tc"
    return "simt"


def bsr_tc_shape(nnb: int, bn: int, jmax: int, T: int, M: int) -> dict:
    """The BSR tensor-core instance's launch shape for a plan of ``nnb``
    column blocks of ``bn`` columns and join lists of ``jmax`` slots, at
    ``T`` timesteps and ``M`` spike rows.

    ``bn`` (a block's columns: 128 where the plan's ``bn`` is a multiple of
    128, else 64), ``mma`` (the instruction, m64nNk16 with N = that tile),
    ``splits`` (the cluster's ranks S, in ascending order) and
    ``slots_per_rank`` (rank s takes join slots [s * slots_per_rank, (s +
    1) * slots_per_rank) of every column block) depend on the plan alone,
    so every output element is summed in the same order for any M: S
    doubles while ``nnb * (bn / tile) * S`` launches fewer than 64 blocks
    and every rank keeps at least 4 of the ``jmax`` slots, up to 8.  The
    ranks' partial tiles meet through distributed shared memory, which
    costs prefill more than the MMAs of a few slots, while decode streams
    the payload faster over more blocks: this rule was the fastest of
    those timed on the card at both (PERF.md).

    Only the block's rows follow M (they decide work, not results):
    ``rows`` MMA rows (256, two consumer warpgroups of two m64 tiles, where
    M * T' > 64 and the 256-row grid fills a wave of the H100's 132 SMs;
    else 64, one warpgroup of one tile, two such blocks an SM) hold ``bm``
    = rows / T' spike rows, T' = T rounded up to a power of two, at least
    4; an m64 tile holds 64 / T' of them, so a 256-row block covers several
    act row tiles and reads each payload stage once for all of them."""
    tile = _TC_WIDE_BN if bn % _TC_WIDE_BN == 0 else _TC_BN
    n_cols = nnb * (bn // tile)
    splits = 1
    while (splits < _TC_MAX_SPLITS and n_cols * splits < _TC_MIN_BLOCKS
           and 2 * splits * _TC_MIN_SLOTS <= jmax):
        splits *= 2
    t_pad = max(4, 1 << (T - 1).bit_length())
    rows = 64
    if M * t_pad > 64 and -(-M // (256 // t_pad)) * n_cols * splits >= _TC_WAVE:
        rows = 256
    return {"bn": tile, "mma": f"m64n{tile}k16", "splits": splits,
            "slots_per_rank": -(-jmax // splits), "rows": rows,
            "bm": rows // t_pad}


def _bsr_work(a, payload, kidx, vidx, cnt, act, n_out, T, v_th=DEFAULT_VTH,
              tau=DEFAULT_TAU, *, bm, fuse_lif=True, tmap=None, instance=None,
              parent=None):
    kernel_work.check_values(a, "ftp_spmm_bsr")
    nbytes, ops = kernel_work.bsr_work(a, payload, kidx, vidx, cnt, act, n_out,
                                       T, bm=bm, fuse_lif=fuse_lif, tmap=tmap)
    name = "ftp_bsr" if tmap is None else "ftp_bsr_adaptive"
    return name, DTYPE_NAMES[payload.dtype], ops, nbytes


@counted_kernel(_bsr_work)
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
    tmap: torch.Tensor | None = None,
    instance: str | None = None,
    parent: tuple[int, int] | None = None,
):
    """Dual-sparse FTP spMspM over a load-time weight join plan.

    a:       (M, K) int32 packed spikes (bit t = timestep t).
    payload: (nnzb, bk, bn) bf16/f32 non-zero weight blocks.
    kidx, vidx: (nnb, jmax) int32 join lists; cnt: (nnb,) int32 live slots.
    act:     (ceil(M/bm), nkb) int32 spike block-activity map for row tile
             ``bm`` (>0 where the (bm, bk) spike block has a non-silent word).
    tmap:    optional (T,) int32 timestep-activity map: planes with
             ``tmap[t] == 0`` add nothing (kernel 4); the LIF still walks
             all T.  None walks every plane (kernel 3).

    instance: "tc" or "simt" overrides `bsr_instance`'s choice, to measure
             one instance against the other; an instance the payload does
             not fit raises.
    parent:  (nnb, jmax) of the whole plan when this plan is one of its
             column slabs (`join_plan.shard_plan`): the tc instance then
             launches with the whole plan's splits and slots per rank, so
             every element is summed in the order of the unsharded call.

    Returns (packed spikes (M, n_out) int32, final U (M, n_out) f32) when
    ``fuse_lif``, else ((T, M, n_out) f32 full sums, zeros (M, n_out))."""
    M, K, bk, bn, nnb = _check(a, payload, kidx, vidx, cnt, act, n_out, bm,
                               T, tmap)
    if a.device.type == "cpu":
        return ftp_spmm_bsr_plain(a, payload, kidx, vidx, cnt, act, n_out, T,
                                  v_th, tau, bm=bm, fuse_lif=fuse_lif,
                                  tmap=tmap)
    if a.device.type != "cuda":
        raise ValueError(f"no ftp_bsr kernel for device {a.device}")
    if bm not in (_SMALL_BM, _large_bm(T)):
        raise ValueError(f"the kernel's row tile at T={T} is {_SMALL_BM} or "
                         f"{_large_bm(T)}, got {bm}")
    aligned = payload.data_ptr() % 16 == 0
    route = bsr_instance(payload.dtype, bk, bn, aligned)
    if instance is None:
        instance = route
    elif instance == "tc" and route != "tc":
        raise ValueError(f"the tc instance takes a bf16 payload with a 16-byte "
                         f"aligned base, bk % 16 == 0 and bn % {_TC_BN} == 0, "
                         f"got {payload.dtype}, bk={bk}, bn={bn}")
    elif instance not in ("tc", "simt"):
        raise ValueError(f"no ftp_bsr instance {instance!r}")
    if instance == "simt" and (bn % _COLS or bk > _MAX_BK or not aligned):
        raise ValueError(
            f"the kernel needs bn % {_COLS} == 0, bk <= {_MAX_BK} and a "
            f"16-byte aligned payload (bk={bk}, bn={bn})"
        )
    if -(-M // bm) > _MAX_ROW_TILES:
        raise ValueError(f"M={M} needs more than {_MAX_ROW_TILES} row tiles")
    if fuse_lif:
        out = torch.empty((M, n_out), dtype=torch.int32, device=a.device)
    else:
        out = torch.empty((T, M, n_out), dtype=torch.float32, device=a.device)
    u = torch.empty((M, n_out), dtype=torch.float32, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    lib = _kernel_lib("ftp_bsr")
    tmap_ptr = None if tmap is None else tmap.data_ptr()
    jmax = kidx.shape[1]
    if parent is not None and (parent[1] < jmax or parent[0] < nnb):
        raise ValueError(f"a column slab ({nnb}, {jmax}) cannot be wider "
                         f"than its parent plan {tuple(parent)}")
    with _build.on_card(a.device):  # launch on the tensors' card
        if instance == "tc":
            p_nnb, p_jmax = (nnb, jmax) if parent is None else parent
            shape = bsr_tc_shape(p_nnb, bn, p_jmax, T, M)
            a_vec = a.data_ptr() % 16 == 0 and K % 4 == 0
            rc = lib.ftp_bsr_tc_launch(
                a.data_ptr(), M, K, int(a_vec), payload.data_ptr(),
                payload.shape[0], bk, bn, kidx.data_ptr(), vidx.data_ptr(),
                cnt.data_ptr(), nnb, jmax, act.data_ptr(), act.shape[1], bm,
                tmap_ptr, T, shape["rows"], shape["bn"], shape["splits"],
                shape["slots_per_rank"], n_out, float(v_th), float(tau),
                int(fuse_lif), out.data_ptr(), u.data_ptr(), stream)
        else:
            rc = lib.ftp_bsr_launch(
                a.data_ptr(), M, K, payload.data_ptr(),
                int(payload.dtype == torch.bfloat16), bk, bn,
                kidx.data_ptr(), vidx.data_ptr(), cnt.data_ptr(), nnb, jmax,
                act.data_ptr(), act.shape[1], tmap_ptr, bm // 4, n_out, T,
                float(v_th), float(tau), int(fuse_lif), out.data_ptr(),
                u.data_ptr(), stream)
    _raise_on(rc, "ftp_bsr")
    global LAUNCHES, ADAPTIVE_LAUNCHES, BSR_TC_LAUNCHES, BSR_SIMT_LAUNCHES
    if tmap is None:
        LAUNCHES += 1
    else:
        ADAPTIVE_LAUNCHES += 1
    if instance == "tc":
        BSR_TC_LAUNCHES += 1
    else:
        BSR_SIMT_LAUNCHES += 1
    return out, u


def ftp_spmm_bsr_plain(
    a, payload, kidx, vidx, cnt, act, n_out, T,
    v_th=DEFAULT_VTH, tau=DEFAULT_TAU, *, bm, fuse_lif=True, tmap=None,
):
    """Plain torch version of the kernel: unpack -> per-join-slot block
    products in f32, ascending slot, every column block at once -> LIF.
    Skips exactly what the kernel skips: dead join slots, spike blocks the
    activity map marks silent and, with ``tmap``, the gated planes."""
    M, K = a.shape
    _, bk, bn = payload.shape
    nnb, jmax = kidx.shape
    nkb = act.shape[1]
    planes = unpack_spikes(a, T, torch.float32)  # (T, M, K)
    if tmap is not None:
        planes = planes * (tmap > 0).to(torch.float32)[:, None, None]
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
