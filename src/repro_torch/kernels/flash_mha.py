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

Each kernel has two instances (`flash_instance`): ``tc`` on the tensor
cores for bf16 inputs at every dh (one warpgroup a tile up to dh 128, two
splitting the output columns at dh 192 and 256), ``simt`` (SIMT f32 FMA)
for f32 ones.  Each wrapper
launches its CUDA kernel for CUDA tensors and runs its plain version
(`ref.flash_mha_fwd_plain`, `ref.flash_mha_bwd_dq_plain`,
`ref.flash_mha_bwd_dkv_plain`) only for tensors on the CPU, at the true dh;
the reference's ``interpret`` switch is not ported.  There is no fallback:
a CUDA input a kernel does not take raises, and a `tc` build or launch that
fails raises.  The kernels are built for dh 32, 64, 128, 192 and 256
(`HEAD_DIMS`, both instances); any other dh up to 256 is
zero-padded on the last axis to the next of them (`template_dh`) and run
with the true ``dh ** -0.5`` scale, and the outputs are sliced back
(`at_template`; zero columns add exact +0 products).  dh > 256 raises: no
arch of the reference's zoo has it.  The padding is plain torch on the wrapper's path.  The
reference's block sizes ``bq``/``bk`` are validated as the reference does
(``bq = min(bq, S)``, ``S % bq == 0``, ``Skv % bk == 0``); the kernels tile by
64 rows whatever they are, and no output depends on them beyond rounding.
`launch_counts()` counts kernel launches (not plain-version calls), by
kernel and by instance, and the Function's backward passes that launched
the backward kernels.  Under an active op counter
(`repro_torch.roofline.op_stats`) each of `flash_mha_fwd`,
`flash_mha_bwd_dq` and `flash_mha_bwd_dkv` counts one call by its least
work (`roofline.kernel_work.flash_work`, from shapes alone) and none of the
aten ops inside it.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.roofline import kernel_work
from repro_torch.roofline.op_stats import counted_kernel

from . import _build
from .ref import (
    flash_mha_bwd_dkv_plain,
    flash_mha_bwd_dq_plain,
    flash_mha_fwd_plain,
)

DEFAULT_BQ = 256
DEFAULT_BK = 256
HEAD_DIMS = (32, 64, 128, 192, 256)  # the kernels' template instances
INSTANCES = ("tc", "simt")

KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")  # kernels 5, 6, 6
AUTOGRAD_BACKWARDS = 0  # kernel 7: backward passes that launched kernel 6
# launches by kernel and instance: {"flash_fwd_tc": n, ...}
INSTANCE_LAUNCHES = {f"{k}_{i}": 0 for k in KERNELS for i in INSTANCES}


def launch_counts() -> dict[str, int]:
    """Launches of kernels 5 (``flash_fwd``) and 6 (``flash_bwd_dq``,
    ``flash_bwd_dkv``), the Function's backward passes (``flash_mha``), and
    each kernel's launches by instance (``flash_fwd_tc``,
    ``flash_fwd_simt``, ...)."""
    totals = {k: sum(INSTANCE_LAUNCHES[f"{k}_{i}"] for i in INSTANCES)
              for k in KERNELS}
    return {**totals, "flash_mha": AUTOGRAD_BACKWARDS, **INSTANCE_LAUNCHES}


def reset_launch_counts() -> None:
    global AUTOGRAD_BACKWARDS
    AUTOGRAD_BACKWARDS = 0
    INSTANCE_LAUNCHES.update(dict.fromkeys(INSTANCE_LAUNCHES, 0))


def template_dh(dh: int) -> int:
    """The kernel template a head dim runs at: the least of `HEAD_DIMS`
    that is >= dh (16 -> 32, 48 -> 64, 80 / 96 / 112 -> 128, 160 -> 192,
    224 -> 256)."""
    if not 1 <= dh <= HEAD_DIMS[-1]:
        raise ValueError(f"the kernels take 1 <= dh <= {HEAD_DIMS[-1]}, got "
                         f"dh={dh} (larger head dims: see ROADMAP.md)")
    return next(t for t in HEAD_DIMS if t >= dh)


def flash_instance(dtype: torch.dtype, dh: int) -> str:
    """The kernels' instance for inputs of ``dtype`` and head dim ``dh``
    (1 to 256): ``tc`` (tensor cores) for bf16, ``simt`` for f32.  Nothing
    else decides it."""
    template_dh(dh)
    if dtype == torch.bfloat16:
        return "tc"
    if dtype == torch.float32:
        return "simt"
    raise ValueError(f"the kernels take bf16 or f32, got {dtype}")


def _pick(dtype, dh, instance):
    """The routed instance, or ``instance`` if it fits the dtype (SIMT
    takes bf16 too, `tc` only bf16)."""
    route = flash_instance(dtype, dh)
    if instance is None:
        return route
    if instance not in INSTANCES:
        raise ValueError(f"no flash instance {instance!r}")
    if instance == "tc" and route != "tc":
        raise ValueError(f"the tc instance does not take {dtype} at dh={dh}")
    return instance


def at_template(fn, *tensors, **kw):
    """``fn(*tensors, scale=dh ** -0.5, **kw)`` with every (BH, rows, dh)
    tensor zero-padded on its last axis to `template_dh` (lse and delta
    pass as they are), and each (·, ·, template) output sliced back to dh.
    The kernel path runs through this; so do the CPU tests, with the plain
    versions as ``fn``."""
    dh = tensors[0].shape[-1]
    to = template_dh(dh)

    def pad(t):
        return F.pad(t, (0, to - dh)) if t.ndim == 3 and to != dh else t

    out = fn(*map(pad, tensors), scale=float(dh ** -0.5), **kw)
    cut = lambda t: t[..., :dh].contiguous() if t.ndim == 3 and to != dh else t
    return tuple(map(cut, out)) if isinstance(out, tuple) else cut(out)


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel library (built at first use) with its C signatures set."""
    lib = _build.load("flash_mha")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # BH, S, Skv, dh, bf16, scale, causal, window, tc
    geom = [i, i, i, i, i, f, i, i, i]
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


def _check_kernel(q, k, v, *extra) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention kernel for device {q.device}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the kernels take bf16 or f32, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q, k, v must share one dtype")
    for t in (q, k, v, *extra):
        if not t.is_contiguous():
            raise ValueError("the kernels take contiguous tensors")


def _aligned(t):
    """``t``, or a copy of it if its base is not 16-byte aligned (the `tc`
    instance copies rows 16 bytes at a time)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _geometry(q, S, Skv, scale, causal, window, instance):
    BH, _, dh = q.shape
    return (BH, S, Skv, dh, int(q.dtype == torch.bfloat16), scale,
            int(bool(causal)), int(window), int(instance == "tc"))


def _count(name, instance):
    INSTANCE_LAUNCHES[f"{name}_{instance}"] += 1


def _fwd_launch(q, k, v, *, scale, causal, window, instance):
    """Kernel 5 at a template dh."""
    q, k, v = map(_aligned, (q, k, v))
    BH, S, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((BH, S), dtype=torch.float32, device=q.device)
    with _build.on_card(q.device):  # launch on the tensors' card
        rc = _lib().flash_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            *_geometry(q, S, k.shape[1], scale, causal, window, instance),
            o.data_ptr(), lse.data_ptr(),
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, f"flash_fwd ({instance})")
    _count("flash_fwd", instance)
    return o, lse


def _work(name):
    def work(q, k, v, *args, causal=True, window=0, **kwargs):
        nbytes, ops = kernel_work.flash_work(q, k.shape[1], causal, window)[name]
        return name, kernel_work.flash_dtype(q), ops, nbytes
    return work


@counted_kernel(_work("flash_fwd"))
def flash_mha_fwd(q, k, v, *, causal=True, window=0, bq=DEFAULT_BQ,
                  bk=DEFAULT_BK, instance=None):
    """q (BH, S, dh), k, v (BH, Skv, dh) -> (o (BH, S, dh) in q's dtype,
    lse (BH, S) f32) (kernel 5).  ``instance`` ("tc" or "simt") overrides
    `flash_instance`'s choice, to measure one instance against the other;
    an instance the dtype does not fit raises."""
    BH, S, Skv, dh = _check(q, k, v, bq, bk)
    if q.device.type == "cpu":
        if instance is not None:
            _pick(q.dtype, dh, instance)
        return flash_mha_fwd_plain(q, k, v, causal, window)
    _check_kernel(q, k, v)
    inst = _pick(q.dtype, dh, instance)
    return at_template(_fwd_launch, q, k, v, causal=causal, window=window,
                       instance=inst)


def _check_bwd(q, k, v, do, lse, delta, bq, bk, instance):
    """The backward's checks; returns the instance to launch (None on the
    CPU)."""
    BH, S, Skv, dh = _check(q, k, v, bq, bk, do, lse, delta)
    if do.shape != q.shape or lse.shape != (BH, S) or delta.shape != (BH, S):
        raise ValueError("do must be (BH, S, dh), lse and delta (BH, S)")
    if q.device.type == "cpu":
        if instance is not None:
            _pick(q.dtype, dh, instance)
        return None
    _check_kernel(q, k, v, do, lse, delta)
    if (do.dtype != q.dtype or lse.dtype != torch.float32
            or delta.dtype != torch.float32):
        raise ValueError("do must be in q's dtype, lse and delta f32")
    return _pick(q.dtype, dh, instance)


def _bwd_args(q, k, v, do, lse, delta, scale, causal, window, instance):
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(),
            *_geometry(q, q.shape[1], k.shape[1], scale, causal, window,
                       instance))


def _dq_launch(q, k, v, do, lse, delta, *, scale, causal, window, instance):
    """Kernel 6's dq kernel at a template dh."""
    q, k, v, do = map(_aligned, (q, k, v, do))  # alive through the launch
    dq = torch.empty_like(q)
    with _build.on_card(q.device):
        rc = _lib().flash_bwd_dq_launch(
            *_bwd_args(q, k, v, do, lse, delta, scale, causal, window,
                       instance),
            dq.data_ptr(), torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, f"flash_bwd_dq ({instance})")
    _count("flash_bwd_dq", instance)
    return dq


def _dkv_launch(q, k, v, do, lse, delta, *, scale, causal, window, instance):
    """Kernel 6's dk/dv kernel at a template dh."""
    q, k, v, do = map(_aligned, (q, k, v, do))  # alive through the launch
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with _build.on_card(q.device):
        rc = _lib().flash_bwd_dkv_launch(
            *_bwd_args(q, k, v, do, lse, delta, scale, causal, window,
                       instance),
            dk.data_ptr(), dv.data_ptr(),
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, f"flash_bwd_dkv ({instance})")
    _count("flash_bwd_dkv", instance)
    return dk, dv


@counted_kernel(_work("flash_bwd_dq"))
def flash_mha_bwd_dq(q, k, v, do, lse, delta, *, causal=True, window=0,
                     bq=DEFAULT_BQ, bk=DEFAULT_BK, instance=None):
    """dq (BH, S, dh) in q's dtype from the forward's lse and delta =
    rowsum(o * do) (kernel 6, the dq kernel); ``instance`` as for
    `flash_mha_fwd`."""
    inst = _check_bwd(q, k, v, do, lse, delta, bq, bk, instance)
    if inst is None:
        return flash_mha_bwd_dq_plain(q, k, v, do, lse, delta, causal, window)
    return at_template(_dq_launch, q, k, v, do, lse, delta, causal=causal,
                       window=window, instance=inst)


@counted_kernel(_work("flash_bwd_dkv"))
def flash_mha_bwd_dkv(q, k, v, do, lse, delta, *, causal=True, window=0,
                      bq=DEFAULT_BQ, bk=DEFAULT_BK, instance=None):
    """(dk, dv) (BH, Skv, dh) in k's and v's dtypes (kernel 6, the dk/dv
    kernel); ``instance`` as for `flash_mha_fwd`."""
    inst = _check_bwd(q, k, v, do, lse, delta, bq, bk, instance)
    if inst is None:
        return flash_mha_bwd_dkv_plain(q, k, v, do, lse, delta, causal, window)
    return at_template(_dkv_launch, q, k, v, do, lse, delta, causal=causal,
                       window=window, instance=inst)


def flash_mha_bwd(q, k, v, o, lse, do, *, causal=True, window=0,
                  bq=DEFAULT_BQ, bk=DEFAULT_BK, instance=None):
    """Gradients of ``sum(o * do)`` from the forward's o and lse -> (dq, dk,
    dv) in the inputs' dtypes (kernel 6: delta in plain torch, then the dq
    kernel and the dk/dv kernel); ``instance`` as for `flash_mha_fwd`."""
    if o.shape != q.shape or o.device != q.device:
        raise ValueError("o must be (BH, S, dh) beside q")
    delta = (o.float() * do.float()).sum(-1)
    kw = dict(causal=causal, window=window, bq=bq, bk=bk, instance=instance)
    dq = flash_mha_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = flash_mha_bwd_dkv(q, k, v, do, lse, delta, **kw)
    return dq, dk, dv


class FlashMHA(torch.autograd.Function):
    """Attention whose backward is kernel 6 (the reference's custom_vjp):
    saves q, k, v, o, lse; the non-tensor arguments get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, bq, bk, instance):
        ctx.opts = dict(causal=causal, window=window, bq=bq, bk=bk,
                        instance=instance)
        o, lse = flash_mha_fwd(q, k, v, **ctx.opts)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_mha_bwd(q, k, v, o, lse, do.contiguous(), **ctx.opts)
        if do.is_cuda:
            global AUTOGRAD_BACKWARDS
            AUTOGRAD_BACKWARDS += 1
        return dq, dk, dv, None, None, None, None, None


def flash_mha(q, k, v, causal=True, window=0, bq=DEFAULT_BQ, bk=DEFAULT_BK,
              *, instance=None):
    """Differentiable flash attention: (BH, S, dh) q and (BH, Skv, dh) k, v
    -> o (BH, S, dh) (kernel 7 over kernels 5 and 6); ``instance`` as for
    `flash_mha_fwd`, for both passes."""
    return FlashMHA.apply(q, k, v, causal, window, bq, bk, instance)
