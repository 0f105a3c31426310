"""Work counts of a torch program: the port's counterpart of
`repro.roofline.hlo_stats`, which reads the same numbers off compiled XLA
HLO.  Here there is no compiled module to read, so the program is run under
a `TorchDispatchMode` that sees every aten op it dispatches, on real CUDA
tensors, real CPU tensors or meta / fake ones alike (the last give the
shapes without doing the work: the dry run's way in).

* flops: each op with a formula in `torch.utils.flop_counter`'s registry
  (mm, bmm, addmm, convolution, attention, ...), as the reference counts
  dot and convolution only; ``flops_by_dtype`` splits them by the dtype of
  the op's first tensor operand (on an H100 an f32 product without TF32
  runs off the tensor cores: 67 against 989 TFLOP/s on the data sheet);
* bytes: each op's tensor operands plus its outputs, an HBM-traffic proxy
  in the spirit of the reference's per-kernel operand + output bytes; view
  and metadata ops (`_SKIP_BYTES_OPS` and every op whose output aliases
  its input) move nothing and are skipped;
* collectives: c10d ops, their operand bytes in ``collective_bytes`` (0 on
  one device; the slot is for the multi-device slice);
* the hand-written kernels: the FTP and flash wrappers are ctypes calls no
  dispatch mode sees, so each such function counts itself once at its entry
  (`counted_kernel`), by the least work of its call (`kernel_work`), and
  the aten ops inside it (the plain version on the CPU, the output
  allocations on the card) are not counted: a counted run gives the same
  stats on either device.

The reference corrects a ``while`` loop by its trip count.  The port's
loops are Python loops that run every iteration; `launch.dryrun` corrects
them from outside, by counting at a few depths, batches and sequence
lengths and extrapolating, and records the axes it extrapolated along in
``repeats``.
"""
from __future__ import annotations

import functools
import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import (
    TorchDispatchMode,
    _get_current_dispatch_mode_stack,
)

DTYPE_NAMES = {
    getattr(torch, name): short for name, short in (
        ("bool", "pred"), ("uint8", "u8"), ("int8", "s8"), ("int16", "s16"),
        ("int32", "s32"), ("int64", "s64"), ("uint16", "u16"),
        ("uint32", "u32"), ("uint64", "u64"), ("float16", "f16"),
        ("bfloat16", "bf16"), ("float32", "f32"), ("float64", "f64"),
        ("complex64", "c64"), ("complex128", "c128"))
    if hasattr(torch, name)
}

# ops that allocate without moving bytes (the reference's parameter /
# constant), besides the views and the ops that return no tensor
_SKIP_BYTES_OPS = {
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional", "c10d")
_COLLECTIVE_NOOPS = {"wait_tensor", "_wrap_tensor_autograd"}  # move nothing


def shape_key(t: torch.Tensor) -> str:
    """The reference's shape key, e.g. ``bf16[4,128,2048]``."""
    return f"{DTYPE_NAMES.get(t.dtype, str(t.dtype))}[{','.join(map(str, t.shape))}]"


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


_VIEW_LIKE = {"_unsafe_view", "lift_fresh", "detach"}


@functools.cache
def _op_info(func) -> tuple[str, str, bool, object]:
    """(name, kind, in place, flop formula) of an aten op.  kind: "view"
    (returns an alias of an input; so do `_VIEW_LIKE`), "collective",
    "noop" (a collective's bookkeeping), "alloc" (`_SKIP_BYTES_OPS`) or
    "op"."""
    from torch.utils.flop_counter import flop_registry

    name = func.overloadpacket.__name__
    aliases = [r.alias_info for r in func._schema.returns if r.alias_info]
    if name in _VIEW_LIKE or any(not a.is_write for a in aliases):
        kind = "view"
    elif func.namespace in _COLLECTIVE_NAMESPACES:
        kind = "noop" if name in _COLLECTIVE_NOOPS else "collective"
    else:
        kind = "alloc" if name in _SKIP_BYTES_OPS else "op"
    inplace = any(a.is_write for a in aliases)
    return name, kind, inplace, flop_registry.get(func.overloadpacket)


def _tensors(args, kwargs=None) -> list:
    """The tensors among an op's arguments or results (a tensor, or a list
    of them, at most one level deep)."""
    if isinstance(args, torch.Tensor):
        return [args]
    out = []
    for seq in (args, kwargs.values() if kwargs else ()):
        if not isinstance(seq, (tuple, list, type({}.values()))):
            continue
        for x in seq:
            if isinstance(x, torch.Tensor):
                out.append(x)
            elif isinstance(x, (tuple, list)):
                out += [y for y in x if isinstance(y, torch.Tensor)]
    return out


def _meta_key(x):
    """A hashable key of an op argument for the meta-output cache: a tensor
    by its shape, strides and dtype, sequences element-wise, anything else
    as it is."""
    if isinstance(x, torch.Tensor):
        return (x.shape, x.stride(), x.dtype)
    if isinstance(x, (tuple, list)):
        return tuple(map(_meta_key, x))
    if isinstance(x, dict):
        return tuple((k, _meta_key(v)) for k, v in x.items())
    return x


def _meta_spec(out):
    if isinstance(out, torch.Tensor):
        return ("t", tuple(out.shape), out.stride(), out.dtype)
    if isinstance(out, (tuple, list)):
        return (type(out), tuple(map(_meta_spec, out)))
    return ("v", out)


def _from_spec(spec):
    if spec[0] == "t":
        return torch.empty_strided(spec[1], spec[2], dtype=spec[3], device="meta")
    if spec[0] == "v":
        return spec[1]
    return spec[0](map(_from_spec, spec[1]))


def _add(d: dict, key, value) -> None:
    d[key] = d.get(key, 0) + value


@dataclass
class OpStats:
    flops: int = 0              # Python ints: exact at any size
    bytes_accessed: int = 0
    collective_bytes: int = 0
    collectives: dict = field(default_factory=dict)      # op name -> bytes
    n_collective_ops: int = 0
    repeats: list = field(default_factory=list)          # trip counts applied
    bytes_by_shape: dict = field(default_factory=dict)   # out shape -> bytes
    flops_by_dtype: dict = field(default_factory=dict)   # "bf16" -> flops
    # hand-written kernel functions counted at their entry:
    # name -> {"calls", "flops", "bytes"}
    kernels: dict = field(default_factory=dict)
    n_ops: int = 0                                       # aten ops counted

    def asdict(self) -> dict:
        top = dict(sorted(self.bytes_by_shape.items(),
                          key=lambda kv: -kv[1])[:40])
        return {
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "collective_bytes": self.collective_bytes,
            "collectives": dict(self.collectives),
            "n_collective_ops": self.n_collective_ops,
            "repeats": list(self.repeats),
            "bytes_by_shape": top,
            "flops_by_dtype": dict(self.flops_by_dtype),
            "kernels": {k: dict(v) for k, v in self.kernels.items()},
            "n_ops": self.n_ops,
        }

    @classmethod
    def combine(cls, terms) -> "OpStats":
        """sum_i c_i * stats_i over ``terms`` [(c_i, stats_i)], field by
        field: the extrapolation of counts taken at a few depths and
        batches.  A shape of ``bytes_by_shape`` or a kernel that some term
        lacks (a shape that moves with the depth or the batch) is left out,
        so those dicts may sum to less than the totals."""
        terms = list(terms)
        out = cls()
        for c, s in terms:
            out.flops += c * s.flops
            out.bytes_accessed += c * s.bytes_accessed
            out.collective_bytes += c * s.collective_bytes
            out.n_collective_ops += c * s.n_collective_ops
            out.n_ops += c * s.n_ops
            for k, v in s.flops_by_dtype.items():
                _add(out.flops_by_dtype, k, c * v)
            for k, v in s.collectives.items():
                _add(out.collectives, k, c * v)
        for name in ("bytes_by_shape", "kernels"):
            shared = set.intersection(*(set(getattr(s, name)) for _, s in terms))
            for key in shared:
                if name == "bytes_by_shape":
                    out.bytes_by_shape[key] = sum(
                        c * s.bytes_by_shape[key] for c, s in terms)
                else:
                    out.kernels[key] = {
                        f: sum(c * s.kernels[key][f] for c, s in terms)
                        for f in ("calls", "flops", "bytes")}
        out.flops_by_dtype = {k: v for k, v in out.flops_by_dtype.items() if v}
        return out


class OpCounter(TorchDispatchMode):
    """Count the aten ops dispatched inside ``with OpCounter() as c:`` into
    ``c.stats``.  With ``track_memory``, also the peak of the bytes held by
    the tensors the ops created (``c.peak_bytes``; a storage counts from
    the op that created it until it dies), that peak within each phase of
    a step (``c.peak_by_phase``: "forward" with autograd recording,
    "backward" inside autograd's engine, "no_grad" else, e.g. an optimizer
    update) and what is still held at the end (``c.live_bytes``)."""

    def __init__(self, *, track_memory: bool = False):
        super().__init__()
        self.stats = OpStats()
        self.track_memory = track_memory
        self.live_bytes = 0
        self.peak_bytes = 0
        self.peak_by_phase: dict[str, int] = {}
        self._live: dict[int, int] = {}
        self._meta_cache: dict = {}
        self._paused = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name, kind, inplace, formula = _op_info(func)
        if kind == "view":
            return func(*args, **kwargs)
        ins = _tensors(args, kwargs)
        out = self._run(func, inplace, args, kwargs, ins)
        outs = _tensors(out)
        if self.track_memory and not inplace:  # in place: an existing tensor
            for t in outs:
                self._hold(t)
            phase = ("backward" if torch._C._current_autograd_node() is not None
                     else "forward" if torch.is_grad_enabled() else "no_grad")
            self.peak_by_phase[phase] = max(self.peak_by_phase.get(phase, 0),
                                            self.live_bytes)
        if not self._paused:
            self._record(name, kind, formula, args, kwargs, ins, out, outs)
        return out

    def _run(self, func, inplace, args, kwargs, ins):
        """``func(*args, **kwargs)``; on meta inputs a functional op's
        outputs come from a cache keyed by the inputs' metadata (most meta
        kernels are Python references that cost ~0.2 ms an op, an empty
        tensor of the cached layout ~5 us)."""
        meta = (all(t.is_meta for t in ins) if ins
                else str(kwargs.get("device")) == "meta")
        if not meta or inplace:
            return func(*args, **kwargs)
        try:
            key = (func, _meta_key(args), _meta_key(kwargs))
            spec = self._meta_cache.get(key)
        except TypeError:  # an unhashable argument: no cache
            return func(*args, **kwargs)
        if spec is None:
            out = func(*args, **kwargs)
            self._meta_cache[key] = _meta_spec(out)
            return out
        return _from_spec(spec)

    def _hold(self, t: torch.Tensor) -> None:
        storage = t.untyped_storage()
        key = id(storage)
        if key in self._live:
            return
        n = storage.nbytes()
        self._live[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(storage, self._release, key)

    def _release(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def _record(self, name, kind, formula, args, kwargs, ins, out, outs) -> None:
        st = self.stats
        if kind == "collective":
            nb = sum(map(_nbytes, ins))
            st.collective_bytes += nb
            _add(st.collectives, name, nb)
            st.n_collective_ops += 1
            return
        if kind != "op" or not outs:
            return  # bookkeeping, an allocation, or metadata (a device, a scalar)
        st.n_ops += 1
        if formula is not None and ins:
            f = formula(*args, **kwargs, out_val=out)
            st.flops += f
            _add(st.flops_by_dtype, DTYPE_NAMES[ins[0].dtype], f)
        nb = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        st.bytes_accessed += nb
        _add(st.bytes_by_shape, shape_key(outs[0]), nb)

    def add_kernel(self, name: str, dtype: str, flops: int, nbytes: int) -> None:
        """One call of a hand-written kernel function, by its work; ``dtype``
        names the peak its operations run at ("bf16", "f32")."""
        st = self.stats
        st.flops += flops
        st.bytes_accessed += nbytes
        if flops:
            _add(st.flops_by_dtype, dtype, flops)
        k = st.kernels.setdefault(name, {"calls": 0, "flops": 0, "bytes": 0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes


def active_counter() -> OpCounter | None:
    """The innermost `OpCounter` on this thread's dispatch-mode stack (the
    stack reaches autograd's backward threads too), or None."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, OpCounter):
            return mode
    return None


def counted_kernel(work):
    """Decorator of a hand-written kernel's function: under an active
    counter, ``work(*args, **kwargs) -> (name, dtype name, flops, bytes)`` is
    added once and the function's own aten ops are not counted.  With no
    counter the function runs as it is."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            counter = active_counter()
            if counter is None or counter._paused:
                return fn(*args, **kwargs)
            counter._paused += 1
            try:
                counter.add_kernel(*work(*args, **kwargs))
                return fn(*args, **kwargs)
            finally:
                counter._paused -= 1
        return inner
    return wrap


def count(fn, *args, **kwargs) -> OpStats:
    """The `OpStats` of ``fn(*args, **kwargs)``."""
    with OpCounter() as c:
        fn(*args, **kwargs)
    return c.stats


# The summary keys of one dispatch's attribution, as the reference's.
ATTRIBUTION_KEYS = (
    "flops", "bytes_accessed", "collective_bytes", "n_collective_ops",
    "collectives",
)


def attribution_summary(fn, *args, **kwargs) -> dict:
    """`count` trimmed to `ATTRIBUTION_KEYS`, plus the arithmetic intensity
    (flops per byte), the flops by dtype and the kernels counted at their
    entry: what one dispatch does, read from its work rather than from a
    clock."""
    st = count(fn, *args, **kwargs).asdict()
    out = {k: st[k] for k in ATTRIBUTION_KEYS}
    ba = out["bytes_accessed"]
    out["arithmetic_intensity"] = out["flops"] / ba if ba else 0.0
    out["flops_by_dtype"] = st["flops_by_dtype"]
    out["kernels"] = st["kernels"]
    return out
