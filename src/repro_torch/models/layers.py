"""Primitive layers of the transformer (port of `repro.models.layers`: GQA
attention, causal, sliding-window or bidirectional, with and without a KV
cache (a ring of ``window`` slots for sliding-window attention), the
spiking FFN, the dense MLPs and the top-k capacity-routed MoE).

Params are plain dicts of tensors.  Compute runs in ``cfg.compute_dtype``
(bf16) with reductions and softmax in f32, in the reference's op order.
The reference switches the spiking FFN between its float training path and
the packed inference path with a module-level mode; here the mode is an
explicit ``spiking_mode`` argument ("train" | "infer") threaded from the
model entry points, so two callers in one process never see each other's
setting.
"""
from __future__ import annotations

import contextlib
import math

import torch

from repro_torch.configs.base import ArchConfig

SPIKING_MODES = ("train", "infer")
# Rows per call of the serving forward's row-blocked ops (`row_blocks`): a
# decode step (B rows), a speculative verify window (B (k + 1) rows) and a
# stream's frame all fit one block.
ROW_BLOCK = 64
# Query positions per attention call of the serving forward
# (`multihead_attention(q_block=...)`): a decode step and a verify window
# fit one block, a prefill takes several.
Q_BLOCK = 32
# Batch rows per attention call of the serving forward, so that the
# einsums' batch count (B x KV) has one value too: on the card an MQA row
# alone (B x KV = 1) took another algorithm than a batch of 4 did, and its
# logits moved in their last bits (PERF.md has the measurement).
B_BLOCK = 4
# Column blocks of the serving unembedding (`vocab_blocks`; fewer when the
# vocab does not divide): one device and every serve mesh make the same
# (ROW_BLOCK, D) x (D, V / VOCAB_BLOCKS) library products, so a model axis
# that divides the count shards the vocab without changing a bit.  On the
# card a product over a column slab sums in another order than the whole
# product at some widths (chip_smoke phase 17e measures it).
VOCAB_BLOCKS = 8


# Constraint hook for (B, S, H, dh) attention tensors, installed by the
# train mesh (`sharding.make_qkv_hook`); the identity off a mesh.
_qkv_hook = lambda t: t


def set_qkv_hook(fn) -> None:
    """Install ``fn`` (a tensor -> the tensor) as the attention-tensor hook;
    `reset_qkv_hook` puts the identity back."""
    global _qkv_hook
    _qkv_hook = fn


def reset_qkv_hook() -> None:
    set_qkv_hook(lambda t: t)


def _dt(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def _ct(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def dense_init(gen: torch.Generator, shape, dtype, fan_in=None) -> torch.Tensor:
    fan_in = fan_in if fan_in is not None else shape[0]
    w = torch.randn(shape, generator=gen, device=gen.device)
    return (w / math.sqrt(fan_in)).to(dtype)


# ---------------------------------------------------------------------------
# norms and RoPE
# ---------------------------------------------------------------------------

def row_blocks(fn, x: torch.Tensor, *args) -> torch.Tensor:
    """``fn(rows, *args)`` over blocks of ``ROW_BLOCK`` rows of the 2-D
    ``x`` (the last block zero-padded), as one result for x's rows.  Every
    call of ``fn`` sees one shape, so the library runs one algorithm and a
    row's values do not depend on how many rows share the dispatch (a
    decode step, a speculative verify window, a prefill): the property
    speculation and stream ingestion rest on.  On the card the rmsnorm's
    row mean, the f32 unembed and the projections go through it (PERF.md
    has the measurement)."""
    n = x.shape[0]
    pad = (-n) % ROW_BLOCK
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    out = [fn(x[i:i + ROW_BLOCK], *args) for i in range(0, n + pad, ROW_BLOCK)]
    return (out[0] if len(out) == 1 else torch.cat(out))[:n]


def batch_blocks(fn, args, fills) -> tuple:
    """``fn(*block)`` over blocks of `B_BLOCK` rows (dim 0) of the tensors
    ``args``, the last block padded with rows of ``fills`` (one value per
    argument), as the results' rows for the args' rows: ``fn`` returns a
    tuple of tensors whose dim 0 is the block's rows.  Every call sees one
    batch count, so a row's values do not depend on how many rows share the
    dispatch (the serving attention's einsums, the recurrent cores'
    einsums and cumsum)."""
    n = args[0].shape[0]
    nb = -(-n // B_BLOCK) * B_BLOCK
    if nb != n:
        args = [torch.cat([a, a.new_full((nb - n,) + tuple(a.shape[1:]), f)])
                for a, f in zip(args, fills)]
    outs = [fn(*(a[i:i + B_BLOCK] for a in args)) for i in range(0, nb, B_BLOCK)]
    return tuple((o[0] if len(o) == 1 else torch.cat(o))[:n] for o in zip(*outs))


def vocab_blocks(w: torch.Tensor) -> torch.Tensor:
    """A (D, V) unembedding as its (n, D, V / n) contiguous column blocks,
    n the largest halving of `VOCAB_BLOCKS` that divides V."""
    D, V = w.shape
    n = VOCAB_BLOCKS
    while V % n:
        n //= 2
    return w.reshape(D, n, V // n).permute(1, 0, 2).contiguous()


def _vocab_mm(x: torch.Tensor, blocks: torch.Tensor) -> torch.Tensor:
    """(R, D) rows x (n, D, Vb) column blocks -> (R, n * Vb), one library
    product per block."""
    return torch.cat([x @ w for w in blocks], dim=-1)


class VocabSlabs:
    """An unembedding's column blocks dealt over a serve mesh's model axis
    (`serve.sharding.shard_vocab`): slab j, blocks [j n / shards, (j + 1) n
    / shards), runs on logical device (i, j) for data group i.  On the
    blocks' own device a slab is a view; on another, a copy made once."""

    def __init__(self, blocks: torch.Tensor, shards: int):
        if blocks.shape[0] % shards:
            raise ValueError(f"{blocks.shape[0]} vocab blocks do not divide "
                             f"into {shards} slabs")
        self.blocks, self.shards = blocks, shards
        self._placed: dict = {}

    def slab(self, j: int, device=None) -> torch.Tensor:
        per = self.blocks.shape[0] // self.shards
        home = self.blocks[j * per:(j + 1) * per]
        if device is None or torch.device(device) == self.blocks.device:
            return home
        key = (j, str(torch.device(device)))
        if key not in self._placed:
            self._placed[key] = home.to(device)
        return self._placed[key]


class TPSlabs:
    """A weight dealt over a serve mesh's model axis for psum tensor
    parallelism (`serve.sharding.shard_params`).  ``kind`` "col" cuts the
    last dim (a column-parallel projection: whole heads, whole ``d_ff`` or
    ``d_inner`` blocks), "row" the second last (a row-parallel one: its
    contraction, whose shard products are partials of one sum).  Slab j is
    placed on each torch device of ``devices[j]`` (default: the weight's
    own) when the slabs are dealt, and `slab` only looks it up.  When every
    slab stays on the weight's own device (one card, or the CPU) each is a
    view of the weight: no copy.  When they spread over several devices,
    each device gets a contiguous copy of its own slabs alone and no
    reference to the whole is kept, so a load-time cast of the weight is
    freed once the slabs are made."""

    def __init__(self, w: torch.Tensor, shards: int, kind: str, devices=None):
        dim = {"col": w.ndim - 1, "row": w.ndim - 2}[kind]
        n = w.shape[dim]
        if n % shards:
            raise ValueError(f"dim {dim} of {tuple(w.shape)} does not divide "
                             f"into {shards} slabs")
        width = n // shards
        devices = [[torch.device(d) for d in ds]
                   for ds in (devices or [[w.device]] * shards)]
        spread = any(d != w.device for ds in devices for d in ds)
        self.shards, self.kind, self.device = shards, kind, w.device
        self._slabs: dict = {}
        for j, ds in enumerate(devices):
            view = w.narrow(dim, j * width, width)
            for d in ds:
                if (j, d) not in self._slabs:
                    self._slabs[(j, d)] = (
                        torch.empty(view.shape, dtype=w.dtype, device=d
                                    ).copy_(view) if spread else view)

    def slab(self, j: int, device=None) -> torch.Tensor:
        key = (j, self.device if device is None else torch.device(device))
        if key not in self._slabs:
            raise ValueError(f"TP slab {j} was not dealt to {key[1]}")
        return self._slabs[key]


def tp_devices(shards: int) -> list:
    """Shard j's torch device, for each j, from the installed mesh
    (`kernels.ops.serve_mesh_scope`: the serve engine's, or the train
    step's), whose row 0 holds the calling data group's devices."""
    from repro_torch.kernels.ops import get_serve_mesh

    mesh = get_serve_mesh()
    if mesh is None or mesh.shape["model"] != shards:
        raise ValueError(
            f"TP slabs over {shards} model shards need a serve mesh with that "
            f"model axis (ops.serve_mesh_scope); got {mesh}")
    return [mesh.physical(0, j) for j in range(shards)]


def tp_sum(p: dict, names, body, *, ct, lead, down, partial=None,
           dtype=None) -> torch.Tensor:
    """One block body over the serve mesh's model shards.  ``body(ws, j, m,
    dev, down)`` computes shard j of m on torch device ``dev`` from its
    weights ``ws`` (``p[n]`` for each of ``names``, None where ``p`` has no
    ``n``), its row-parallel product by ``down``.  With ``p[names[0]]`` a
    tensor (the unsharded block) it runs once, on the whole weights in
    ``ct`` on ``lead`` with ``down``.  Dealt as `TPSlabs`, it runs once per
    shard on that shard's slabs and device with ``partial`` (default
    `partial_matmul`), and the f32 partials add in `psum`, rounded once to
    ``dtype`` (default ``ct``)."""
    if not isinstance(p[names[0]], TPSlabs):
        ws = tuple(p[n].to(ct) if n in p else None for n in names)
        return body(ws, 0, 1, lead, down)
    m = p[names[0]].shards
    parts = [body(tuple(p[n].slab(j, dev) if n in p else None for n in names),
                  j, m, dev, partial or partial_matmul)
             for j, dev in enumerate(tp_devices(m))]
    return psum(parts, lead, ct if dtype is None else dtype)


def psum(parts, device, dtype) -> torch.Tensor:
    """The model shards' f32 partial products of one row-parallel
    contraction (`partial_matmul`), moved to ``device`` (the mesh row's
    lead) and added there in f32 in shard order 0 .. m-1, rounded once to
    ``dtype``: a fixed order, so the result repeats bit for bit from run to
    run."""
    acc = parts[0].to(device, torch.float32)
    for part in parts[1:]:
        acc = acc + part.to(device, torch.float32)
    return acc.to(dtype)


def _mm_f32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` (2-D, or batched 3-D) with an f32 result: the library's
    f32 accumulation, not rounded to the inputs' dtype (on the card
    cuBLAS's ``out_dtype``; elsewhere, and where autograd records (a train
    mesh's TP: the ``out_dtype`` product has no derivative), the same exact
    products of the values upcast)."""
    if a.dtype == w.dtype == torch.float32:
        return a @ w
    grad = torch.is_grad_enabled() and (a.requires_grad or w.requires_grad)
    if a.is_cuda and not grad:
        fn = torch.bmm if a.ndim == 3 else torch.mm
        return fn(a, w, out_dtype=torch.float32)
    return a.float() @ w.float()


# whether TP shard products run over fixed row blocks (a serve's, for row
# invariance) or as one library call each (`plain_tp_products`)
_TP_ROW_BLOCKS = True


@contextlib.contextmanager
def plain_tp_products():
    """Within: the TP shard products (`partial_matmul`, the column-parallel
    projections of attention and the dense MLPs) run as one library call
    each instead of over fixed row blocks.  A train step's data group uses
    it: training needs no row invariance (a serve does), and the blocks
    would cost its forward and backward a launch per 64 rows."""
    global _TP_ROW_BLOCKS
    prev, _TP_ROW_BLOCKS = _TP_ROW_BLOCKS, False
    try:
        yield
    finally:
        _TP_ROW_BLOCKS = prev


def partial_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One model shard's partial of a row-parallel product, ``x (..., K/m)
    @ w (K/m, N)`` in f32 over fixed row blocks (`row_blocks`; one call
    under `plain_tp_products`), for `psum`."""
    x2 = x.reshape(-1, x.shape[-1])
    out = row_blocks(_mm_f32, x2, w) if _TP_ROW_BLOCKS else _mm_f32(x2, w)
    return out.reshape(tuple(x.shape[:-1]) + (-1,))


def vocab_logits(x: torch.Tensor, w) -> torch.Tensor:
    """(R, D) f32 rows x the unembedding's column blocks -> (R, V) f32
    logits, over fixed blocks of rows and of columns.  ``w`` is the (n, D,
    Vb) blocks, or `VocabSlabs` under the serve mesh: the rows split into
    its data groups and slab j of group i runs on device (i, j), with the
    products of the unsharded call, concatenated in order."""
    if not isinstance(w, VocabSlabs):
        return row_blocks(_vocab_mm, x, w)
    from repro_torch.kernels.ops import get_serve_mesh
    from repro_torch.launch.mesh import data_groups

    mesh = get_serve_mesh()
    if mesh is None or mesh.shape["model"] != w.shards:
        raise ValueError(
            f"vocab slabs over {w.shards} model shards need a serve mesh with "
            f"that model axis (ops.serve_mesh_scope); got {mesh}")
    out = []
    for i, rows in data_groups(mesh, x.shape[0]):
        parts = []
        for j in range(w.shards):
            dev = mesh.physical(i, j)
            parts.append(row_blocks(_vocab_mm, x[rows].to(dev),
                                    w.slab(j, dev)).to(x.device))
        out.append(torch.cat(parts, dim=-1))
    return torch.cat(out)


def _mean_square(x: torch.Tensor) -> torch.Tensor:
    return (x * x).mean(-1, keepdim=True)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5, *,
            row_invariant: bool = False) -> torch.Tensor:
    """RMS norm scaled by ``1 + scale`` (scales are zero-initialised).
    ``row_invariant`` (the serving forward) takes the row mean in
    `row_blocks`; the values are the same function of each row."""
    x32 = x.float()
    if row_invariant:
        D = x.shape[-1]
        var = row_blocks(_mean_square, x32.reshape(-1, D)).reshape(
            tuple(x.shape[:-1]) + (1,))
    else:
        var = _mean_square(x32)
    return (x32 * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(x.dtype)


def rope_apply(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, dh); positions: (B, S) int."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = positions.float()[..., None] * freqs  # (B, S, half)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA; causal, sliding-window or bidirectional; exact softmax
# chunked over queries)
# ---------------------------------------------------------------------------

def attn_init(gen: torch.Generator, cfg: ArchConfig) -> dict:
    D, H, KV, dh = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    p = {
        "wq": dense_init(gen, (D, H * dh), _dt(cfg)),
        "wk": dense_init(gen, (D, KV * dh), _dt(cfg)),
        "wv": dense_init(gen, (D, KV * dh), _dt(cfg)),
        "wo": dense_init(gen, (H * dh, D), _dt(cfg)),
    }
    if cfg.qk_norm:  # per-head rmsnorm scales of q and k (zero-initialised)
        p["q_norm"] = torch.zeros((dh,), dtype=_dt(cfg), device=gen.device)
        p["k_norm"] = torch.zeros((dh,), dtype=_dt(cfg), device=gen.device)
    return p


def attn_axes(cfg: ArchConfig) -> dict:
    """Logical axes of `attn_init`'s leaves (`repro_torch.sharding`)."""
    ax = {
        "wq": ("d_model", "heads_flat"),
        "wk": ("d_model", "kv_flat"),
        "wv": ("d_model", "kv_flat"),
        "wo": ("heads_flat", "d_model"),
    }
    if cfg.qk_norm:
        ax["q_norm"] = (None,)
        ax["k_norm"] = (None,)
    return ax


ATTN_MODES = ("causal", "swa", "bidir")


def _attn_mask(iq, jk, mode: str = "causal", window: int = 0) -> torch.Tensor:
    """iq: (cq,) absolute query positions; jk: (Skv,) absolute kv positions
    of the cache slots (a ring's stored positions; -1 = empty slot).
    ``causal``: jk <= iq; ``swa`` also jk > iq - window; ``bidir``: every
    filled slot."""
    if mode == "bidir":
        m = torch.ones((iq.shape[0], jk.shape[0]), dtype=torch.bool,
                       device=jk.device)
    elif mode in ("causal", "swa"):
        m = jk[None, :] <= iq[:, None]
        if mode == "swa":
            m = m & (jk[None, :] > (iq[:, None] - window))
    else:
        raise ValueError(f"unknown attention mode {mode!r} ({ATTN_MODES})")
    return m & (jk[None, :] >= 0)


def multihead_attention(q, k, v, cfg: ArchConfig, *, q_offset: int,
                        kv_positions: torch.Tensor, q_block: int | None = None):
    """q: (B, Sq, H, dh); k, v: (B, Skv, KV, dh) -> (B, Sq, H, dh); the
    queries sit at positions ``q_offset ..``, the kv slots at
    ``kv_positions`` (Skv,); ``cfg.attn`` picks the mask (`_attn_mask`).

    f32 scores, a -1e30 mask, f32 softmax, probabilities rounded to v's
    dtype before the value contraction — the reference's form, not a fused
    attention kernel.  Queries run in chunks of ``cfg.attn_chunk`` when it
    divides Sq, which bounds the live (cq, Skv) score tile; every query row
    computes the same values either way.  ``q_block`` (the serving forward)
    runs the queries in blocks of exactly that many positions and the batch
    in blocks of `B_BLOCK` rows, both zero-padded: every product then has
    one shape, and a query row's values depend neither on Sq nor on B (the
    library picks its algorithm by shape)."""
    B, Sq, H, dh = q.shape
    G = H // k.shape[2]
    KV = k.shape[2]
    qg = q.reshape(B, Sq, KV, G, dh)
    scale = dh ** -0.5
    jk = kv_positions
    kf, vf = k.float(), v.float()

    def chunk_attn(q_c, iq, kf=kf, vf=vf):
        s = torch.einsum("bqkgd,bskd->bkgqs", q_c.float(), kf) * scale
        m = _attn_mask(iq, jk, cfg.attn, cfg.window)
        s = torch.where(m[None, None, None], s, torch.full_like(s, -1e30))
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).float(), vf)
        return o.to(q.dtype)

    if q_block:
        n = -(-Sq // q_block) * q_block
        iq = q_offset + torch.arange(n, device=q.device)

        def batch_block(qb, kb, vb):
            return (torch.cat([chunk_attn(qb[:, c:c + q_block], iq[c:c + q_block],
                                          kb, vb)
                               for c in range(0, n, q_block)], dim=1),)

        o, = batch_blocks(batch_block, (_zero_pad(qg, 1, n), kf, vf), (0.0,) * 3)
        return o[:, :Sq].reshape(B, Sq, H, dh)
    iq = q_offset + torch.arange(Sq, device=q.device)
    cq = cfg.attn_chunk
    if cq and Sq > cq and Sq % cq == 0:
        o = torch.cat([chunk_attn(qg[:, c:c + cq], iq[c:c + cq])
                       for c in range(0, Sq, cq)], dim=1)
    else:
        o = chunk_attn(qg, iq)
    return o.reshape(B, Sq, H, dh)


def _zero_pad(t: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    """``t`` zero-padded along ``dim`` to ``size``."""
    if t.shape[dim] == size:
        return t
    shape = list(t.shape)
    shape[dim] = size - shape[dim]
    return torch.cat([t, t.new_zeros(shape)], dim=dim)


def cache_slot(pos: int, S: int, s_cache: int, attn: str) -> int:
    """First cache slot of S new positions from position ``pos``: ``pos %
    s_cache``, clamped so that the S rows fit, as the reference's
    ``dynamic_update_slice`` clamps its start.  A sliding-window cache is a
    ring of ``window`` slots and wraps; a full-length cache (causal,
    bidirectional) must hold ``pos + S`` positions, or this raises."""
    if S > s_cache or (attn != "swa" and pos + S > s_cache):
        raise ValueError(
            f"cache of {s_cache} slots cannot take positions "
            f"{pos}..{pos + S - 1} (admission bounds prompt + new tokens "
            "by max_len)"
        )
    return min(pos % s_cache, s_cache - S)


def attn_apply(p, x, cfg: ArchConfig, *, positions, cache=None):
    """Projections (+ qk-norm) + RoPE (none for ``bidir``: the encoders here
    use no position encoding in attention) + attention under ``cfg.attn``.
    ``cache=None`` (the training forward) attends over the S new positions
    themselves, kv positions ``0..S-1``, and writes nothing: every op is
    differentiable.  Otherwise ``cache`` is one layer's dict(k, v, kv_pos,
    pos): k/v (B, S_cache, KV, dh) are written IN PLACE at the rows from
    `cache_slot` (the cohort owns its cache; the reference returns an
    updated copy instead), ``kv_pos`` is the already-updated slot-position
    vector and ``pos`` a host int.

    ``cfg.expand_kv`` repeats k and v to H heads at attention time, after
    the cache write (the cache keeps KV heads), as the reference does.

    With ``wq`` / ``wo`` dealt as `TPSlabs` (approximate serving on a serve
    mesh) the block runs tensor-parallel through `tp_sum`: shard j projects
    q for heads [j H / m, (j + 1) H / m), attends on them and multiplies by
    ``wo``'s row slab j.  It projects k / v for its own KV heads when
    ``wk`` / ``wv`` are slabs too (m divides KV), else every shard reads
    the KV heads its q heads map to from the k / v the lead projects once.
    The cache stays on the lead, each shard writing and reading its KV
    heads as a view along the head dim."""
    B, S, D = x.shape
    H, dh = cfg.n_heads, cfg.head_dim
    ct = _ct(cfg)
    serving = cache is not None
    lead = x.device
    # every projection is a contiguous 2-D (B*S, D) product; a serving or
    # tensor-parallel forward runs it over fixed row blocks, so a
    # position's values do not depend on B and S (`row_blocks`)
    xc = x.to(ct).reshape(B * S, D)
    proj = (_row_invariant_matmul if serving or (
        isinstance(p["wq"], TPSlabs) and _TP_ROW_BLOCKS) else torch.matmul)
    if serving:
        pos = cache["pos"]
        slot = cache_slot(pos, S, cache["k"].shape[1], cfg.attn)
        kv_positions = cache["kv_pos"]
    else:
        pos, kv_positions = 0, torch.arange(S, device=lead)

    def heads(t, norm, dev):
        """(B S, n dh) projections as (B, S, n, dh) heads: per-head rmsnorm
        (a serving forward takes its row means over fixed row blocks, as
        the block norms do), then RoPE."""
        t = t.reshape(B, S, -1, dh)
        if cfg.qk_norm:
            t = rmsnorm(t, p[norm].to(dev), cfg.norm_eps, row_invariant=serving)
        if cfg.attn != "bidir":
            t = rope_apply(t, positions.to(dev), cfg.rope_theta)
        return t

    def kv_heads(wk, wv, j, dev):
        """k and v of KV-head block j (``wk``'s columns wide); a serving
        forward writes them into the lead's cache and reads back that
        block of heads."""
        xd = xc.to(dev)
        k = heads(proj(xd, wk), "k_norm", dev)
        n = k.shape[2]
        v = proj(xd, wv).reshape(B, S, n, dh)
        if not serving:  # fresh k / v only: a cache keeps its own layout
            return _qkv_hook(k), _qkv_hook(v)
        hs = slice(j * n, (j + 1) * n)
        cache["k"][:, slot:slot + S, hs] = k.to(lead, cache["k"].dtype)
        cache["v"][:, slot:slot + S, hs] = v.to(lead, cache["v"].dtype)
        return cache["k"][:, :, hs], cache["v"][:, :, hs]

    kv_split = isinstance(p["wk"], TPSlabs)
    kv = None if kv_split else kv_heads(p["wk"].to(ct), p["wv"].to(ct), 0, lead)

    def body(ws, j, m, dev, down):
        wq, wo = ws
        hl = H // m
        q = _qkv_hook(heads(proj(xc.to(dev), wq), "q_norm", dev))
        k, v = (kv_heads(p["wk"].slab(j, dev), p["wv"].slab(j, dev), j, dev)
                if kv_split else kv)
        kv0 = j * cfg.n_kv // m if kv_split else 0
        k, v = (_shard_kv(t.to(dev, q.dtype), cfg, j, hl, kv0) for t in (k, v))
        o = multihead_attention(q, k, v, cfg, q_offset=pos,
                                kv_positions=kv_positions.to(dev),
                                q_block=Q_BLOCK if serving else None)
        return down(o.reshape(B * S, hl * dh), wo)

    out = tp_sum(p, ("wq", "wo"), body, ct=ct, lead=lead, down=proj)
    return out.reshape(B, S, D).to(x.dtype)


def _shard_kv(t: torch.Tensor, cfg: ArchConfig, j: int, hl: int,
              kv0: int) -> torch.Tensor:
    """The KV heads q heads [j hl, (j + 1) hl) attend with, from ``t`` (B,
    S, n, dh) holding KV heads kv0 .. kv0 + n - 1 (q head h reads KV head
    h // (H / KV)): the GQA groups as they are when the q heads cover
    whole groups or one group covers them, repeated to one KV head per q
    head under ``cfg.expand_kv``; otherwise one head per q head."""
    G = cfg.n_heads // cfg.n_kv
    lo = j * hl // G - kv0
    if hl % G == 0:
        t, rep = t[:, :, lo:lo + hl // G], G
    elif G % hl == 0:
        t, rep = t[:, :, lo:lo + 1], hl
    else:
        heads = torch.arange(j * hl, (j + 1) * hl, device=t.device) // G - kv0
        return t.index_select(2, heads)
    if cfg.expand_kv and rep > 1:
        return torch.repeat_interleave(t, rep, dim=2)
    return t


def _row_invariant_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return row_blocks(torch.matmul, x, w)


def project(x: torch.Tensor, w: torch.Tensor, *, row_invariant: bool) -> torch.Tensor:
    """``x (..., K) @ w (K, N)`` as one 2-D product over x's rows, over
    fixed row blocks (`row_blocks`) when ``row_invariant`` (the serving
    forward)."""
    mm = _row_invariant_matmul if row_invariant else torch.matmul
    return mm(x.reshape(-1, x.shape[-1]), w).reshape(tuple(x.shape[:-1]) + (-1,))


# ---------------------------------------------------------------------------
# MLP: the spiking dual-sparse FFN and the dense MLPs
# ---------------------------------------------------------------------------

def mlp_axes(cfg: ArchConfig) -> dict:
    """Logical axes of `mlp_init`'s leaves."""
    if cfg.act in ("swiglu", "geglu") and not cfg.spiking_ffn:
        return {
            "wg": ("d_model", "d_ff"),
            "wu": ("d_model", "d_ff"),
            "wd": ("d_ff", "d_model"),
        }
    return {"wu": ("d_model", "d_ff"), "wd": ("d_ff", "d_model")}


def mlp_init(gen: torch.Generator, cfg: ArchConfig, d_ff=None) -> dict:
    """FFN weights.  Spiking: two GEMMs, no gate, LTH-pruned ONCE here to
    the plan's block grid when ``spiking_weight_density < 1`` (forwards
    never re-prune).  Dense: gate, up and down for swiglu/geglu, up and
    down otherwise, drawn in that order."""
    D, F = cfg.d_model, d_ff or cfg.d_ff
    if not cfg.spiking_ffn:
        names = ("wg", "wu") if cfg.act in ("swiglu", "geglu") else ("wu",)
        p = {n: dense_init(gen, (D, F), _dt(cfg)) for n in names}
        p["wd"] = dense_init(gen, (F, D), _dt(cfg))
        return p
    from repro_torch.core.snn_layers import prune_by_magnitude
    from repro_torch.kernels.join_plan import pick_plan_blocks

    p = {
        "wu": dense_init(gen, (D, F), _dt(cfg)),
        "wd": dense_init(gen, (F, D), _dt(cfg)),
    }
    if cfg.spiking_weight_density < 1.0:
        for name in ("wu", "wd"):
            K, N = p[name].shape
            bk, bn = pick_plan_blocks(K, N)
            block = (bk, bn) if (K % bk == 0 and N % bn == 0) else None
            p[name] = prune_by_magnitude(
                p[name], cfg.spiking_weight_density, block=block
            )
    return p


def attach_spiking_ffn_plans(params: dict, cfg: ArchConfig,
                             model_shards: int = 1) -> dict:
    """Load-time step of the dual-sparse serving path: assert the prune-once
    density contract and attach one `WeightJoinPlan` per GEMM per layer
    (``plan_in`` / ``plan_out``, payload in the compute dtype, on the
    weights' device).  Returns a new tree; host work happens once here.

    ``model_shards > 1`` (mesh serving): each plan is split into that many
    column slabs (`join_plan.shard_plan`), which `serve.sharding.place_plans`
    deals out over the mesh's model axis."""
    if not cfg.spiking_ffn:
        return params
    from repro_torch.core.snn_layers import assert_weight_density
    from repro_torch.kernels.join_plan import (
        build_sharded_weight_plan,
        build_weight_plan,
        shard_plan,
    )

    ct = _ct(cfg)

    def build_weight_plan_for(w):
        if model_shards > 1:
            return shard_plan(build_sharded_weight_plan(w, model_shards),
                              model_shards)
        return build_weight_plan(w)

    def prepare(mlp):
        if cfg.spiking_weight_density < 1.0:
            assert_weight_density(mlp["wu"], cfg.spiking_weight_density)
            assert_weight_density(mlp["wd"], cfg.spiking_weight_density)
        # the payload carries the compute-dtype cast the apply path uses
        return dict(mlp, plan_in=build_weight_plan_for(mlp["wu"].to(ct)),
                    plan_out=build_weight_plan_for(mlp["wd"].to(ct)))

    def walk(node):
        # every spiking-FFN weight pair (a dict with wu and wd, no gate),
        # wherever the family keeps it: each layer's mlp, zamba's shared one
        if isinstance(node, dict):
            if {"wu", "wd"} <= node.keys() and "wg" not in node:
                return prepare(node)
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node

    return walk(params)


def derive_draft_params(params: dict, cfg: ArchConfig, density: float) -> dict:
    """Second param tree for speculative drafts: every spiking-FFN weight
    pair re-pruned to ``density`` (below the target's
    ``cfg.spiking_weight_density``), every other leaf SHARED with the
    target tree (the same tensors).  Returns a plan-free tree; the caller
    attaches the draft's own plans with `attach_spiking_ffn_plans`."""
    if not cfg.spiking_ffn:
        raise ValueError("draft weight pruning needs a spiking-FFN arch")
    from repro_torch.kernels.join_plan import prune_to_density

    def prune(mlp):
        out = {k: v for k, v in mlp.items() if k not in ("plan_in", "plan_out")}
        out["wu"] = prune_to_density(mlp["wu"], density)
        out["wd"] = prune_to_density(mlp["wd"], density)
        return out

    layers = [dict(lp, mlp=prune(lp["mlp"])) for lp in params["layers"]]
    return dict(params, layers=layers)


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    """1 / (1 + exp(-x)) op by op in x's dtype: XLA expands the reference's
    logistic so, and torch.sigmoid rounds a bf16 result differently."""
    return 1 / (1 + torch.exp(-x))


def _in_dtype(c: float, dtype: torch.dtype) -> float:
    """The Python constant ``c`` rounded to ``dtype``, as jax rounds a
    (weakly typed) constant to its array operand's dtype."""
    return float(torch.tensor(c, dtype=dtype))


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu's tanh approximation, op by op in x's dtype, with its
    constants rounded to that dtype first as jax rounds them."""
    c = _in_dtype(math.sqrt(2 / math.pi), x.dtype)
    a = _in_dtype(0.044715, x.dtype)
    cdf = 0.5 * (1.0 + torch.tanh(c * (x + a * (x ** 3))))
    return x * cdf


def mlp_apply(p, x, cfg: ArchConfig, spiking_mode: str = "train", *,
              row_invariant: bool = False):
    """The FFN.  Spiking: the dual-sparse spiking FFN under the FTP
    dataflow; ``infer`` with attached plans routes both GEMMs through the
    dual-sparse BSR kernel, ``infer`` without plans runs them against the
    dense weights (through the dense-weight kernels when the activations
    are on the card: the reference turns its kernels on when its backend
    is the TPU), ``train`` runs the differentiable float path.  A plan
    route whose tree carries an ``ffn_policy`` (a speculative draft with an
    adaptive temporal axis, `Engine._configure_draft`) runs both GEMMs
    under that policy, so its timestep gate reaches the kernel.  Dense:
    swiglu / geglu / sq_relu / gelu in the compute dtype, whatever the
    mode; ``row_invariant`` (zamba's shared block in a serving forward)
    runs its products over fixed row blocks (`project`).

    With ``wu`` / ``wd`` dealt as `TPSlabs` (approximate serving on a serve
    mesh; under packed spikes the FFN shards as plan or dense column slabs
    instead, `kernels.ops`) the products run tensor-parallel through
    `tp_sum`, over fixed row blocks: shard j runs the up (and gate)
    column slab j, the activation on its ``d_ff / m`` hidden units and the
    down row slab j.  The spiking FFN's float path runs so in f32: its
    hidden LIF neurons are per unit, so shard j fires its own, and the
    partial full sums (T, M, D) add before the rate decode."""
    if spiking_mode not in SPIKING_MODES:
        raise ValueError(f"unknown spiking FFN mode {spiking_mode!r}")
    ct = _ct(cfg)
    xc = x.to(ct)
    tp = isinstance(p["wu"], TPSlabs)
    if not cfg.spiking_ffn:
        def mm(a, w):
            if row_invariant or (tp and _TP_ROW_BLOCKS):
                return project(a, w, row_invariant=True)
            return a @ w

        def body(ws, j, m, dev, down):
            wu, wg, wd = ws
            a = xc.to(dev)
            gate = mm(a, wg) if cfg.act in ("swiglu", "geglu") else None
            return down(_dense_act(cfg, mm(a, wu), gate), wd)

        y = tp_sum(p, ("wu", "wg", "wd"), body, ct=ct, lead=x.device, down=mm)
        return y.to(x.dtype)
    from repro_torch.core.snn_layers import SpikingConfig, spiking_ffn_apply

    scfg = SpikingConfig(T=cfg.spiking_T, weight_density=cfg.spiking_weight_density)
    weights = {"w_in": p["wu"], "w_out": p["wd"]}
    plans = over = None
    if spiking_mode == "infer" and "plan_in" in p:
        plans = (p["plan_in"], p["plan_out"])  # the kernel reads only these
    elif tp:
        def over(ffn):
            def body(ws, j, m, dev, down):
                return ffn(*ws, dev, lambda a, w: down(a.float(), w.float()))
            return tp_sum(p, ("wu", "wd"), body, ct=ct, lead=x.device,
                          down=None, dtype=torch.float32)
    else:  # the float and dense paths contract the compute-dtype values
        weights = {k: w.to(ct) for k, w in weights.items()}
    y = spiking_ffn_apply(weights, xc, scfg, mode=spiking_mode, plans=plans,
                          policy=p.get("ffn_policy"), over=over)
    return y.to(x.dtype)


def _dense_act(cfg: ArchConfig, up: torch.Tensor, gate) -> torch.Tensor:
    """The dense MLP's hidden activation of the up (and gate) products."""
    if cfg.act == "swiglu":
        return gate * _sigmoid(gate) * up
    if cfg.act == "geglu":
        return _gelu(gate) * up
    if cfg.act == "sq_relu":
        return torch.square(torch.relu(up))
    if cfg.act == "gelu":
        return _gelu(up)
    raise ValueError(cfg.act)


# ---------------------------------------------------------------------------
# MoE: top-k token-choice router, capacity-based dispatch
# ---------------------------------------------------------------------------

EXPERT_WEIGHTS = ("wu", "wg", "wd")


def moe_init(gen: torch.Generator, cfg: ArchConfig) -> dict:
    """The f32 router (D, E), then ``wu`` (E, D, F), ``wd`` (E, F, D) and,
    for gated activations, ``wg`` (E, D, F), drawn in that order with the
    reference's fan-ins."""
    D, F, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {
        "router": dense_init(gen, (D, E), torch.float32),
        "wu": dense_init(gen, (E, D, F), _dt(cfg), fan_in=D),
        "wd": dense_init(gen, (E, F, D), _dt(cfg), fan_in=F),
    }
    if cfg.act in ("swiglu", "geglu"):
        p["wg"] = dense_init(gen, (E, D, F), _dt(cfg), fan_in=D)
    return p


def moe_axes(cfg: ArchConfig) -> dict:
    """Logical axes of `moe_init`'s leaves: experts on ``data`` (EP)."""
    ax = {
        "router": ("d_model", None),
        "wu": ("experts", "d_model", "d_ff"),
        "wd": ("experts", "d_ff", "d_model"),
    }
    if cfg.act in ("swiglu", "geglu"):
        ax["wg"] = ("experts", "d_model", "d_ff")
    return ax


def moe_route(router: torch.Tensor, xt: torch.Tensor, cfg: ArchConfig):
    """The routing of T tokens ``xt`` (T, D): (probs (T, E) f32, gates
    (T, K) f32 renormalised over the top K, expert ids (T, K), capacity
    positions (T, K), kept mask (T, K), capacity C).

    C = max(1, int(T K capacity_factor / E)) comes from the call's token
    count, so a token's routing depends on the other rows of its batch.
    Top-k is a stable descending sort: among equal probabilities the lower
    expert index comes first, as ``jax.lax.top_k`` returns it (``torch.
    topk`` promises no order).  Each (token, k) takes the next free slot of
    its expert's buffer in token-major order (an int cumsum); past C it is
    dropped."""
    T = xt.shape[0]
    E, K = cfg.n_experts, cfg.top_k
    C = max(1, int(T * K * cfg.capacity_factor / E))
    probs = torch.softmax(xt.float() @ router.float(), dim=-1)
    gate, eidx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, eidx = gate[:, :K], eidx[:, :K]
    gate = gate / gate.sum(-1, keepdim=True)
    onehot = torch.nn.functional.one_hot(eidx, E)           # (T, K, E) int
    flat = onehot.reshape(T * K, E)
    pos = ((flat.cumsum(0) - flat).reshape(T, K, E) * onehot).sum(-1)
    return probs, gate, eidx, pos, pos < C, C


def moe_apply(p, x, cfg: ArchConfig, route=None):
    """Top-k MoE with capacity-based dispatch; x (B, S, D) -> (y (B, S, D)
    in x's dtype, the Switch load-balancing loss E sum_e f_e p_e (f32)).

    Dispatch: each kept (token, k) pair owns one (expert, slot) of the
    (E, C, D) buffer (`moe_route`), so an indexed write of the kept pairs
    onto zeros gives the reference's scatter-add values whatever the order:
    ``index_copy_`` over E C + 1 rows, the dropped pairs all sent to the
    extra row, which is cut off.  The expert products are one ``bmm`` each
    in the compute dtype on every device, the activation runs op by op
    (`_sigmoid`, `_gelu`), the combine sum_k y_tk (gate keep) in the
    compute dtype.

    ``route`` (one data group of a train mesh, `moe_route_groups`) gives
    the whole batch's routing of these rows: their experts, slots, kept
    mask and capacity, f_e and the batch's token count.  The group keeps
    and drops the pairs the batch's routing does and runs its kept pairs
    through the experts in a buffer of its own; the gates are this group's
    own probabilities at those experts, and the load-balancing term is this
    group's share of the batch's, E sum_e f_e (sum of its rows' p_e) / T:
    the groups' shares add up to the batch's term."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    xt = x.reshape(T, D)
    if route is None:
        probs, gate, eidx, pos, keep, C = moe_route(p["router"], xt, cfg)
        _log_routing(keep)
        top1 = torch.nn.functional.one_hot(eidx[:, 0], E).float()
        aux = E * torch.sum(top1.mean(0) * probs.mean(0))
    else:
        eidx, _, keep, _, f, n_all = route
        probs = torch.softmax(xt.float() @ p["router"].float(), dim=-1)
        gate = probs.gather(-1, eidx)
        gate = gate / gate.sum(-1, keepdim=True)
        aux = E * torch.sum(f * (probs.sum(0) / n_all))
        # this group's kept pairs only, in a buffer of its own: each pair's
        # rank among them in its expert (token-major, as the batch's slots
        # order them), C its largest expert's count; the expert products
        # are row by row, so no value changes
        onehot = torch.nn.functional.one_hot(eidx, E) * keep[..., None]
        flat = onehot.reshape(T * K, E)
        pos = ((flat.cumsum(0) - flat).reshape(T, K, E) * onehot).sum(-1)
        C = max(1, int(flat.sum(0).max()))

    slot = torch.where(keep, eidx * C + pos, E * C).reshape(T * K)
    disp = x.new_zeros((E * C + 1, D))
    disp.index_copy_(0, slot, xt[:, None, :].expand(T, K, D).reshape(T * K, D))
    ct = _ct(cfg)
    disp = disp[:E * C].reshape(E, C, D).to(ct)
    # (E, C, D); with the experts' d_ff dealt as `TPSlabs` (approximate
    # serving on a serve mesh, or a train mesh's model axis), over its m
    # blocks, the router whole before
    y_e = tp_sum(p, ("wu", "wg", "wd"),
                 lambda ws, j, m, dev, down: _experts(*ws, disp.to(dev), cfg,
                                                      down=down),
                 ct=ct, lead=disp.device, down=torch.bmm, partial=_mm_f32)

    zero = torch.zeros_like(eidx)
    y_tk = y_e[torch.where(keep, eidx, zero), torch.where(keep, pos, zero)]
    y = (y_tk * (gate * keep).to(y_tk.dtype)[..., None]).sum(1)
    return y.reshape(B, S, D).to(x.dtype), aux


def moe_route_groups(router: torch.Tensor, xts: list, cfg: ArchConfig) -> list:
    """The routing of the whole batch, whose token rows are the data
    groups' ``xts`` (T_i, D) in group order, computed once with no
    gradient (it picks slots: nothing to differentiate) and split into each
    group's ``route`` for `moe_apply`: (expert ids, slots, kept mask,
    capacity C, f_e, T).  C comes from the batch's token count T, as on one
    device, so every group keeps and drops the (token, k) pairs one device
    does."""
    E = cfg.n_experts
    lead = xts[0].device
    with torch.no_grad():
        xt = torch.cat([x.detach().to(lead) for x in xts])
        _, _, eidx, pos, keep, C = moe_route(router.detach().to(lead), xt, cfg)
        _log_routing(keep)
        f = torch.nn.functional.one_hot(eidx[:, 0], E).float().mean(0)
    out, lo = [], 0
    for x in xts:
        n, dev = x.shape[0], x.device
        out.append((eidx[lo:lo + n].to(dev), pos[lo:lo + n].to(dev),
                    keep[lo:lo + n].to(dev), C, f.to(dev), xt.shape[0]))
        lo += n
    return out


_ROUTING_LOG = None


def _log_routing(keep: torch.Tensor) -> None:
    if _ROUTING_LOG is not None:
        _ROUTING_LOG.append(keep.detach().cpu())


class record_moe_routing:
    """``with record_moe_routing() as log:`` — each routing of the block
    (one per MoE layer and call) appends its (T, K) kept mask to ``log``;
    the dropped (token, k) pairs are its False entries.  Meant for a
    no-grad forward: a remat'd layer routes again in its backward."""

    def __enter__(self) -> list:
        global _ROUTING_LOG
        self._prev, _ROUTING_LOG = _ROUTING_LOG, []
        return _ROUTING_LOG

    def __exit__(self, *exc) -> None:
        global _ROUTING_LOG
        _ROUTING_LOG = self._prev


def _experts(wu, wg, wd, disp, cfg: ArchConfig, down=torch.bmm) -> torch.Tensor:
    """The experts' products on their (E, C, D) dispatch buffer: one
    ``bmm`` each in the compute dtype (the down product by ``down``), the
    activation op by op."""
    h_u = torch.bmm(disp, wu)
    if wg is not None:
        g = torch.bmm(disp, wg)
        h = (g * _sigmoid(g) if cfg.act == "swiglu" else _gelu(g)) * h_u
    else:
        h = torch.square(torch.relu(h_u)) if cfg.act == "sq_relu" else _gelu(h_u)
    return down(h, wd)
