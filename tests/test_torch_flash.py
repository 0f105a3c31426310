"""The port's flash attention (kernels 5-7) against the JAX reference, on the
CPU: the plain forward (o, lse) and the autograd Function's dq, dk, dv.

On the CPU the wrappers run their plain versions (`kernels/ref.py`); the CUDA
kernels are held to those same plain versions on the card
(`tests/test_torch_gpu.py`, `chip_smoke.py`).  The reference runs its Pallas
kernels in interpret mode, as its own tests do.

Tolerances are the reference tests' own (`tests/test_flash_mha.py`):
outputs and lse 3e-4, large logits 1e-3, gradients 3e-3, the first causal
row 1e-4.  The port sums the full score row at once where the reference
sums tile by tile with an online rescale, so the f32 sums run in another
order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_mha import flash_mha as j_flash_mha
from repro.kernels.flash_mha import flash_mha_fwd as j_flash_fwd
from repro.kernels.ref import mha_ref as j_mha_ref
from repro_torch.kernels import flash_mha as t_flash
from repro_torch.kernels import ref as t_ref

torch.set_num_threads(1)


def _qkv(seed, BH, S, dh, skv=None, scale_q=1.0):
    rng = np.random.default_rng(seed)
    skv = skv or S
    mk = lambda s: rng.normal(size=s).astype(np.float32)
    return mk((BH, S, dh)) * np.float32(scale_q), mk((BH, skv, dh)), mk((BH, skv, dh))


def _both(q, k, v, causal, window, bq, bk):
    """(reference o, lse), (port o, lse) as numpy."""
    jo, jl = j_flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=causal, window=window, bq=bq, bk=bk,
                         interpret=True)
    to, tl = t_flash.flash_mha_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=causal,
                                   window=window, bq=bq, bk=bk)
    return (np.asarray(jo), np.asarray(jl)), (to.numpy(), tl.numpy())


FWD_CASES = [
    # the reference test's shapes x masks
    *[(BH, S, dh, bq, bk, None, causal, window)
      for BH, S, dh, bq, bk in [(2, 256, 64, 128, 128), (4, 512, 128, 256, 256),
                                (1, 128, 32, 128, 64)]
      for causal, window in [(True, 0), (False, 0), (True, 64)]],
    (2, 128, 64, 128, 128, 512, False, 0),   # cross attention, kv longer
    (2, 256, 64, 64, 64, None, True, 64),    # whole kv tiles masked for rows >= 128
    (1, 256, 32, 64, 64, 64, True, 32),      # rows >= 95 see no key at all
]


@pytest.mark.parametrize("BH,S,dh,bq,bk,skv,causal,window", FWD_CASES)
def test_flash_fwd_plain_matches_reference(BH, S, dh, bq, bk, skv, causal, window):
    q, k, v = _qkv(BH * S + dh, BH, S, dh, skv)
    (jo, jl), (to, tl) = _both(q, k, v, causal, window, bq, bk)
    np.testing.assert_allclose(to, jo, rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(tl, jl, rtol=3e-4, atol=3e-4)
    want = np.asarray(j_mha_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal, window))
    np.testing.assert_allclose(to, want, rtol=3e-4, atol=3e-4)
    got = t_ref.mha_ref(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), causal, window).numpy()
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-4)


def test_flash_fwd_large_logits():
    q, k, v = _qkv(11, 1, 256, 64, scale_q=30.0)
    (jo, jl), (to, tl) = _both(q, k, v, True, 0, 128, 128)
    assert np.isfinite(to).all() and np.isfinite(tl).all()
    np.testing.assert_allclose(to, jo, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(tl, jl, rtol=1e-3, atol=1e-3)


def test_flash_fwd_first_row_causal():
    """Row 0 attends only to key 0: o[:, 0] == v[:, 0], lse = its score."""
    q, k, v = _qkv(13, 1, 128, 32)
    o, lse = t_flash.flash_mha_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=True, bq=64, bk=64)
    np.testing.assert_allclose(o[:, 0].numpy(), v[:, 0], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(lse[:, 0].numpy(),
                               (q[:, 0] * k[:, 0]).sum(-1) * 32 ** -0.5,
                               rtol=1e-4, atol=1e-4)


GRAD_CASES = [
    (2, 256, 64, 128, 128, None, True, 0),   # the reference test's case
    (2, 256, 64, 128, 128, None, False, 0),
    (2, 256, 64, 64, 64, None, True, 64),
    (2, 128, 64, 128, 128, 512, False, 0),
    (1, 128, 32, 64, 64, None, True, 0),
]


@pytest.mark.parametrize("BH,S,dh,bq,bk,skv,causal,window", GRAD_CASES)
def test_flash_autograd_grads_match_reference(BH, S, dh, bq, bk, skv, causal,
                                              window):
    """dq, dk, dv of sum(o ** 2) through the port's autograd Function
    against jax.grad through the reference's custom_vjp (interpret mode)."""
    q, k, v = _qkv(7 + S + dh, BH, S, dh, skv)

    def lf(q, k, v):
        return jnp.sum(j_flash_mha(q, k, v, causal, window, bq, bk, True) ** 2)

    want = jax.grad(lf, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    (t_flash.flash_mha(tq, tk, tv, causal, window, bq, bk) ** 2).sum().backward()
    for g, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=3e-3, atol=3e-3)


def test_plain_backward_equals_autograd_of_plain_attention():
    """The recompute formulas of the plain backward give autograd's
    gradients of the plain forward (bf16 inputs, causal window)."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(3, 2, 128, 64))
    o, lse = t_ref.flash_mha_fwd_plain(q, k, v, True, 32)
    do = torch.from_numpy(np.random.default_rng(4).normal(
        size=o.shape).astype(np.float32)).to(torch.bfloat16)
    got = t_ref.flash_mha_bwd_plain(q, k, v, o, lse, do, True, 32)
    qs, ks, vs = (t.float().requires_grad_() for t in (q, k, v))
    (t_ref.mha_ref(qs, ks, vs, True, 32) * do.float()).sum().backward()
    for g, w, like in zip(got, (qs.grad, ks.grad, vs.grad), (q, k, v)):
        assert g.dtype == like.dtype
        np.testing.assert_allclose(g.float().numpy(), w.to(like.dtype).float().numpy(),
                                   rtol=2e-2, atol=2e-2)


COUNT_NAMES = {"flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "flash_mha",
               *(f"{k}_{i}" for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
                 for i in ("tc", "simt"))}


def test_cpu_path_launches_no_kernel_and_validates_blocks():
    """Every count, the per-instance ones too, starts at 0 after a reset and
    CPU calls (f32 and bf16, a padded dh too) move none."""
    t_flash.reset_launch_counts()
    assert t_flash.launch_counts() == dict.fromkeys(COUNT_NAMES, 0)
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _qkv(5, 1, 128, 32))
    t_flash.flash_mha(q, k, v).sum().backward()
    qb, kb, vb = (torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
                  for a in _qkv(6, 1, 128, 48))
    t_flash.flash_mha(qb, kb, vb).float().sum().backward()
    assert t_flash.launch_counts() == dict.fromkeys(COUNT_NAMES, 0)
    with pytest.raises(ValueError, match="multiples"):
        t_flash.flash_mha_fwd(q, k, v, bq=96)
    with pytest.raises(ValueError, match="share"):
        t_flash.flash_mha_fwd(q, k[:, :, :16], v)


# ---------------------------------------------------------------------------
# instance routing and the head-dim padding (the CUDA kernels' templates)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dh", range(1, 257))
def test_flash_instance_and_template_dh(dh):
    """bf16 routes to the tensor-core instance and f32 to SIMT at every dh
    the kernels take; dh is padded to the next template."""
    want = next(t for t in (32, 64, 128, 192, 256) if t >= dh)
    assert t_flash.template_dh(dh) == want
    assert t_flash.flash_instance(torch.bfloat16, dh) == "tc"
    assert t_flash.flash_instance(torch.float32, dh) == "simt"


@pytest.mark.parametrize("dh", [0, 257])
def test_flash_refuses_dh_outside_the_templates(dh):
    with pytest.raises(ValueError, match=f"dh={dh}.*ROADMAP"):
        t_flash.template_dh(dh)
    with pytest.raises(ValueError, match=f"dh={dh}"):
        t_flash.flash_instance(torch.bfloat16, dh)
    x = torch.zeros(1, 64, dh)
    with pytest.raises(ValueError, match=f"dh={dh}"):
        t_flash.at_template(t_ref.flash_mha_fwd_plain, x, x, x)


@pytest.mark.parametrize("dh", [129, 160, 192, 256])
def test_flash_wide_head_dims_route_and_match_reference(dh):
    """Above dh 128 (nemotron's 192, gemma's 256, and padded 129 / 160),
    causal with a window of 32.  bf16 routes to the tensor-core instance,
    and either instance may be asked for.  f32: the padding path with the
    plain versions in the kernels' place matches the reference's Pallas
    kernels in interpret mode, o and lse within 3e-4, dq, dk, dv within
    3e-3 (the file's tolerances).  bf16: the wrapper on CPU tensors, under
    either instance, equals the plain versions at the true dh bit for bit,
    the padding path within 1e-5, and the reference on the same
    bf16-rounded inputs within 1e-2 (one bf16 step)."""
    assert t_flash.flash_instance(torch.bfloat16, dh) == "tc"
    q, k, v = _qkv(dh, 2, 128, dh)
    do = np.random.default_rng(dh + 1).normal(size=q.shape).astype(np.float32)
    kw = dict(causal=True, window=32)

    def reference(q, k, v, do):
        jo, jl = j_flash_fwd(*map(jnp.asarray, (q, k, v)), bq=64, bk=64,
                             interpret=True, **kw)
        _, vjp = jax.vjp(lambda a, b, c: j_flash_mha(a, b, c, True, 32, 64, 64,
                                                     True),
                         *map(jnp.asarray, (q, k, v)))
        return (np.asarray(jo), np.asarray(jl),
                *map(np.asarray, vjp(jnp.asarray(do))))

    def padded(tq, tk, tv, tdo):
        to, tl = t_flash.at_template(t_ref.flash_mha_fwd_plain, tq, tk, tv, **kw)
        delta = (to.float() * tdo.float()).sum(-1)
        tdq = t_flash.at_template(t_ref.flash_mha_bwd_dq_plain, tq, tk, tv, tdo,
                                  tl, delta, **kw)
        tdk, tdv = t_flash.at_template(t_ref.flash_mha_bwd_dkv_plain, tq, tk,
                                       tv, tdo, tl, delta, **kw)
        return to, tl, tdq, tdk, tdv

    # f32: the padding path against the reference
    got = padded(*map(torch.from_numpy, (q, k, v, do)))
    assert got[0].shape == got[2].shape == q.shape
    assert got[3].shape == got[4].shape == k.shape
    for i, (a, b) in enumerate(zip(got, reference(q, k, v, do))):
        tol = 3e-4 if i < 2 else 3e-3
        np.testing.assert_allclose(a.numpy(), b, rtol=tol, atol=tol)
    # bf16: the wrapper under either instance
    qb, kb, vb, dob = (torch.from_numpy(a).to(torch.bfloat16)
                       for a in (q, k, v, do))
    plain_o, plain_lse = t_ref.flash_mha_fwd_plain(qb, kb, vb, **kw)
    delta = (plain_o.float() * dob.float()).sum(-1)
    plain = (plain_o, plain_lse,
             t_ref.flash_mha_bwd_dq_plain(qb, kb, vb, dob, plain_lse, delta, **kw),
             *t_ref.flash_mha_bwd_dkv_plain(qb, kb, vb, dob, plain_lse, delta,
                                            **kw))
    pad = padded(qb, kb, vb, dob)
    want = reference(*(t.float().numpy() for t in (qb, kb, vb, dob)))
    for instance in ("tc", "simt"):
        o, lse = t_flash.flash_mha_fwd(qb, kb, vb, instance=instance, **kw)
        dq, dk, dv = t_flash.flash_mha_bwd(qb, kb, vb, o, lse, dob,
                                           instance=instance, **kw)
        for a, b, c, w in zip((o, lse, dq, dk, dv), plain, pad, want):
            assert a.dtype == b.dtype and torch.equal(a, b), instance
            torch.testing.assert_close(a.float(), c.float(), rtol=1e-5,
                                       atol=1e-5)
            np.testing.assert_allclose(a.float().numpy(), w, rtol=1e-2,
                                       atol=1e-2)


def test_flash_instance_override_must_fit_the_dtype():
    q, k, v = (torch.from_numpy(a) for a in _qkv(8, 1, 64, 32))
    with pytest.raises(ValueError, match="does not take"):
        t_flash.flash_mha_fwd(q, k, v, instance="tc")
    with pytest.raises(ValueError, match="no flash instance"):
        t_flash.flash_mha_fwd(q, k, v, instance="wgmma")
    with pytest.raises(ValueError, match="bf16 or f32"):
        t_flash.flash_instance(torch.float16, 64)
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    o, _ = t_flash.flash_mha_fwd(qb, kb, vb, instance="simt")
    torch.testing.assert_close(o, t_ref.flash_mha_fwd_plain(qb, kb, vb)[0])


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 32)])
@pytest.mark.parametrize("dh", [16, 48, 80, 112])
def test_flash_padded_template_path_matches_reference(dh, causal, window):
    """The kernels' padding path (zero-pad dh to the template, run at the
    template with the true dh ** -0.5, slice back) with the plain versions
    in the kernels' place, against the reference's Pallas kernels at the
    true dh (interpret mode): o and lse within 3e-4, dq, dk, dv (from the
    same do) within 3e-3, the reference tests' tolerances; and against the
    plain versions at the true dh within 1e-5 (the zero columns add exact
    +0 products; the f32 sums run in another blocking)."""
    q, k, v = _qkv(dh + window + causal, 2, 128, dh)
    do = np.random.default_rng(dh).normal(size=q.shape).astype(np.float32)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    kw = dict(causal=causal, window=window)
    to, tl = t_flash.at_template(t_ref.flash_mha_fwd_plain, tq, tk, tv, **kw)
    delta = (to * tdo).sum(-1)
    tdq = t_flash.at_template(t_ref.flash_mha_bwd_dq_plain, tq, tk, tv, tdo,
                              tl, delta, **kw)
    tdk, tdv = t_flash.at_template(t_ref.flash_mha_bwd_dkv_plain, tq, tk, tv,
                                   tdo, tl, delta, **kw)
    assert to.shape == tdq.shape == q.shape and tdk.shape == tdv.shape == k.shape

    jo, jl = j_flash_fwd(*map(jnp.asarray, (q, k, v)), bq=64, bk=64,
                         interpret=True, **kw)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=3e-4, atol=3e-4)
    _, vjp = jax.vjp(lambda a, b, c: j_flash_mha(a, b, c, causal, window, 64,
                                                 64, True),
                     *map(jnp.asarray, (q, k, v)))
    for got, want in zip((tdq, tdk, tdv), vjp(jnp.asarray(do))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-3,
                                   atol=3e-3)

    po, pl = t_ref.flash_mha_fwd_plain(tq, tk, tv, **kw)
    pdq = t_ref.flash_mha_bwd_dq_plain(tq, tk, tv, tdo, pl, delta, **kw)
    pdk, pdv = t_ref.flash_mha_bwd_dkv_plain(tq, tk, tv, tdo, pl, delta, **kw)
    for got, want in zip((to, tl, tdq, tdk, tdv), (po, pl, pdq, pdk, pdv)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
