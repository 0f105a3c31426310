"""The port's tooling (ROADMAP item 13b) against the JAX reference's, on the
CPU at small sizes: the configs' parameter counts and shape cells, the cell
manifest and batch shapes, the op counter (`roofline.op_stats`, the
counterpart of `roofline.hlo_stats`), the kernels' work formulas
(`roofline.kernel_work`), the roofline report and the dry run.

Held, and how closely:
* configs, `applicable_shapes`, `skip_reason`, the manifest, the batch
  shapes: equal to the reference's;
* flops of dense products: equal to `hlo_stats.analyze` of the same
  program (both count 2 M N K per product); bytes are each package's own
  proxy (HLO kernels there, aten ops here) and are not compared;
* a smoke llama prefill: the port's flops exceed the reference's by
  exactly the last-position unembed's padding (the serving forward runs
  the B last rows as one 64-row block, `layers.row_blocks`), and by
  nothing else;
* counts on meta tensors, on fake tensors and on real CPU tensors: equal;
* the dry run's extrapolation from its counted points: equal to a full
  count, flops and bytes, for every kind of cell and family tested;
* the kernels' work: equal to values worked out by hand in each test.
"""
import contextlib
import dataclasses
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as j_get_config
from repro.configs import smoke_variant as j_smoke_variant
from repro.configs.base import SHAPES as J_SHAPES
from repro.configs.base import applicable_shapes as j_applicable
from repro.configs.base import skip_reason as j_skip_reason
from repro.data.pipeline import batch_shapes as j_batch_shapes
from repro.launch.specs import runnable_cells as j_runnable
from repro.launch.specs import skipped_cells as j_skipped
from repro.models.registry import build_model as j_build
from repro.roofline.hlo_stats import analyze
from repro_torch import bridge
from repro_torch.configs import ARCHS, SHAPES, ShapeCell, get_config, smoke_variant
from repro_torch.configs.base import applicable_shapes, skip_reason
from repro_torch.data import batch_shapes
from repro_torch.kernels import ftp_spmm
from repro_torch.launch import dryrun
from repro_torch.launch.specs import build_cell, runnable_cells, skipped_cells
from repro_torch.models.layers import ROW_BLOCK, attach_spiking_ffn_plans
from repro_torch.models.registry import build_model
from repro_torch.roofline import attribution_summary, count, kernel_work
from repro_torch.roofline.op_stats import ATTRIBUTION_KEYS, OpCounter, active_counter
from repro_torch.roofline.report import (
    H100,
    device_peaks,
    model_flops,
    parse_smi,
    roofline_from_record,
)

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# configs, shape cells, manifest, batch shapes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_shape_cells_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    assert cfg.n_params() == jcfg.n_params()
    assert cfg.active_params() == jcfg.active_params()
    got, want = applicable_shapes(cfg), j_applicable(jcfg)
    assert list(got) == list(want)
    for name in got:
        assert (got[name] is None) == (want[name] is None)
        if got[name] is not None:
            assert dataclasses.asdict(got[name]) == dataclasses.asdict(want[name])
        assert skip_reason(cfg, name) == j_skip_reason(jcfg, name)
        b, jb = batch_shapes(cfg, SHAPES[name]), j_batch_shapes(jcfg, J_SHAPES[name])
        assert {k: tuple(v.shape) for k, v in b.items()} == {
            k: tuple(v.shape) for k, v in jb.items()}
        assert all(v.is_meta for v in b.values())
        assert {k: v.dtype for k, v in b.items()} == {
            k: torch.int64 if jnp.issubdtype(v.dtype, jnp.integer) else torch.float32
            for k, v in jb.items()}


def test_manifest_equals_the_reference():
    assert runnable_cells() == j_runnable()
    assert skipped_cells() == j_skipped()
    assert (len(runnable_cells()), len(skipped_cells())) == (32, 8)
    assert {s: dataclasses.asdict(c) for s, c in SHAPES.items()} == {
        s: dataclasses.asdict(c) for s, c in J_SHAPES.items()}


def test_dryrun_manifest_cli_lists_32_runs_and_8_skips():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert dryrun.main(["--manifest"]) == 0
    lines = out.getvalue().splitlines()
    assert sum(ln.startswith("run ") for ln in lines) == 32
    assert sum(ln.startswith("skip ") for ln in lines) == 8


# ---------------------------------------------------------------------------
# the op counter against hlo_stats
# ---------------------------------------------------------------------------

def test_op_stats_repeated_products_and_collectives():
    """The counterpart of the reference's trip-count test: ten 8 x 8
    products (the reference's while body, here a Python loop) count 10 x 2
    x 8 x 8 x 8 flops, and their all-reduces 10 x 256 collective bytes."""
    dist.init_process_group("gloo", store=dist.HashStore(), world_size=1, rank=0)
    try:
        def body(x):
            for _ in range(10):
                x = x @ x
                dist.all_reduce(x)
            return x

        st = count(body, torch.ones(8, 8))
    finally:
        dist.destroy_process_group()
    assert st.flops == 10 * 2 * 8 * 8 * 8
    assert st.flops_by_dtype == {"f32": 10 * 2 * 8 * 8 * 8}
    assert st.collective_bytes == 10 * 8 * 8 * 4
    assert st.collectives == {"allreduce_": 10 * 256}
    assert st.n_collective_ops == 10
    # without a process group nothing is a collective
    assert count(lambda x: x @ x, torch.ones(8, 8)).collective_bytes == 0


def test_op_stats_flops_equal_hlo_stats_on_the_scanned_program():
    """The reference's 6-layer scanned tanh(x @ w): its `analyze` of the
    compiled HLO and the port's count of the same loop give equal flops."""
    def f(ws, x):
        def body(x, w):
            return jnp.tanh(x @ w), None
        x, _ = jax.lax.scan(body, x, ws)
        return x.sum()

    want = analyze(jax.jit(f).lower(jnp.ones((6, 16, 16)), jnp.ones((4, 16)))
                   .compile().as_text())

    def g(ws, x):
        for w in ws:
            x = torch.tanh(x @ w)
        return x.sum()

    got = count(g, torch.ones(6, 16, 16), torch.ones(4, 16))
    assert 6 in want.while_trip_counts
    assert got.flops == want.flops == 6 * 2 * 4 * 16 * 16


def test_op_stats_smoke_prefill_flops_against_hlo_stats():
    """A smoke llama prefill (B 4, S 32: no query or batch block padded):
    the port's product flops are the reference's plus the unembed's
    padding, 2 (ROW_BLOCK - B) D V: the serving forward runs the B
    last-position rows as one 64-row block (`layers.row_blocks`)."""
    jcfg = j_smoke_variant(j_get_config("llama3_2_1b"))
    jm = j_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    B, S = 4, 32
    hlo = jax.jit(jm.prefill).lower(jp, {"tokens": jnp.zeros((B, S), jnp.int32)},
                                    jm.init_cache(B, S)).compile().as_text()
    want = analyze(hlo).flops
    cfg = smoke_variant(get_config("llama3_2_1b"))
    m = build_model(cfg)
    params = m.prepare(bridge.params_from_reference(jax.tree.map(np.asarray, jp)))
    got = count(m.prefill, params, {"tokens": torch.zeros((B, S), dtype=torch.long)},
                m.init_cache(B, S, device="cpu"))
    assert got.flops == want + 2 * (ROW_BLOCK - B) * cfg.d_model * cfg.vocab


def _fake(tree, mode):
    if isinstance(tree, dict):
        return {k: _fake(v, mode) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_fake(v, mode) for v in tree)
    return mode.from_tensor(tree) if isinstance(tree, torch.Tensor) else tree


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_meta_and_fake_counts_equal_real_cpu_counts(kind):
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = smoke_variant(get_config("llama3_2_1b"))
    cell = ShapeCell(kind, 64, 4, kind)
    real = build_cell("llama3_2_1b", kind, cfg=cfg, cell=cell, device="cpu")
    want = count(real.fn, *real.args)
    meta = build_cell("llama3_2_1b", kind, cfg=cfg, cell=cell)
    got = count(meta.fn, *meta.args)
    with FakeTensorMode() as mode:
        fake = _fake(real.args, mode)
        with OpCounter() as c:
            real.fn(*fake)
    for st in (got, c.stats):
        assert (st.flops, st.bytes_accessed, st.flops_by_dtype, st.n_ops) == (
            want.flops, want.bytes_accessed, want.flops_by_dtype, want.n_ops)
    assert want.flops > 0 and want.bytes_accessed > 0


# ---------------------------------------------------------------------------
# the dry run's extrapolation
# ---------------------------------------------------------------------------

# (arch, config changes, cell, n_layers): cells at smoke width whose plans
# reach every axis (`test_extrapolation_cases_cover_every_axis`)
EXTRAPOLATED = [
    ("llama3_2_1b", {}, ShapeCell("p", 2048, 8, "prefill"), 3),         # seq, 3 points
    ("llama3_2_1b", {"loss_chunk": 64}, ShapeCell("t", 64, 256, "train"), 5),
    ("llama3_2_1b", {}, ShapeCell("d", 64, 8, "decode"), 5),
    ("rwkv6_1_6b", {}, ShapeCell("p", 256, 16, "prefill"), 5),          # seq, 2 points
    ("rwkv6_1_6b", {}, ShapeCell("t", 512, 8, "train"), 3),             # seq in a train step
    ("zamba2_7b", {"shared_attn_every": 2}, ShapeCell("p", 256, 16, "prefill"), 5),
    ("zamba2_7b", {"shared_attn_every": 2}, ShapeCell("d", 64, 8, "decode"), 5),
    ("mixtral_8x22b", {}, ShapeCell("p", 256, 16, "prefill"), 5),
    ("phi3_5_moe", {"loss_chunk": 64}, ShapeCell("t", 64, 256, "train"), 5),
    ("hubert_xlarge", {}, ShapeCell("p", 256, 32, "prefill"), 5),        # batch
]


def _case_cfg(arch, over, n_layers):
    return dataclasses.replace(smoke_variant(get_config(arch)), n_layers=n_layers, **over)


def test_extrapolation_cases_cover_every_axis():
    seen = {(a.name, len(a.points)) for arch, over, cell, n in EXTRAPOLATED
            for a in dryrun.plan(_case_cfg(arch, over, n), cell)}
    assert seen >= {("layers", 2), ("layers", 3), ("batch", 2), ("batch", 3),
                    ("seq", 2), ("seq", 3)}


@pytest.mark.parametrize("arch,over,cell,n_layers", EXTRAPOLATED,
                         ids=[f"{a}-{c.kind}-{c.global_batch}x{c.seq_len}"
                              for a, _, c, _ in EXTRAPOLATED])
def test_extrapolated_counts_equal_full_counts(arch, over, cell, n_layers):
    """Counted at the plan's points and extrapolated, against one count at
    full size (zamba2: groups of 2 and a tail layer)."""
    cfg = _case_cfg(arch, over, n_layers)
    axes = dryrun.plan(cfg, cell)
    assert axes and axes[0].name == "layers" and max(axes[0].points) < n_layers
    got = dryrun.count_cell(arch, cell.name, cfg=cfg, cell=cell)["stats"]
    want, _, _ = dryrun.count_point(arch, cell.name, cfg=cfg, cell=cell)
    assert got.flops == want.flops
    assert got.bytes_accessed == want.bytes_accessed
    assert got.flops_by_dtype == want.flops_by_dtype
    assert got.repeats == [{"axis": a.name, "points": list(a.points), "target": a.target}
                           for a in axes]


def test_plan_of_the_full_cells():
    """The axes of a few full-size cells (no count): decode by depth only,
    llama's prefill also by batch and sequence (quadratic), rwkv6's train
    step by sequence (its scan's steps do not shrink with the batch), zamba2
    by groups of 6 with its tail of 3."""
    names = lambda axes: [(a.name, a.points) for a in axes]
    llama = get_config("llama3_2_1b")
    assert names(dryrun.plan(llama, SHAPES["decode_32k"])) == [("layers", (1, 2))]
    p = dryrun.plan(llama, SHAPES["prefill_32k"])
    assert [a.name for a in p] == ["layers", "batch", "seq"] and len(p[2].points) == 3
    r = dryrun.plan(get_config("rwkv6_1_6b"), SHAPES["train_4k"])
    assert [a.name for a in r] == ["layers", "seq"]
    z = dryrun.plan(get_config("zamba2_7b"), SHAPES["decode_32k"])
    assert names(z) == [("layers", (6, 12, 7))] and z[0].coef == (-14, 12, 3)
    for axes in (p, r, z):
        for a in axes:
            assert sum(a.coef) == 1  # a constant extrapolates to itself


# ---------------------------------------------------------------------------
# the kernels' work, counted at their entry
# ---------------------------------------------------------------------------

def _bsr_case():
    """M 2, K 4, T 2, 2 x 2 blocks, one column block: k block 0 active with
    3 non-silent words (1; 3, 1), k block 1 silent in the activity map."""
    a = torch.tensor([[1, 0, 0, 0], [3, 1, 0, 0]], dtype=torch.int32)
    payload = torch.ones((2, 2, 2), dtype=torch.bfloat16)
    kidx = torch.tensor([[0, 1]], dtype=torch.int32)
    vidx = torch.tensor([[0, 1]], dtype=torch.int32)
    cnt = torch.tensor([2], dtype=torch.int32)
    act = torch.tensor([[1, 0]], dtype=torch.int32)
    return a, payload, kidx, vidx, cnt, act, 2, 2


def test_bsr_work_by_hand():
    args = _bsr_case()
    # ops: 2 T' bn x 3 words = 2 * 2 * 2 * 3 (both planes carry a spike);
    # bytes: words 32 + one payload block 8 + act 8 + lists 20 + out
    assert kernel_work.bsr_work(*args, bm=2, fuse_lif=True) == (32 + 8 + 8 + 20 + 32, 24)
    assert kernel_work.bsr_work(*args, bm=2, fuse_lif=False) == (32 + 8 + 8 + 20 + 48, 24)
    tmap = torch.tensor([1, 0], dtype=torch.int32)  # plane 1 gated
    assert kernel_work.bsr_work(*args, bm=2, fuse_lif=True, tmap=tmap) == (108, 12)


def test_dense_and_flash_work_by_hand():
    a = _bsr_case()[0]
    w = torch.ones((4, 3), dtype=torch.bfloat16)
    # 2 T N per non-silent word: 2 * 2 * 3 * 3; words 32 + weight 24 + out 48
    assert kernel_work.dense_work(a, w, 2, True) == (104, 36)
    assert kernel_work.dense_work(a, w, 2, False) == (104, 36)
    q = torch.zeros((1, 4, 8), dtype=torch.bfloat16)
    work = kernel_work.flash_work(q, 4, True, 0)  # 10 visible pairs
    assert work == {"flash_fwd": (272, 320), "flash_bwd_dq": (352, 480),
                    "flash_bwd_dkv": (416, 640), "flash_mha": (512, 960)}
    assert kernel_work.visible_pairs(4, 4, True, 2) == 7
    assert kernel_work.flash_dtype(q) == "bf16"
    assert kernel_work.flash_dtype(q.float()) == "f32"


def test_bound_ms_by_hand():
    assert kernel_work.bound_ms(3.35e9, 0) == (1.0, "bytes")
    assert kernel_work.bound_ms(0, 989e9) == (1.0, "operations")
    assert kernel_work.bound_ms(3.35e9, 67e9 * 2, "f32") == (2.0, "operations")


def test_kernel_functions_count_their_work_and_not_their_plain_version(monkeypatch):
    """Under the counter, `ftp_spmm_bsr` adds its `bsr_work` once and none
    of its plain version's aten ops; without a counter it runs as before."""
    args = _bsr_case()
    seen = []
    plain = ftp_spmm.ftp_spmm_bsr_plain

    def watched(*a, **kw):
        c = active_counter()
        before = (c.stats.n_ops, c.stats.bytes_accessed)
        out = plain(*a, **kw)
        seen.append(before == (c.stats.n_ops, c.stats.bytes_accessed))
        return out

    monkeypatch.setattr(ftp_spmm, "ftp_spmm_bsr_plain", watched)
    st = count(ftp_spmm.ftp_spmm_bsr, *args, bm=2, fuse_lif=True)
    assert seen == [True]
    assert st.kernels == {"ftp_bsr": {"calls": 1, "flops": 24, "bytes": 100}}
    assert (st.flops, st.bytes_accessed, st.n_ops) == (24, 100, 0)
    assert st.flops_by_dtype == {"bf16": 24}
    monkeypatch.setattr(ftp_spmm, "ftp_spmm_bsr_plain", plain)
    words, _ = ftp_spmm.ftp_spmm_bsr(*args, bm=2, fuse_lif=True)
    with OpCounter():
        counted, _ = ftp_spmm.ftp_spmm_bsr(*args, bm=2, fuse_lif=True)
    assert torch.equal(words, counted)
    meta = [t.to("meta") if isinstance(t, torch.Tensor) else t for t in args]
    with pytest.raises(ValueError, match="real tensors"):
        count(ftp_spmm.ftp_spmm_bsr, *meta, bm=2, fuse_lif=True)


def test_counted_smoke_main_path_counts_kernel_3_by_its_formula(monkeypatch):
    """The smoke main path (llama3.2-1b, spiking FFNs at density 0.3, the
    dual-sparse plans, ``infer``): a counted prefill calls kernel 3 twice a
    layer, each call counted by `bsr_work` on its own inputs and none of
    the plain version's ops; the same prefill counted again gives the same
    stats (the work is a function of the data)."""
    from repro_torch.launch.serve import build_config

    cfg = build_config("llama3_2_1b", smoke=True, spiking=True, weight_density=0.3)
    m = build_model(cfg)
    params = m.prepare(attach_spiking_ffn_plans(m.init(0, device="cpu"), cfg))
    tokens = torch.randint(0, cfg.vocab, (2, 16), generator=torch.Generator().manual_seed(0))
    works, clean = [], []
    entry, plain = kernel_work.bsr_work, ftp_spmm.ftp_spmm_bsr_plain

    def work(*a, **kw):
        works.append(entry(*a, **kw))
        return works[-1]

    def watched(*a, **kw):
        c = active_counter()
        before = c.stats.n_ops
        out = plain(*a, **kw)
        clean.append(c.stats.n_ops == before)
        return out

    monkeypatch.setattr(kernel_work, "bsr_work", work)
    monkeypatch.setattr(ftp_spmm, "ftp_spmm_bsr_plain", watched)

    def prefill():
        return m.prefill(params, {"tokens": tokens}, m.init_cache(2, 16, device="cpu"),
                         spiking_mode="infer")

    st = count(prefill)
    k3 = st.kernels["ftp_bsr"]
    assert k3["calls"] == 2 * cfg.n_layers == len(works) == len(clean)
    assert all(clean)
    assert k3["flops"] == sum(ops for _, ops in works) > 0
    assert k3["bytes"] == sum(nb for nb, _ in works)
    assert st.flops_by_dtype["bf16"] >= k3["flops"]
    again = count(prefill)
    assert (again.flops, again.bytes_accessed) == (st.flops, st.bytes_accessed)
    summary = attribution_summary(prefill)
    assert set(ATTRIBUTION_KEYS) <= set(summary)
    assert summary["arithmetic_intensity"] == pytest.approx(st.flops / st.bytes_accessed)
    assert summary["kernels"]["ftp_bsr"] == k3


# ---------------------------------------------------------------------------
# the roofline report and the dry run's record
# ---------------------------------------------------------------------------

def test_roofline_from_record_by_hand():
    rec = {"arch": "llama3_2_1b", "shape": "decode_32k", "device": H100,
           "op_stats": {"flops": 989e9 + 67e9,
                        "flops_by_dtype": {"bf16": 989e9, "f32": 67e9},
                        "bytes_accessed": 3 * 3.35e9, "collective_bytes": 0,
                        "bytes_by_shape": {"f32[4,8,4,32,32768]": 1e9}},
           "memory": {"total_bytes": 40 * 2**30}}
    r = roofline_from_record(rec)
    assert r["t_comp_s"] == pytest.approx(2e-3)      # 1 ms bf16 + 1 ms f32
    assert r["t_mem_s"] == pytest.approx(3e-3)
    assert r["t_coll_s"] == 0.0
    assert r["bottleneck"] == "memory"
    assert r["t_total_us"] == pytest.approx(3000.0)
    mf = 2.0 * get_config("llama3_2_1b").active_params() * 128
    assert r["model_flops_per_dev"] == mf == model_flops("llama3_2_1b", "decode_32k")
    assert r["roofline_fraction"] == pytest.approx(mf / 989e12 / 3e-3)
    assert r["score_bytes"] == 1e9
    assert r["t_mem_flash_s"] == pytest.approx((3 * 3.35e9 - 1e9) / 3.35e12)
    assert r["mem_gib"] == 40 and "fits80G=Y" in r["summary"]
    with pytest.raises(ValueError, match="no roofline numbers"):
        roofline_from_record(dict(rec, device="NVIDIA A100-SXM4-80GB"))
    assert parse_smi("NVIDIA H100 80GB HBM3, 700.00 W") == (H100, 700.0)
    assert device_peaks(H100)["power_limit_w"] == 700.0


def test_dryrun_writes_a_smoke_record(tmp_path):
    cfg = smoke_variant(get_config("llama3_2_1b"))
    cell = ShapeCell("decode_32k", 64, 8, "decode")
    rec = dryrun.run_cell("llama3_2_1b", "decode_32k", str(tmp_path), cfg=cfg, cell=cell)
    assert rec["ok"], rec.get("traceback")
    on_disk = json.loads((tmp_path / "llama3_2_1b__decode_32k__h100.json").read_text())
    assert set(on_disk) >= {"arch", "shape", "device", "n_devices", "ok", "count_s",
                            "memory", "op_stats", "fits", "points", "roofline"}
    assert set(on_disk["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes",
                                      "alias_bytes", "total_bytes"}
    assert set(on_disk["op_stats"]) >= {"flops", "bytes_accessed", "collective_bytes",
                                        "collectives", "n_collective_ops", "repeats",
                                        "bytes_by_shape", "flops_by_dtype", "kernels"}
    assert on_disk["device"] == H100 and on_disk["fits"] is True
    full = build_cell("llama3_2_1b", "decode_32k", cfg=cfg, cell=cell)
    want = count(full.fn, *full.args)
    assert on_disk["op_stats"]["flops"] == want.flops
    assert on_disk["op_stats"]["bytes_accessed"] == want.bytes_accessed
    # the in-place KV cache is an argument the output aliases
    assert on_disk["memory"]["alias_bytes"] > 0
    bad = dryrun.run_cell("llama3_2_1b", "decode_32k", str(tmp_path), cfg=cfg,
                          cell=cell, device="no such card")
    assert not bad["ok"] and "no such card" in bad["error"]
