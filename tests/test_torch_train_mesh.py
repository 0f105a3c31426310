"""The port's train mesh (`repro_torch.sharding`, the meshed
`train.step.make_train_step`, `ft.elastic.plan_mesh` / `reshard_state`,
`ckpt.restore_checkpoint(shardings=)`, `optim.compress.compressed_psum`,
the dry run's mesh records) against the JAX reference, on the CPU.

The port's mesh is a grid of logical devices in one process; here eight of
them map onto the CPU, as the reference's tests run on eight fake XLA host
devices (`tests/conftest.py`), which the reference's sharded step runs on
in this process (its module-global hooks are reset after each use).

Held:
* specs, exact: for every arch at full config, on the 16x16 and 2x16x16
  production meshes (stand-ins carrying their ``shape``: `spec_for` reads
  nothing else) and on ``plan_mesh(8, 2)`` / ``plan_mesh(4, 2)``, every
  leaf of the train state (params, AdamW or Adafactor state, ``ef_err``)
  has the reference's spec with its leading ``layers`` entry dropped (the
  port keeps per-layer lists); an Adafactor leaf the reference factors
  only because it stacks layers (a norm scale) is the port's unfactored
  ``v`` and carries the param's spec.  Fallback logs equal as sets,
  ``count_params`` equal, the hooks' specs the reference's;
* the meshed step at data=4 x model=2, three steps, each from the meshed
  run's own state against the one-device step from that state: within
  1e-5 relative on the loss and 1e-4 on the grad norm in f32 compute
  (measured at most 1.4e-7 and 6.3e-7: the sums reassociate, nothing
  else); in the archs' bf16 compute within 1e-4 and 1e-2, the bounds
  `tests/test_torch_train.py` holds the one-device port to against the
  reference run op by op (measured up to 1.7e-5 and 5.2e-3, rwkv6: a data
  group's weight gradient and a model shard's input gradient round to
  bf16 before they add, one device's once after); the spiking FFN's hidden
  spike flips counted against one device (0 in f32); a repeat of the
  meshed run bit for bit; pruned FFN weights stay 0;
* the meshed step against the reference's sharded step (its GSPMD run on
  plan_mesh(8, 2) of the fake devices) from the reference's bridged
  params, AdamW at a constant lr: per-step loss 2e-3 relative and grad
  norm 5e-2, `tests/test_torch_train.py`'s trajectory bounds against the
  jitted reference;
* elastic: the reference's cell (train at plan_mesh(8, 2), to the host,
  reshard onto plan_mesh(4, 2), one step), and a restore with
  ``shardings=`` equal bit for bit to the state and next loss;
* `compressed_psum` against the reference's shard_map cell;
* the dry run's per-device param bytes equal to the reference's specs'.
"""
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.data.pipeline import SyntheticLMData as JData
from repro.ft.elastic import plan_mesh as j_plan_mesh
from repro.models import layers as j_layers
from repro.models import transformer as j_transformer
from repro.models.registry import build_model as j_build
from repro.optim import get_optimizer as j_get_optimizer
from repro.optim.schedules import constant as j_constant
from repro.sharding import base_rules as j_base_rules
from repro.sharding import count_params as j_count_params
from repro.sharding import make_qkv_hook as j_make_qkv_hook
from repro.sharding import make_shard_hook as j_make_shard_hook
from repro.sharding import spec_for as j_spec_for
from repro.sharding import tree_shardings as j_tree_shardings
from repro.train.step import init_train_state as j_init_train_state
from repro.train.step import make_train_step as j_make_train_step
from repro.train.step import train_state_axes as j_train_state_axes
from repro_torch import bridge
from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import ARCHS, get_config, smoke_variant
from repro_torch.core import snn_layers as t_snn
from repro_torch.data import SyntheticLMData, batch_to_torch
from repro_torch.ft.elastic import plan_mesh, reshard_state
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import LogicalDevice, data_groups, make_production_mesh
from repro_torch.launch.specs import _params
from repro_torch.models.registry import build_model
from repro_torch.optim import get_optimizer
from repro_torch.optim.compress import compressed_psum
from repro_torch.optim.schedules import constant
from repro_torch.sharding import (
    base_rules,
    count_params,
    device_bytes,
    make_qkv_hook,
    make_shard_hook,
    spec_for,
    tree_shardings,
)
from repro_torch.train import init_train_state
from repro_torch.train.step import make_train_step, train_state_axes
from repro_torch.tree import tree_leaves, tree_map, tree_paths

torch.set_num_threads(1)

CPU8 = [LogicalDevice(i, torch.device("cpu")) for i in range(8)]
SPIKING = dict(spiking_ffn=True, spiking_T=4, spiking_weight_density=0.3)
_LIF = t_snn.lif_forward

# the four meshes of the spec test, by their shape (`spec_for` reads only it)
MESH_SHAPES = {
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
    "4x2": {"data": 4, "model": 2},
    "2x2": {"data": 2, "model": 2},
}


@pytest.fixture
def reference_hooks():
    """The reference's module-global hooks, reset to the identity after the
    test, so that no other test in the worker sees them."""
    yield
    j_transformer.set_shard_hook(lambda x, name: x)
    j_layers.set_qkv_hook(lambda t: t)


def test_meshes_match_reference():
    """plan_mesh's shapes and axes (with and without a pod axis) and the
    production meshes' equal the reference's; a serve mesh folds the pod
    axis into data."""
    from repro.ft.elastic import plan_serve_mesh as j_plan_serve_mesh
    from repro_torch.ft.elastic import plan_serve_mesh

    for n, mp in ((8, 2), (4, 2), (8, 1), (8, 8)):
        want = j_plan_mesh(n, model_parallel=mp)
        got = plan_mesh(n, mp, devices=CPU8[:n])
        assert got.shape == dict(want.shape) and got.axis_names == want.axis_names
    devs = [LogicalDevice(i, torch.device("cpu")) for i in range(512)]
    big = plan_mesh(512, 16, devices=devs)
    assert big.axis_names == ("pod", "data", "model")
    assert big.shape == {"pod": 2, "data": 16, "model": 16} and big.n_rows == 32
    assert plan_mesh(256, 16, devices=devs[:256]).shape == MESH_SHAPES["16x16"]
    assert plan_serve_mesh(devs, 16).shape == {"data": 32, "model": 16}
    assert j_plan_serve_mesh(jax.devices()[:8], 2).shape == dict(
        plan_serve_mesh(CPU8, 2).shape)
    for multi, name in ((False, "16x16"), (True, "2x16x16")):
        m = make_production_mesh(multi_pod=multi, device="meta")
        assert m.shape == MESH_SHAPES[name] and m.lead == torch.device("meta")
    assert data_groups(big, 64)[1] == (1, slice(2, 4))
    assert data_groups(big, 33) == [(0, slice(0, 33))]
    with pytest.raises(ValueError, match="divide"):
        plan_mesh(8, 3, devices=CPU8)


# ---------------------------------------------------------------------------
# specs, exact
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _full_states(arch):
    """(reference state shapes and axes, port meta state and axes) of the
    arch's full config, with the int8 error-feedback buffer."""
    jm = j_build(j_get_config(arch))
    jshapes = jax.eval_shape(
        lambda: j_init_train_state(jm, jax.random.PRNGKey(0), grad_compress=True))
    jaxes = j_train_state_axes(jm, grad_compress=True)
    cfg = get_config(arch)
    model = build_model(cfg)
    state = _meta_state(model, _params(model, torch.device("meta")))
    return (jshapes, jaxes), (state, train_state_axes(model, grad_compress=True)), model


def _meta_state(model, params):
    from repro_torch.optim.compress import ErrorFeedbackInt8
    from repro_torch.train.step import default_optimizer

    return {"params": params, "opt": default_optimizer(model.cfg).init(params),
            "step": torch.zeros((), dtype=torch.int32, device="meta"),
            "ef_err": ErrorFeedbackInt8().init(params)}


def _ref_specs(shapes, axes, rules, mesh, log, path=""):
    """{path: (spec tuple, stacked)} of the reference's state."""
    if isinstance(shapes, dict):
        out = {}
        for k in shapes:
            out.update(_ref_specs(shapes[k], axes[k], rules, mesh, log, f"{path}.{k}"))
        return out
    spec = tuple(j_spec_for(shapes.shape, axes, rules, mesh, log))
    return {path: (spec, axes[:1] == ("layers",))}


def _port_specs(tree, shardings, path=""):
    """{path with list indices dropped: set of specs} of the port's state."""
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            for p, s in _port_specs(tree[k], shardings[k], f"{path}.{k}").items():
                out.setdefault(p, set()).update(s)
        return out
    if isinstance(tree, list):
        out = {}
        for t, s in zip(tree, shardings):
            for p, v in _port_specs(t, s, path).items():
                out.setdefault(p, set()).update(v)
        return out
    return {path: {shardings.spec}}


def _drop(spec):
    """A JAX spec entry as the port writes it (a tuple of one axis is that
    axis)."""
    return tuple(e if not (isinstance(e, tuple) and len(e) == 1) else e[0]
                 for e in spec)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_state_specs_equal_reference(arch):
    (jshapes, jaxes), (state, axes), model = _full_states(arch)
    cfg = model.cfg
    assert count_params(state["params"]) == j_count_params(jshapes["params"])
    rules, jrules = base_rules(cfg.fsdp), j_base_rules(cfg.fsdp)
    assert rules == jrules
    for name, shape in MESH_SHAPES.items():
        mesh = types.SimpleNamespace(shape=shape)
        jlog, log = [], []
        want = _ref_specs(jshapes, jaxes, jrules, mesh, jlog)
        got = _port_specs(state, tree_shardings(state, axes, mesh, rules, log))
        assert set(log) == set(jlog), (name, set(log) ^ set(jlog))
        matched = set()
        for path, specs in got.items():
            assert len(specs) == 1, (name, path, specs)  # every layer alike
            spec = specs.pop()
            if path in want:
                ref, stacked = want[path]
                matched.add(path)
            else:
                # an Adafactor leaf factored in the reference only because
                # it stacks layers: the port's unfactored v has the param's
                # axes
                assert path.startswith(".opt.v.") and path.endswith(".v"), path
                assert path[:-2] + ".vr" in want, path
                matched.update({path[:-2] + ".vr", path[:-2] + ".vc"})
                ref, stacked = want[".params." + path[len(".opt.v."):-2]]
            assert spec == _drop(ref[1:] if stacked else ref), (name, path)
        assert matched == set(want), (name, set(want) - matched)


@pytest.mark.parametrize("arch", ARCHS)
def test_hook_specs_equal_reference(arch, reference_hooks):
    """The hooks record the reference's spec for the same shape (the
    reference's own hooks run under jit on the 4x2 and 2x2 meshes of the
    fake devices; on the production meshes its rule, `spec_for`, with the
    applicability test of `make_qkv_hook`)."""
    cfg = get_config(arch)
    B, S = 64, 4096
    H = cfg.n_heads or cfg.ssm_heads
    shapes4 = [(B, S, H, cfg.head_dim), (B, S, max(cfg.n_kv, 1), cfg.head_dim)]
    rules = base_rules(cfg.fsdp)
    for name, shape in MESH_SHAPES.items():
        mesh = types.SimpleNamespace(shape=shape)
        sh, qkv = make_shard_hook(mesh, rules), make_qkv_hook(mesh, rules)
        x = torch.empty((B, S, cfg.d_model), device="meta")
        assert sh(x, "residual") is x and sh(x, "other") is x
        for s4 in shapes4:
            qkv(torch.empty(s4, device="meta"))
        want = [((B, S, cfg.d_model), tuple(j_spec_for(
            (B, S, cfg.d_model), ("batch", "seq", "act_d"), rules, mesh)))]
        want += [(s4, tuple(j_spec_for(s4, ("batch", None, "heads", None),
                                       rules, mesh)))
                 for s4 in shapes4 if s4[2] % shape["model"] == 0]
        got = sh.log + qkv.log
        assert [(s, _drop(sp)) for s, sp in want] == got, (name, got)
    # the reference's own hooks on real device meshes (small shapes)
    for n, mp in ((8, 2), (4, 2)):
        jmesh = j_plan_mesh(n, model_parallel=mp)
        mesh = plan_mesh(n, mp, devices=CPU8[:n])
        jsh, jqkv = j_make_shard_hook(jmesh, rules), j_make_qkv_hook(jmesh, rules)
        sh, qkv = make_shard_hook(mesh, rules), make_qkv_hook(mesh, rules)
        for s in ((8, 16, 32), (8, 16, 4, 16), (8, 16, 1, 16)):
            x = jnp.zeros(s, jnp.float32)
            with jmesh:
                out = (jax.jit(lambda t: jsh(t, "residual"))(x) if len(s) == 3
                       else jax.jit(jqkv)(x))
            t = torch.zeros(s)
            (sh(t, "residual") if len(s) == 3 else qkv(t))
            log = sh.log if len(s) == 3 else qkv.log
            applies = len(s) == 3 or s[2] % mp == 0
            if applies:
                assert log[-1] == (s, _drop(tuple(out.sharding.spec)) + (None,) * (
                    len(s) - len(out.sharding.spec))), (n, s, log[-1], out.sharding)
            else:
                assert all(e[0] != s for e in log)


@pytest.mark.parametrize("arch", ARCHS)
def test_dryrun_param_bytes_equal_reference_specs(arch):
    """Per-device param bytes on both production meshes (the dry run's
    `mesh_memory` sums each leaf's part) equal the bytes the reference's
    specs give its params, and the train cell's mesh record holds them."""
    (jshapes, jaxes), (state, axes), model = _full_states(arch)
    rules = base_rules(model.cfg.fsdp)
    for multi, name in ((False, "16x16"), (True, "2x16x16")):
        mesh = make_production_mesh(multi_pod=multi, device="meta")
        got = device_bytes(state["params"], tree_shardings(
            state["params"], axes["params"], mesh, rules))
        want = 0
        for leaf, ax in zip(jax.tree.leaves(jshapes["params"]),
                            jax.tree.leaves(jaxes["params"],
                                            is_leaf=lambda a: isinstance(a, tuple))):
            spec = j_spec_for(leaf.shape, ax, rules, mesh)
            n = 1
            for e in spec:
                for a in ((e,) if isinstance(e, str) else (e or ())):
                    n *= mesh.shape[a]
            want += int(np.prod(leaf.shape)) // n * leaf.dtype.itemsize
        assert got == want, (name, got, want)
        per, log = dryrun.mesh_memory(arch, "train_4k", mesh)
        assert per["state"] > got and per["batch"] > 0


# ---------------------------------------------------------------------------
# the meshed step
# ---------------------------------------------------------------------------

CASES = [("llama3_2_1b", "dense"), ("llama3_2_1b", "spiking")] + [
    (a, "dense") for a in ARCHS if a != "llama3_2_1b"]


def _cfg(arch, kind, **kw):
    extra = dict(SPIKING) if kind == "spiking" else {}
    return dataclasses.replace(smoke_variant(get_config(arch)), **extra, **kw)


def _spikes_by_layer(record, n_layers, groups, shards):
    """Recorded hidden spikes (T, rows, units) of one forward, per layer:
    one device records layer by layer; a meshed forward group by group,
    each layer's model shards in order."""
    if groups == shards == 1:
        return record
    per = n_layers * shards
    out = []
    for li in range(n_layers):
        rows = [torch.cat(record[g * per + li * shards:g * per + (li + 1) * shards],
                          dim=-1) for g in range(groups)]
        out.append(torch.cat(rows, dim=1))
    return out


def _run_pair(cfg, steps=3, seed=0, monkeypatch=None):
    """The meshed run at 4 x 2 and, from each of its states, the one-device
    step: [(meshed metrics, one-device metrics, spike flips, spikes)], the
    meshed run's states."""
    model = build_model(cfg)
    data = SyntheticLMData(cfg, seq_len=32, global_batch=8)
    mesh = plan_mesh(8, 2, devices=CPU8)
    state = reshard_state(init_train_state(model, seed, device="cpu"),
                          train_state_axes(model), mesh, base_rules(cfg.fsdp))
    one, meshed = make_train_step(model), make_train_step(model, mesh=mesh)
    out, states, rec = [], [state], []
    if monkeypatch is not None and cfg.spiking_ffn:
        def recorded(o, **kw):
            spikes, u = _LIF(o, **kw)
            rec.append(spikes.detach())
            return spikes, u

        monkeypatch.setattr(t_snn, "lif_forward", recorded)
    for s in range(steps):
        batch = batch_to_torch(data.batch(s), "cpu")
        flips = spikes = 0
        if cfg.spiking_ffn and monkeypatch is not None:
            from repro_torch.train.step import meshed_loss_and_grads

            with torch.no_grad():
                rec.clear()
                model.loss(state["params"], batch)
                a = list(rec)
                rec.clear()
                meshed_loss_and_grads(model, state["params"], batch, mesh,
                                      need_grads=False)
                b = _spikes_by_layer(list(rec), cfg.n_layers, 4, 2)
            flips = sum(int((x != y).sum()) for x, y in zip(a, b))
            spikes = sum(int(x.sum()) for x in a)
        _, m1 = one(state, batch)
        state, mm = meshed(state, batch)
        states.append(state)
        out.append((mm, m1, flips, spikes))
    return out, states


@pytest.mark.parametrize("arch,kind", CASES)
def test_meshed_step_matches_one_device(arch, kind, monkeypatch):
    # f32 compute: the meshed step is one device's up to reassociation
    f32, _ = _run_pair(_cfg(arch, kind, compute_dtype="float32"),
                       monkeypatch=monkeypatch)
    for s, (mm, m1, flips, spikes) in enumerate(f32):
        np.testing.assert_allclose(float(mm["loss"]), float(m1["loss"]),
                                   rtol=1e-5, err_msg=f"f32 step {s}")
        np.testing.assert_allclose(float(mm["grad_norm"]), float(m1["grad_norm"]),
                                   rtol=1e-4, err_msg=f"f32 step {s}")
        assert flips <= 0.02 * max(spikes, 1), (s, flips, spikes)
    # the arch's own bf16 compute
    cfg = _cfg(arch, kind)
    bf16, states = _run_pair(cfg, monkeypatch=monkeypatch)
    for s, (mm, m1, flips, spikes) in enumerate(bf16):
        np.testing.assert_allclose(float(mm["loss"]), float(m1["loss"]),
                                   rtol=1e-4, err_msg=f"bf16 step {s}")
        np.testing.assert_allclose(float(mm["grad_norm"]), float(m1["grad_norm"]),
                                   rtol=1e-2, err_msg=f"bf16 step {s}")
        assert flips <= 0.02 * max(spikes, 1), (s, flips, spikes)
    if kind == "spiking":
        assert sum(f[3] for f in bf16) > 0
    # a repeat of the meshed run is bit for bit
    again, states2 = _run_pair(cfg)
    for (a, _, _, _), (b, _, _, _) in zip(bf16, again):
        assert torch.equal(a["loss"], b["loss"])
        assert torch.equal(a["grad_norm"], b["grad_norm"])
    for a, b in zip(tree_leaves(states[-1]), tree_leaves(states2[-1])):
        assert torch.equal(a, b)
    # pruned FFN weights stay 0 (the LTH prune-once contract)
    if kind == "spiking":
        before = dict(tree_paths(states[0]["params"]))
        after = dict(tree_paths(states[-1]["params"]))
        for p, w0 in before.items():
            if p.endswith(("mlp/wu", "mlp/wd")):
                pruned = w0 == 0
                assert float(pruned.float().mean()) > 0.6
                assert torch.equal(after[p][pruned], torch.zeros_like(after[p][pruned]))


def _ref_runs(jcfg, batches, jopt, n=8, mp=2):
    """The reference's sharded step on plan_mesh(n, mp) of the fake devices
    (its integration test's recipe) and its one-device jitted step, from
    one state: (that state on the host, the sharded run's metrics per step,
    the one-device run's)."""
    jm = j_build(jcfg)
    mesh = j_plan_mesh(n, model_parallel=mp)
    rules = j_base_rules(jcfg.fsdp)
    jstate = j_init_train_state(jm, jax.random.PRNGKey(0), optimizer=jopt)
    host = jax.tree.map(np.asarray, jstate)
    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    single, one = jax.jit(j_make_train_step(jm, optimizer=jopt)), []
    state = jstate
    for b in jb:
        state, m = single(state, b)
        one.append({k: float(v) for k, v in m.items()})
    j_transformer.set_shard_hook(j_make_shard_hook(mesh, rules))
    j_layers.set_qkv_hook(j_make_qkv_hook(mesh, rules))
    shapes = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), jstate)
    sh = j_tree_shardings(shapes, j_train_state_axes(jm), mesh, rules)
    placed = jax.tree.map(lambda a, s: jax.device_put(jnp.asarray(a), s), host, sh)
    step = jax.jit(j_make_train_step(jm, optimizer=jopt))
    sharded = []
    with mesh:
        for b in jb:
            placed, m = step(placed, b)
            sharded.append({k: float(v) for k, v in m.items()})
    return host, sharded, one


@pytest.mark.parametrize("arch,kind", CASES)
def test_meshed_step_matches_reference_sharded(arch, kind, reference_hooks):
    """Per step within 2e-3 (loss) and 5e-2 (grad norm) of the reference's
    sharded run, or, where the reference's own sharded and one-device runs
    are farther apart than that (rwkv6 by step 2: 43% on the grad norm, its
    trajectory at lr 3e-3 is that sensitive), within that distance, as
    `tests/test_torch_archs.py` widens nemotron's bound to the reference's
    own spread.  Every arch on AdamW, so the reference's and the port's
    states bridge (an Adafactor arch's own optimizer runs in the test
    against one device)."""
    from repro.configs import smoke_variant as j_smoke_variant

    extra = dict(SPIKING) if kind == "spiking" else {}
    jcfg = dataclasses.replace(j_smoke_variant(j_get_config(arch)),
                               optimizer="adamw", **extra)
    batches = [JData(jcfg, seq_len=32, global_batch=8).batch(s) for s in range(3)]
    host, want, own = _ref_runs(jcfg, batches,
                                j_get_optimizer("adamw", j_constant(3e-3)))
    cfg = _cfg(arch, kind, optimizer="adamw")
    model = build_model(cfg)
    mesh = plan_mesh(8, 2, devices=CPU8)
    state = reshard_state(bridge.train_state_from_reference(host),
                          train_state_axes(model), mesh, base_rules(cfg.fsdp))
    step = make_train_step(model, get_optimizer("adamw", constant(3e-3)), mesh=mesh)
    for s, b in enumerate(batches):
        state, m = step(state, batch_to_torch(b, "cpu"))
        for key, bound in (("loss", 2e-3), ("grad_norm", 5e-2)):
            spread = abs(own[s][key] - want[s][key]) / abs(want[s][key])
            np.testing.assert_allclose(float(m[key]), want[s][key],
                                       rtol=max(bound, spread),
                                       err_msg=f"step {s} {key}")


def test_moe_routing_over_the_whole_batch():
    """An MoE arch's data groups route the whole batch at once: the dropped
    (token, k) pairs are one device's (a group routing its own rows alone
    gets another capacity and drops others)."""
    from repro_torch.models.layers import record_moe_routing
    from repro_torch.train.step import meshed_loss_and_grads

    cfg = _cfg("phi3_5_moe", "dense", capacity_factor=0.5)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    batch = batch_to_torch(SyntheticLMData(cfg, 32, 8).batch(0), "cpu")
    mesh = plan_mesh(8, 2, devices=CPU8)
    with torch.no_grad():
        with record_moe_routing() as one:
            want = model.loss(params, batch)
        with record_moe_routing() as meshed:
            got, _ = meshed_loss_and_grads(model, params, batch, mesh,
                                           need_grads=False)
        with record_moe_routing() as alone:
            model.loss(params, {k: v[:2] for k, v in batch.items()})
    assert len(one) == len(meshed) == cfg.n_layers
    drops = [int((~k).sum()) for k in one]
    assert min(drops) > 0, drops
    for a, b in zip(one, meshed):
        assert torch.equal(a, b)
    assert not torch.equal(alone[0], one[0][:alone[0].shape[0]])
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_meshed_step_with_grad_compression():
    """The int8 error-feedback compression on the mesh: its per-tensor max
    is taken over the whole leaf, so each step (f32 compute, from the
    meshed run's state) is the one-device step's within 1e-5 / 1e-4, and
    the error buffer is placed like the params."""
    cfg = _cfg("llama3_2_1b", "dense", compute_dtype="float32")
    model = build_model(cfg)
    data = SyntheticLMData(cfg, seq_len=32, global_batch=8)
    mesh = plan_mesh(8, 2, devices=CPU8)
    axes = train_state_axes(model, grad_compress=True)
    state = reshard_state(init_train_state(model, 0, grad_compress=True,
                                           device="cpu"), axes, mesh, base_rules())
    assert axes["ef_err"] == axes["params"]
    one = make_train_step(model, grad_compress=True)
    meshed = make_train_step(model, grad_compress=True, mesh=mesh)
    for s in range(3):
        batch = batch_to_torch(data.batch(s), "cpu")
        a, m1 = one(state, batch)
        state, m = meshed(state, batch)
        np.testing.assert_allclose(float(m["loss"]), float(m1["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), float(m1["grad_norm"]),
                                   rtol=1e-4)
    assert any(float(e.abs().max()) > 0 for e in tree_leaves(state["ef_err"]))


def test_meshed_step_runs_the_hooks():
    """The residual and qkv hooks, installed as the reference's tests
    install theirs, fire in the meshed step at the reference's sites (every
    block's residual, the fresh q / k / v), record the spec of the shape
    they see, and change nothing (the step equals the one without them,
    bit for bit)."""
    from repro_torch.models import layers as t_layers
    from repro_torch.models import transformer as t_transformer

    cfg = _cfg("llama3_2_1b", "dense")
    model = build_model(cfg)
    mesh = plan_mesh(8, 2, devices=CPU8)
    rules = base_rules()
    state = reshard_state(init_train_state(model, 0, device="cpu"),
                          train_state_axes(model), mesh, rules)
    batch = batch_to_torch(SyntheticLMData(cfg, 32, 8).batch(0), "cpu")
    step = make_train_step(model, mesh=mesh)
    _, want = step(state, batch)
    res, qkv = make_shard_hook(mesh, rules), make_qkv_hook(mesh, rules)
    t_transformer.set_shard_hook(res)
    t_layers.set_qkv_hook(qkv)
    try:
        _, got = step(state, batch)
    finally:
        t_transformer.reset_shard_hook()
        t_layers.reset_qkv_hook()
    assert torch.equal(got["loss"], want["loss"])
    assert torch.equal(got["grad_norm"], want["grad_norm"])
    # per group: the embedding and two residuals a layer, in the forward
    # and again in each layer's remat recompute
    assert len(res.log) >= 4 * (1 + 2 * cfg.n_layers)
    assert {s for s, _ in res.log} == {(2, 32, cfg.d_model)}
    assert all(sp == spec_for(s, ("batch", "seq", "act_d"), rules, mesh)
               for s, sp in res.log)
    assert qkv.log and all(
        sp == spec_for(s, ("batch", None, "heads", None), rules, mesh)
        for s, sp in qkv.log)
    x = torch.zeros(2, 3, 4)
    assert t_transformer._shard_hook(x, "residual") is x
    assert t_layers._qkv_hook(x) is x


# ---------------------------------------------------------------------------
# elastic re-shard, restore with shardings, compressed psum
# ---------------------------------------------------------------------------

def test_elastic_reshard_and_restore_with_shardings(tmp_path):
    """The reference's cell (`test_multidevice_sharded_training_and_elastic_
    rescale`): 4 steps at plan_mesh(8, 2), the state to the host, reshard
    onto plan_mesh(4, 2), one step.  A checkpoint restored with the 4x2
    shardings is the resharded state, and its next step the same, bit for
    bit."""
    cfg = dataclasses.replace(_cfg("llama3_2_1b", "dense"), n_layers=2,
                              d_model=64, d_ff=128, n_heads=4, n_kv=2)
    model = build_model(cfg)
    data = SyntheticLMData(cfg, seq_len=32, global_batch=8)
    rules = base_rules()
    axes = train_state_axes(model)
    mesh8 = plan_mesh(8, 2, devices=CPU8)
    state = reshard_state(init_train_state(model, 0, device="cpu"), axes, mesh8, rules)
    step8 = make_train_step(model, mesh=mesh8)
    for i in range(4):
        state, m = step8(state, batch_to_torch(data.batch(i), "cpu"))
    assert np.isfinite(float(m["loss"]))
    host = tree_map(lambda t: t.detach().cpu().clone(), state)
    mesh4 = plan_mesh(4, 2, devices=CPU8[:4])
    state4 = reshard_state(host, axes, mesh4, rules)
    step4 = make_train_step(model, mesh=mesh4)
    mgr = CheckpointManager(str(tmp_path), interval=1, async_save=False)
    mgr.maybe_save(4, state4, force=True)
    sh4 = tree_shardings(state4, axes, mesh4, rules)
    restored, at = mgr.restore_latest(init_train_state(model, 1, device="cpu"),
                                      shardings=sh4)
    assert at == 4
    for a, b in zip(tree_leaves(state4), tree_leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    batch = batch_to_torch(data.batch(4), "cpu")
    s_a, m_a = step4(state4, batch)
    s_b, m_b = step4(restored, batch)
    assert np.isfinite(float(m_a["loss"]))
    assert torch.equal(m_a["loss"], m_b["loss"])
    for a, b in zip(tree_leaves(s_a), tree_leaves(s_b)):
        assert torch.equal(a, b)
    # each device's part of a placed leaf is a view of it: no state twice
    wq = state4["params"]["layers"][0]["attn"]["wq"]
    parts = sh4["params"]["layers"][0]["attn"]["wq"].parts(wq)
    assert len(parts) == 4 and all(
        p.untyped_storage().data_ptr() == wq.untyped_storage().data_ptr()
        for p in parts.values())
    assert {tuple(p.shape) for p in parts.values()} == {(64, 32)}


def test_compressed_psum_matches_reference():
    """The reference's shard_map cell (x = arange(64) / 7 over 4 devices):
    within its atol of max|mean| / 100, and bit for bit the reference's
    output (both quantise the same values against the same scale)."""
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh as JMesh
    from jax.sharding import PartitionSpec as P

    from repro.optim.compress import compressed_psum as j_compressed_psum

    x = np.arange(64, dtype=np.float32).reshape(4, 16) / np.float32(7.0)
    jmesh = JMesh(np.asarray(jax.devices()[:4]), ("data",))
    f = shard_map(lambda g: j_compressed_psum(g[0], "data")[None], mesh=jmesh,
                  in_specs=P("data", None), out_specs=P("data", None))
    want = np.asarray(f(jnp.asarray(x)))
    got = compressed_psum([torch.from_numpy(x[i]) for i in range(4)])
    assert len(got) == 4
    mean = x.mean(0)
    for i, g in enumerate(got):
        assert np.allclose(g.numpy(), mean, atol=np.abs(mean).max() / 100)
        np.testing.assert_array_equal(g.numpy(), want[i])
    with pytest.raises(IndexError):
        compressed_psum([])


@pytest.mark.parametrize("mesh_flag", ["host", "none"])
def test_train_cli_mesh_flag_trains(mesh_flag, capsys):
    """``--mesh host`` is parsed and, as in the reference, trains as
    ``--mesh none`` does."""
    from repro_torch.launch import train as train_cli

    args = ["--arch", "llama3_2_1b", "--smoke", "--device", "cpu", "--steps", "2",
            "--batch", "2", "--seq", "16", "--log-every", "1"]
    assert train_cli.main(args + ["--mesh", mesh_flag]) == 0
    out = capsys.readouterr().out
    assert train_cli.main(args) == 0
    assert capsys.readouterr().out == out
