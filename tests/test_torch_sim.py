"""The port's cycle / energy simulator (`repro_torch.sim`) and Table II
workloads (`repro_torch.configs.snn_workloads`) against the reference's,
in the same process.

Both are numpy models of the LoAS ASIC and its baselines; the port keeps
its own copy (it imports nothing of `repro`).  Every number must be EQUAL,
not close: the same float operations in the same order.  The networks'
per-layer sparsities are jittered from ``hash(name)``, which Python
randomizes per process, so the two packages agree within one process only
(which is where this file compares them); the Table II averages they are
renormalized to hold in every process.
"""
import dataclasses

import pytest

from repro.configs import snn_workloads as j_wl
from repro.sim import dense_snn as j_dense
from repro.sim import energy as j_energy
from repro.sim import gamma as j_gamma
from repro.sim import gospa as j_gospa
from repro.sim import loas as j_loas
from repro.sim import runner as j_runner
from repro.sim import sparten as j_sparten
from repro.sim import workloads as j_work
from repro_torch.configs import snn_workloads as t_wl
from repro_torch.sim import dense_snn as t_dense
from repro_torch.sim import energy as t_energy
from repro_torch.sim import gamma as t_gamma
from repro_torch.sim import gospa as t_gospa
from repro_torch.sim import loas as t_loas
from repro_torch.sim import runner as t_runner
from repro_torch.sim import sparten as t_sparten
from repro_torch.sim import workloads as t_work

LAYERS = tuple(j_work.TABLE_II_LAYERS)
NETWORKS = j_work.NETWORKS


def _res(r) -> dict:
    """A SimResult as a plain dict (its fields and derived totals)."""
    return dict(dataclasses.asdict(r), dram_total=r.dram_total,
                energy_total=r.energy_total)


def _layer(l) -> dict:
    return dataclasses.asdict(l)


def test_public_names_match():
    import repro.sim as j_sim
    import repro_torch.sim as t_sim

    assert t_sim.__all__ == j_sim.__all__
    assert t_runner.DESIGNS == j_runner.DESIGNS
    assert t_work.NETWORKS == j_work.NETWORKS
    assert t_work.TABLE_II_LAYERS == j_work.TABLE_II_LAYERS
    assert t_wl.SNN_WORKLOADS == j_wl.SNN_WORKLOADS


def test_hw_and_energy_configs_equal():
    assert dataclasses.asdict(t_runner.HwConfig()) == dataclasses.asdict(
        j_runner.HwConfig())
    assert dataclasses.asdict(t_energy.EnergyModel()) == dataclasses.asdict(
        j_energy.EnergyModel())
    assert t_runner.HwConfig().dram_bytes_per_cycle == \
        j_runner.HwConfig().dram_bytes_per_cycle


@pytest.mark.parametrize("T", [1, 2, 4, 8, 16, 32])
def test_tppe_area_power_equal(T):
    assert t_energy.tppe_area_power(T) == j_energy.tppe_area_power(T)


@pytest.mark.parametrize("name", LAYERS)
def test_get_layer_equal(name):
    assert _layer(t_work.get_layer(name)) == _layer(j_work.get_layer(name))
    assert t_work.get_layer(name).fire_rate_nonsilent == \
        j_work.get_layer(name).fire_rate_nonsilent


@pytest.mark.parametrize("name", NETWORKS)
def test_get_network_equal(name):
    t, j = t_work.get_network(name), j_work.get_network(name)
    assert t.name == j.name and len(t.layers) == len(j.layers)
    assert [_layer(l) for l in t.layers] == [_layer(l) for l in j.layers]
    assert t.totals() == j.totals()


@pytest.mark.parametrize("name", NETWORKS + LAYERS)
def test_snn_workloads_equal(name):
    assert t_wl.as_gemm_shapes(name) == j_wl.as_gemm_shapes(name)
    t, j = t_wl.get_snn_workload(name), j_wl.get_snn_workload(name)
    assert type(t).__name__ == type(j).__name__


def test_unknown_workload_raises():
    with pytest.raises(KeyError, match="unknown SNN workload"):
        t_wl.get_snn_workload("lenet")


def test_table_ii_layer_shapes_exact():
    """The four single-layer rows at Table II's exact (T, M, N, K)."""
    assert [t_wl.as_gemm_shapes(n)[0] for n in LAYERS] == [
        (4, 64, 256, 3456), (4, 16, 512, 2304), (4, 16, 512, 2304),
        (4, 784, 3072, 3072)]


@pytest.mark.parametrize("name", NETWORKS)
def test_network_averages_hold_table_ii(name):
    """The MAC-weighted averages equal Table II's in every process (the
    jitter is renormalized away)."""
    sp_a, silent, _, sp_b = {"alexnet": (81.2, 71.3, 76.7, 98.2),
                             "vgg16": (82.3, 74.1, 79.6, 98.2),
                             "resnet19": (68.6, 59.6, 66.1, 96.8)}[name]
    net = t_work.get_network(name)
    w = [l.T * l.M * l.N * l.K for l in net.layers]
    tot = sum(w)
    avg = lambda f: sum(wi * f(l) for wi, l in zip(w, net.layers)) / tot
    assert avg(lambda l: l.d_a) == pytest.approx(1 - sp_a / 100, abs=0.02)
    assert avg(lambda l: l.ns) == pytest.approx(1 - silent / 100, abs=0.02)
    assert avg(lambda l: l.d_b) == pytest.approx(1 - sp_b / 100, abs=0.01)


@pytest.mark.parametrize("name", LAYERS)
@pytest.mark.parametrize("design", j_runner.DESIGNS)
def test_run_layer_equal(design, name):
    assert _res(t_runner.run_layer(design, name)) == _res(
        j_runner.run_layer(design, name))


@pytest.mark.parametrize("name", NETWORKS)
@pytest.mark.parametrize("design", j_runner.DESIGNS)
def test_run_design_equal(design, name):
    assert _res(t_runner.run_design(design, name)) == _res(
        j_runner.run_design(design, name))


def test_speedup_energy_table_equal():
    assert t_runner.speedup_energy_table() == j_runner.speedup_energy_table()


def test_dense_snn_table_equal():
    assert t_runner.dense_snn_table() == j_runner.dense_snn_table()


def test_snn_vs_ann_table_equal():
    assert t_runner.snn_vs_ann_table() == j_runner.snn_vs_ann_table()


@pytest.mark.parametrize("name", LAYERS)
def test_per_design_layer_costs_equal(name):
    """The layer models beside the runner's: ANN baselines, the dense
    systolic arrays on the densified layer, GoSPA at T = 1, LoAS with and
    without preprocessing."""
    hw_t, hw_j = t_runner.HwConfig(), j_runner.HwConfig()
    lt, lj = t_work.get_layer(name), j_work.get_layer(name)
    pairs = [
        (t_sparten.layer_cost_ann(lt, hw_t), j_sparten.layer_cost_ann(lj, hw_j)),
        (t_gamma.layer_cost_ann(lt, hw_t), j_gamma.layer_cost_ann(lj, hw_j)),
        (t_gospa.layer_cost(dataclasses.replace(lt, T=1), hw_t),
         j_gospa.layer_cost(dataclasses.replace(lj, T=1), hw_j)),
        (t_loas.layer_cost(lt, hw_t, preprocessed=True),
         j_loas.layer_cost(lj, hw_j, preprocessed=True)),
        (t_dense.ptb_layer_cost(t_dense.densify(lt), hw_t),
         j_dense.ptb_layer_cost(j_dense.densify(lj), hw_j)),
        (t_dense.stellar_layer_cost(t_dense.densify(lt), hw_t),
         j_dense.stellar_layer_cost(j_dense.densify(lj), hw_j)),
    ]
    for t, j in pairs:
        assert _res(t) == _res(j)


def test_paper_orderings_hold_on_the_port():
    """Fig. 12's orderings on the port's own table: LoAS-FT fastest, the
    baselines' average speedups ordered SparTen > GoSPA > Gamma, and the
    preprocessing's gain ~20 %."""
    table = t_runner.speedup_energy_table()
    avg = {d: sum(r[d]["cycles"] / r["loas-ft"]["cycles"] for r in table.values())
           / len(table) for d in ("sparten-snn", "gospa-snn", "gamma-snn")}
    for row in table.values():
        for d in avg:
            assert row[d]["cycles"] > row["loas-ft"]["cycles"]
    assert avg["sparten-snn"] > avg["gospa-snn"] > avg["gamma-snn"]
    gain = sum(r["loas"]["cycles"] / r["loas-ft"]["cycles"]
               for r in table.values()) / len(table)
    assert 1.05 <= gain <= 1.35
