"""Guards of the port's boundaries: it imports neither jax nor the JAX
package, and its entry points refuse to fall back to the CPU silently."""
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(
    r"^\s*(?:import\s+(?:jax|repro)(?:[.\s,]|$)|from\s+(?:jax|repro)[.\s])"
    r"|import_module\(\s*f?[\"'](?:jax|repro)[.\"']",
    re.MULTILINE,
)


def _sources():
    return (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "examples").glob("*_torch.py")))


def test_port_sources_import_no_jax_and_no_reference():
    offenders = {
        str(p.relative_to(ROOT)): FORBIDDEN.findall(p.read_text())
        for p in _sources()
    }
    assert {k: v for k, v in offenders.items() if v} == {}
    assert len(offenders) > 20  # the scan saw the package
    assert "examples/quickstart_torch.py" in offenders  # and the examples
    assert "examples/train_snn_lth_torch.py" in offenders
    assert "examples/serve_llm_torch.py" in offenders


def test_scan_covers_the_mesh_modules():
    """The serve mesh's modules are in the scan (and so import neither jax
    nor the reference)."""
    seen = {str(p.relative_to(ROOT)) for p in _sources()}
    for m in ("src/repro_torch/launch/mesh.py",
              "src/repro_torch/serve/sharding.py",
              "src/repro_torch/ft/elastic.py",
              "src/repro_torch/kernels/join_plan.py"):
        assert m in seen
        assert not FORBIDDEN.findall((ROOT / m).read_text())


def test_forbidden_pattern_tells_the_packages_apart():
    assert FORBIDDEN.search("import jax.numpy as jnp")
    assert FORBIDDEN.search("    from repro.core import lif")
    assert FORBIDDEN.search("import repro")
    assert not FORBIDDEN.search("from repro_torch.core import lif")
    assert not FORBIDDEN.search("import repro_torch.kernels")


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"))


def test_importing_every_port_module_loads_no_jax():
    mods = [
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        for p in PORT.rglob("*.py")
    ]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m.removesuffix('.__init__'))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], env=_env(),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the default is legitimate")


def test_entry_points_raise_without_a_card_and_without_device():
    _no_card()
    from repro_torch.launch.serve import build_config
    from repro_torch.models.registry import build_model
    from repro_torch.serve import Engine
    from repro_torch.train import init_train_state

    cfg = build_config("llama3_2_1b", smoke=True, spiking=True, weight_density=0.3)
    model = build_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_train_state(model, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init_cache(1, 8)
    params = model.init(0, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(model, params, max_len=16)
    Engine(model, params, max_len=16, device="cpu")  # explicit CPU is fine


def _run_smoke(cwd, env):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_a_card(tmp_path):
    """Without a card, and alone in a directory without the repo, the chip
    smoke exits non-zero and prints no result line."""
    _no_card()
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    alone = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for cwd, env in ((ROOT, _env()), (tmp_path, alone)):
        r = _run_smoke(cwd, env)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout and '"kernels"' not in r.stdout


@pytest.mark.parametrize("example", ["quickstart_torch", "train_snn_lth_torch",
                                     "serve_llm_torch", "serve_dvs_torch",
                                     "spiking_ffn_llm_torch"])
def test_examples_raise_without_a_card_and_without_device(example):
    """The port's examples run on the card unless ``--device cpu``: without
    a card and without the flag they raise instead of running on the CPU,
    and they import no jax."""
    _no_card()
    args = {"train_snn_lth_torch": ["--steps", "1", "--rounds", "1"],
            "spiking_ffn_llm_torch": ["--steps", "1"]}.get(example, [])
    r = subprocess.run([sys.executable, str(ROOT / "examples" / f"{example}.py"),
                        *args], env=_env(), capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0
    assert "device='cpu'" in r.stderr
