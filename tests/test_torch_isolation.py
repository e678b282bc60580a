"""The PyTorch port stands alone: importing every ``repro_torch`` module
loads neither JAX nor any module of the JAX package, no port source (or
chip_smoke.py) imports them, and no library attention or compiler stands
in for the hand-written kernels."""
import ast
import json
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "src", "repro_torch")
SMOKE = os.path.join(REPO, "chip_smoke.py")


def _sources():
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def test_importing_every_module_loads_no_jax_and_no_repro():
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "print(json.dumps({'modules': names, 'bad': bad}))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["bad"] == []
    assert "repro_torch.serving.engine" in got["modules"]
    assert "repro_torch.serving.speculative" in got["modules"]
    assert "repro_torch.launch.serve" in got["modules"]
    for name in ("core.controller", "core.coexec", "core.baselines", "configs.yolo_v2_tiny",
                 "configs.seamless_m4t_medium", "configs.jamba_v0_1_52b",
                 "uncertainty", "uncertainty.conformal", "uncertainty.model", "faults.plan",
                 "faults.injector", "serving.bucketed", "fleet", "fleet.replay",
                 "fleet.workloads", "fleet.population", "fleet.report"):
        assert f"repro_torch.{name}" in got["modules"]


@pytest.mark.parametrize("module", ["repro_torch.serving.scheduler", "repro_torch.core.profiler",
                                    "repro_torch.kernels.ssd_scan",
                                    "repro_torch.serving.speculative",
                                    "repro_torch.core", "repro_torch.core.controller",
                                    "repro_torch.core.coexec", "repro_torch.core.baselines",
                                    "repro_torch.configs.yolo_v2_tiny",
                                    "repro_torch.models.moe",
                                    "repro_torch.configs.deepseek_v2_lite_16b",
                                    "repro_torch.models.ssm", "repro_torch.models.model",
                                    "repro_torch.configs.seamless_m4t_medium",
                                    "repro_torch.configs.jamba_v0_1_52b",
                                    "repro_torch.uncertainty", "repro_torch.faults",
                                    "repro_torch.faults.plan", "repro_torch.faults.injector",
                                    "repro_torch.serving.bucketed", "repro_torch.fleet",
                                    "repro_torch.fleet.replay"])
def test_scheduled_path_modules_load_no_jax_and_no_repro(module):
    """Each module of the scheduled, speculative and joint-planning paths, of
    the closed loop, of the MoE layer, of the encoder-decoder and hybrid
    path (Mamba1, the encoder, the two configs), of the uncertainty layer,
    the fault plans and injector, the bucketed mode and the fleet replay,
    imported alone in a fresh process."""
    code = (
        "import importlib, json, sys\n"
        f"importlib.import_module({module!r})\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "print(json.dumps(bad))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("path", sorted(_sources()) + [SMOKE],
                         ids=lambda p: os.path.relpath(p, REPO))
def test_sources_import_no_jax_and_no_library_attention(path):
    tree = ast.parse(open(path, encoding="utf-8").read())
    # chip_smoke.py times SDPA as a yardstick and switches cuDNN's TF32 off
    banned = {"compile"} if path == SMOKE else {
        "compile", "cudnn", "scaled_dot_product_attention"}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            roots = [(node.module or "").split(".")[0]]
        else:
            roots = []
        assert not {"jax", "jaxlib", "repro"} & set(roots), ast.dump(node)
        if isinstance(node, ast.Attribute):
            assert node.attr not in banned, ast.dump(node)


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    lone = tmp_path / "chip_smoke.py"
    lone.write_text(open(SMOKE, encoding="utf-8").read())
    for script in (SMOKE, str(lone)):
        out = subprocess.run([sys.executable, script], capture_output=True, text=True,
                             timeout=120, cwd=os.path.dirname(script))
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
