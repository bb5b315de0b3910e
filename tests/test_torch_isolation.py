"""The port stands alone: no module of ``paddle_tpu_torch`` (nor
``chip_smoke.py``) imports ``jax``, anything of ``paddle_tpu``, the repo's
root ``bench.py`` or ``tools/``, and importing the whole package pulls in
none of them. The Paddle-style scripts that ``chip_smoke.py`` loads by path
import neither at module level (their tests do, inside functions)."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "paddle_tpu_torch"
FILES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu", "bench", "tools")
SCRIPTS = [ROOT / "tests" / "test_torch_paddle_script.py",
           ROOT / "tests" / "test_torch_paddle_encoder_script.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in FORBIDDEN


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield node.lineno, str(node.args[0].value)


def test_package_has_modules_to_scan():
    assert len(FILES) > 15
    scanned = {str(p.relative_to(ROOT)) for p in FILES}
    for mod in ("serving/generation/prefix_cache.py",
                "serving/generation/spec_decode.py",
                "serving/generation/engine.py", "ops/paged_attention.py",
                "ops/cuda_paged_attention.py", "bench.py",
                "models/bert.py", "models/ernie.py",
                "vision/models/resnet.py", "nn/layer/conv.py",
                "nn/layer/norm.py", "nn/layer/pooling.py",
                "distributed/fleet/utils.py", "jit/api.py",
                "framework/exporting.py", "framework/monitor.py",
                "inference/__init__.py", "serving/server.py",
                "serving/batcher.py", "serving/metrics.py",
                "observability/registry.py", "observability/tracing.py",
                "profiler/__init__.py", "static/__init__.py",
                "bench_inference.py",
                # the operations plane and the tenant scheduler
                "observability/__init__.py", "observability/exposition.py",
                "observability/httpd.py", "observability/slo.py",
                "observability/stepprof.py",
                "serving/scheduling/__init__.py",
                "serving/scheduling/admission.py",
                "serving/scheduling/policy.py",
                "serving/scheduling/metrics.py",
                "serving/scheduling/schedz.py",
                # the serving fleet and its autoscaler
                "serving/scheduling/autoscaler.py",
                "serving/fleet/__init__.py", "serving/fleet/codec.py",
                "serving/fleet/metrics.py", "serving/fleet/resilience.py",
                "serving/fleet/router.py", "serving/fleet/supervisor.py",
                "serving/fleet/worker.py",
                # elastic training and its telemetry, and the drill
                "framework/checkpoint.py", "elastic/__init__.py",
                "elastic/manager.py", "elastic/preemption.py",
                "observability/goodput.py", "observability/training.py",
                "tools/__init__.py", "tools/faultinject.py",
                "tools/elastic_ckpt_worker.py",
                # the runtime and numerics plane
                "observability/runtime.py", "observability/xstats.py",
                "observability/numerics.py"):
        assert f"paddle_tpu_torch/{mod}" in scanned


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [(line, mod) for line, mod in _imports(path) if _forbidden(mod)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_package_loads_neither():
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        .removesuffix(".__init__") for p in PKG.rglob("*.py"))
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        f"             if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(len(sys.modules)); assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", SCRIPTS, ids=lambda p: p.name)
def test_scripts_import_neither_at_module_level(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in tree.body:
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and \
                _forbidden(node.module or ""):
            bad.append(node.module)
    assert not bad, f"{path.name} imports {bad} at module level"
