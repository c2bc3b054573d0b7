"""The port stands alone: no JAX, nothing of the JAX package, and no
silent CPU fallback when no card is visible."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "distributed_crawler_tpu_torch"
# ``safetensors`` too: the card's machine has no such package, so the
# port reads the format itself (`models/hf_convert.read_safetensors`).
# ``tools`` too: the reference's operator tools import the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "safetensors",
             "distributed_crawler_tpu", "tools")


def _port_files():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    return files


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                "import_module", "__import__"):
            for arg in node.args[:1]:
                if isinstance(arg, ast.Constant) and isinstance(arg.value,
                                                                str):
                    yield arg.value


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in FORBIDDEN


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_forbidden_rule_is_exact():
    assert _forbidden("distributed_crawler_tpu.ops")
    assert _forbidden("jax.numpy")
    assert _forbidden("tools.loadtest")
    assert not _forbidden("distributed_crawler_tpu_torch.ops")


def test_importing_the_port_loads_no_jax():
    modules = sorted(
        "distributed_crawler_tpu_torch." + ".".join(
            p.relative_to(PORT).with_suffix("").parts)
        for p in PORT.rglob("*.py") if p.name != "__init__.py")
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(len(bad))\n"
        "print(bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[0] == "0", out.stdout


def test_no_card_and_no_device_raises(monkeypatch):
    from distributed_crawler_tpu_torch import device
    from distributed_crawler_tpu_torch.inference.engine import (
        EngineConfig,
        InferenceEngine,
    )
    from distributed_crawler_tpu_torch.utils.metrics import MetricsRegistry

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine(EngineConfig(model="tiny"),
                        registry=MetricsRegistry())
    with pytest.raises(RuntimeError):
        device.resolve_device("cuda")
    with pytest.raises(RuntimeError):
        device.resolve_device("mps")
    assert device.resolve_device("cpu") == torch.device("cpu")
    assert device.torch_dtype("bfloat16") is torch.bfloat16
    with pytest.raises(ValueError):
        device.torch_dtype("float16")


def test_attention_xla_refused_on_card(monkeypatch):
    from distributed_crawler_tpu_torch import device
    from distributed_crawler_tpu_torch.inference import engine

    monkeypatch.setattr(engine, "resolve_device",
                        lambda d=None: torch.device("cuda", 0))
    with pytest.raises(ValueError, match="xla"):
        engine.InferenceEngine(
            engine.EngineConfig(model="tiny", attention="xla"))
    assert device.resolve_device("cpu").type == "cpu"


def test_kernel_build_needs_nvcc(monkeypatch):
    from distributed_crawler_tpu_torch import kernels

    monkeypatch.setenv("PATH", "")
    monkeypatch.setattr(kernels, "DEFAULT_NVCC", "/nonexistent/nvcc")
    monkeypatch.setattr(kernels, "_builds", {})
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.build()
    with pytest.raises(KeyError):
        kernels.build(["no_such_kernel"])
