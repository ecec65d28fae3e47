"""The port stands alone: no JAX and nothing of ``repro`` in its sources
or ``chip_smoke.py``; it imports on a host with no CUDA compiler and no
triton; its entry points default to the card and refuse to continue on
the CPU; the kernel wrapper never falls back to the plain version."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch import compat
from repro_torch.configs import get_config
from repro_torch.kernels import _build
from repro_torch.kernels import flash_decode as fd
from repro_torch.launch import serve as launch_serve
from repro_torch.models.model import build_model
from repro_torch.serve import ServeEngine

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_package_imports_without_nvcc_or_triton(tmp_path):
    """Import every module of the port in a fresh interpreter whose PATH
    holds no compiler; no kernel is built and neither triton nor JAX is
    loaded."""
    code = (
        "import pkgutil, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    __import__(m.name)\n"
        "assert 'triton' not in sys.modules, 'triton imported'\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert not any(n == 'repro' or n.startswith('repro.') "
        "for n in sys.modules), 'repro imported'\n")
    env = {"PATH": str(tmp_path), "PYTHONPATH": str(ROOT / "src"),
           "CUDA_HOME": str(tmp_path), "HOME": str(tmp_path)}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_engine_defaults_to_the_card(no_card):
    cfg = get_config("gptneox-1b").reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(model, params, batch=1, max_seq=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compat.resolve_device("cuda:0")
    assert compat.resolve_device("cpu") == torch.device("cpu")


def test_launcher_defaults_to_the_card(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main(["--reduced"])


def _decode_inputs(device="cpu"):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 1, 4, 16, generator=g)
    k = torch.randn(2, 8, 2, 16, generator=g)
    sp = torch.arange(8, dtype=torch.int32).expand(2, 8).contiguous()
    pos = torch.tensor([7, 3], dtype=torch.int32)
    return [t.to(device) for t in (q, k, k.clone(), sp, pos)]


def test_kernel_path_without_library_raises(monkeypatch):
    """The CUDA path with no compiler to build its library raises; it
    does not fall back to the plain version, and counts no launch."""
    monkeypatch.setattr(compat, "nvcc_path", lambda: None)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR / "absent")
    before = fd.flash_decode.launches
    q, k, v, sp, pos = _decode_inputs()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fd._kernel(q, k, v, sp, pos, None, None, 0.25)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("flash_decode")
    assert fd.flash_decode.launches == before


def test_wrapper_refuses_other_devices():
    """Only CPU tensors take the plain version: tensors elsewhere (here
    the meta device) raise instead of being computed some other way."""
    with pytest.raises(ValueError, match="cuda"):
        fd.flash_decode(*_decode_inputs("meta"))


def test_plain_version_counts_no_launch():
    before = fd.flash_decode.launches
    out = fd.flash_decode(*_decode_inputs())
    assert out.shape == (2, 1, 4, 16)
    assert fd.flash_decode.launches == before
