"""The port stands alone: no JAX, no ``ml_dtypes`` (the machine with the
card does not have it) and nothing of ``repro`` in its sources or
``chip_smoke.py``; it imports on a host with no CUDA compiler and no
triton; its entry points default to the card and refuse to continue on
the CPU; the kernel wrappers never fall back to their plain versions."""

import ast
import dataclasses
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch import compat
from repro_torch.configs import get_config
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import flash_decode_quant as fdq
from repro_torch.kernels import qmatmul as qm
from repro_torch.kernels import ssd_scan as kss
from repro_torch.models import attention as attn
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models.model import build_model
from repro_torch.serve import AdmissionConfig, ServeEngine, faults

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro", "ml_dtypes")


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
        "assert 'ml_dtypes' not in sys.modules, 'ml_dtypes imported'\n"
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


@pytest.mark.parametrize("argv", [
    ["--arch", "jamba-v0.1-52b", "--reduced"],
    ["--arch", "kimi-k2-1t-a32b", "--reduced"],
    ["--arch", "llama4-maverick-400b-a17b", "--reduced"],
    ["--reduced", "--scenario", "poisson", "--queue-limit", "2"]])
def test_new_launcher_paths_default_to_the_card(no_card, argv):
    """The MoE / hybrid models and the traffic mode of the launcher run
    on the card unless asked for the CPU."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main(argv)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "kimi-k2-1t-a32b",
                                  "llama4-maverick-400b-a17b"])
def test_moe_engine_defaults_to_the_card(no_card, arch):
    """An engine of the MoE / hybrid models, with an admission policy,
    refuses to start without a card when no device is named."""
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(model, params, batch=1, max_seq=16,
                    admission=AdmissionConfig(queue_limit=2))


def test_robustness_and_moe_modules_are_checked():
    """The MoE, admission, fault, traffic and synthetic-prompt modules
    and the three configs are among the files the import check reads,
    and the registry serves the configs."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"src/repro_torch/models/moe.py",
            "src/repro_torch/serve/admission.py",
            "src/repro_torch/serve/faults.py",
            "src/repro_torch/serve/traffic.py",
            "src/repro_torch/data/synthetic.py",
            "src/repro_torch/configs/jamba_v0p1_52b.py",
            "src/repro_torch/configs/kimi_k2_1t.py",
            "src/repro_torch/configs/llama4_maverick_400b.py"} <= names
    for arch in ("jamba-v0.1-52b", "kimi-k2-1t-a32b",
                 "llama4-maverick-400b-a17b"):
        assert get_config(arch).name == arch


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "internvl2-2b"])
def test_encdec_and_vlm_configs_are_checked(no_card, arch):
    """The two configs are among the files the import check reads, the
    registry serves them, and their engines
    refuse to start without a card when no device is named."""
    module = {"seamless-m4t-medium": "seamless_m4t_medium",
              "internvl2-2b": "internvl2_2b"}[arch]
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert f"src/repro_torch/configs/{module}.py" in names
    cfg = get_config(arch)
    assert cfg.name == arch and (cfg.is_encoder_decoder
                                 or cfg.frontend == "vision")
    model = build_model(cfg.reduced())
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(model, params, batch=1, max_seq=16)


def test_faults_write_in_place_with_no_host_fallback():
    """The cache poisoners write the slot's leaves where they live (here
    the meta device, which holds no data to copy to the host): no
    tensor leaves its device, and the source reads nothing back."""
    src = (ROOT / "src/repro_torch/serve/faults.py").read_text()
    for word in (".cpu(", ".numpy(", ".item(", ".tolist(", '"cpu"'):
        assert word not in src, word
    cfg = get_config("jamba-v0.1-52b").reduced()
    model = build_model(dataclasses.replace(cfg, kv_format="float8_e4m3fn"))
    cache = model.init_cache(2, 16, "meta")
    leaves = {id(t) for e in cache.values() for tree in e.values()
              for t in tree.values()}
    for kind in ("e8m0_overflow", "kv_bitflip", "state_inf"):
        out = faults.CACHE_POISONERS[kind](cache, 1)
        assert out is cache
    assert leaves == {id(t) for e in cache.values() for tree in e.values()
                      for t in tree.values()}
    assert all(t.device.type == "meta" for e in cache.values()
               for tree in e.values() for t in tree.values())


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


def _quant_inputs(device="cpu"):
    q, k, v, _, pos = _decode_inputs()
    kv = attn.init_kv_cache(2, 8, 2, 16, torch.float32, "cpu",
                            kv_format="float4_e2m1fn")
    attn.cache_write_chunk(kv, k, v, torch.arange(8),
                           torch.ones(8, dtype=torch.bool),
                           kv_format="float4_e2m1fn")
    return (q.to(device), {n: t.to(device) for n, t in kv.items()},
            pos.to(device))


def _qmm_inputs(device="cpu"):
    g = torch.Generator().manual_seed(1)
    x = torch.randn(5, 64, generator=g).to(torch.bfloat16)
    w = torch.randn(64, 32, generator=g)
    qw, sc = qm.quantize_for_qmatmul(w, "float4_e2m1fn")
    pw, _ = qm.pack_for_qmatmul(w, "float4_e2m1fn")
    return [t.to(device) for t in (x, qw, pw, sc)]


def test_new_kernel_paths_without_library_raise(monkeypatch):
    """The same for flash_decode_quant, qmatmul and qmatmul_packed."""
    monkeypatch.setattr(compat, "nvcc_path", lambda: None)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR / "absent")
    before = (fdq.flash_decode_quant.launches, qm.qmatmul.launches,
              qm.qmatmul_packed.launches)
    q, kv, pos = _quant_inputs()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fdq._kernel(q, kv, pos, "float4_e2m1fn", None, None, 0.25)
    x, qw, pw, sc = _qmm_inputs()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        qm._launch("float8_e4m3fn", x, qw, sc, 32, torch.bfloat16,
                   "qmatmul")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        qm._launch("float4_e2m1fn", x, pw, sc, 32, torch.bfloat16,
                   "qmatmul_packed")
    assert (fdq.flash_decode_quant.launches, qm.qmatmul.launches,
            qm.qmatmul_packed.launches) == before


def test_wrapper_refuses_other_devices():
    """Only CPU tensors take the plain version: tensors elsewhere (here
    the meta device) raise instead of being computed some other way."""
    with pytest.raises(ValueError, match="cuda"):
        fd.flash_decode(*_decode_inputs("meta"))
    q, kv, pos = _quant_inputs("meta")
    with pytest.raises(ValueError, match="cuda"):
        fdq.flash_decode_quant(q, kv, pos, fmt="float4_e2m1fn")
    x, qw, pw, sc = _qmm_inputs("meta")
    with pytest.raises(ValueError, match="cuda"):
        qm.qmatmul(x, qw, sc)
    with pytest.raises(ValueError, match="cuda"):
        qm.qmatmul_packed(x, pw, sc, "float4_e2m1fn")


def test_plain_version_counts_no_launch():
    before = fd.flash_decode.launches
    out = fd.flash_decode(*_decode_inputs())
    assert out.shape == (2, 1, 4, 16)
    assert fd.flash_decode.launches == before
    counts = (fdq.flash_decode_quant.launches, qm.qmatmul.launches,
              qm.qmatmul_packed.launches)
    q, kv, pos = _quant_inputs()
    assert fdq.flash_decode_quant(q, kv, pos, fmt="float4_e2m1fn"
                                  ).shape == (2, 1, 4, 16)
    x, qw, pw, sc = _qmm_inputs()
    assert torch.equal(qm.qmatmul(x, qw, sc),
                       qm.qmatmul_packed(x, pw, sc, "float4_e2m1fn"))
    assert (fdq.flash_decode_quant.launches, qm.qmatmul.launches,
            qm.qmatmul_packed.launches) == counts


def _ssd_inputs(device="cpu"):
    g = torch.Generator().manual_seed(2)
    x = torch.randn(1, 40, 2, 16, generator=g)
    dt_a = -torch.rand(1, 40, 2, generator=g)
    b, c = torch.randn(2, 1, 40, 8, generator=g)
    state = torch.randn(1, 2, 16, 8, generator=g)
    return [t.to(device) for t in (x, dt_a, b, c, state)]


def test_ssd_scan_kernel_path_without_library_raises(monkeypatch):
    """The ssd_scan kernel path with no compiler to build its library
    raises; it does not fall back to the plain version, and counts no
    launch and no plain call."""
    monkeypatch.setattr(compat, "nvcc_path", lambda: None)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR / "absent")
    before = (kss.ssd_scan.launches, kss.ssd_scan_plain.calls)
    x, dt_a, b, c, state = _ssd_inputs()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kss._kernel(x, dt_a, b, c, 40, state)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("ssd_scan")
    assert (kss.ssd_scan.launches, kss.ssd_scan_plain.calls) == before


def test_ssd_scan_refuses_other_devices_and_counts_plain_calls():
    """A meta tensor raises; a CPU tensor takes the plain version, which
    counts a plain call and no launch."""
    x, dt_a, b, c, state = _ssd_inputs("meta")
    with pytest.raises(ValueError, match="cuda"):
        kss.ssd_scan(x, dt_a, b, c, chunk=32, initial_state=state)
    before = (kss.ssd_scan.launches, kss.ssd_scan_plain.calls)
    y, st = kss.ssd_scan(*_ssd_inputs()[:4], chunk=32,
                         initial_state=_ssd_inputs()[4])
    assert y.shape == (1, 40, 2, 16) and st.shape == (1, 2, 16, 8)
    assert (kss.ssd_scan.launches, kss.ssd_scan_plain.calls) == (
        before[0], before[1] + 1)


def _fa_inputs(device="cpu", dtype=torch.float32, d=16):
    g = torch.Generator().manual_seed(3)
    q = torch.randn(2, 24, 4, d, generator=g).to(dtype)
    k = torch.randn(2, 40, 2, d, generator=g).to(dtype)
    return [t.to(device) for t in (q, k, k.clone())]


def test_flash_attention_module_is_checked():
    """The new modules are among the files the import check reads."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"src/repro_torch/kernels/flash_attention.py",
            "src/repro_torch/models/attention.py",
            "src/repro_torch/models/transformer.py",
            "src/repro_torch/models/ssm.py",
            "src/repro_torch/models/model.py"} <= names


def test_sampler_and_config_modules_are_checked():
    """The PRNG, the sampler and the dense-decoder configs are among the
    files the import check reads, and the registry serves them."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"src/repro_torch/serve/prng.py",
            "src/repro_torch/serve/sampler.py",
            "src/repro_torch/configs/gemma2_2b.py",
            "src/repro_torch/configs/qwen2p5_3b.py",
            "src/repro_torch/configs/llama3p2_3b.py",
            "src/repro_torch/configs/gemma_2b.py"} <= names
    for arch in ("gemma2-2b", "qwen2.5-3b", "llama3.2-3b", "gemma-2b"):
        assert get_config(arch).name == arch


def test_flash_attention_kernel_path_without_library_raises(monkeypatch):
    """The flash_attention kernel path with no compiler to build its
    library raises; it does not fall back to the plain version, and
    counts no launch and no plain call."""
    monkeypatch.setattr(compat, "nvcc_path", lambda: None)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR / "absent")
    before = (kfa.flash_attention.launches, kfa.flash_attention_plain.calls)
    q, k, v = _fa_inputs()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kfa._kernel(q, k, v, True, None, None, 0.25, 0)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("flash_attention")
    assert (kfa.flash_attention.launches,
            kfa.flash_attention_plain.calls) == before


def test_flash_attention_refuses_other_devices_and_counts_plain_calls():
    """A meta tensor raises; a CPU tensor takes the plain version, which
    counts a plain call and no launch."""
    with pytest.raises(ValueError, match="cuda"):
        kfa.flash_attention(*_fa_inputs("meta"))
    before = (kfa.flash_attention.launches, kfa.flash_attention_plain.calls)
    out = kfa.flash_attention(*_fa_inputs())
    assert out.shape == (2, 24, 4, 16)
    assert (kfa.flash_attention.launches,
            kfa.flash_attention_plain.calls) == (before[0], before[1] + 1)


@pytest.mark.parametrize("case,error", [
    ("d_above_256", ValueError), ("bf16_d_not_multiple_of_8", ValueError),
    ("float16", TypeError), ("mixed_dtypes", TypeError),
    ("head_dim_not_unit_stride", ValueError),
    ("row_stride_off_16_bytes", ValueError),
    ("hq_not_multiple_of_hkv", ValueError), ("window_0", ValueError),
    ("negative_q_offset", ValueError), ("batch_mismatch", ValueError)])
def test_flash_attention_check_kernel_inputs_refuses(case, error):
    """What the kernel does not take raises before any launch."""
    window, q_offset = None, 0
    q, k, v = _fa_inputs()
    if case == "d_above_256":
        q, k, v = _fa_inputs(d=264)
    elif case == "bf16_d_not_multiple_of_8":
        q, k, v = _fa_inputs(dtype=torch.bfloat16, d=12)
    elif case == "float16":
        q, k, v = _fa_inputs(dtype=torch.float16)
    elif case == "mixed_dtypes":
        k = k.to(torch.bfloat16)
    elif case == "head_dim_not_unit_stride":
        q = q.transpose(2, 3).contiguous().transpose(2, 3)
    elif case == "row_stride_off_16_bytes":
        k = torch.randn(2, 40, 2, 18)[..., 1:17]
    elif case == "hq_not_multiple_of_hkv":
        k = torch.randn(2, 40, 3, 16)
        v = k.clone()
    elif case == "window_0":
        window = 0
    elif case == "negative_q_offset":
        q_offset = -1
    elif case == "batch_mismatch":
        k, v = k[:1], v[:1]
    with pytest.raises(error):
        kfa.check_kernel_inputs(q, k, v, window, q_offset)
    kfa.check_kernel_inputs(*_fa_inputs(), None, 0)
    kfa.check_kernel_inputs(*_fa_inputs(dtype=torch.bfloat16, d=256), 8, 3)


@pytest.mark.parametrize("draft", ["ngram", "model"])
def test_spec_engine_defaults_to_the_card(no_card, draft):
    """A speculative engine (n-gram drafting, or a draft model) refuses
    to start without a card when no device is named, and
    ``serve/spec.py`` is among the files the import check reads; only
    ``mesh=`` is still refused as not ported."""
    from repro_torch.serve import SpecConfig
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert "src/repro_torch/serve/spec.py" in names
    cfg = get_config("gptneox-1b").reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    spec = (SpecConfig() if draft == "ngram" else
            SpecConfig(draft_model=model, draft_params=params))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(model, params, batch=1, max_seq=16, spec=spec)
    eng = ServeEngine(model, params, batch=1, max_seq=16, spec=spec,
                      device="cpu")
    assert eng.spec_report()["enabled"]
    with pytest.raises(NotImplementedError, match="mesh"):
        ServeEngine(model, params, batch=1, max_seq=16, spec=spec,
                    device="cpu", mesh=object())


def test_training_modules_are_checked():
    """The training slice's modules are among the files the import
    check reads."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"src/repro_torch/train/step.py",
            "src/repro_torch/train/loop.py",
            "src/repro_torch/optim/adamw.py",
            "src/repro_torch/checkpoint/checkpointer.py",
            "src/repro_torch/distributed/elastic.py",
            "src/repro_torch/data/packing.py",
            "src/repro_torch/launch/train.py"} <= names


def test_train_launcher_defaults_to_the_card(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--reduced", "--steps", "1"])


def test_flash_attention_bwd_without_library_raises(monkeypatch):
    """The backward kernel's path with no compiler to build its library
    raises; it does not fall back to the plain backward, and counts no
    launch and no plain call."""
    monkeypatch.setattr(compat, "nvcc_path", lambda: None)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR / "absent")
    before = (kfa.flash_attention_bwd.launches,
              kfa.flash_attention_bwd_plain.calls)
    g = torch.Generator().manual_seed(5)
    q, o, do = torch.randn(3, 1, 8, 4, 16, generator=g)
    k, v = torch.randn(2, 1, 8, 2, 16, generator=g)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kfa._bwd_kernel(q, k, v, o, do, True, None, None, 0.25)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("flash_attention_bwd")
    assert (kfa.flash_attention_bwd.launches,
            kfa.flash_attention_bwd_plain.calls) == before


def test_ssd_scan_refuses_device_inputs_that_need_grad():
    """Off the CPU and the card, an input that requires grad is refused
    (the training path, ``SsdScanFn``, dispatches as the forward does),
    running no kernel and no plain version; without grad the meta device
    is refused as before; on the CPU the plain version is differentiable
    through the plain backward (one forward storing the states, one
    backward a call)."""
    x, dt_a, b, c, state = _ssd_inputs("meta")
    before = (kss.ssd_scan.launches, kss.ssd_scan_plain.calls,
              kss.ssd_scan_bwd.launches, kss.ssd_scan_bwd_plain.calls)
    with pytest.raises(ValueError, match="cuda"):
        kss.ssd_scan(x.requires_grad_(True), dt_a, b, c, 40, state)
    with torch.no_grad():
        with pytest.raises(ValueError, match="cuda"):
            kss.ssd_scan(x, dt_a, b, c, 40, state)
    assert (kss.ssd_scan.launches, kss.ssd_scan_plain.calls,
            kss.ssd_scan_bwd.launches, kss.ssd_scan_bwd_plain.calls) == before
    x, dt_a, b, c, state = _ssd_inputs()
    y, _ = kss.ssd_scan(x.requires_grad_(True), dt_a, b, c, 40, state)
    (gx,) = torch.autograd.grad(y.sum(), x)
    assert torch.isfinite(gx).all()
    assert (kss.ssd_scan_plain.calls, kss.ssd_scan_bwd_plain.calls) == (
        before[1] + 1, before[3] + 1)


def test_ssd_scan_bwd_without_library_raises(monkeypatch):
    """The backward kernel's path with no compiler to build its library
    raises; it does not fall back to the plain backward, and counts no
    launch and no plain call."""
    monkeypatch.setattr(compat, "nvcc_path", lambda: None)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR / "absent")
    x, dt_a, b, c, state = _ssd_inputs()
    states = torch.zeros((1, 1, 2, 16, 8))
    before = (kss.ssd_scan_bwd.launches, kss.ssd_scan_bwd_plain.calls)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kss._bwd_kernel(x, dt_a, b, c, states, torch.zeros_like(x), None,
                        40)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("ssd_scan_bwd")
    assert (kss.ssd_scan_bwd.launches,
            kss.ssd_scan_bwd_plain.calls) == before


def test_data_parallel_modules_and_examples_are_checked():
    """The data-parallel slice's modules and the examples are among the
    files the import check reads."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"src/repro_torch/distributed/compression.py",
            "src/repro_torch/train/local_dp.py",
            "src/repro_torch/examples/__init__.py",
            "src/repro_torch/examples/quickstart.py",
            "src/repro_torch/examples/train_100m.py"} <= names


def test_energy_modules_and_new_examples_are_checked():
    """The energy model, the NVML readings and the serving examples are
    among the files the import check reads."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"src/repro_torch/core/energy.py",
            "src/repro_torch/core/nvml.py",
            "src/repro_torch/examples/serve_demo.py",
            "src/repro_torch/examples/long_context.py",
            "src/repro_torch/examples/characterize.py"} <= names


@pytest.mark.parametrize("name,argv", [
    ("quickstart", []), ("train_100m", ["--steps", "1", "--ckpt", "unused"]),
    ("serve_demo", []), ("long_context", []), ("characterize", [])])
def test_examples_default_to_the_card(no_card, name, argv, tmp_path,
                                      monkeypatch):
    """Each example runs on the card unless ``--device cpu`` is given:
    without one it refuses before it builds anything."""
    import importlib
    monkeypatch.chdir(tmp_path)
    module = importlib.import_module(f"repro_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(argv)
    assert not any(tmp_path.iterdir())
