"""Structural checks of the PyTorch port: it stands alone (no JAX, nothing
of the JAX package), its entry points run on the card unless the CPU is
asked for, and its kernels are built from the sources in the repository."""
import ast
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.serving import ProtectedSession  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    bad = [m for m in _imported(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tcnn.resnet18(0.12)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcnn.init_cnn(cfg)
    params = tcnn.init_cnn(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcore.build_plan(params, cfg)
    x = torch.zeros((1, 3, 32, 32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcnn.forward_cnn(params, x, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcnn.params_from_numpy({"w": [1.0]})
    assert repro_torch.resolve_device("cpu") == torch.device("cpu")


def test_serving_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfigs.get("smollm-360m-smoke")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttf.init_params(cfg)
    params = ttf.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcore.build_plan(params, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ProtectedSession(params, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttf.params_from_numpy({"w": [1.0]})
    with pytest.raises(ValueError, match="params lie on"):
        ProtectedSession(params, cfg, device="meta")


def test_campaign_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch):
    from repro_torch.campaign import CampaignEngine, run_campaign
    from repro_torch.campaign.run import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CampaignEngine()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_campaign(trials=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--trials", "1", "--layers", "matmul", "--faults", "burst",
              "--no-check"])
    assert CampaignEngine(device="cpu").device == torch.device("cpu")


def test_forward_rejects_tensors_off_its_device():
    cfg = tcnn.alexnet(0.12)
    params = tcnn.init_cnn(cfg, device="cpu")
    with pytest.raises(ValueError, match="runs on meta"):
        tcnn.forward_cnn(params, torch.zeros((1, 3, 48, 48)), cfg,
                         device="meta")


def test_fp32_ieee_scope_restores_the_flags():
    mm = torch.backends.cuda.matmul
    saved = (torch.backends.cudnn.allow_tf32, mm.allow_tf32,
             mm.allow_bf16_reduced_precision_reduction)
    torch.backends.cudnn.allow_tf32 = True
    mm.allow_bf16_reduced_precision_reduction = True
    try:
        with repro_torch.fp32_ieee():
            assert not torch.backends.cudnn.allow_tf32
            assert not mm.allow_tf32
            assert not mm.allow_bf16_reduced_precision_reduction
        assert torch.backends.cudnn.allow_tf32
        assert mm.allow_bf16_reduced_precision_reduction
    finally:
        (torch.backends.cudnn.allow_tf32, mm.allow_tf32,
         mm.allow_bf16_reduced_precision_reduction) = saved


def test_missing_nvcc_is_an_error(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


@pytest.mark.parametrize("name", _build.SOURCES)
def test_each_kernel_source_exports_what_its_wrapper_calls(name):
    """Every source under csrc/ is built, opens with its note (the TPU
    kernel it replaces, its bound on the card), and exports the C entry
    point its wrapper binds."""
    src = (_build.CSRC / f"{name}.cu").read_text()
    head = src[:600]
    assert "Replaces: src/repro/kernels/" in head
    assert "Bound on an H100" in head
    wrapper = (PORT / "kernels" / f"{name}.py").read_text()
    entries = re.findall(r"\"(repro_\w+)\"", wrapper)
    assert entries
    for entry in entries:
        assert re.search(rf'extern "C" int {entry}\(', src), entry
    assert sorted(p.stem for p in _build.CSRC.glob("*.cu")) == \
        sorted(_build.SOURCES)


def test_library_paths_are_keyed_by_source_content():
    a = _build._lib_path("checksum_reduce")
    b = _build._lib_path("abft_matmul")
    assert a != b and a.parent == _build.BUILD_DIR
    assert a.name.startswith("libchecksum_reduce-") and a.suffix == ".so"
