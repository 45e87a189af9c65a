"""The port stands alone: nothing under src/repro_torch/ nor chip_smoke.py
imports JAX or the JAX package, and its entry points refuse to fall back
to the CPU when no card is found."""
import ast
from pathlib import Path

import pytest
import torch

from repro_torch import configs
from repro_torch.models import Model, resolve_device
from repro_torch.serving import make_adapter

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def _imported(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_imports_neither_jax_nor_repro(path):
    for name in _imported(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, name)


def test_the_file_list_covers_the_package():
    names = {p.name for p in FILES}
    assert {"engine.py", "model.py", "decode_attention.py",
            "flash_attention.py", "ssd_scan.py", "ssd.py", "rglru_scan.py",
            "rglru.py", "chip_smoke.py"} <= names


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get_smoke("granite-3-2b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(configs.get_smoke("mamba2-780m"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(configs.get_smoke("recurrentgemma-9b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_adapter(0, "a", cfg.d_model, cfg.vocab_size)
    assert Model(cfg, device="cpu").device == torch.device("cpu")
    assert Model(configs.get_smoke("mamba2-780m"),
                 device="cpu").device == torch.device("cpu")
    assert Model(configs.get_smoke("recurrentgemma-9b"),
                 device="cpu").device == torch.device("cpu")
