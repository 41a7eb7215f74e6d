"""The port stands alone: nothing under ``src/repro_torch`` and nothing in
its root scripts ``chip_smoke.py``, ``dgrad_probe.py`` and
``dispatch_probe.py`` imports JAX, the JAX package ``repro`` or
``ml_dtypes`` (the card's machine has none: bf16 crosses as ``uint16``
bits)."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "dgrad_probe.py", ROOT / "dispatch_probe.py"
]


def _imported(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro", "ml_dtypes")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_reference(path):
    bad = [n for n in _imported(ast.parse(path.read_text(), str(path))) if _forbidden(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_sees_the_port():
    assert len(FILES) > 10
    port = ROOT / "src" / "repro_torch"
    for new in ("checkpoint/manager.py", "optim/compression.py", "launch/calibrate.py", "launch/roofline.py",
                "layers/moe.py", "layers/mamba2.py", "configs/mamba2_2p7b.py", "configs/zamba2_7b.py",
                "configs/chatglm3_6b.py", "configs/nemotron4_15b.py", "configs/gemma3_27b.py",
                "configs/granite_moe_3b.py", "configs/llama4_maverick.py", "examples/quickstart.py",
                "examples/compress_operator.py", "examples/train_tiny_lm.py", "examples/serve_lm.py",
                "distributed/__init__.py", "distributed/mesh.py", "distributed/sharding.py",
                "kernels/chain_sharded.py", "distributed/layout.py", "distributed/pipeline.py", "layers/param.py"):
        assert port / new in FILES
    assert _forbidden("repro.kernels.ops") and _forbidden("jax.numpy") and _forbidden("ml_dtypes")
    assert not _forbidden("repro_torch.kernels.ops")
