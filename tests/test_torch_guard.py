"""The port stands alone: no module under src/repro_torch/, not
chip_smoke.py and no probe under probes/ imports jax or the JAX package
`repro`, and entry points called without a device raise on a machine with
no GPU."""
import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
SOURCES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"] + sorted((ROOT / "probes").glob("*.py"))
FORBIDDEN = ("jax", "repro", "jaxlib")


def _imported(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    bad = [m for m in _imported(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_port_imports_with_jax_blocked():
    """Import every module of the port in a fresh interpreter where
    `import jax` and `import repro` fail."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert 'repro_torch.launch.serve' in names\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"}, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20


def test_entry_points_without_device_raise_when_no_gpu(monkeypatch):
    from repro_torch.configs import get_reduced_config
    from repro_torch.launch import serve
    from repro_torch.models.model import Model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_reduced_config("tinyllama-1.1b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(cfg)
    model = Model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.ContinuousBatchingEngine(
            model, serve.make_cache_config("sparq", None))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--reduced", "--batch", "1", "--prompt-len", "4",
                    "--gen", "2"])
