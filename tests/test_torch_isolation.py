"""The port stands alone: importing every module of ``repro_torch`` loads
neither JAX nor anything of the JAX package ``repro``; ``chip_smoke.py``
imports neither; and the entry points, called with no device on a machine
with no card, raise instead of drifting to the CPU.  Nothing here needs
JAX."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for m in mods:
    importlib.import_module(m)
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith(("jax.", "jaxlib"))
             or k == "repro" or k.startswith("repro."))
assert not bad, bad
assert len(mods) >= 45, mods
print(len(mods))
"""


def test_import_every_module_without_jax():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_source_file_imports_jax_or_repro():
    files = sorted((SRC / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for f in files:
        assert not _imported_roots(f) & {"jax", "jaxlib", "repro"}, f


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card behaviour is not "
                    "observable here")


def test_entry_points_raise_without_a_card():
    _no_card()
    from repro_torch.configs import whisper_tiny
    from repro_torch.core.gadmm import GADMMConfig
    from repro_torch.dist.qgadmm import DistConfig, QGADMMTrainer, init_state
    from repro_torch.launch import train
    from repro_torch.models import encdec

    cfg = whisper_tiny.smoke_config()
    dcfg = DistConfig(num_workers=2, gadmm=GADMMConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        QGADMMTrainer(encdec, cfg, dcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_state(lambda g: encdec.init(g, cfg), 0, dcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--smoke", "--steps", "1"])

    from repro_torch.configs import mamba2_2_7b
    from repro_torch.device import generator
    from repro_torch.dist.serve import Server
    from repro_torch.launch import serve
    from repro_torch.models import ssm

    from repro_torch.core.gadmm import init_state as chain_init_state
    from repro_torch.launch import paper
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chain_init_state(4, 6, GADMMConfig())
    for cmd in ("linreg", "dnn"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            paper.main([cmd, "--rounds", "1"])

    mcfg = mamba2_2_7b.smoke_config()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Server(model=ssm, cfg=mcfg, batch_size=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--smoke", "--gen-len", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ssm.init(generator(0), mcfg)


def test_chip_smoke_fails_without_a_card():
    """No card: a non-zero exit and no result line."""
    _no_card()
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120,
                         cwd=ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
