"""The port stands alone: importing every ``repro_torch`` module (and
``chip_smoke.py``) loads neither JAX nor the JAX package, changes no
process-global state, and builds no kernel; no source names either."""
import os
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

_PROBE = r"""
import importlib, os, pkgutil, sys
env0 = dict(os.environ)
import torch
dtype0, threads0 = torch.get_default_dtype(), torch.get_num_threads()
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
sys.path.insert(0, sys.argv[1])
import chip_smoke
from repro_torch.kernels import _build
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
assert dict(os.environ) == env0, "an import changed the environment"
assert torch.get_default_dtype() == dtype0
assert torch.get_num_threads() == threads0
assert not _build._loaded, "an import loaded a kernel library"
print(len(names))
"""


def test_importing_the_port_loads_no_jax_and_no_reference():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC)
    out = subprocess.run([sys.executable, "-c", _PROBE, str(ROOT)],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 15


def test_no_source_imports_jax_or_the_reference():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)",
                     re.M)
    files = sorted((SRC / "repro_torch").rglob("*.py")) \
        + [ROOT / "chip_smoke.py"]
    assert len(files) >= 15
    for f in files:
        hits = pat.findall(f.read_text())
        assert not hits, f"{f.relative_to(ROOT)} imports {hits}"
