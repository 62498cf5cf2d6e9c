"""The port's examples stand alone: no ``examples/*_torch.py`` imports JAX
or the JAX package, and importing them loads neither, changes no
process-global state, builds or binds no kernel and writes no file (the
checks of ``test_torch_isolation.py``, extended to the examples)."""
import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart", "policy_compare", "smart_city", "serve_batch",
            "train_lm")

_PROBE = r"""
import importlib, os, sys
env0 = dict(os.environ)
import torch
dtype0, threads0 = torch.get_default_dtype(), torch.get_num_threads()
grad0 = torch.is_grad_enabled()
sys.path.insert(0, sys.argv[1])
for name in sys.argv[2:]:
    importlib.import_module(name)
from repro_torch.kernels import _build
from repro_torch.kernels.mr_sched import kernel, megakernel
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.rwkv6 import kernel as wkv_kernel
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
assert dict(os.environ) == env0, "an import changed the environment"
assert torch.get_default_dtype() == dtype0
assert torch.get_num_threads() == threads0
assert torch.is_grad_enabled() == grad0
assert not _build._loaded, "an import loaded a kernel library"
assert not megakernel._LIBS and not kernel._LIB, "an import bound a kernel"
assert not fa_kernel._LIB and not wkv_kernel._LIB, "an import bound a kernel"
assert not torch.distributed.is_initialized(), "an import opened a group"
assert not os.listdir("."), os.listdir(".")
print("ISOLATED", len(sys.argv) - 2)
"""


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_source_imports_no_jax_or_reference(name):
    text = (ROOT / "examples" / f"{name}_torch.py").read_text()
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)",
                     re.M)
    assert not pat.findall(text)
    assert re.search(r"^\s*from\s+repro_torch[.\s]", text, re.M)
    assert "--device" in text and 'default="cuda"' in text


def test_importing_the_examples_changes_nothing(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", _PROBE, str(ROOT / "examples"),
         *(f"{n}_torch" for n in EXAMPLES)],
        env=env, capture_output=True, text=True, timeout=300,
        cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-4000:]
    assert f"ISOLATED {len(EXAMPLES)}" in out.stdout
