"""The port stands alone: importing every ``repro_torch`` module (and
``chip_smoke.py``) loads neither JAX nor the JAX package, changes no
process-global state, and builds or loads no kernel; no source names
either, and every CUDA source is listed in ``_build.SOURCES`` and needs no
PyTorch header."""
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
from repro_torch.kernels.mr_sched import kernel, megakernel
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.rwkv6 import kernel as wkv_kernel
from repro_torch.core import telemetry
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
assert dict(os.environ) == env0, "an import changed the environment"
assert torch.get_default_dtype() == dtype0
assert torch.get_num_threads() == threads0
assert not _build._loaded, "an import loaded a kernel library"
assert not megakernel._LIBS, "an import bound a kernel"
assert not kernel._LIB, "an import bound mr_schedule"
assert not fa_kernel._LIB and not wkv_kernel._LIB, "an import bound a kernel"
assert telemetry.provenance.cache_info().currsize == 0
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
    # chip_smoke.py imports tests/mr_stress.py, so it is held to the same
    # rule
    files = sorted((SRC / "repro_torch").rglob("*.py")) \
        + [ROOT / "chip_smoke.py", ROOT / "tests" / "mr_stress.py"]
    assert len(files) >= 15
    for f in files:
        hits = pat.findall(f.read_text())
        assert not hits, f"{f.relative_to(ROOT)} imports {hits}"


def test_every_kernel_source_is_built_without_torch_headers():
    # _build.SOURCES lists every CUDA source of the port (so the build
    # phase of chip_smoke.py compiles each), and each has a plain C
    # interface
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build
    sources = sorted((SRC / "repro_torch").rglob("*.cu"))
    assert len(sources) >= 2
    assert sorted(_build.SOURCES.values()) == sources
    inc = re.compile(r"^\s*#\s*include\s*[<\"]([^>\"]+)", re.M)
    for f in sources:
        text = f.read_text()
        heads = inc.findall(text)
        assert not [h for h in heads if h.startswith(("torch", "ATen",
                                                      "c10"))], f
        assert 'extern "C"' in text, f
    # every library names a registered source, and its launch symbol is
    # defined there (the trace instantiations through the MR_TRACE macro)
    assert set(_build.LIBRARIES) == {
        "mr_epoch", "mr_epoch_control", "mr_epoch_trace",
        "mr_epoch_control_trace", "mr_schedule", "flash_attention", "wkv6"}
    for name, (src, macros) in _build.LIBRARIES.items():
        text = _build.SOURCES[src].read_text()
        assert f"{name}_launch" in text, name
        assert all(m.startswith("-D") for m in macros), name
        if macros:
            assert "#ifdef MR_TRACE" in text, name
