"""A pinned cost-model cache for the port's CPU tests.

``SweepPlan.run`` prices bucket splits with
``repro_torch.core.costmodel.default_cost_model``, which measures the device
once and keeps the coefficients in a file under ``~/.cache``.  Importing
:func:`pinned_cost_cache` into a test module points that cache at a file
under each test's ``tmp_path`` holding the JAX package's fallback
coefficients for the CPU: the port's buckets are then the reference's at its
fallback model, nothing is measured and nothing is written outside
``tmp_path``.
"""
import pytest

from repro_torch.core import costmodel


@pytest.fixture(autouse=True)
def pinned_cost_cache(tmp_path, monkeypatch):
    path = tmp_path / "costmodel.json"
    model = costmodel.fallback_cost_model(costmodel.device_key("cpu"))
    costmodel.save_cost_model(model, path)
    monkeypatch.setenv(costmodel.ENV_PATH, str(path))
    monkeypatch.setattr(costmodel, "_CACHE", {})
    return path
