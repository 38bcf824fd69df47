"""The benchmark's own tests: CPU tests at tiny sizes, and tests marked
`cuda` that run on a card and skip without one (decided inside each
test). Run them from the repository root:

    python -m pytest benchmark/tests -q
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU with CUDA; skips without one")


@pytest.fixture
def db_cache(tmp_path, monkeypatch):
    """The database cache of a test, in its own temporary directory."""
    from benchmark.harness import panel

    monkeypatch.setattr(panel, "CACHE_DIR", str(tmp_path / "cache"))
    return tmp_path / "cache"
