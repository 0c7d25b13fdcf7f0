"""Pytest settings shared by every test directory: the `cuda` marker of the
tests that need an NVIDIA GPU (they skip without one)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")
