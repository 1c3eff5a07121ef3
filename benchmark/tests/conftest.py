"""The benchmark's CPU tests. Tests that need an NVIDIA card carry the
`card` marker and skip here; whether there is a card is decided inside
the `card` fixture, never while a module is imported."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; torch finds none")
    return torch.device("cuda")


@pytest.fixture(scope="session")
def spec():
    from benchmark import registry

    return registry.load_spec()


def small_desc(spec, config):
    """The configuration's file at a size a test run holds."""
    from benchmark import registry

    desc = registry.config_desc(spec, config)
    desc["scale_factor"] = 0.002
    return desc
