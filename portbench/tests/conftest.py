"""Shared pieces of the benchmark's own tests (CPU; the card leg skips
without one)."""
from __future__ import annotations

import pytest

from portbench import harness, program


@pytest.fixture(scope="session")
def prog():
    return program.load()


@pytest.fixture
def small():
    """A cell's configuration on a small graph."""
    def make(config: str, n_vertices: int = 512) -> dict:
        return dict(harness.load_config(config), n_vertices=n_vertices)
    return make


@pytest.fixture
def card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch
