"""Shared pieces of the benchmark's tests: the `cuda` marker, a fixture
that decides inside a test whether a card exists, and a shrunk copy of a
cell that runs on the CPU in about a second."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: the shrunk sizes of each configuration and mix for the CPU
SMALL_CONFIG = {"id_bits": 14, "setbits_per_day": 2048, "days": 5}
SMALL_MIX = {"warm_seconds": 0.1, "trace_seconds": 0.3, "window_days": 5,
             "login_batch": 64, "login_every_ms": 10,
             "today_setbits_at_start": 1024}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips where none is visible")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible")
    return "cuda:0"


def small(config: str, traffic: str):
    """(config, mix) of a cell, shrunk and on the CPU."""
    from gridbench.harness import spec

    cfg, mix = spec.config(config), spec.traffic(traffic)
    cfg.update({k: v for k, v in SMALL_CONFIG.items() if k in cfg})
    cfg["engine_settings"]["device"] = "cpu"
    mix.update({k: v for k, v in SMALL_MIX.items() if k in mix})
    return cfg, mix
