"""What the harness takes from the program (`redisson_tpu_torch`): a client
built from a configuration file, the executor's own counters, reads of
its state once the window has closed, and the release of its memory."""

from __future__ import annotations

import gc
from typing import List, Optional, Tuple


def make_client(cfg: dict, device: Optional[str] = None):
    """A `RedissonTorch` on the configuration's engine section
    (`CudaConfig` or `PodConfig`) with its settings, pinned ingest route
    included, and the client's own settings (`Config` fields such as
    `inflight_runs`); `device` overrides the section's device (the CPU
    tests)."""
    from redisson_tpu_torch.client import RedissonTorch
    from redisson_tpu_torch.config import Config, CudaConfig, PodConfig

    kinds = {"CudaConfig": ("cuda", CudaConfig), "PodConfig": ("pod", PodConfig)}
    section, kind = kinds[cfg["engine"]]
    settings = dict(cfg.get("engine_settings", {}))
    if device is not None:
        settings["device"] = device
    return RedissonTorch(Config(**{section: kind(**settings)},
                                **cfg.get("client_settings", {})))


def stage_totals(client) -> Tuple[float, int]:
    """(seconds, runs) of the dispatcher's host staging so far, over every
    op kind (`ExecutorMetrics`' `executor.stage_s.<kind>` histograms)."""
    hists = client.metrics.snapshot()["histograms"]
    total, runs = 0.0, 0
    for name, h in hists.items():
        if name.startswith("executor.stage_s."):
            total += h["sum"]
            runs += h["count"]
    return total, runs


def export(client, name: str, kind: str):
    """The dispatcher-serialized copy of one object's state
    (`bits_export` / `hll_export`), as checkpoints read it."""
    return client._executor.execute_sync(name, kind, None)


def free_memory(cards: List[str]) -> int:
    """Give the cards' cached blocks back once the caller has dropped every
    reference to the program's objects, so that the reference that
    follows finds the cards empty. Returns the bytes still allocated on
    them (what the caller failed to drop)."""
    import torch

    gc.collect()
    left = 0
    for card in cards:
        if card.startswith("cuda"):
            with torch.cuda.device(card):
                torch.cuda.empty_cache()
            left += torch.cuda.memory_allocated(card)
    return left


def memory_peak(cards: List[str]) -> int:
    import torch

    return max((torch.cuda.max_memory_allocated(c) for c in cards
                if c.startswith("cuda")), default=0)
