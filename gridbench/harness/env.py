"""The run's surroundings: where caches go, which modules may not load,
when the process started, and which cards it runs on."""

from __future__ import annotations

import os
import sys
import time
from typing import List

from gridbench.harness.spec import BENCH_DIR

#: top-level module names that may not be loaded in a run's process: the
#: JAX package and JAX itself (compared whole: the port's name begins with
#: the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "redisson_tpu")
#: a fixed folder inside the checkout for every kernel cache the run makes
CACHE_DIR = BENCH_DIR / ".cache"


def pin_caches() -> None:
    """Point Triton's cache into the checkout (the port's nvcc builds
    already go to `redisson_tpu_torch/build/`) and keep libraries that the
    port may import from loading JAX on their own."""
    (CACHE_DIR / "triton").mkdir(parents=True, exist_ok=True)
    os.environ["TRITON_CACHE_DIR"] = str(CACHE_DIR / "triton")
    os.environ["USE_FLAX"] = "0"


def forbidden_loaded() -> List[str]:
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def process_start() -> float:
    """The process's start on the `time.time()` clock, from its age in
    /proc (clock ticks since boot); now, where /proc cannot say."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - max(0.0, uptime - started)
    except (OSError, ValueError, IndexError):
        return time.time()


def cards(chips: int) -> List[str]:
    """The cards a cell uses: cuda:0 .. cuda:chips-1."""
    return [f"cuda:{i}" for i in range(chips)]


def device_name() -> str:
    import torch

    return torch.cuda.get_device_name(0)

