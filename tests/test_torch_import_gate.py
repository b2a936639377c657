"""The port stands alone: every module of redisson_tpu_torch (and
chip_smoke.py) imports with JAX blocked and loads no redisson_tpu module;
an entry point that asks for the card raises when there is none instead of
running on the CPU."""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

from redisson_tpu_torch import device as device_mod
from redisson_tpu_torch.client import RedissonTorch
from redisson_tpu_torch.config import Config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: modules of redisson_tpu_torch the walk must find (52 with the structures
#: tier and RBatch, 67 with persist/, fault/, checkpoint and serve/errors, 84
#: with observability, trace/, memstat/ and the rest of serve/, 96 with the
#: replica tier, the follower, cluster/errors, reactive/, services/ and
#: version, 108 with the cluster tier, parallel/topology, loopwitness and
#: wire/, 114 with geo/ and the two runtime witnesses, 122 with interop/,
#: 129 with the rest of parallel/ and the passthrough half of interop/)
NMODS = 129

_GATE = textwrap.dedent("""
    import importlib, pkgutil, runpy, sys
    sys.modules["jax"] = None  # any `import jax` now raises ImportError
    import redisson_tpu_torch
    mods = [m.name for m in pkgutil.walk_packages(
        redisson_tpu_torch.__path__, "redisson_tpu_torch.")]
    for name in mods:
        importlib.import_module(name)
    import torch
    torch.cuda.is_available = lambda: False
    sys.argv = ["chip_smoke.py"]
    try:
        runpy.run_path("chip_smoke.py", run_name="__main__")
        rc = 0
    except SystemExit as exc:
        rc = exc.code
    leaked = sorted(m for m in sys.modules if m == "redisson_tpu"
                    or m.startswith(("redisson_tpu.", "jax.")))
    slice3 = {"redisson_tpu_torch.native", "redisson_tpu_torch.ingest.delta",
              "redisson_tpu_torch.ingest.tape",
              "redisson_tpu_torch.ops.window_kernel"}
    print("SLICE3", sorted(slice3 - set(mods)))
    slice6 = {"redisson_tpu_torch.structures.engine",
              "redisson_tpu_torch.commands",
              "redisson_tpu_torch.models.batch",
              "redisson_tpu_torch.models.lock"}
    print("SLICE6", sorted(slice6 - set(mods)))
    slice8 = {"redisson_tpu_torch.checkpoint", "redisson_tpu_torch.serve.errors",
              *(f"redisson_tpu_torch.persist.{m}" for m in
                ("codec", "journal", "snapshotter", "recover", "manager")),
              *(f"redisson_tpu_torch.fault.{m}" for m in
                ("taxonomy", "inject", "watchdog", "rebuild", "manager"))}
    print("SLICE8", sorted(slice8 - set(mods)))
    slice9 = {"redisson_tpu_torch.observability",
              "redisson_tpu_torch.trace", "redisson_tpu_torch.memstat",
              *(f"redisson_tpu_torch.trace.{m}" for m in
                ("hist", "spans", "slowlog", "monitor", "export", "manager")),
              *(f"redisson_tpu_torch.memstat.{m}" for m in
                ("accounting", "pressure", "report")),
              *(f"redisson_tpu_torch.serve.{m}" for m in
                ("admission", "breaker", "policy", "scheduler", "windows"))}
    print("SLICE9", sorted(slice9 - set(mods)))
    slice10 = {"redisson_tpu_torch.version", "redisson_tpu_torch.reactive",
               "redisson_tpu_torch.persist.follower",
               "redisson_tpu_torch.cluster", "redisson_tpu_torch.cluster.errors",
               *(f"redisson_tpu_torch.replica.{m}" for m in
                 ("manager", "replica", "router")),
               *(f"redisson_tpu_torch.services.{m}" for m in
                 ("remote", "cache_manager"))}
    print("SLICE10", sorted(slice10 - set(mods)))
    slice11 = {"redisson_tpu_torch.loopwitness", "redisson_tpu_torch.parallel",
               "redisson_tpu_torch.parallel.topology", "redisson_tpu_torch.wire",
               *(f"redisson_tpu_torch.cluster.{m}" for m in
                 ("split", "shard", "router", "migrator", "manager")),
               *(f"redisson_tpu_torch.wire.{m}" for m in
                 ("proto", "commands", "server"))}
    print("SLICE11", sorted(slice11 - set(mods)))
    slice12 = {"redisson_tpu_torch.concurrency",
               "redisson_tpu_torch.contractwitness", "redisson_tpu_torch.geo",
               *(f"redisson_tpu_torch.geo.{m}" for m in
                 ("applier", "link", "manager"))}
    print("SLICE12", sorted(slice12 - set(mods)))
    slice13 = {"redisson_tpu_torch.interop",
               *(f"redisson_tpu_torch.interop.{m}" for m in
                 ("hyll", "resp_client", "pool", "topology_redis", "mini_lua",
                  "fake_server", "durability"))}
    print("SLICE13", sorted(slice13 - set(mods)))
    slice14 = {*(f"redisson_tpu_torch.parallel.{m}" for m in
                 ("mesh", "sharded", "sharded_bits", "backend_pod")),
               *(f"redisson_tpu_torch.interop.{m}" for m in
                 ("backend_redis", "bloom_redis", "coordination_redis"))}
    print("SLICE14", sorted(slice14 - set(mods)))
    print("MODULES", len(mods), "SMOKE_RC", rc, "LEAKED", leaked)
""")


def test_port_imports_without_jax_or_the_jax_package():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _GATE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("MODULES")][-1]
    _, nmods, _, rc, _, leaked = line.split(" ", 5)
    assert int(nmods) >= NMODS
    assert "SLICE3 []" in out.stdout  # the walk covered slice 3's modules
    assert "SLICE6 []" in out.stdout  # and the structures tier's
    assert "SLICE8 []" in out.stdout  # and the durability and fault modules
    assert "SLICE9 []" in out.stdout  # and the serving / tracing / memory tier
    assert "SLICE10 []" in out.stdout  # and the replica tier and the facades
    assert "SLICE11 []" in out.stdout  # and the cluster tier and the wire
    assert "SLICE12 []" in out.stdout  # and geo/ and the witnesses
    assert "SLICE13 []" in out.stdout  # and interop/
    assert "SLICE14 []" in out.stdout  # and parallel/ and the passthrough
    assert rc == "2"  # chip_smoke refuses to run without a card
    assert leaked == "[]"
    assert '"ok"' not in out.stdout


def test_cuda_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        device_mod.resolve("cuda:0")
    with pytest.raises(RuntimeError):
        RedissonTorch.create(Config().use_cuda())
    with pytest.raises(RuntimeError):
        RedissonTorch.create()  # the default is the card, not the CPU
    durable = Config()
    durable.use_cuda()
    durable.use_redis().address = "redis://127.0.0.1:1"
    with pytest.raises(RuntimeError, match="cuda"):
        RedissonTorch.create(durable)  # the durability tier asks for cuda:0
    assert device_mod.resolve("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        device_mod.resolve("mps")


def test_config_accepts_the_host_ingest_paths():
    for ingest in ("hostfold", "delta", "tape"):
        assert Config().use_cuda(device="cpu", ingest=ingest).ingest == ingest
    with pytest.raises(ValueError):
        Config().use_cuda(ingest="bogus")
    with pytest.raises(TypeError):
        Config().use_cuda(no_such_field=1)
    cfg = Config()
    assert cfg.use_cuda(ingest="segment") is cfg.cuda
    assert cfg.cuda.device == "cuda:0"


@pytest.mark.parametrize("ingest", ["hostfold", "delta", "tape"])
def test_forced_host_ingest_raises_without_the_fold_library(monkeypatch, ingest):
    from redisson_tpu_torch import native

    monkeypatch.setattr(native, "available", lambda: False)
    with pytest.raises(RuntimeError, match="host fold library"):
        RedissonTorch.create(Config().use_cuda(device="cpu", ingest=ingest))
    c = RedissonTorch.create(Config().use_cuda(device="cpu", ingest="auto"))
    c.shutdown()  # auto falls back to the device paths
    with pytest.raises(ValueError, match="redis"):
        RedissonTorch.create(Config().use_cuda(device="cpu", ingest=ingest,
                                               hll_hash="redis"))
