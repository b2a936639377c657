"""The port's command table (`redisson_tpu_torch.commands`) against the JAX
package's and against the port's own backends, in both directions, as
tests/test_commands_table.py holds the JAX backends."""

import re

import pytest

from redisson_tpu import commands as jax_commands
from redisson_tpu_torch import commands

#: device-tier kinds the port has no handler for yet: none since geo/ and
#: the backend's four `_op_geo_*` handlers landed
WAITING_FOR_GEO = set()


def _ops_of(path: str) -> set:
    with open(path) as f:
        return set(re.findall(r"def _op_(\w+)\(", f.read()))


def test_op_table_equals_the_jax_table():
    assert list(commands.OP_TABLE) == list(jax_commands.OP_TABLE)
    assert len(commands.OP_TABLE) == len(jax_commands.OP_TABLE) == 174
    for kind, d in commands.OP_TABLE.items():
        j = jax_commands.OP_TABLE[kind]
        assert (d.kind, d.redis_name, d.write, d.tiers, d.contract) == (
            j.kind, j.redis_name, j.write, j.tiers, j.contract), kind


@pytest.mark.parametrize("tier", ["engine", "tpu", "redis", "coord"])
def test_kinds_for_tier_match(tier):
    assert commands.kinds_for_tier(tier) == jax_commands.kinds_for_tier(tier)


def test_engine_tier_complete():
    impl = _ops_of("redisson_tpu_torch/structures/engine.py") | _ops_of(
        "redisson_tpu_torch/structures/extended.py")
    table = commands.kinds_for_tier("engine")
    impl |= {"keys"}  # keyspace scan is served by RoutingBackend's fan-out
    assert impl - table == set(), f"undocumented engine ops: {impl - table}"
    assert table - impl == set(), f"phantom engine ops: {table - impl}"


def test_device_tier_complete_but_geo():
    impl = _ops_of("redisson_tpu_torch/backend_torch.py")
    table = commands.kinds_for_tier("tpu")
    assert impl - table == set(), f"undocumented device ops: {impl - table}"
    assert table - impl == WAITING_FOR_GEO


def test_router_sends_every_kind_to_a_tier():
    """No kind of the engine or device tier reaches a NotImplementedError:
    each has a handler in the tier the router picks for it."""
    from redisson_tpu_torch.client import RedissonTorch
    from redisson_tpu_torch.config import Config

    c = RedissonTorch.create(Config().use_cuda(device="cpu"))
    try:
        routing = c._routing
        for kind in commands.kinds_for_tier("engine"):
            if kind in routing._BOTH:
                continue
            assert routing.structures.handles(kind) or routing.sketch.handles(kind), kind
        for kind in commands.kinds_for_tier("tpu") - WAITING_FOR_GEO:
            assert kind in routing._BOTH or routing.sketch.handles(kind), kind
    finally:
        c.shutdown()


def test_descriptor_sanity():
    assert len(commands.OP_TABLE) >= 155
    for k, d in commands.OP_TABLE.items():
        assert d.kind == k
        assert d.redis_name
        assert d.tiers
