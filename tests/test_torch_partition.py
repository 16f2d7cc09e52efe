"""Port parity: the partition schedule and the scenario-axis shard planner.

The port's ``core/partition.py`` is a copy of the JAX package's numpy
code, so everything here is held **equal** to the JAX package's result
on the cases of ``tests/test_partition.py``: Algorithm 1's simulated
schedule and paper Table I, the cost model, LPT plans, layouts, the
measured-seconds re-plan and the EMA rebalancer.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import partition as J

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from repro_torch.core import partition as T


def _same_schedule(a, b):
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.makespan_nodes == b.makespan_nodes
    assert a._init_counts == b._init_counts


@pytest.mark.parametrize("n,p,L,literal", [
    (100, 3, 5, False), (250, 8, 5, False), (1000, 4, 50, False),
    (37, 2, 3, False), (64, 8, 1, False), (200, 4, 5, True),
    (500, 8, 10, True), (1200, 2, 5, False)])
def test_simulate_schedule_matches_jax(n, p, L, literal):
    _same_schedule(T.simulate_schedule(n, p, L, literal=literal),
                   J.simulate_schedule(n, p, L, literal=literal))


def test_table1_reference_and_reproduction_match_jax():
    assert T.table1_reference() == J.table1_reference()
    for (p, n), want in T.table1_reference().items():
        assert T.simulate_schedule(n, p, 5).p0_nodes == want
    for bad in ((0, 2, 5), (10, 0, 5), (10, 2, 0)):
        with pytest.raises(ValueError, match="need p >= 1"):
            T.simulate_schedule(*bad)


def test_scenario_costs_match_jax():
    cases = [
        dict(n_steps=100, cost_rate=[0.0, 0.01], capacity=48),
        dict(n_steps=200, cost_rate=[0.0]),
        dict(n_steps=100, cost_rate=[0.0, 0.01], capacity=48, pieces=6),
        dict(n_steps=100, cost_rate=[0.01, 0.01], capacity=48,
             pieces=np.array([4.0, 8.0])),
        dict(n_steps=100, cost_rate=[0.0], capacity=48, pieces=40),
        dict(n_steps=50, cost_rate=np.tile([0.0, 0.01], 5), engine="lsmc",
             n_paths=2048, n_exercise=11, n_assets=3),
        dict(n_steps=50, cost_rate=[0.0, 0.02], engine="lsmc"),
    ]
    for kw in cases:
        np.testing.assert_array_equal(T.scenario_costs(**kw),
                                      J.scenario_costs(**kw))


def _plan_cases():
    cr = np.tile([0.0, 0.005, 0.01], 36)
    return [
        (J.scenario_costs(10, cr, capacity=16), 8, {}),
        (np.ones(12), 4, {}),
        (np.ones(3), 8, {}),
        (np.ones(10), 2, dict(lanes_pow2=True)),
        (J.scenario_costs(50, np.tile([0.0, 0.01], 20), capacity=32), 4, {}),
        (np.ones(300), 2, dict(device_speed=[2.0, 1.0])),
        (J.scenario_costs(8, np.tile([0.0, 0.01, 0.01], 11), capacity=8),
         4, {}),
    ]


@pytest.mark.parametrize("case", range(7))
def test_plan_shards_and_layout_match_jax(case):
    costs, n, kw = _plan_cases()[case]
    got, want = T.plan_shards(costs, n, **kw), J.plan_shards(costs, n, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.sizes, got.padded_rows, got.work_spread) == (
        want.sizes, want.padded_rows, want.work_spread)
    for a, b in zip(T.shard_layout(got), J.shard_layout(want)):
        np.testing.assert_array_equal(a, b)


def test_plan_shards_errors_match_jax():
    for args, kw in (((np.ones(4), 0), {}),
                     ((np.array([1.0, -1.0]), 2), {}),
                     ((np.ones(4), 2), dict(device_speed=[1.0, 0.0]))):
        with pytest.raises(ValueError) as jx:
            J.plan_shards(*args, **kw)
        with pytest.raises(ValueError, match=str(jx.value)):
            T.plan_shards(*args, **kw)
    bad = T.ShardPlan(n_shards=1, shards=((0,),), work=(1.0,), lanes=1,
                      n_rows=2)
    with pytest.raises(ValueError, match="every row exactly once"):
        T.shard_layout(bad)


@pytest.mark.parametrize("seconds", [[3.0, 1.0, 1.0, 1.0],
                                     [1.0, 1.0, 1.0, 1.0],
                                     [0.0, 2.0, 1.0, 0.5]])
def test_replan_shards_matches_jax(seconds):
    costs = np.ones(120)
    tp, jp = T.plan_shards(costs, 4), J.plan_shards(costs, 4)
    got = T.replan_shards(costs, tp, seconds)
    want = J.replan_shards(costs, jp, seconds)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert sum(got.sizes) == 120


def test_rebalancer_matches_jax():
    tr, jr = T.ShardRebalancer(ema=0.5), J.ShardRebalancer(ema=0.5)
    costs = np.ones(64)
    for secs in ([2.0, 1.0, 1.0, 1.0], [2.0, 1.0, 1.0, 1.0],
                 [1.0, 1.0, 3.0, 1.0]):
        tp, jp = tr.plan("bucket", costs, 4), jr.plan("bucket", costs, 4)
        assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
        np.testing.assert_array_equal(tr.observe("bucket", tp, secs),
                                      jr.observe("bucket", jp, secs))
    np.testing.assert_array_equal(tr.speed("bucket", 4),
                                  jr.speed("bucket", 4))
    assert (tr.speed("other", 4) == 1.0).all()
    assert (tr.speed("bucket", 8) == 1.0).all()
    with pytest.raises(ValueError, match=r"ema must be in \(0, 1\]"):
        T.ShardRebalancer(ema=0.0)
