"""The port's dispatch policy against the JAX package's, field for field.

``dispatch_policy`` is host-side numpy in both packages, so every field of a
plan must be equal: strategy, spike budget, knee, hysteresis, fan-in cap,
diagonal drive, the modeled costs (exact floats), and the fan-in lists
(equal arrays). The port's plan also accepts tensors.
"""
import numpy as np
import pytest
import torch

from repro.core import connectivity as j_conn
from repro.core import dispatch_policy as j_policy
from repro_torch import interop
from repro_torch.core import dispatch_policy as t_policy
from repro_torch.core.engine import EngineOptions

PLATFORMS = ("cpu", "gpu", "tpu")


def _fields(plan):
    return interop.plan_to_numpy(plan)


def _assert_plans_equal(t_plan, j_plan):
    got, want = _fields(t_plan), _fields(j_plan)
    assert set(got) == set(want)
    for key, value in want.items():
        if isinstance(value, np.ndarray):
            assert got[key].dtype == value.dtype, key
            np.testing.assert_array_equal(got[key], value, err_msg=key)
        else:
            assert got[key] == value, key


def test_constants_are_the_reference_ones():
    assert t_policy.GATHER_PENALTY == j_policy.GATHER_PENALTY
    assert t_policy.GATHER_PENALTY["gpu"] == 6.0
    assert t_policy.TOPK_SORT_PENALTY == j_policy.TOPK_SORT_PENALTY
    assert t_policy.DEFAULT_HYSTERESIS == j_policy.DEFAULT_HYSTERESIS


@pytest.mark.parametrize("n", [1, 7, 64, 4096])
@pytest.mark.parametrize("k_active", [None, 1, 30, 10_000])
def test_resolve_k_active(n, k_active):
    assert t_policy.resolve_k_active(n, k_active) == j_policy.resolve_k_active(n, k_active)


@pytest.mark.parametrize("platform", PLATFORMS + ("unknown",))
@pytest.mark.parametrize("n", [1, 40, 4096])
def test_knee_and_costs(platform, n):
    assert t_policy.knee_spikes(n, platform=platform) == j_policy.knee_spikes(n, platform=platform)
    assert t_policy.gather_penalty(platform) == j_policy.gather_penalty(platform)
    for b in (1, 16):
        assert t_policy.dense_cost(n, b, n_ext_gemms=1) == j_policy.dense_cost(n, b, n_ext_gemms=1)
        assert (t_policy.fanin_cost(n, b, 9, platform=platform)
                == j_policy.fanin_cost(n, b, 9, platform=platform))
        assert (t_policy.topk_cost(n, b, 12, platform=platform)
                == j_policy.topk_cost(n, b, 12, platform=platform))


def test_platform_follows_the_visible_card():
    assert t_policy._platform(None) == ("gpu" if torch.cuda.is_available() else "cpu")
    assert t_policy._platform("tpu") == "tpu"


def test_is_diagonal_on_arrays_and_tensors():
    eye = np.eye(5, dtype=np.float32)
    off = eye.copy()
    off[0, 1] = 1.0
    for a in (None, eye, off, np.ones((2, 3)), np.diag(np.arange(5.0))):
        assert t_policy.is_diagonal(a) == j_policy.is_diagonal(a)
        if a is not None:
            assert t_policy.is_diagonal(torch.as_tensor(a)) == j_policy.is_diagonal(a)


@pytest.mark.parametrize("platform", PLATFORMS)
@pytest.mark.parametrize("density", [0.02, 0.05, 0.1, 0.3])
@pytest.mark.parametrize("opts", [
    {}, {"rate": 0.05}, {"rate": 0.2, "batch": 16}, {"k_active": 5},
    {"cap": 64}, {"cap": 2}, {"vmap_safe": True}, {"adaptive": False},
    {"vmap_safe": True, "cap": 64, "prefer_density": 0.2},
])
def test_plan_field_for_field(platform, density, opts):
    """Every field of the plan, for a range of densities, rates, caps and
    options, on each platform's cost model."""
    n = 96
    c = j_conn.sparse_random(n, density, seed=int(density * 100))
    w_in = np.eye(n, dtype=np.float32) if density < 0.1 else np.ones((n, n), np.float32)
    j_plan = j_policy.plan(c, w_in=w_in, platform=platform, **opts)
    t_plan = t_policy.plan(c, w_in=w_in, platform=platform, device="cpu", **opts)
    _assert_plans_equal(t_plan, j_plan)
    t_from_tensors = t_policy.plan(torch.as_tensor(c), w_in=torch.as_tensor(w_in),
                                   platform=platform, **opts)
    _assert_plans_equal(t_from_tensors, j_plan)
    if t_plan.neighbors is not None:
        assert t_from_tensors.neighbors.idx.device.type == "cpu"
        assert t_plan.neighbors.idx.dtype == torch.int32


def test_plan_builds_the_engine_options():
    """A plan's ``engine_kwargs`` are the reference's and build a validated
    event engine; ``engine_options`` layers other options on top."""
    c = j_conn.sparse_random(128, 0.3, seed=3)
    j_plan = j_policy.plan(c, platform="tpu", rate=0.05)
    t_plan = t_policy.plan(c, platform="tpu", rate=0.05, device="cpu")
    assert t_plan.strategy == "topk" and t_plan.knee is not None
    assert t_plan.engine_kwargs() == j_plan.engine_kwargs()
    opts = t_plan.engine_options(mode="euler")
    assert isinstance(opts, EngineOptions) and opts.backend == "event"
    assert (opts.mode, opts.event_knee, opts.event_k_active) == ("euler", t_plan.knee,
                                                                 t_plan.k_active)


def test_plan_carries_across_through_interop():
    """A reference plan carried across as numpy fields is the port's plan."""
    c = j_conn.sparse_random(80, 0.05, seed=4)
    j_plan = j_policy.plan(c, w_in=np.eye(80), platform="cpu", cap=40, prefer_density=0.1,
                           vmap_safe=True)
    assert j_plan.strategy == "fan_in"
    carried = interop.plan_from_numpy(_fields(j_plan), "cpu")
    _assert_plans_equal(carried, j_plan)
    _assert_plans_equal(t_policy.plan(c, w_in=np.eye(80), platform="cpu", cap=40,
                                      prefer_density=0.1, vmap_safe=True, device="cpu"),
                        j_plan)
