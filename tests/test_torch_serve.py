"""The port's multi-tenant server against the JAX package's.

Frozen tenants only (the port's first slice): the same RegisterBank images
and requests go to the reference ``SNNServer(backend="jnp",
event_density=None)`` and to the port's server on each backend; counts and
predictions must be bitwise equal (u8 weights and drive: exact sums).
"""
import copy

import numpy as np
import pytest
import torch

from repro.core import connectivity
from repro.core.registers import RegisterBank, WeightLayout
from repro.launch import serve as j_serve
from repro_torch.launch import serve as t_serve

N_MAX, SLOTS, MAX_TICKS = 32, 4, 10


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _banks(seed=0):
    """Five frozen tenants of unequal sizes: layered, ring, dense, sparse, layered."""
    rng = np.random.default_rng(seed)
    specs = [("layered", 20), ("ring", 32), ("dense", 14), ("sparse", 27), ("layered", 11)]
    out = []
    for i, (kind, n) in enumerate(specs):
        if kind == "layered":
            n_in, n_out = n // 3, max(2, n // 4)
            c = connectivity.layered([n_in, n - n_in - n_out, n_out])
        elif kind == "ring":
            c, n_in, n_out = connectivity.ring(n, k=2), n, n
        elif kind == "dense":
            c, n_in, n_out = connectivity.all_to_all(n), n, n
        else:
            c, n_in, n_out = connectivity.sparse_random(n, 0.15, seed=i), n, n
        bank = RegisterBank(n, weight_layout=WeightLayout.PER_SYNAPSE)
        bank.set_connection_list(c)
        bank.set_weights((rng.integers(40, 200, (n, n)) * c).astype(np.uint8))
        bank.set_thresholds(rng.integers(60, 200, (n,)).astype(np.uint8))
        bank.set_leak(int(rng.integers(0, 8)))
        bank.set_refractory(int(rng.integers(0, 3)))
        out.append((f"{kind}-{i}", bank, n_in, n_out))
    return out


def _requests(banks, n_requests, seed):
    """Requests as numpy records; budgets below and at max_ticks."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n_requests):
        name, bank, n_in, _ = banks[i % len(banks)]
        ticks = int(rng.integers(3, MAX_TICKS + 1))
        ext = ((rng.random((ticks, n_in)) < 0.4)
               * rng.integers(80, 255, (ticks, n_in))).astype(np.float32)
        reqs.append((i, name, ext, ticks))
    return reqs


def _serve(mod, server, reqs):
    made = [mod.ServeRequest(rid=i, tenant=t, ext=e.copy(), n_ticks=k) for i, t, e, k in reqs]
    return made, server.serve(made)


@pytest.fixture(scope="module")
def reference():
    banks = _banks()
    server = j_serve.SNNServer(n_max=N_MAX, slots=SLOTS, max_ticks=MAX_TICKS,
                               backend="jnp", event_density=None)
    for name, bank, n_in, n_out in banks:
        server.add_tenant(name, bank, n_in=n_in, n_out=n_out)
    reqs = _requests(banks, 11, seed=1) + [(99, "no-such-tenant", np.ones((2, 2), np.float32), 2)]
    made, stats = _serve(j_serve, server, reqs)
    return banks, reqs, made, stats


def _port_server(banks, backend):
    server = t_serve.SNNServer(n_max=N_MAX, slots=SLOTS, max_ticks=MAX_TICKS,
                               backend=backend, device="cpu")
    for name, bank, n_in, n_out in banks:
        server.add_tenant(name, copy.deepcopy(bank), n_in=n_in, n_out=n_out)
    return server


@pytest.mark.parametrize("backend", ["jnp", "pallas", "pallas_fused"])
def test_counts_and_preds_bitwise(reference, backend):
    banks, reqs, j_made, j_stats = reference
    t_made, t_stats = _serve(t_serve, _port_server(banks, backend), reqs)
    served = [r for r in j_made if r.tenant != "no-such-tenant"]
    assert len(served) == 11 and any(r.n_ticks < MAX_TICKS for r in served)
    assert sum(float(r.counts.sum()) for r in served) > 0
    for jr, tr in zip(j_made, t_made):
        if jr.tenant == "no-such-tenant":
            assert tr.counts is None
            continue
        np.testing.assert_array_equal(tr.counts, jr.counts)
        assert tr.pred == jr.pred
    assert t_stats["preds"] == j_stats["preds"]
    for key in ("n_requests", "requests_rejected", "n_tenants", "waves", "ticks",
                "useful_slot_ticks", "spikes_out", "compiles", "recompiles_after_warmup"):
        assert t_stats[key] == j_stats[key], key


def test_stats_key_set_and_rejections(reference):
    banks, _, _, j_stats = reference
    server = _port_server(banks, "pallas_fused")
    _, t_stats = _serve(t_serve, server, [(0, "nobody", np.ones((2, 2), np.float32), 2)])
    assert set(t_stats) == set(j_stats)
    assert t_stats["requests_served"] == 0 and t_stats["requests_rejected"] == 1
    assert server.requests_rejected == 1
    _, empty = _serve(t_serve, server, [])
    assert set(empty) == set(j_stats) and empty["n_requests"] == 0


def test_budget_masks_counts(reference):
    """A request with a short budget counts only its first ticks."""
    banks = reference[0]
    server = _port_server(banks, "pallas_fused")
    name, _, n_in, _ = banks[2]
    ext = np.full((MAX_TICKS, n_in), 200.0, np.float32)
    full = t_serve.ServeRequest(rid=0, tenant=name, ext=ext, n_ticks=MAX_TICKS)
    short = t_serve.ServeRequest(rid=1, tenant=name, ext=ext, n_ticks=3)
    server.serve([full, short])
    assert short.counts.sum() < full.counts.sum()


def test_plastic_and_later_options_raise(reference):
    banks = reference[0]
    server = _port_server(banks[:1], "jnp")
    name, bank, n_in, n_out = banks[0]
    with pytest.raises(NotImplementedError, match="STDP slice"):
        server.add_tenant("learner", bank, n_in=n_in, n_out=n_out, plastic=True)
    with pytest.raises(NotImplementedError, match="event slice"):
        t_serve.SNNServer(n_max=8, event_density=0.2, device="cpu")
    with pytest.raises(NotImplementedError, match="observability slice"):
        t_serve.SNNServer(n_max=8, telemetry=True, device="cpu")


def test_demo_generators_and_cli_smoke(capsys):
    stats = t_serve.main(["--arch", "snn", "--smoke", "--device", "cpu", "--requests", "9"])
    assert stats["n_requests"] == 9 and stats["recompiles_after_warmup"] == 0
    assert "kernel launches" in capsys.readouterr().out
