"""The port's multi-tenant server against the JAX package's.

The same RegisterBank images and requests go to the reference
``SNNServer(backend="jnp", event_density=None)`` and to the port's server on
each backend. Counts and predictions must be bitwise equal (u8 weights and
drive: exact sums, and at these sizes the learned weights keep every spike
decision away from its threshold). A plastic tenant's written-back weights
must match the reference's to ``rtol=atol=1e-5``, the reference's own
tolerance between its learning backends.
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
    """A plastic tenant is accepted: a wave that holds it learns until the
    plastic slot's budget and not at all in the frozen slots (their
    ``learn_until`` is 0), a frozen-only wave does not learn; the event
    program's options construct, telemetry is on by default with its
    registry, and ``telemetry=False`` builds a server without it."""
    banks = reference[0]
    server = _port_server(banks[:1], "jnp")
    name, bank, n_in, n_out = banks[0]
    learner = server.add_tenant("learner", bank, n_in=n_in, n_out=n_out, plastic=True)
    assert learner.plastic and not server.tenants[name].plastic
    ext = np.ones((MAX_TICKS, n_in), np.float32)
    frozen_req = t_serve.ServeRequest(rid=0, tenant=name, ext=ext, n_ticks=5)
    learner_req = t_serve.ServeRequest(rid=1, tenant="learner", ext=ext, n_ticks=3)
    _, _, budget, until, rewards = server._assemble([frozen_req, learner_req])
    assert budget.tolist() == [5, 3, 0, 0] and until.tolist() == [0, 3, 0, 0]
    assert rewards.shape == (MAX_TICKS, SLOTS) and not rewards.any()
    _, _, _, until, rewards = server._assemble([frozen_req])
    assert until is None and rewards is None
    sparse_server = t_serve.SNNServer(n_max=8, event_density=0.2, device="cpu")
    assert (sparse_server.event_density, sparse_server.event_cap) == (0.2, 2)
    assert sparse_server.backend == "jnp"
    assert sparse_server.telemetry and sparse_server.registry.get("snn_requests_total")
    quiet = t_serve.SNNServer(n_max=8, telemetry=False, device="cpu")
    assert not quiet.telemetry and quiet.tenant_report() == {}


def test_demo_generators_and_cli_smoke(capsys):
    stats = t_serve.main(["--arch", "snn", "--smoke", "--device", "cpu", "--requests", "9",
                           "--slots", "8"])
    assert stats["n_requests"] == 9 and stats["recompiles_after_warmup"] == 0
    assert "kernel launches" in capsys.readouterr().out


# -- plastic tenants -------------------------------------------------------------


def _learner_bank(seed=3, n=16):
    """A dense tenant whose weights can move: mid-range u8 weights."""
    rng = np.random.default_rng(seed)
    bank = RegisterBank(n, weight_layout=WeightLayout.PER_SYNAPSE)
    bank.set_connection_list(connectivity.all_to_all(n))
    bank.set_weights(rng.integers(60, 160, (n, n)).astype(np.uint8))
    bank.set_thresholds(rng.integers(60, 160, (n,)).astype(np.uint8))
    bank.set_leak(2)
    bank.set_refractory(1)
    return bank


def _learner_requests(n_req, seed, rid0=100, rewards=False):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_req):
        ticks = int(rng.integers(4, MAX_TICKS + 1))
        ext = ((rng.random((ticks, 16)) < 0.4) * rng.integers(80, 255, (ticks, 16))).astype(
            np.float32)
        rew = rng.uniform(-1, 1, ticks).astype(np.float32) if rewards else None
        out.append((rid0 + i, "learner", ext, ticks, rew))
    return out


def _serve_with_rewards(mod, server, reqs):
    made = [mod.ServeRequest(rid=i, tenant=t, ext=e.copy(), n_ticks=k,
                             rewards=None if r is None else r.copy())
            for i, t, e, k, r in reqs]
    return made, server.serve(made)


def _mixed_requests(banks, rule):
    """Frozen requests with the learner's interleaved: two learner requests
    land in the first four, so admission must defer one."""
    frozen = [r + (None,) for r in _requests(banks, 7, seed=4)]
    learner = _learner_requests(4, seed=5, rewards=rule == "rstdp")
    return [frozen[0], learner[0], learner[1], frozen[1], frozen[2], learner[2],
            frozen[3], frozen[4], frozen[5], learner[3], frozen[6]]


RULES = {"stdp": None, "rstdp": dict(a_plus=0.5, a_minus=0.25, lr_reward=2.0)}


@pytest.fixture(scope="module", params=sorted(RULES))
def plastic_reference(request):
    from repro.plasticity import PlasticityParams as JPP

    rule = request.param
    banks = _banks()
    jpp = None if RULES[rule] is None else JPP.make(rule, **RULES[rule])
    server = j_serve.SNNServer(n_max=N_MAX, slots=SLOTS, max_ticks=MAX_TICKS, backend="jnp",
                               event_density=None, plasticity=jpp)
    for name, bank, n_in, n_out in banks:
        server.add_tenant(name, bank, n_in=n_in, n_out=n_out)
    server.add_tenant("learner", _learner_bank(), n_in=16, n_out=16, plastic=True)
    w0 = np.asarray(server.tenants["learner"].params.w).copy()
    reqs = _mixed_requests(banks, rule)
    made, stats = _serve_with_rewards(j_serve, server, reqs)
    return rule, banks, reqs, made, stats, w0, np.asarray(server.tenants["learner"].params.w)


@pytest.mark.parametrize("backend", ["jnp", "pallas", "pallas_fused"])
def test_plastic_tenant_matches_reference(plastic_reference, backend):
    """Counts and predictions equal across waves, the learner's written-back
    weights within 1e-5 of the reference's, the same number of waves."""
    from repro_torch.plasticity import PlasticityParams

    rule, banks, reqs, j_made, j_stats, w0, j_w = plastic_reference
    pp = None if RULES[rule] is None else PlasticityParams.make(rule, **RULES[rule])
    server = t_serve.SNNServer(n_max=N_MAX, slots=SLOTS, max_ticks=MAX_TICKS,
                               backend=backend, device="cpu", plasticity=pp)
    for name, bank, n_in, n_out in banks:
        server.add_tenant(name, copy.deepcopy(bank), n_in=n_in, n_out=n_out)
    server.add_tenant("learner", _learner_bank(), n_in=16, n_out=16, plastic=True)
    t_made, t_stats = _serve_with_rewards(t_serve, server, reqs)
    assert t_stats["waves"] == j_stats["waves"] >= 4
    for jr, tr in zip(j_made, t_made):
        np.testing.assert_array_equal(tr.counts, jr.counts, err_msg=str(tr.rid))
        assert tr.pred == jr.pred
    assert t_stats["preds"] == j_stats["preds"]
    t_w = server.tenants["learner"].params.w.numpy()
    assert np.abs(t_w - w0).max() > 1.0, "the learner should learn"
    np.testing.assert_allclose(t_w, j_w, rtol=1e-5, atol=1e-5)
    assert t_w.min() >= 0.0 and t_w.max() <= 255.0
    for name, bank, _, _ in banks:
        np.testing.assert_array_equal(server.tenants[name].params.w[:bank.n, :bank.n].numpy(),
                                      bank.weights.astype(np.float32))


def test_one_request_per_plastic_tenant_per_wave():
    """Three learner requests and two frozen ones on four slots: the reference
    defers the second and third learner request to waves of their own, and the
    port admits the same waves; each later wave starts from the learned weights."""
    banks = _banks()[:2]
    reqs = ([r + (None,) for r in _requests(banks, 2, seed=6)]
            + _learner_requests(3, seed=7))
    reqs = [reqs[2], reqs[3], reqs[0], reqs[4], reqs[1]]
    results = {}
    for mod, kw in ((j_serve, {"event_density": None}), (t_serve, {"device": "cpu"})):
        server = mod.SNNServer(n_max=N_MAX, slots=SLOTS, max_ticks=MAX_TICKS, **kw)
        for name, bank, n_in, n_out in banks:
            server.add_tenant(name, copy.deepcopy(bank), n_in=n_in, n_out=n_out)
        server.add_tenant("learner", _learner_bank(), n_in=16, n_out=16, plastic=True)
        waves = []
        run_wave = server.run_wave
        server.run_wave = lambda wave, run=run_wave: (
            waves.append([r.rid for r in wave if r.rid >= 0]), run(wave))
        made, stats = _serve_with_rewards(mod, server, reqs)
        results[mod] = (waves, stats, made)
    (j_waves, j_stats, j_made), (t_waves, t_stats, t_made) = results[j_serve], results[t_serve]
    assert t_waves == j_waves and t_stats["waves"] == j_stats["waves"] == 3
    for wave in t_waves:
        assert sum(1 for rid in wave if rid >= 100) <= 1
    for jr, tr in zip(j_made, t_made):
        np.testing.assert_array_equal(tr.counts, jr.counts)


@pytest.mark.parametrize("backend", ["jnp", "pallas", "pallas_fused"])
def test_frozen_counts_do_not_depend_on_a_plastic_wave(backend):
    """A frozen tenant's counts are bitwise the same whether its wave runs the
    frozen rollout (no plastic tenant) or the learning rollout (one there):
    this pins the port's frozen-wave shortcut."""
    banks = _banks()
    server = _port_server(banks, backend)
    server.add_tenant("learner", _learner_bank(), n_in=16, n_out=16, plastic=True)
    frozen = _requests(banks, 3, seed=8)
    alone, _ = _serve(t_serve, server, frozen)
    learner = _learner_requests(1, seed=9)
    made, stats = _serve_with_rewards(t_serve, server, [r + (None,) for r in frozen] + learner)
    assert stats["waves"] == 1
    for a, m in zip(alone, made):
        np.testing.assert_array_equal(a.counts, m.counts)
        assert a.pred == m.pred


def test_demo_tenants_mark_the_last_plastic():
    j_server = j_serve.SNNServer(n_max=24, slots=2, max_ticks=4, event_density=None)
    t_server = t_serve.SNNServer(n_max=24, slots=2, max_ticks=4, device="cpu")
    for n_tenants in (4, 8):
        j_names = j_serve.make_demo_tenants(j_server, n_tenants, seed=n_tenants)
        t_names = t_serve.make_demo_tenants(t_server, n_tenants, seed=n_tenants)
        assert t_names == j_names
        for name in t_names:
            jt, tt = j_server.tenants[name], t_server.tenants[name]
            assert tt.plastic == jt.plastic == (name == t_names[-1])
            # The reference's plastic mask: the connection list of the plastic
            # tenant, all-zero for a frozen one (whose learn_until is 0 here).
            want = tt.params.c.numpy() if tt.plastic else 0.0
            np.testing.assert_array_equal(np.asarray(jt.plastic_c), np.broadcast_to(
                want, jt.plastic_c.shape))


# -- the event program ----------------------------------------------------------


def _event_banks(seed=0):
    """The five frozen tenants plus two sparse ones whose fan-in fits the
    event program's cap (``N_MAX // 4``): a ring and a 10 % random fabric."""
    rng = np.random.default_rng(seed + 100)
    out = _banks(seed)
    for name, c in (("ring-5", connectivity.ring(24, k=1)),
                    ("sparse-6", connectivity.sparse_random(30, 0.1, seed=6))):
        n = c.shape[0]
        bank = RegisterBank(n, weight_layout=WeightLayout.PER_SYNAPSE)
        bank.set_connection_list(c)
        bank.set_weights((rng.integers(40, 200, (n, n)) * c).astype(np.uint8))
        bank.set_thresholds(rng.integers(60, 200, (n,)).astype(np.uint8))
        bank.set_leak(int(rng.integers(0, 8)))
        bank.set_refractory(int(rng.integers(0, 3)))
        out.append((name, bank, n, n))
    return out


def _logged(server):
    """Record each wave's request ids and its tenants' programs."""
    waves = []
    run_wave = server.run_wave

    def run(wave):
        waves.append(([r.rid for r in wave if r.rid >= 0],
                      {server.tenants[r.tenant].backend for r in wave}))
        return run_wave(wave)

    server.run_wave = run
    return waves


@pytest.fixture(scope="module")
def event_reference():
    banks = _event_banks()
    server = j_serve.SNNServer(n_max=N_MAX, slots=SLOTS, max_ticks=MAX_TICKS,
                               backend="jnp", event_density=0.2)
    for name, bank, n_in, n_out in banks:
        server.add_tenant(name, bank, n_in=n_in, n_out=n_out)
    waves = _logged(server)
    reqs = _requests(banks, 17, seed=11)
    made, stats = _serve(j_serve, server, reqs)
    return banks, reqs, made, stats, waves, server


@pytest.mark.parametrize("backend", ["jnp", "pallas", "pallas_fused"])
def test_event_program_counts_bitwise(event_reference, backend):
    """With ``event_density=0.2`` the same tenants ride the event program as
    in the reference, the waves are grouped by program in the same order, and
    every count and prediction is bitwise the reference's."""
    banks, reqs, j_made, j_stats, j_waves, j_server = event_reference
    server = t_serve.SNNServer(n_max=N_MAX, slots=SLOTS, max_ticks=MAX_TICKS,
                               backend=backend, event_density=0.2, device="cpu")
    for name, bank, n_in, n_out in banks:
        server.add_tenant(name, copy.deepcopy(bank), n_in=n_in, n_out=n_out)
    waves = _logged(server)
    t_made, t_stats = _serve(t_serve, server, reqs)
    on_event = sorted(n for n, t in server.tenants.items() if t.backend == "event")
    assert on_event == sorted(n for n, t in j_server.tenants.items() if t.backend == "event")
    assert set(on_event) >= {"ring-1", "ring-5", "sparse-6"}
    relabel = lambda b: "default" if b != "event" else b
    assert [(ids, {relabel(b) for b in bs}) for ids, bs in waves] == [
        (ids, {relabel(b) for b in bs}) for ids, bs in j_waves]
    assert all(len(bs) == 1 for _, bs in waves)
    for jr, tr in zip(j_made, t_made):
        np.testing.assert_array_equal(tr.counts, jr.counts, err_msg=str(tr.rid))
        assert tr.pred == jr.pred
    assert t_stats["preds"] == j_stats["preds"]
    assert t_stats["backends"]["event"] == j_stats["backends"]["event"]
    assert sum(t_stats["backends"].values()) == sum(j_stats["backends"].values())
    assert t_stats["compiles"] == j_stats["compiles"] == 2
    for key in ("n_requests", "waves", "ticks", "useful_slot_ticks", "spikes_out"):
        assert t_stats[key] == j_stats[key], key


def test_event_tenants_carry_the_reference_fan_in_lists(event_reference):
    """Admission plans each sparse tenant as the reference does: the same
    plan, and ``(n_max, event_cap)`` fan-in lists equal to the reference's."""
    banks, _, _, _, _, j_server = event_reference
    server = t_serve.SNNServer(n_max=N_MAX, slots=SLOTS, max_ticks=MAX_TICKS,
                               event_density=0.2, device="cpu")
    for name, bank, n_in, n_out in banks:
        server.add_tenant(name, copy.deepcopy(bank), n_in=n_in, n_out=n_out)
    for name, jt in j_server.tenants.items():
        tt = server.tenants[name]
        assert (tt.plan is None) == (jt.plan is None)
        if jt.plan is not None:
            assert tt.plan.strategy == jt.plan.strategy and tt.plan.cap == jt.plan.cap
        if jt.backend != "event":
            assert tt.fan_idx is None and tt.fan_mask is None
            continue
        assert tt.fan_idx.shape == (N_MAX, server.event_cap) and tt.fan_idx.dtype == torch.int32
        np.testing.assert_array_equal(tt.fan_idx.numpy(), np.asarray(jt.fan_idx))
        np.testing.assert_array_equal(tt.fan_mask.numpy(), np.asarray(jt.fan_mask))
    fan = server._fan_in([t_serve.ServeRequest(rid=0, tenant="ring-1"),
                          t_serve.ServeRequest(rid=1, tenant="sparse-6")])
    assert fan.idx.shape == (2, N_MAX, server.event_cap)
    assert server._fan_in([t_serve.ServeRequest(rid=0, tenant="dense-2")]) is None


def test_a_wave_never_mixes_programs(event_reference):
    banks = event_reference[0]
    server = t_serve.SNNServer(n_max=N_MAX, slots=2, max_ticks=MAX_TICKS,
                               event_density=0.2, device="cpu")
    for name, bank, n_in, n_out in banks[:2]:
        server.add_tenant(name, copy.deepcopy(bank), n_in=n_in, n_out=n_out)
    ext = np.ones((2, 20), np.float32)
    mixed = [t_serve.ServeRequest(rid=0, tenant="layered-0", ext=ext, n_ticks=2),
             t_serve.ServeRequest(rid=1, tenant="ring-1", ext=ext, n_ticks=2)]
    with pytest.raises(ValueError, match="mixes backends"):
        server.run_wave(mixed)


@pytest.mark.parametrize("backend", ["jnp", "pallas_fused"])
def test_plastic_sparse_tenant_learns_on_the_event_program(backend):
    """A plastic sparse tenant rides the event program and learns there, as
    in the reference: counts equal, written-back weights within 1e-5."""
    banks = _event_banks()
    ring = next(b for b in banks if b[0] == "ring-5")
    rng = np.random.default_rng(12)
    reqs = []
    for i in range(5):
        ticks = int(rng.integers(4, MAX_TICKS + 1))
        ext = ((rng.random((ticks, 24)) < 0.5) * rng.integers(80, 255, (ticks, 24))).astype(
            np.float32)
        reqs.append((i, "ring-5" if i % 2 == 0 else "sparse-6", ext, ticks))
    out = {}
    for mod, kw in ((j_serve, {}), (t_serve, {"device": "cpu", "backend": backend})):
        server = mod.SNNServer(n_max=N_MAX, slots=SLOTS, max_ticks=MAX_TICKS,
                               event_density=0.2, **kw)
        for name, bank, n_in, n_out in banks:
            server.add_tenant(name, copy.deepcopy(bank), n_in=n_in, n_out=n_out,
                              plastic=name == "ring-5")
        made, stats = _serve(mod, server, reqs)
        out[mod] = (made, stats, np.asarray(server.tenants["ring-5"].params.w),
                    server.tenants["ring-5"].backend)
    (j_made, j_stats, j_w, j_b), (t_made, t_stats, t_w, t_b) = out[j_serve], out[t_serve]
    assert j_b == t_b == "event" and t_stats["waves"] == j_stats["waves"] == 3
    for jr, tr in zip(j_made, t_made):
        np.testing.assert_array_equal(tr.counts, jr.counts)
    w0 = ring[1].weights.astype(np.float32)
    assert np.abs(t_w[:24, :24] - w0).max() > 1.0, "the ring tenant should learn"
    np.testing.assert_allclose(t_w, j_w, rtol=1e-5, atol=1e-5)


def test_cli_serves_the_event_program(capsys):
    """The CLI builds its server as the reference's does: the ``snn-event``
    arch serves on the ``jnp`` default program with ``event_density=0.2``."""
    stats = t_serve.main(["--arch", "snn-event", "--smoke", "--device", "cpu",
                          "--slots", "4", "--requests", "8"])
    out = capsys.readouterr().out
    assert "backend jnp" in out and "event_dispatch_db=0" in out
    assert set(stats["backends"]) == {"event", "jnp"} and stats["compiles"] == 2
