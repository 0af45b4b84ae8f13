"""Rank bodies of ``tests/test_torch_sharding.py``.

``run_cases`` runs on every rank of a gloo world that
:func:`repro_torch.launch.mesh.run_world` starts (a module, not the test file,
because spawned ranks import their target by name). Each case builds the
global inputs from seeds with numpy, cuts this rank's shard with
``snn_sharding.place``, runs the sharded engine and gathers the results back
to the global layout with ``snn_sharding.collect``, as numpy arrays. With
``mesh=None`` the same cases run the plain single-device engine on the global
inputs. The input makers are shared with the test file, which feeds the same
inputs to the reference.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch import interop
from repro_torch.core import connectivity
from repro_torch.core.engine import EngineOptions, TickCarry, TickEngine
from repro_torch.core.lif import LIFParams
from repro_torch.core.network_types import SNNParams, SNNState
from repro_torch.kernels.ops import EventFanIn
from repro_torch.obs.telemetry import TickTelemetry
from repro_torch.parallel import snn_sharding
from repro_torch.parallel.mesh import SNNMesh
from repro_torch.plasticity import PlasticityParams, PlasticityState

PP = dict(rule="stdp", a_plus=0.05, a_minus=0.05)


def fabric(n, *, density=0.1, seed=0, v_th=6.0, leak=0.25, r_ref=1, c_none=False):
    """The reference test's fabric as a numpy tree: dyadic weights, a
    ``sparse_random`` list, ``w_in = 2 I``, uniform LIF rows. The default
    density and threshold keep it below saturation (about a seventh of the
    neurons spike a tick, and potentials stay between 0 and threshold);
    the reference test's 0.25 and 1.0 make every neuron fire every other
    tick whatever the weights."""
    w = snn_sharding.make_sharded_dyadic_weights(n, seed=seed, device="cpu").numpy()
    c = connectivity.sparse_random(n, density, seed=seed + 1).astype(np.float32)
    return {"w": w, "c": None if c_none else c,
            "w_in": np.eye(n, dtype=np.float32) * 2.0,
            "lif.v_th": np.full(n, v_th, np.float32), "lif.leak": np.full(n, leak, np.float32),
            "lif.r_ref": np.full(n, r_ref, np.int32), "lif.gain": np.ones(n, np.float32),
            "lif.i_bias": np.zeros(n, np.float32), "lif.v_reset": np.zeros(n, np.float32)}


def ext(n, ticks, batch_shape=(), p=0.3, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.random((ticks,) + tuple(batch_shape) + (n,)) < p).astype(np.float32)


def _tel(telem):
    return {k: v.copy() for k, v in telem.numpy().items()}


def _place(tree, specs, mesh):
    return snn_sharding.place(tree, specs, mesh)


def _collect(tree, specs, mesh):
    return snn_sharding.collect(tree, specs, mesh)


def _gather(x, mesh):
    return mesh.all_gather(x).cpu().numpy()


def _params(tree, mesh, rules):
    p = interop.params_from_numpy(tree, "cpu")
    return _place(p, snn_sharding.params_specs(rules, p), mesh)


def _state(mesh, rules, n, batch=(), max_delay=1):
    st = SNNState.zeros(batch, n, max_delay=max_delay, device="cpu")
    specs = snn_sharding.state_specs(rules, st)
    return _place(st, specs, mesh), specs


def _gather_state(st, specs, mesh):
    return interop.state_to_numpy(_collect(st, specs, mesh))


def rollout_case(mesh, case):
    rules = snn_sharding.snn_rules(mesh.axis)
    n, ticks = case["n"], case["ticks"]
    tree = fabric(n, **case.get("fabric", {}))
    params = _params(tree, mesh, rules)
    st, specs = _state(mesh, rules, n, case.get("batch", ()), case.get("max_delay", 1))
    x = torch.from_numpy(ext(n, ticks, case.get("batch", ()), **case.get("ext", {})))
    nbrs = None
    if case.get("fan_in"):
        full = EventFanIn.from_dense(tree["c"], device="cpu")
        nbrs = _place(full, snn_sharding.neighbors_specs(rules, full), mesh)
    eng = TickEngine(EngineOptions(mesh=case["engine_mesh"], **case.get("opts", {})))
    out = eng.rollout(params, st, x.to(mesh.device), ticks, neighbors=nbrs)
    res = {"raster": _gather(out[1], mesh), "state": _gather_state(out[0], specs, mesh)}
    if len(out) == 3:
        res["telem"] = _tel(out[2])
    return res


def learning_case(mesh, case):
    rules = snn_sharding.snn_rules(mesh.axis)
    n, ticks = case["n"], case["ticks"]
    params = _params(fabric(n, **case.get("fabric", {})), mesh, rules)
    st, specs = _state(mesh, rules, n)
    plast = PlasticityState.zeros((), n, device="cpu")
    p_specs = snn_sharding.carry_specs(rules, TickCarry(state=st, plast=plast, w=params.w)).plast
    plast = _place(plast, p_specs, mesh)
    x = torch.from_numpy(ext(n, ticks, p=0.4)).to(mesh.device)
    eng = TickEngine(EngineOptions(backend=case["backend"], mesh=case["engine_mesh"],
                                   plasticity=PlasticityParams.make(**PP),
                                   telemetry=case.get("telemetry", False)))
    out = eng.learning_rollout(params, st, plast, x, ticks)
    (st2, plast2, w2), raster = out[0], out[1]
    res = {"raster": _gather(raster, mesh), "state": _gather_state(st2, specs, mesh),
           "w": _gather(w2, mesh),
           "plast": interop.plast_to_numpy(_collect(plast2, p_specs, mesh))}
    if len(out) == 3:
        res["telem"] = _tel(out[2])
    return res


def chunks_case(mesh, case):
    from repro_torch.launch.serve import _plan_misses

    rules = snn_sharding.snn_rules(mesh.axis)
    n, T, K = case["n"], case["T"], case["K"]
    params = _params(fabric(n), mesh, rules)
    x = torch.from_numpy(ext(n, K * T))
    eng = TickEngine(EngineOptions(telemetry=True, mesh=mesh, backend=case["backend"]))
    st, _ = _state(mesh, rules, n)
    _, ras_ref, tel_ref = eng.rollout(params, st, x, K * T)
    carry = TickCarry(state=_state(mesh, rules, n)[0], telem=TickTelemetry.zeros((), "cpu"))
    rasters, misses = [], []
    for k in range(K):
        carry, ras = eng.chunk(params, carry, x[k * T:(k + 1) * T], T)
        rasters.append(_gather(ras, mesh))
        misses.append(_plan_misses())
    return {"chunks": np.concatenate(rasters), "rollout": _gather(ras_ref, mesh),
            "telem": _tel(carry.telem), "telem_rollout": _tel(tel_ref),
            "new_plans_after_first": misses[-1] - misses[0]}


def _raises(fn):
    try:
        fn()
    except Exception as e:   # the refusal's type and message are the result
        return type(e).__name__, str(e)
    return None, ""


def refusal_cases(mesh, case):
    rules = snn_sharding.snn_rules(mesh.axis)
    n = 16
    tree = fabric(n)
    local = _params(tree, mesh, rules)
    st1, _ = _state(mesh, rules, n)
    st4, _ = _state(mesh, rules, n, max_delay=4)
    x = torch.from_numpy(ext(n, 2))
    pl = snn_sharding.place(PlasticityState.zeros((), n, device="cpu"), PlasticityState(
        x_pre=None, x_post=-1, elig=-1), mesh)
    eng = lambda **kw: TickEngine(EngineOptions(mesh=mesh, **kw))
    r_n = case["ragged_n"]
    ragged = SNNParams(w=torch.zeros(r_n, r_n), c=torch.zeros(r_n, r_n), w_in=torch.eye(r_n),
                       lif=LIFParams.make(r_n, device="cpu"))
    c_none = dataclasses.replace(local, c=None)
    learn = dict(plasticity=PlasticityParams.make(**PP))
    return {
        "ragged": _raises(lambda: eng().rollout(
            ragged, SNNState.zeros((), r_n, device="cpu"),
            torch.from_numpy(ext(r_n, 2)), 2)),
        "place_ragged": _raises(lambda: snn_sharding.place(
            ragged, snn_sharding.params_specs(rules, ragged), mesh)),
        "global_operands": _raises(lambda: eng().rollout(
            interop.params_from_numpy(tree, "cpu"), SNNState.zeros((), n, device="cpu"),
            x, 2)),
        "tick": _raises(lambda: eng().tick(st1, local)),
        "delay_matrix": _raises(lambda: eng().rollout(
            local, st4, x, 2, delays=torch.ones((n, n // mesh.size), dtype=torch.int32))),
        "event_ext_diag": _raises(lambda: EngineOptions(
            backend="event", event_ext_diag=True, mesh=mesh)),
        "learning_delay": _raises(lambda: eng(**learn).learning_rollout(
            local, st4, pl, x, 2)),
        "learning_c_none": _raises(lambda: eng(**learn).learning_rollout(
            c_none, st1, pl, x, 2)),
    }


def weights_case(mesh, case):
    w = snn_sharding.make_sharded_dyadic_weights(case["n"], mesh, levels=case["levels"])
    return {"w": mesh.all_gather(w).numpy(), "local_shape": tuple(w.shape)}


def cli_case(mesh, case):
    from repro_torch.configs import get_bundle
    from repro_torch.launch.serve import serve_sharded_main

    cfg = get_bundle("snn-64k").smoke
    stats = serve_sharded_main(cfg, argparse.Namespace(requests=case["requests"],
                                                       device="cpu", metrics_out=None))
    res = stats.pop("results")
    return {"stats": stats, "telemetry": res["telemetry"],
            "rasters": np.concatenate([mesh.all_gather(r).numpy() for r in res["rasters"]])}


KINDS = {"rollout": rollout_case, "learning": learning_case, "chunks": chunks_case,
         "refusals": refusal_cases, "weights": weights_case, "cli": cli_case}


def run_cases(mesh, cases):
    """Every case on this rank: ``{name: result}``. With ``mesh=None`` the
    plain engine runs the global inputs on the case's ``device`` (the CPU by
    default), through a one-rank placement that cuts nothing."""
    out = {}
    for c in cases:
        here = mesh or SNNMesh(rank=0, size=1, device=torch.device(c.get("device", "cpu")))
        out[c["name"]] = KINDS[c["kind"]](here, dict(c, engine_mesh=mesh))
    return out
