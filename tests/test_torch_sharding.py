"""The port's sharded fabric against the JAX package: sharded == single-device.

The contract (DESIGN.md §15): ``EngineOptions(mesh=make_snn_mesh(D))``
partitions the fabric by destination columns over a world of D ranks and
changes nothing else. One gloo world per D in {2, 4} (``run_world``, module
scoped) runs every case of ``tests/torch_sharding_ranks.py`` once; D = 1 runs
in this process (a lone process is a world of one). Each case is asserted
here on its own:

* **Frozen**, on all four backends (the kernel backends run their twins on
  the CPU) and with batch rows, a uniform delay ring, fan-in neighbours,
  ``c=None`` and kernel B4's grid walk: rasters and the gathered final
  state bitwise the port's single-device run and the reference's
  single-device rollout at every D, and the reference's own ``sharded_scan``
  at D = 4 where it runs under this jax (``jnp`` and ``event`` without
  telemetry; its Pallas arms and its telemetry and learning carries trip
  ``shard_map``'s varying-axis check, and jax 0.9.0 rejects its learning and
  chunk carries everywhere, so those are held against its single-device run,
  which its own tests pin to its sharded one).
* **Telemetry** combined once a scan: ``ticks``/``spikes``/``v_max``/
  ``overflow``/``policy_dense`` exact, ``v_sum``/``ref_sum`` to 1e-6; every
  leaf bitwise at D = 1.
* **Learning**: bitwise the port's single-device run of the same backend
  (``pallas_fused`` at D > 1 is remapped: bitwise single-device ``pallas``,
  within 1e-5 of the single-device whole-tick kernel); against the
  reference's single-device ``jnp`` learning rollout, rasters exact and
  weights, potentials and traces to 1e-5, as ``tests/test_torch_learning.py``
  holds the single-device port.
* **Chunks**, on all four backends: K chunks equal one K*T rollout bitwise,
  no new launch plan after the first, and telemetry not inflated D-fold.
* **Refusals**: every ``TestValidation`` case of the reference, with its
  message, but ``c=None`` on the kernels (the port's B1 and B2 run it, a
  deliberate difference), and the port's own (operands that are not a
  rank's shard).
* **Weights, fan-in lists and the CLI**: ``make_sharded_dyadic_weights``,
  ``shard_fan_in`` / ``shard_stats`` / ``shard_imbalance`` equal to the
  reference's; ``--arch snn-64k --smoke`` prints the reference's stats keys.

The fabrics are the reference test's on the dyadic grid, at a density and
threshold below saturation (see ``torch_sharding_ranks.fabric``), so every
f32 sum order is exact and a frozen run can be bitwise at any D.
"""
import dataclasses
import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_sharding_ranks as ranks
from repro.core import connectivity as j_conn
from repro.core.engine import EngineOptions as JOptions
from repro.core.engine import TickEngine as JEngine
from repro.core.lif import LIFParams as JLIF
from repro.core.network_types import SNNParams as JParams
from repro.core.network_types import SNNState as JState
from repro.kernels.ops import EventFanIn as JFanIn
from repro.launch import serve as j_serve
from repro.launch.mesh import make_snn_mesh as j_mesh
from repro.parallel import snn_sharding as j_sharding
from repro.plasticity import PlasticityParams as JPP
from repro.plasticity import PlasticityState as JPS
from repro_torch.core import connectivity
from repro_torch.core.engine import EngineOptions, TickEngine
from repro_torch.launch import serve as t_serve
from repro_torch.launch import mesh as launch_mesh
from repro_torch.launch.mesh import run_world
from repro_torch.parallel.mesh import SNNMesh, make_snn_mesh
from repro_torch.parallel import snn_sharding

BACKENDS = ("jnp", "pallas", "pallas_fused", "event")
WORLDS = (1, 2, 4)
LIF_ROWS = ("v_th", "leak", "r_ref", "gain", "i_bias", "v_reset")
LEARN_FABRIC = dict(v_th=4.0)

FROZEN = {f"frozen-{b}": dict(n=128, ticks=10, opts=dict(backend=b)) for b in BACKENDS}
FROZEN.update({
    "grid": dict(n=128, ticks=10, opts=dict(backend="event", event_kernel="grid")),
    "batched": dict(n=128, ticks=8, batch=(3,)),
    "ring": dict(n=128, ticks=12, max_delay=4),
    "ring-event": dict(n=128, ticks=12, max_delay=4, opts=dict(backend="event")),
    "fan_in": dict(n=128, ticks=10, fan_in=True,
                   opts=dict(backend="event", event_dispatch="fan_in")),
    "c_none": dict(n=128, ticks=8, fabric=dict(c_none=True)),
    **{f"c_none-{b}": dict(n=128, ticks=8, fabric=dict(c_none=True), opts=dict(backend=b))
       for b in ("pallas", "pallas_fused", "event")},
})
# Cases the reference's sharded_scan runs under this jax (jnp / event, no telemetry).
REF_SHARDED = ("frozen-jnp", "frozen-event", "grid", "batched", "ring", "ring-event", "fan_in",
               "c_none", "c_none-event")
TELEMETRY = {
    "telemetry-jnp": dict(n=128, ticks=16, batch=(2,), opts=dict(telemetry=True)),
    "telemetry-event": dict(n=128, ticks=16, batch=(2,),
                            opts=dict(backend="event", telemetry=True, event_k_active=12)),
}
LEARN = {f"learn-{b}": dict(kind="learning", n=64, ticks=10, backend=b, fabric=LEARN_FABRIC)
         for b in BACKENDS}
LEARN["learn-telemetry"] = dict(kind="learning", n=64, ticks=10, backend="pallas",
                                fabric=LEARN_FABRIC, telemetry=True)
SINGLE = {**{k: dict(v, kind="rollout") for k, v in {**FROZEN, **TELEMETRY}.items()}, **LEARN}
CASES = [dict(v, name=k) for k, v in SINGLE.items()] + [
    *(dict(name=f"chunks-{b}", kind="chunks", n=128, T=6, K=4, backend=b) for b in BACKENDS),
    dict(name="refusals", kind="refusals", ragged_n=101),
    dict(name="weights", kind="weights", n=256, levels=8),
    dict(name="cli", kind="cli", requests=6),
]
REFUSALS = {   # the reference's TestValidation match strings, and the port's own
    "ragged": "split evenly", "place_ragged": "split evenly",
    "global_operands": "not one rank's shard", "tick": "single-device",
    "delay_matrix": "delay", "event_ext_diag": "event_ext_diag",
    "learning_delay": "max_delay == 1", "learning_c_none": "plastic_c",
}


@pytest.fixture(scope="module")
def worlds():
    """Every case's per-rank results at D = 1, 2, 4, and the single-device runs."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = {None: [ranks.run_cases(None, [c for c in CASES if c["name"] in SINGLE])],
               1: [ranks.run_cases(make_snn_mesh(1, device="cpu"), CASES)]}
        for d in WORLDS[1:]:
            out[d] = run_world("torch_sharding_ranks:run_cases", d, CASES, device="cpu",
                               threads=1, timeout=600)
    finally:
        torch.set_num_threads(prev)
    return out


def _got(worlds, name, d):
    """Rank 0's result; every rank gathered the same global arrays."""
    first = worlds[d][0][name]
    for other in worlds[d][1:]:
        if "raster" in first:
            np.testing.assert_array_equal(other[name]["raster"], first["raster"])
    return first


# -- the reference side ----------------------------------------------------------------


def _j_params(tree):
    return JParams(w=jnp.asarray(tree["w"]),
                   c=None if tree["c"] is None else jnp.asarray(tree["c"]),
                   w_in=jnp.asarray(tree["w_in"]),
                   lif=JLIF(**{k: jnp.asarray(tree[f"lif.{k}"]) for k in LIF_ROWS}))


@functools.lru_cache(maxsize=None)
def _j_rollout(name, d=None):
    """The reference's rollout of a frozen case: single-device, or its
    ``sharded_scan`` on ``d`` simulated devices."""
    case = SINGLE[name]
    n, ticks, batch = case["n"], case["ticks"], case.get("batch", ())
    tree = ranks.fabric(n, **case.get("fabric", {}))
    opts = {k: v for k, v in case.get("opts", {}).items() if k != "event_kernel"}
    if tree["c"] is None and opts.get("backend") in ("pallas", "pallas_fused"):
        opts["backend"] = "jnp"    # the reference's kernels refuse c=None (ROADMAP §C)
    nbrs = JFanIn.from_dense(tree["c"]) if case.get("fan_in") else None
    eng = JEngine(JOptions(mesh=None if d is None else j_mesh(d), **opts))
    out = eng.rollout(_j_params(tree), JState.zeros(batch, n, max_delay=case.get("max_delay", 1)),
                      jnp.asarray(ranks.ext(n, ticks, batch)), ticks, neighbors=nbrs)
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _j_learning(n, ticks):
    """The reference's single-device ``jnp`` learning rollout of the learning cases."""
    eng = JEngine(JOptions(plasticity=JPP.make(**ranks.PP)))
    (st, pl, w), ras = eng.learning_rollout(
        _j_params(ranks.fabric(n, **LEARN_FABRIC)), JState.zeros((), n), JPS.zeros((), n),
        jnp.asarray(ranks.ext(n, ticks, p=0.4)), ticks)
    return st, pl, w, ras


def _assert_state(got, ref):
    np.testing.assert_array_equal(got["lif.v"], np.asarray(ref.lif.v))
    np.testing.assert_array_equal(got["lif.r"], np.asarray(ref.lif.r))
    np.testing.assert_array_equal(got["lif.y"], np.asarray(ref.lif.y))
    np.testing.assert_array_equal(got["delay_buf"], np.asarray(ref.delay_buf))
    assert int(got["tick"]) == int(ref.tick)


def _assert_numpy_state(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def _assert_telemetry(got, ref):
    for k in ("ticks", "spikes", "v_max", "overflow", "policy_dense"):
        np.testing.assert_array_equal(got[k], np.asarray(getattr(ref, k)), err_msg=k)
    for k in ("v_sum", "ref_sum"):
        np.testing.assert_allclose(got[k], np.asarray(getattr(ref, k)), rtol=1e-6, err_msg=k)


# -- frozen ------------------------------------------------------------------------------


@pytest.mark.parametrize("d", WORLDS)
@pytest.mark.parametrize("name", tuple(FROZEN))
def test_frozen_bitwise(worlds, name, d):
    got = _got(worlds, name, d)
    single = worlds[None][0][name]
    np.testing.assert_array_equal(got["raster"], single["raster"])
    _assert_numpy_state(got["state"], single["state"])
    ref_state, ref_raster = _j_rollout(name)
    np.testing.assert_array_equal(got["raster"], np.asarray(ref_raster))
    _assert_state(got["state"], ref_state)
    assert 0 < got["raster"].mean() < 0.5     # a fabric below saturation
    if d == 4 and name in REF_SHARDED:
        sh_state, sh_raster = _j_rollout(name, d)
        np.testing.assert_array_equal(got["raster"], np.asarray(sh_raster))
        _assert_state(got["state"], sh_state)


@pytest.mark.parametrize("d", WORLDS)
@pytest.mark.parametrize("name", tuple(TELEMETRY))
def test_telemetry_totals(worlds, name, d):
    got = _got(worlds, name, d)
    single = worlds[None][0][name]
    np.testing.assert_array_equal(got["raster"], single["raster"])
    _, ref_raster, ref_tel = _j_rollout(name)
    np.testing.assert_array_equal(got["raster"], np.asarray(ref_raster))
    _assert_telemetry(got["telem"], ref_tel)
    np.testing.assert_array_equal(got["telem"]["spikes"], got["raster"].sum((0, 2)))
    if d == 1:   # a one-rank mesh combines nothing: every leaf as single-device
        for k, v in single["telem"].items():
            np.testing.assert_array_equal(got["telem"][k], v, err_msg=k)
    if name == "telemetry-event":
        assert got["telem"]["overflow"].min() > 0      # the budget of 12 overflows


# -- learning ----------------------------------------------------------------------------


@pytest.mark.parametrize("d", WORLDS)
@pytest.mark.parametrize("name", tuple(LEARN))
def test_learning(worlds, name, d):
    case = LEARN[name]
    got = _got(worlds, name, d)
    single = worlds[None][0][name]
    if case["backend"] == "pallas_fused" and d > 1:
        # Remapped to B1: bitwise single-device pallas, near the whole-tick kernel.
        row = worlds[None][0]["learn-pallas"]
        np.testing.assert_array_equal(got["raster"], row["raster"])
        np.testing.assert_array_equal(got["w"], row["w"])
        np.testing.assert_array_equal(got["raster"], single["raster"])
        np.testing.assert_allclose(got["w"], single["w"], rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_array_equal(got["raster"], single["raster"])
        np.testing.assert_array_equal(got["w"], single["w"])
        _assert_numpy_state(got["state"], single["state"])
        _assert_numpy_state(got["plast"], single["plast"])
    st, pl, w, ras = _j_learning(case["n"], case["ticks"])
    np.testing.assert_array_equal(got["raster"], np.asarray(ras))
    np.testing.assert_allclose(got["w"], np.asarray(w), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["state"]["lif.v"], np.asarray(st.lif.v), rtol=1e-5, atol=1e-5)
    for k in ("x_pre", "x_post"):
        np.testing.assert_allclose(got["plast"][k], np.asarray(getattr(pl, k)), rtol=1e-5,
                                   atol=1e-5)
    w0 = ranks.fabric(case["n"], **LEARN_FABRIC)["w"]
    assert np.abs(got["w"] - w0).sum() > 0          # learning happened
    if case.get("telemetry"):
        for k in ("ticks", "spikes", "v_max"):
            np.testing.assert_array_equal(got["telem"][k], single["telem"][k], err_msg=k)
        for k in ("v_sum", "ref_sum"):
            np.testing.assert_allclose(got["telem"][k], single["telem"][k], rtol=1e-6)
        for k in ("dw_l1", "dw_sq"):
            assert single["telem"][k] > 0
            np.testing.assert_allclose(got["telem"][k], single["telem"][k], rtol=1e-5)


# -- chunks ------------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _j_chunks_reference(n, ticks, backend):
    """The reference's single-device rollout of the chunk cases, telemetry on
    (``event`` counts its overflow ticks; the dense backends count none, as
    its ``jnp`` run)."""
    eng = JEngine(JOptions(telemetry=True, backend=backend))
    _, ras, tel = eng.rollout(_j_params(ranks.fabric(n)), JState.zeros((), n),
                              jnp.asarray(ranks.ext(n, ticks)), ticks)
    return ras, tel


@pytest.mark.parametrize("d", WORLDS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_chunks_match_rollout_and_do_not_inflate_telemetry(worlds, backend, d):
    got = _got(worlds, f"chunks-{backend}", d)
    np.testing.assert_array_equal(got["chunks"], got["rollout"])
    assert got["new_plans_after_first"] == 0
    ras, tel = _j_chunks_reference(128, 6 * 4, "event" if backend == "event" else "jnp")
    np.testing.assert_array_equal(got["chunks"], np.asarray(ras))
    for t in (got["telem"], got["telem_rollout"]):
        _assert_telemetry(t, tel)
    assert float(got["telem"]["spikes"]) == got["chunks"].sum()


# -- refusals ----------------------------------------------------------------------------


def _j_refusals(d):
    """The reference's TestValidation calls on a mesh of ``d`` simulated devices."""
    n = 16
    p = _j_params(ranks.fabric(n))
    x = jnp.asarray(ranks.ext(n, 2))
    eng = lambda **kw: JEngine(JOptions(mesh=j_mesh(d), **kw))
    learn = dict(plasticity=JPP.make(**ranks.PP))
    r_n = 101
    ragged = JParams(w=jnp.zeros((r_n, r_n)), c=jnp.zeros((r_n, r_n)), w_in=jnp.eye(r_n),
                     lif=JLIF.make(r_n))
    c_none = dataclasses.replace(p, c=None)
    return {
        "ragged": lambda: eng().rollout(ragged, JState.zeros((), r_n),
                                        jnp.asarray(ranks.ext(r_n, 2)), 2),
        "tick": lambda: eng().tick(JState.zeros((), n), p),
        "delay_matrix": lambda: eng().rollout(p, JState.zeros((), n, max_delay=2), x, 2,
                                              delays=jnp.ones((n, n), jnp.int32)),
        "event_ext_diag": lambda: JOptions(backend="event", event_ext_diag=True,
                                           mesh=j_mesh(d)),
        "learning_delay": lambda: eng(**learn).learning_rollout(
            p, JState.zeros((), n, max_delay=4), JPS.zeros((), n), x, 2),
        "learning_c_none": lambda: eng(**learn).learning_rollout(
            c_none, JState.zeros((), n), JPS.zeros((), n), x, 2),
    }


@pytest.mark.parametrize("d", WORLDS[1:])
@pytest.mark.parametrize("name", tuple(REFUSALS))
def test_refusals(worlds, name, d):
    for rank in worlds[d]:
        kind, msg = rank["refusals"][name]
        assert kind == "ValueError", (kind, msg)
        assert REFUSALS[name] in msg, msg
    ref = _j_refusals(d).get(name)
    if ref is not None:
        with pytest.raises(ValueError, match=REFUSALS[name]):
            ref()


def test_options_mirror_the_reference():
    """``sharded``, ``resolved_shard_axis`` and ``effective_backend`` (the
    ``pallas_fused`` -> ``pallas`` remap) agree with the reference's, for the
    outer (mesh) and the inner (shard_axis alone) forms; a non-mesh raises."""
    mesh = make_snn_mesh(1, device="cpu")
    assert isinstance(mesh, SNNMesh) and mesh.axis_names == ("model",)
    for b in BACKENDS:
        for kw, jkw in (({}, {}), (dict(mesh=mesh), dict(mesh=j_mesh(1))),
                        (dict(shard_axis="model"), dict(shard_axis="model"))):
            t, j = EngineOptions(backend=b, **kw), JOptions(backend=b, **jkw)
            assert (t.sharded, t.resolved_shard_axis(), t.effective_backend()) == (
                j.sharded, j.resolved_shard_axis(), j.effective_backend())
    with pytest.raises(ValueError, match="shard_axis"):
        EngineOptions(mesh=mesh, shard_axis="data")
    with pytest.raises(ValueError, match="mesh must be"):
        EngineOptions(mesh=j_mesh(1))
    # The mesh lives in the parallel layer; the launcher re-exports it under
    # the reference's module name.
    assert launch_mesh.make_snn_mesh is make_snn_mesh and launch_mesh.SNNMesh is SNNMesh


# -- weights and fan-in lists -----------------------------------------------------------


@pytest.mark.parametrize("d", WORLDS)
def test_sharded_weights_equal_the_reference(worlds, d):
    got = worlds[d][0]["weights"]
    n, levels = 256, 8
    np.testing.assert_array_equal(got["w"], np.asarray(j_sharding.make_sharded_dyadic_weights(n)))
    np.testing.assert_array_equal(got["w"], np.asarray(
        j_sharding.make_sharded_dyadic_weights(n, j_mesh(d))))
    assert got["local_shape"] == (n, n // d)
    scale = 2.0 ** round(math.log2(2.0 / math.sqrt(n)))
    lv = got["w"] / np.float32(scale)
    np.testing.assert_array_equal(lv, np.round(lv))
    assert lv.min() >= 0 and lv.max() <= levels - 1


@pytest.mark.parametrize("n,density,seed,shards", [
    (64, 0.2, 3, 4), (64, 0.3, 4, 4), (96, 0.1, 5, 3), (128, 0.05, 6, 8)])
def test_shard_helpers_equal_the_reference(n, density, seed, shards):
    c = connectivity.sparse_random(n, density, seed=seed)
    np.testing.assert_array_equal(c, j_conn.sparse_random(n, density, seed=seed))
    for got, want in zip(connectivity.shard_fan_in(c, shards), j_conn.shard_fan_in(c, shards),
                         strict=True):
        np.testing.assert_array_equal(got.idx, want.idx)
        np.testing.assert_array_equal(got.mask, want.mask)
        assert (got.cap, got.axis, got.n_edges, got.max_degree) == (
            want.cap, want.axis, want.n_edges, want.max_degree)
    stats, j_stats = connectivity.shard_stats(c, shards), j_conn.shard_stats(c, shards)
    assert [dataclasses.astuple(s) for s in stats] == [dataclasses.astuple(s) for s in j_stats]
    assert connectivity.shard_imbalance(stats) == j_conn.shard_imbalance(j_stats)
    for mod in (connectivity, j_conn):
        with pytest.raises(ValueError, match="split evenly"):
            mod.shard_fan_in(c, shards + 1 if n % (shards + 1) else shards + 2)
        with pytest.raises(ValueError, match="split evenly"):
            mod.shard_stats(c, 7)


# -- the serve CLI -----------------------------------------------------------------------


def _telemetry_line(text):
    return next(line for line in text.splitlines() if line.startswith("telemetry: "))


def test_cli_snn_64k_smoke_matches_the_reference(capsys, monkeypatch):
    """``--arch snn-64k --smoke``: the reference's stats keys and telemetry
    line, and no new plan after the warm-up. The reference's sharded chunk
    trips jax 0.9.0's ``shard_map`` check on its telemetry carry, so its CLI
    runs here with the single-device scan in place of ``sharded_scan`` (the
    same fabric, bitwise at any D by its own tests); its jit then retraces
    once on the committed carry, and its closing recompile assertion may
    fire after it has printed, so its stats are read from what it printed."""
    stats = t_serve.main(["--arch", "snn-64k", "--smoke", "--device", "cpu"])
    port_out = capsys.readouterr().out
    results = stats.pop("results")

    def single_device(engine, params, carry0, ext_seq, n_ticks, **kw):
        return JEngine(dataclasses.replace(engine.options, mesh=None)).scan(
            params, carry0, ext_seq, n_ticks, **kw)

    monkeypatch.setattr(j_sharding, "sharded_scan", single_device)
    try:
        j_serve.main(["--arch", "snn-64k", "--smoke"])
    except AssertionError as e:
        assert "recompiled" in str(e)
    ref_out = capsys.readouterr().out
    lines = ref_out.split("chunks)\n", 1)[1].split("telemetry: ")[0].splitlines()
    ref = dict(line.split(": ", 1) for line in lines)
    assert list(stats) == list(ref)
    for k in ("mode", "n_neurons", "ticks"):
        assert str(stats[k]) == ref[k], k
    assert stats["recompiles_after_warmup"] == 0 and stats["mode"] == "sharded"
    assert _telemetry_line(port_out) == _telemetry_line(ref_out)
    assert len(results["rasters"]) == 1 + 6 and results["telemetry"]["ticks"] == 56


def test_cli_serves_on_the_worlds_ranks(worlds, capsys):
    """Deliberate difference: the reference simulates ``snn_mesh`` devices in
    one process; the port serves on the ranks of the world it was started in
    and prints D (a lone process: 1), with the same answers at every D."""
    stats = t_serve.main(["--arch", "snn-64k", "--smoke", "--device", "cpu"])
    out = capsys.readouterr().out
    assert stats["n_devices"] == 1
    assert "names a 2-device mesh; this world has 1 rank(s)" in out
    lone = np.concatenate([r.numpy() for r in stats["results"]["rasters"]])
    for d in WORLDS[1:]:
        got = worlds[d][0]["cli"]
        assert got["stats"]["n_devices"] == d and got["stats"]["recompiles_after_warmup"] == 0
        np.testing.assert_array_equal(got["rasters"], lone)
        assert got["telemetry"]["spikes"] == stats["results"]["telemetry"]["spikes"]
    with pytest.raises(ValueError, match="this world has 1 rank"):
        make_snn_mesh(2, device="cpu")


def test_cli_defaults_equal_the_reference(monkeypatch):
    """Every flag both serve CLIs share defaults alike, ``--arch`` included
    (the reference's default is the LM smollm-135m, which the port serves):
    each CLI's parsed arguments, caught before it serves anything."""
    import argparse

    class Parsed(Exception):
        pass

    parse = argparse.ArgumentParser.parse_args

    def catch(self, args=None, namespace=None):
        raise Parsed(vars(parse(self, args, namespace)))

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    parsed = []
    for mod in (j_serve, t_serve):
        with pytest.raises(Parsed) as exc:
            mod.main([])
        parsed.append(exc.value.args[0])
    ref, port = parsed
    shared = set(ref) & set(port)
    assert {"arch", "smoke", "requests", "max_new", "slots", "max_len", "continuous",
            "profile", "metrics_out"} <= shared
    assert {k: port[k] for k in shared} == {k: ref[k] for k in shared}
    assert (port["arch"], port["requests"], port["slots"], port["max_new"],
            port["max_len"]) == ("smollm-135m", 6, 4, 12, 64)


def test_c_none_runs_on_the_kernels_where_the_reference_refuses():
    """Deliberate difference (ROADMAP §C): the reference's Pallas kernels
    refuse ``c=None`` and name the jnp and event backends; the port's B1 and
    B2 take ``W`` alone (as the event arm's dense path does), bitwise the
    ``jnp`` rollout, here and sharded (the ``c_none-*`` frozen cases)."""
    tree = ranks.fabric(16, c_none=True)
    from repro_torch import interop
    from repro_torch.core.network_types import SNNState

    p = interop.params_from_numpy(tree, "cpu")
    x = torch.from_numpy(ranks.ext(16, 2))
    st = SNNState.zeros((), 16, device="cpu")
    want = TickEngine().rollout(p, st, x, 2)
    for backend in ("pallas", "pallas_fused", "event"):
        if backend != "event":
            with pytest.raises(ValueError, match="jnp or event"):
                JEngine(JOptions(backend=backend)).rollout(
                    _j_params(tree), JState.zeros((), 16), jnp.asarray(x.numpy()), 2)
        got = TickEngine(EngineOptions(backend=backend)).rollout(p, st, x, 2)
        np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
        np.testing.assert_array_equal(got[0].lif.v.numpy(), want[0].lif.v.numpy())


def test_deprecation_shims_are_absent():
    """Deliberate difference: the reference's one-release shims
    (``TickEngine(**statics)``, ``launch.serve.Request`` / ``SNNRequest``,
    ``ReproDeprecationWarning``) are not ported."""
    import importlib.util

    with pytest.raises(TypeError):
        TickEngine(backend="jnp")
    assert not hasattr(t_serve, "Request") and not hasattr(t_serve, "SNNRequest")
    assert hasattr(j_serve, "Request") and hasattr(j_serve, "SNNRequest")
    assert importlib.util.find_spec("repro_torch.deprecation") is None
    assert importlib.util.find_spec("repro.deprecation") is not None


@pytest.mark.cuda
def test_cuda_two_ranks_share_one_card():
    """Two gloo ranks on one card (staged through the host): B1 at N = n/2,
    B3 and B5 on the rank's slab, bitwise the card's single-device run."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the two ranks launch the CUDA kernels on one card")
    cases = [dict(name=f"frozen-{b}", kind="rollout", n=256, ticks=10, opts=dict(backend=b))
             for b in BACKENDS]
    cases += [dict(LEARN["learn-pallas"], name="learn-pallas")]
    single = ranks.run_cases(None, [dict(c, device="cuda") for c in cases])
    got = run_world("torch_sharding_ranks:run_cases", 2, cases, device="cuda",
                    backend="gloo", timeout=600)
    for c in cases:
        np.testing.assert_array_equal(got[0][c["name"]]["raster"], single[c["name"]]["raster"])
    np.testing.assert_array_equal(got[0]["learn-pallas"]["w"], single["learn-pallas"]["w"])


def test_mesh_placement_round_trips(worlds):
    """``place`` then ``collect`` gives the global tree back (the CPU worlds'
    cases rest on it); a one-rank mesh cuts nothing."""
    mesh = make_snn_mesh(1, device="cpu")
    from repro_torch import interop

    p = interop.params_from_numpy(ranks.fabric(32), "cpu")
    specs = snn_sharding.params_specs(snn_sharding.snn_rules(mesh.axis), p)
    back = snn_sharding.collect(snn_sharding.place(p, specs, mesh), specs, mesh)
    for k, v in interop.params_to_numpy(p).items():
        np.testing.assert_array_equal(interop.params_to_numpy(back)[k], v)
    assert (specs.w, specs.w_in, specs.lif.v_th) == (-1, -1, -1)
    assert worlds[4][3]["weights"]["local_shape"] == (256, 64)
