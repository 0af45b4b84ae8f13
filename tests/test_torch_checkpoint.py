"""Checkpoints and the fault-tolerance runtime in the port
(``repro_torch.checkpoint``, ``repro_torch.runtime``) against the reference
(``repro.checkpoint``, ``repro.runtime``) on the CPU: the reference's
``tests/test_checkpoint_runtime.py`` cases on the port, the files the two
write for the same trees compared byte for byte, and checkpoints carried
from one package to the other.
"""
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as j_ckpt
from repro.configs import get_bundle as j_get_bundle
from repro.launch import steps as j_steps
from repro.runtime import fault_tolerance as j_ft
from repro.runtime import straggler as j_straggler
from repro_torch import checkpoint as ckpt
from repro_torch import interop
from repro_torch.configs import get_bundle
from repro_torch.launch import steps
from repro_torch.runtime import fault_tolerance as ft
from repro_torch.runtime import straggler
from repro_torch.util import tree

jax.config.update("jax_platform_name", "cpu")

ARCH = "smollm-135m"


def _tree(x=1.0):
    return {"a": torch.full((4, 4), x), "nested": {"b": torch.arange(6).reshape(2, 3)}}


def _states(dtype):
    """The reference's SMOKE train state (params in ``dtype``, f32 moments
    after one update, so no leaf is all zeros) and the port's copy of it."""
    import dataclasses

    cfg = dataclasses.replace(j_get_bundle(ARCH).smoke, dtype=dtype)
    pcfg = j_get_bundle(ARCH).parallel_for("train_4k")
    jstate = j_steps.init_train_state(cfg, pcfg, jax.random.PRNGKey(0))
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, p.dtype), jstate.params)
    params, opt = j_steps.adamw.update(grads, jstate.opt, jstate.params, lr=1e-3)
    jstate = j_steps.TrainState(params=params, opt=opt)
    host = jax.tree.map(lambda a: np.asarray(a, np.int32 if a.dtype == jnp.int32
                                             else np.float32), jstate)
    port = interop.train_state_from_numpy(host, cfg, get_bundle(ARCH).parallel_for("train_4k"),
                                          "cpu")
    return cfg, jstate, port


def _files(path: Path):
    return {p.name: p.read_bytes() for p in sorted(path.iterdir())}


# ---------------------------------------------------------------------------
# the reference's files


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_files_are_the_references_byte_for_byte(tmp_path, dtype):
    """The same train state saved by both packages: the same file names,
    every ``.npy`` and ``META.json`` byte for byte (a bf16 leaf as its 2-byte
    words under ``'<V2'``, ``"dtype": "bfloat16"``)."""
    _, jstate, port = _states(dtype)
    meta = {"pipeline": {"seed": 17, "step": 3}}
    j_ckpt.save(str(tmp_path / "ref"), 3, jstate, extra_meta=meta)
    ckpt.save(str(tmp_path / "port"), 3, port, extra_meta=meta)
    want = _files(tmp_path / "ref" / "step_00000003")
    got = _files(tmp_path / "port" / "step_00000003")
    assert sorted(got) == sorted(want)
    assert "params__stages__0__layer0__mixer__wq.npy" in got and "opt__step.npy" in got
    for name, data in want.items():
        assert got[name] == data, name
    embed = np.load(tmp_path / "port" / "step_00000003" / "params__embed.npy")
    assert embed.dtype == (np.float32 if dtype == "float32" else np.dtype("V2"))


def test_a_reference_checkpoint_restores_into_the_port(tmp_path):
    cfg, jstate, _ = _states("float32")
    j_ckpt.save(str(tmp_path), 7, jstate, extra_meta={"pipeline": {"seed": 17, "step": 7}})
    like = steps.init_train_state(cfg, get_bundle(ARCH).parallel_for("train_4k"),
                                  torch.Generator().manual_seed(5), "cpu")
    restored, meta = ckpt.restore(str(tmp_path), like)
    assert meta["step"] == 7 and meta["extra"]["pipeline"] == {"seed": 17, "step": 7}
    assert isinstance(restored, steps.TrainState) and type(restored.opt).__name__ == "AdamWState"
    for got, want in zip(tree.leaves(restored), jax.tree.leaves(jstate)):
        assert got.dtype == {"float32": torch.float32, "int32": torch.int32}[str(want.dtype)]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_the_references_bf16_restore_fails_where_the_ports_restores(tmp_path):
    """A fault of the reference: its ``restore`` hands back a bf16 leaf as a
    ``|V2`` array, which JAX refuses. The port reads it by the manifest's
    dtype: bitwise the saved bf16 state."""
    cfg, jstate, port = _states("bfloat16")
    j_ckpt.save(str(tmp_path), 1, jstate)
    restored, _ = j_ckpt.restore(str(tmp_path), jstate)
    assert restored.params["embed"].dtype == np.dtype("V2")
    with pytest.raises(TypeError, match="V2"):
        jnp.asarray(restored.params["embed"])
    like = tree.map(torch.zeros_like, port)
    got, _ = ckpt.restore(str(tmp_path), like)
    assert got.params["embed"].dtype == torch.bfloat16
    for a, b in zip(tree.leaves(got), tree.leaves(port)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_restore_casts_to_tree_likes_dtype_and_round_trips_bf16(tmp_path):
    t = {"w": torch.randn(3, 5, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16),
         "step": torch.tensor(4, dtype=torch.int32)}
    ckpt.save(str(tmp_path), 4, t)
    back, meta = ckpt.restore(str(tmp_path), t)
    assert torch.equal(back["w"], t["w"]) and back["step"].dtype == torch.int32
    assert meta["manifest"]["w"]["dtype"] == "bfloat16"
    as_f32, _ = ckpt.restore(str(tmp_path), {"w": torch.zeros(3, 5), "step": t["step"]})
    assert as_f32["w"].dtype == torch.float32 and torch.equal(as_f32["w"], t["w"].float())
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(str(tmp_path), {"w": torch.zeros(5, 3), "step": t["step"]})
    with pytest.raises(KeyError, match="missing leaf"):
        ckpt.restore(str(tmp_path), {"v": torch.zeros(3, 5)})
    with pytest.raises(TypeError, match="not a NamedSharding"):
        ckpt.restore(str(tmp_path), t, shardings=t)
    unsharded, _ = ckpt.restore(str(tmp_path), t, shardings={"w": None, "step": None})
    assert all(torch.equal(unsharded[k], back[k]) for k in t)


# ---------------------------------------------------------------------------
# the reference's checkpointer cases


def test_save_restore_roundtrip(tmp_path):
    d = str(tmp_path)
    t = _tree(3.0)
    ckpt.save(d, 7, t, extra_meta={"pipeline": {"step": 7}})
    restored, meta = ckpt.restore(d, t)
    assert torch.equal(restored["a"], t["a"]) and torch.equal(restored["nested"]["b"],
                                                              t["nested"]["b"])
    assert meta["step"] == 7 and meta["extra"]["pipeline"]["step"] == 7


def test_rotation_keeps_last_k(tmp_path):
    d = str(tmp_path)
    for s in range(6):
        ckpt.save(d, s, _tree(s), keep=3)
    assert ckpt.all_steps(d) == [3, 4, 5]


def test_latest_picks_newest_complete(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 1, _tree())
    ckpt.save(d, 5, _tree())
    os.makedirs(os.path.join(d, "step_00000009.tmp"))   # a crashed partial write
    assert ckpt.latest_step(d) == 5


def test_async_checkpointer(tmp_path):
    d = str(tmp_path)
    ac = ckpt.AsyncCheckpointer(d, keep=2)
    for s in (1, 2, 3):
        ac.save_async(s, _tree(s))
    ac.wait()
    assert ckpt.all_steps(d) == [2, 3]


def test_async_checkpointer_copies_before_returning_and_reports_errors(tmp_path):
    """The caller may write its tensors once ``save_async`` returns; a failed
    write raises at the next ``wait``."""
    ac = ckpt.AsyncCheckpointer(str(tmp_path))
    t = _tree(2.0)
    ac.save_async(1, t)
    t["a"].fill_(-1.0)
    ac.wait()
    assert float(ckpt.restore(str(tmp_path), t)[0]["a"].max()) == 2.0
    (tmp_path / "blocked").write_text("a file where the directory should go")
    bad = ckpt.AsyncCheckpointer(str(tmp_path / "blocked"))
    bad.save_async(1, t)
    with pytest.raises(OSError):
        bad.wait()
    bad.wait()   # the error is raised once


def test_restore_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path), _tree())


# ---------------------------------------------------------------------------
# the resilient loop, heartbeat and straggler monitor


def test_resilient_loop_recovers_from_injected_failures(tmp_path):
    """Steps fail twice; the loop restores and the final state is exactly
    what an uninterrupted run would produce (counter-based pipeline)."""
    d = str(tmp_path)
    failures = {3: 2}

    def step_fn(step, state):
        if failures.get(step, 0) > 0:
            failures[step] -= 1
            raise RuntimeError("injected preemption")
        return state + step

    def save_fn(step, state):
        ckpt.save(d, step, {"s": torch.tensor(state)})

    def restore_fn():
        restored, meta = ckpt.restore(d, {"s": torch.tensor(0)})
        return meta["step"], int(restored["s"])

    save_fn(0, 0)
    policy = ft.RetryPolicy(max_failures=5)
    final_step, final_state = ft.run_resilient_loop(
        n_steps=6, start_step=0, step_fn=step_fn, state=0,
        save_fn=save_fn, restore_fn=restore_fn, checkpoint_every=2, policy=policy)
    assert (final_step, final_state, policy.failures_seen) == (6, sum(range(6)), 2)


def test_exhausted_retries_raise(tmp_path):
    def bad_step(step, state):
        raise RuntimeError("permanent failure")

    with pytest.raises(ft.StepFailure):
        ft.run_resilient_loop(
            n_steps=3, start_step=0, step_fn=bad_step, state=0,
            save_fn=lambda s, st: None, restore_fn=lambda: (0, 0), checkpoint_every=10,
            policy=ft.RetryPolicy(max_failures=2))


def test_heartbeat_ages():
    hb = ft.Heartbeat()
    hb.beat()
    assert hb.age() < 1.0


def test_straggler_flags_slow_host():
    rng = np.random.default_rng(0)
    mons = (straggler.StragglerMonitor(z_threshold=2.0, min_steps=5),
            j_straggler.StragglerMonitor(z_threshold=2.0, min_steps=5))
    for _ in range(20):
        for h in range(8):
            dt = (1.0 + 0.01 * rng.standard_normal()) * (5.0 if h == 3 else 1.0)
            for mon in mons:
                mon.observe(f"host{h}", dt)
    assert mons[0].stragglers() == mons[1].stragglers() == ["host3"]
    assert mons[0].exclusion_plan() == {"host3": "drain_and_replace"}
    assert mons[0].fleet_stats() == mons[1].fleet_stats()


def test_straggler_no_false_positives_on_uniform_fleet():
    mon = straggler.StragglerMonitor()
    for _ in range(10):
        for h in range(8):
            mon.observe(f"host{h}", 1.0 + 0.001 * h)
    assert mon.stragglers() == []


@pytest.mark.parametrize("mod,ref", [(ft, j_ft), (straggler, j_straggler)])
def test_runtime_modules_are_the_references_copies(mod, ref):
    """``fault_tolerance`` and ``straggler`` are copies: every line after the
    docstring's first sentence is the reference's."""
    body = lambda m: Path(m.__file__).read_text().split("\n\n", 1)[1]
    assert body(mod) == body(ref)
