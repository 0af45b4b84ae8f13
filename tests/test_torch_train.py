"""LM training in the port (``repro_torch.data``, the models under autograd
and remat, ``launch/steps.py``, ``launch/train.py``,
``examples/train_lm.py``, ``interop``'s train state) against the reference
(``repro.data``, ``repro.launch.steps``, ``repro.launch.train``) on the CPU.

The reference's parameters are carried across with ``interop`` and the same
batches go through both. Tolerances, stated per test:

* the synthetic batches: bitwise (the same numpy generator);
* ``loss_fn``'s gradients of every f32 SMOKE config: in
  ``tests/test_torch_train_grads.py``;
* ``remat`` none / block / dots: bitwise equal gradients (remat recomputes
  the same operations);
* ``make_train_step``, 5 steps at 1 and 2 microbatches (smollm-135m) and at
  2 (jamba): loss, ``grad_norm`` and ``lr`` within ``rtol=1e-4`` per step
  (jamba keeps a bf16 optimizer state and accumulates in bf16, so a
  last-bit gradient difference can round a moment the other way);
* a resumed run on the CPU: bitwise the uninterrupted run.
"""
import dataclasses
import functools
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.data import pipeline as j_pipeline
from repro.data import synthetic as j_synthetic
from repro.launch import steps as j_steps
from repro.launch import train as j_train
from repro.models import model as JM
from repro_torch import checkpoint as ckpt
from repro_torch import interop
from repro_torch.configs import get_bundle
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import pipeline, synthetic
from repro_torch.examples import train_lm
from repro_torch.launch import steps
from repro_torch.launch import train as train_mod
from repro_torch.models import model as TM
from repro_torch.models import rwkv as t_rwkv
from repro_torch.models import ssm as t_ssm
from repro_torch.models import transformer as t_tf
from repro_torch.util import tree

jax.config.update("jax_platform_name", "cpu")

SHAPE = ShapeConfig("test", "train", 16, 2)
J_SHAPE = JShapeConfig("test", "train", 16, 2)
STEP_CASES = [("smollm-135m", 1), ("smollm-135m", 2), ("jamba-1.5-large-398b", 2)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: under the test runner's parallel workers more
    threads only contend for the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _smoke(arch):
    return j_configs.get_bundle(arch).smoke


@functools.lru_cache(maxsize=None)
def _params(arch):
    """The reference's SMOKE params (``PRNGKey(0)``) as numpy float32 leaves."""
    return jax.tree.map(lambda a: np.asarray(a, np.float32), JM.init(_smoke(arch),
                                                                     jax.random.PRNGKey(0)))


def _batch(arch, step=0, shape=J_SHAPE):
    return j_pipeline.make_batch(_smoke(arch), shape, j_pipeline.PipelineState(17, step))


def _port_params(arch):
    return interop.lm_params_from_numpy(_params(arch), _smoke(arch), "cpu")


def _host(state):
    """A reference train state with numpy leaves: floats as float32 (numpy has
    no bfloat16 without ``ml_dtypes``), ``step`` int32."""
    return jax.tree.map(lambda a: np.asarray(a, np.int32 if a.dtype == jnp.int32
                                             else np.float32), state)


def _named(grads):
    return [("/".join(str(k) for k in path), leaf) for path, leaf in tree.flatten_with_paths(grads)]


def _port_grads(arch, remat="none", params=None):
    batch = {k: torch.from_numpy(v) for k, v in _batch(arch).items()}
    return steps._value_and_grad(params or _port_params(arch), _smoke(arch), batch, remat)


# ---------------------------------------------------------------------------
# data


@pytest.mark.parametrize("n_codebooks", [0, 4])
def test_token_batches_are_bitwise_the_reference(n_codebooks):
    for seed, step in ((17, 0), (17, 1), (17, 41), (3, 7)):
        kw = dict(global_batch=3, seq_len=10, vocab_size=97, n_codebooks=n_codebooks)
        want = j_synthetic.token_batch(seed, step, **kw)
        got = synthetic.token_batch(seed, step, **kw)
        assert sorted(got) == sorted(want) == ["inputs", "targets"]
        for k in want:
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])
    ve = dict(global_batch=2, n_tokens=5, d_vision=6)
    np.testing.assert_array_equal(synthetic.vision_batch(17, 3, **ve),
                                  j_synthetic.vision_batch(17, 3, **ve))


@pytest.mark.parametrize("arch", ["smollm-135m", "musicgen-large", "llama-3.2-vision-90b"])
def test_make_batch_is_bitwise_the_reference(arch):
    cfg = get_bundle(arch).smoke
    state = pipeline.PipelineState(seed=17, step=0)
    for _ in range(3):
        want = j_pipeline.make_batch(_smoke(arch), J_SHAPE, j_pipeline.PipelineState(
            **state.as_dict()))
        got = pipeline.make_batch(cfg, SHAPE, state, device="cpu")
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert got[k].device.type == "cpu" and tuple(got[k].shape) == v.shape
            np.testing.assert_array_equal(got[k].numpy(), v)
        state = pipeline.advance(state)
    assert state == pipeline.PipelineState.from_dict({"seed": 17, "step": 3})
    if cfg.family == "vlm":
        bf16 = dataclasses.replace(cfg, dtype="bfloat16")
        assert pipeline.make_batch(bf16, SHAPE, state, device="cpu")["vision_embeds"].dtype \
            == torch.bfloat16


# ---------------------------------------------------------------------------
# loss_fn under autograd


@pytest.mark.parametrize("arch", ["smollm-135m", "moonshot-v1-16b-a3b",
                                  "jamba-1.5-large-398b", "rwkv6-1.6b"])
def test_remat_changes_no_number(arch):
    loss, _, base = _port_grads(arch, "none")
    for remat in ("block", "dots"):
        loss_r, _, grads = _port_grads(arch, remat)
        assert float(loss_r) == float(loss)
        assert all(torch.equal(a, b) for a, b in zip(tree.leaves(base), tree.leaves(grads))), \
            remat
    with pytest.raises(ValueError, match="remat"):
        _port_grads(arch, "everything")


def test_block_remat_keeps_only_group_inputs(monkeypatch):
    """``"block"`` runs each group body under ``torch.utils.checkpoint`` and
    ``"dots"`` with the selective policy that saves ``aten.mm`` outputs;
    ``"none"`` calls the body directly."""
    calls = []
    real = t_tf._ckpt.checkpoint

    def spy(fn, *args, **kw):
        calls.append(kw.get("context_fn") is not None)
        return real(fn, *args, **kw)

    monkeypatch.setattr(t_tf._ckpt, "checkpoint", spy)
    cfg = _smoke("smollm-135m")
    for remat, want in (("none", []), ("block", [False] * cfg.n_layers),
                        ("dots", [True] * cfg.n_layers)):
        calls.clear()
        _port_grads("smollm-135m", remat)
        assert calls == want, remat
    policy = t_tf._save_2d_products
    assert policy(None, torch.ops.aten.mm.default) == t_tf._ckpt.CheckpointPolicy.MUST_SAVE
    assert policy(None, torch.ops.aten.bmm.default) \
        == t_tf._ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def test_train_mode_unbinds_each_stacked_leaf_once(monkeypatch):
    """Train mode hands each group ``unbind`` views (one ``stack`` a leaf in
    the backward); prefill and decode index the stacked leaves as before."""
    seen = []
    real = t_tf._apply_layer

    def spy(x, p, *a, **kw):
        seen.append((kw["mode"], type(p["mixer"]["wq"].grad_fn).__name__,
                     p["mixer"]["wq"]._base is not None))
        return real(x, p, *a, **kw)

    monkeypatch.setattr(t_tf, "_apply_layer", spy)
    arch = "smollm-135m"
    cfg = _smoke(arch)
    _port_grads(arch)
    assert seen == [("train", "UnbindBackward0", True)] * cfg.n_layers
    seen.clear()
    params = _port_params(arch)
    caches = TM.init_cache(cfg, 2, 8, "cpu")
    TM.prefill_fn(params, cfg, {"inputs": torch.zeros((2, 4), dtype=torch.int32)}, caches)
    assert seen == [("prefill", "NoneType", True)] * cfg.n_layers


def test_scan_chunks_are_checkpointed_under_autograd(monkeypatch):
    """Under autograd the mamba and WKV loops checkpoint each chunk (here 4
    steps of 16), keeping only the carry at its boundaries; the numbers are
    those of one unchunked loop, and without autograd no chunk is
    checkpointed."""
    calls = []
    for mod in (t_ssm, t_rwkv):
        real = mod.checkpoint
        monkeypatch.setattr(mod, "checkpoint",
                            lambda fn, *a, _real=real, **kw: calls.append(fn.__name__)
                            or _real(fn, *a, **kw))
    for arch, mod, chunk in (("jamba-1.5-large-398b", t_ssm, "SSM_CHUNK"),
                             ("rwkv6-1.6b", t_rwkv, "WKV_CHUNK")):
        loss, _, whole = _port_grads(arch)
        monkeypatch.setattr(mod, chunk, 4)
        calls.clear()
        loss4, _, chunked = _port_grads(arch)
        n_scans = sum(lp.mixer in ("mamba", "rwkv") for st in t_tf.stage_plans(_smoke(arch))
                      for lp in st.layers) * _smoke(arch).n_layers // len(
                          t_tf.stage_plans(_smoke(arch))[0].layers)
        assert len(calls) == n_scans * (SHAPE.seq_len // 4), arch
        assert float(loss4) == float(loss)
        assert all(torch.equal(a, b) for a, b in zip(tree.leaves(whole), tree.leaves(chunked)))
        calls.clear()
        with torch.no_grad():
            TM.loss_fn(_port_params(arch), _smoke(arch),
                       {k: torch.from_numpy(v) for k, v in _batch(arch).items()})
        assert calls == []
        monkeypatch.setattr(mod, chunk, 256)


def test_router_aux_gradient_follows_each_groups_last_layer(monkeypatch):
    """The aux loss counts each group's last layer only (a fault of the
    reference the port keeps), and so does its gradient: the routers'
    gradients of ``router_aux`` are those of jamba's layer-7 aux alone, not
    of the four MoE layers' sum (the whole gradient is held against the
    reference's in ``test_loss_fn_gradients_match_the_reference``)."""
    arch = "jamba-1.5-large-398b"
    cfg = _smoke(arch)
    params = _port_params(arch)
    batch = {k: torch.from_numpy(v) for k, v in _batch(arch).items()}
    routers = [params["stages"][0][f"layer{i}"]["ffn"]["router"].requires_grad_(True)
               for i in (1, 3, 5, 7)]
    auxes = []
    real = t_tf.ffn_mod.moe_ffn
    monkeypatch.setattr(t_tf.ffn_mod, "moe_ffn",
                        lambda *a, **kw: auxes.append(real(*a, **kw)) or auxes[-1])
    _, metrics = TM.loss_fn(params, cfg, batch, remat="none")
    assert len(auxes) == 4
    grad = lambda y: torch.autograd.grad(y, routers, retain_graph=True)
    got, last = grad(metrics["router_aux"]), grad(auxes[3][1])
    every = grad(sum(a[1] for a in auxes))
    assert all(torch.equal(a, b) for a, b in zip(got, last))
    # layers 1, 3 and 5 feed their own aux too; layer 7's router feeds only its own
    assert all(float((a - b).abs().max()) > 1e-3 for a, b in zip(got[:3], every[:3]))


# ---------------------------------------------------------------------------
# the train step


@pytest.mark.parametrize("arch,micro", STEP_CASES)
def test_train_step_matches_the_reference(arch, micro):
    """5 steps from the reference's init under its ``train_4k`` knobs (jamba:
    a bf16 optimizer state and bf16 accumulation of its 2 microbatches)."""
    cfg = _smoke(arch)
    jpc = j_configs.get_bundle(arch).parallel_for("train_4k").replace(microbatches=micro)
    tpc = get_bundle(arch).parallel_for("train_4k").replace(microbatches=micro)
    jparams = jax.tree.map(jnp.asarray, _params(arch))
    jstate = j_steps.TrainState(params=jparams, opt=j_steps.adamw.init(
        jparams, jnp.dtype(jpc.opt_state_dtype)))
    tstate = interop.train_state_from_numpy(_host(jstate), cfg, tpc, "cpu")
    kw = dict(peak_lr=1e-3, warmup_steps=2, total_steps=5)
    jstep = jax.jit(j_steps.make_train_step(cfg, jpc, **kw))
    tstep = steps.make_train_step(cfg, tpc, **kw)
    shape = J_SHAPE if micro == 1 else JShapeConfig("test", "train", 16, 4)
    for i in range(5):
        b = _batch(arch, i, shape)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in b.items()})
        assert sorted(tm) == sorted(jm) == ["grad_norm", "loss", "lr", "nll", "router_aux"]
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, atol=0,
                                       err_msg=f"step {i} {k}")
    assert int(tstate.opt.step) == 5
    assert all(t.dtype == torch.float32 for t in tree.leaves(tstate.params))
    moments = tree.leaves(tstate.opt.m)
    assert all(t.dtype == getattr(torch, tpc.opt_state_dtype) for t in moments)


def test_train_step_writes_none_of_its_state():
    arch = "smollm-135m"
    cfg = _smoke(arch)
    pcfg = get_bundle(arch).parallel_for("train_4k")
    state = steps.init_train_state(cfg, pcfg, torch.Generator().manual_seed(0), "cpu")
    before = [t.clone() for t in tree.leaves(state)]
    batch = pipeline.make_batch(cfg, SHAPE, pipeline.PipelineState(17, 0), device="cpu")
    new, metrics = steps.make_train_step(cfg, pcfg)(state, batch)
    assert all(torch.equal(a, b) for a, b in zip(before, tree.leaves(state)))
    assert int(new.opt.step) == 1 and float(metrics["lr"]) == 0.0


def test_prefill_and_decode_steps_are_the_models():
    arch = "smollm-135m"
    cfg = _smoke(arch)
    params = _port_params(arch)
    toks = torch.from_numpy(_batch(arch)["inputs"])
    caches = [TM.init_cache(cfg, 2, 24, "cpu") for _ in range(2)]
    a, _ = steps.make_prefill_step(cfg)(params, {"inputs": toks}, caches[0])
    b, _ = TM.prefill_fn(params, cfg, {"inputs": toks}, caches[1])
    assert torch.equal(a, b)
    tok = a.argmax(-1)[:, None]
    a, _ = steps.make_decode_step(cfg)(params, {"token": tok, "pos": 16}, caches[0])
    b, _ = TM.decode_fn(params, cfg, {"token": tok, "pos": 16}, caches[1])
    assert torch.equal(a, b)
    assert all(torch.equal(x, y) for x, y in zip(tree.leaves(caches[0]), tree.leaves(caches[1])))


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_train_state_interop_round_trip_is_exact(optimizer):
    """The reference's train state into the port and back: every leaf equal,
    each cast to its spec's dtype (bf16 params and moments)."""
    cfg = dataclasses.replace(_smoke("smollm-135m"), dtype="bfloat16")
    pcfg = get_bundle("smollm-135m").parallel_for("train_4k").replace(
        optimizer=optimizer, opt_state_dtype="bfloat16")
    jstate = j_steps.init_train_state(cfg, pcfg, jax.random.PRNGKey(1))
    host = _host(jstate)
    port = interop.train_state_from_numpy(host, cfg, pcfg, "cpu")
    assert port.opt.step.dtype == torch.int32
    assert all(t.dtype == torch.bfloat16 for t in tree.leaves(port.params))
    if optimizer == "adamw":
        assert all(t.dtype == torch.bfloat16 for t in tree.leaves(port.opt.m))
    else:
        assert all(t.dtype == torch.float32 for t in tree.leaves(port.opt.vr))
    back = interop.train_state_to_numpy(port)
    assert type(back.opt).__name__ == type(jstate.opt).__name__
    for a, b in zip(jax.tree.leaves(tuple(back)), jax.tree.leaves(tuple(host))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the driver


def _cli(tmp, *extra, steps_=10):
    return ["--arch", "smollm-135m", "--smoke", "--steps", str(steps_), "--seq-len", "16",
            "--global-batch", "2", "--ckpt-dir", str(tmp), "--ckpt-every", "5",
            "--log-every", "100", "--device", "cpu", *extra]


def test_train_driver_loss_decreases(tmp_path, capsys):
    losses = train_mod.main([
        "--arch", "smollm-135m", "--smoke", "--steps", "30",
        "--seq-len", "32", "--global-batch", "4",
        "--ckpt-dir", str(tmp_path), "--ckpt-every", "10",
        "--log-every", "10", "--peak-lr", "1e-3", "--device", "cpu",
    ])
    assert len(losses) == 30
    assert losses[-1] < losses[0], f"{losses[0]} -> {losses[-1]}"
    out = capsys.readouterr().out.splitlines()
    assert [line.split()[:2] for line in out[:3]] == [["step", "0"], ["step", "10"],
                                                      ["step", "20"]]
    assert out[0].split()[6:8] == ["lr", "0.00e+00"]
    assert out[-1].startswith("done: 30 steps; loss ") and out[-1].endswith("stragglers: []")
    assert ckpt.all_steps(str(tmp_path)) == [10, 20, 30]


def test_train_driver_resumes_from_checkpoint(tmp_path):
    train_mod.main(_cli(tmp_path))
    assert ckpt.latest_step(str(tmp_path)) == 10
    # extending the run resumes from step 10 (3 more steps, not 13)
    losses = train_mod.main(_cli(tmp_path, steps_=13))
    assert len(losses) == 3


def test_a_resumed_run_is_bitwise_the_uninterrupted_one(tmp_path, monkeypatch):
    """10 steps in one run; then, in a fresh directory, the same 10-step run
    stopped after step 5 (its loop given 5 steps: a preempted job) and run
    again, which resumes at 5: its 5 losses and its step-10 checkpoint,
    every file, are the uninterrupted run's."""
    whole = train_mod.main(_cli(tmp_path / "whole"))
    real = train_mod.ft.run_resilient_loop
    monkeypatch.setattr(train_mod.ft, "run_resilient_loop",
                        lambda **kw: real(**{**kw, "n_steps": 5}))
    first = train_mod.main(_cli(tmp_path / "resumed"))
    monkeypatch.setattr(train_mod.ft, "run_resilient_loop", real)
    assert ckpt.all_steps(str(tmp_path / "resumed")) == [5]
    rest = train_mod.main(_cli(tmp_path / "resumed"))
    assert first + rest == whole and len(rest) == 5
    a, b = (tmp_path / "whole" / "step_00000010"), (tmp_path / "resumed" / "step_00000010")
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for name in os.listdir(a):
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


def test_an_injected_step_failure_is_recovered(tmp_path, monkeypatch):
    """A step that fails once after the step-5 checkpoint: the loop restores
    step 5 (its pipeline state too) and the run ends as the uninterrupted
    one."""
    whole = train_mod.main(_cli(tmp_path / "whole"))
    real = steps.make_train_step
    calls = []

    def flaky(*a, **kw):
        step = real(*a, **kw)

        def run(state, batch):
            calls.append(int(state.opt.step))
            if len(calls) == 7:
                shutil.copytree(tmp_path / "flaky", tmp_path / "seen")   # the step-5 write
                raise RuntimeError("injected preemption")
            return step(state, batch)
        return run

    monkeypatch.setattr(train_mod.steps_mod, "make_train_step", flaky)
    losses = train_mod.main(_cli(tmp_path / "flaky"))
    assert calls[6] == 6 and calls[7] == 5     # step 6 failed; the loop went back to 5
    assert losses[:6] == whole[:6] and losses[6:] == whole[5:]
    assert ckpt.all_steps(str(tmp_path / "flaky")) == [5, 10]


def test_cli_refusals_and_the_references_snn_error():
    """``--mesh single|multi`` in a world of one rank exits naming the 256 /
    512 ranks the production mesh needs; an SNN arch fails in
    ``stage_plans`` as the reference's CLI does; without ``--device`` and
    without a card the CLI raises, it does not train on the CPU."""
    for mesh, ranks in (("single", 256), ("multi", 512)):
        with pytest.raises(SystemExit, match=f"--mesh {mesh}: .* needs {ranks} ranks; "
                                             f"this world has 1"):
            train_mod.main(["--arch", "smollm-135m", "--smoke", "--mesh", mesh,
                            "--device", "cpu"])
    with pytest.raises(ValueError, match="unknown family 'snn'") as want:
        j_train.main(["--arch", "snn-fused", "--smoke", "--steps", "1"])
    with pytest.raises(ValueError) as got:
        train_mod.main(["--arch", "snn-fused", "--smoke", "--steps", "1", "--device", "cpu"])
    assert str(got.value) == str(want.value)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="NVIDIA GPU"):
            train_mod.main(["--arch", "smollm-135m", "--smoke", "--steps", "1"])


def test_rerunning_a_finished_run_raises_as_the_reference(tmp_path):
    """The reference's fault, which the port keeps (ROADMAP §C): a second
    run on a ``--ckpt-dir`` whose newest checkpoint is the last step
    resumes there, takes no step, and fails reading ``losses[0]``."""
    argv = ["--arch", "smollm-135m", "--smoke", "--steps", "2", "--seq-len", "16",
            "--global-batch", "2", "--ckpt-every", "2", "--log-every", "100"]
    for main, extra, d in ((j_train.main, [], tmp_path / "reference"),
                           (train_mod.main, ["--device", "cpu"], tmp_path / "port")):
        assert len(main([*argv, "--ckpt-dir", str(d), *extra])) == 2
        assert ckpt.all_steps(str(d)) == [2]
        with pytest.raises(IndexError, match="list index out of range"):
            main([*argv, "--ckpt-dir", str(d), *extra])


def test_cli_defaults_equal_the_references():
    import argparse

    def defaults(main):
        seen = {}

        def parse(self, argv=None, namespace=None):
            seen.update({a.dest: a.default for a in self._actions if a.dest != "help"})
            raise SystemExit(0)

        orig = argparse.ArgumentParser.parse_args
        argparse.ArgumentParser.parse_args = parse
        try:
            with pytest.raises(SystemExit):
                main([])
        finally:
            argparse.ArgumentParser.parse_args = orig
        return seen

    got, want = defaults(train_mod.main), defaults(j_train.main)
    assert got.pop("device") is None
    assert got == want


def test_the_example_trains_and_says_so(monkeypatch, capsys):
    seen = []
    real = train_mod.main
    monkeypatch.setattr(train_mod, "main", lambda argv: seen.append(argv) or real(
        [*argv[:argv.index("--steps") + 1], "12", *argv[argv.index("--steps") + 2:]]))
    losses = train_lm.main(["--device", "cpu"])
    assert seen[0][:8] == ["--arch", "smollm-135m", "--steps", "60", "--seq-len", "64",
                           "--global-batch", "8"]
    assert "--smoke" in seen[0] and seen[0][-2:] == ["--device", "cpu"]
    assert len(losses) == 12 and losses[-1] < losses[0]
    assert capsys.readouterr().out.splitlines()[-1].startswith("loss decreased ")
