"""The on-device learning workload (``mnist-stdp``, the ``online_learning``
example) against the JAX package's config and example.

The reference example is loaded from ``examples/online_learning.py``. Inputs
are shared: the reference's seed-0 initial state and presentation order, its
chain of states, handed to the port as numpy arrays. Tolerances: spike
counts, rasters and predictions exact (0/1 spikes of the same float sums);
learned weights and thresholds to ``rtol=1e-5, atol=1e-4`` (off the u8 grid a
sum's order decides its last bit; ``atol`` covers the synaptic scaling's
division of a 64-term column sum), the readout's weights to 1e-5. On the CPU
the port's kernel backends run their kernels' plain twins; the reference's
``backend="pallas"`` runs its Pallas kernels in interpret mode.
"""
import dataclasses
import importlib.util
import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_bundle as j_get_bundle
from repro.configs import mnist_stdp as j_cfg
from repro.data import mnist as j_mnist
from repro.deprecation import ReproDeprecationWarning
from repro_torch.configs import get_bundle
from repro_torch.configs import mnist_stdp as t_cfg
from repro_torch.core.engine import TickEngine
from repro_torch.examples import online_learning as ol

ROOT = Path(__file__).resolve().parents[1]
PRESENTATIONS = 32
TOL = dict(rtol=1e-5, atol=1e-4)
READOUT_TOL = dict(rtol=1e-5, atol=1e-5)


def _reference_example(name):
    spec = importlib.util.spec_from_file_location(f"_ref_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref = _reference_example("online_learning")


def ref_stdp_present(w, theta, x, backend="jnp"):
    """The reference's ``stdp_present``. Its line 126 rebuilds the engine
    through the ``TickEngine`` keyword shim (``dataclasses.replace`` on an
    engine), which warns once per trace; the example is the reference and
    stays as it is, so that one warning is let through here."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", category=ReproDeprecationWarning,
                                message=r"TickEngine\(\*\*per-call statics\)")
        return ref.stdp_present(w, theta, x, backend=backend)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.fixture(scope="module")
def fast_data():
    """The example's ``--fast`` split: 128 train / 32 test spike vectors."""
    x, y = j_mnist.load(n_per_class=16, seed=0)
    s = j_mnist.to_spikes(x).astype(np.float32)
    n_test = len(y) // 5
    return s[n_test:], y[n_test:], s[:n_test], y[:n_test]


@pytest.fixture(scope="module")
def ref_chain(fast_data):
    """The reference's first ``PRESENTATIONS`` stage-1 presentations on its
    seed-0 schedule (``jnp``): every ``(w, theta, x)`` fed in and the outputs."""
    xtr = fast_data[0]
    rng = np.random.default_rng(0)
    w, theta = ref.init_feature_state(rng)
    steps = []
    for i in rng.permutation(len(xtr))[:PRESENTATIONS]:
        x = xtr[i]
        w2, theta2, counts = ref_stdp_present(w, theta, jnp.asarray(x))
        steps.append((np.asarray(w), np.asarray(theta), x))
        w, theta = w2, theta2
    return steps, np.asarray(w), np.asarray(theta)


# -- the config ----------------------------------------------------------------


def test_config_and_run_equal_the_reference_field_for_field():
    tb, jb = get_bundle("mnist-stdp"), j_get_bundle("mnist-stdp")
    assert dataclasses.asdict(tb.model) == dataclasses.asdict(jb.model)
    assert dataclasses.asdict(tb.smoke) == dataclasses.asdict(jb.smoke)
    assert tb.model.n_neurons == 128 and tb.model.layer_sizes == (64, 64)
    assert tb.model.n_ticks == 8 and tb.model.snn_mode == "fixed_leak"
    assert (t_cfg.N_INPUT, t_cfg.N_HIDDEN, t_cfg.N_CLASSES) == (
        j_cfg.N_INPUT, j_cfg.N_HIDDEN, j_cfg.N_CLASSES)
    t_run, j_run = dataclasses.asdict(t_cfg.RUN), dataclasses.asdict(j_cfg.RUN)
    assert t_run.keys() == j_run.keys()
    for key in t_run:
        assert t_run[key] == j_run[key], key
    for stage in ("feature", "readout"):
        tp, jp = getattr(t_cfg.RUN, stage), getattr(j_cfg.RUN, stage)
        for decay in ("decay_pre", "decay_post", "decay_elig"):
            assert np.float32(getattr(tp, decay)) == np.float32(getattr(jp, decay))
            assert getattr(tp, decay) == getattr(jp, decay)
    assert t_cfg.RUN.feature.rule == "stdp" and t_cfg.RUN.readout.rule == "rstdp"


def test_masks_and_nets_equal_the_reference():
    np.testing.assert_array_equal(ol.routing_mask(), ref.routing_mask())
    np.testing.assert_array_equal(ol.plastic_mask("cpu").numpy(), np.asarray(ref.plastic_mask()))
    rng = np.random.default_rng(3)
    w = rng.uniform(0, 12, (128, 128)).astype(np.float32)
    theta = rng.uniform(-20, 40, 64).astype(np.float32)
    np.testing.assert_array_equal(ol.with_lateral_inhibition(_t(w)).numpy(),
                                  np.asarray(ref.with_lateral_inhibition(jnp.asarray(w))))
    for tn, jn in ((ol.feature_net(_t(w), _t(theta)), ref.feature_net(jnp.asarray(w),
                                                                          jnp.asarray(theta))),
                   (ol.readout_net(_t(w[:74, :74])), ref.readout_net(jnp.asarray(w[:74, :74])))):
        for name in ("w", "c", "w_in"):
            np.testing.assert_array_equal(getattr(tn, name).numpy(), np.asarray(getattr(jn, name)))
        for name in ("v_th", "leak", "r_ref", "gain", "i_bias", "v_reset"):
            np.testing.assert_array_equal(getattr(tn.lif, name).numpy(),
                                          np.asarray(getattr(jn.lif, name)), err_msg=name)


def test_init_feature_state_is_bitwise_the_reference():
    tw, tt = ol.init_feature_state(np.random.default_rng(0), "cpu")
    jw, jt = ref.init_feature_state(np.random.default_rng(0))
    assert tw.dtype == torch.float32 and tt.dtype == torch.float32
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    # the same generator goes on to the same presentation order
    r1, r2 = np.random.default_rng(0), np.random.default_rng(0)
    ol.init_feature_state(r1, "cpu")
    ref.init_feature_state(r2)
    np.testing.assert_array_equal(r1.permutation(128), r2.permutation(128))


# -- stage 1 ----------------------------------------------------------------------


@pytest.mark.parametrize("backend,ref_backend", [("jnp", "jnp"), ("pallas", "pallas"),
                                                 ("pallas_fused", "jnp")])
def test_stdp_present_matches_reference_from_shared_state(ref_chain, backend, ref_backend):
    steps, _, _ = ref_chain
    spiked = 0
    for k, (w, theta, x) in enumerate(steps):
        jw2, jth2, jc = ref_stdp_present(jnp.asarray(w), jnp.asarray(theta), jnp.asarray(x),
                                         backend=ref_backend)
        tw_in, tt_in = _t(w), _t(theta)
        tw2, tth2, tc = ol.stdp_present(tw_in, tt_in, _t(x), backend=backend)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc), err_msg=f"presentation {k}")
        np.testing.assert_allclose(tw2.numpy(), np.asarray(jw2), **TOL,
                                   err_msg=f"presentation {k}")
        np.testing.assert_allclose(tth2.numpy(), np.asarray(jth2), **TOL,
                                   err_msg=f"presentation {k}")
        # inputs untouched; the fixed WTA block comes out bitwise
        assert torch.equal(tw_in, _t(w)) and torch.equal(tt_in, _t(theta))
        np.testing.assert_array_equal(tw2[64:, 64:].numpy(), w[64:, 64:])
        assert float(tw2[:64, 64:].min()) >= 0.0 and float(tw2[:64, 64:].max()) <= 12.0
        spiked += int(tc.sum())
    assert spiked > 0


def test_feature_counts_match_reference(ref_chain, fast_data):
    _, w, theta = ref_chain
    for xs in (fast_data[0], fast_data[2]):
        js, jr = ref.feature_counts(jnp.asarray(w), jnp.asarray(theta), jnp.asarray(xs))
        for backend in ol.BACKENDS:
            ts, tr = ol.feature_counts(_t(w), _t(theta), _t(xs), backend=backend)
            np.testing.assert_array_equal(tr.numpy(), np.asarray(jr), err_msg=backend)
            np.testing.assert_array_equal(ts.numpy(), np.asarray(js), err_msg=backend)
    assert np.asarray(js).sum() > 0


# -- stage 2 ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def readout_inputs(ref_chain, fast_data):
    """The reference's feature rasters of the train and test sets and its
    readout init and schedule (``train_readout``'s ``seed + 1`` generator)."""
    _, w, theta = ref_chain
    xtr, ytr, xte, _ = fast_data
    _, rtr = ref.feature_counts(jnp.asarray(w), jnp.asarray(theta), jnp.asarray(xtr))
    _, rte = ref.feature_counts(jnp.asarray(w), jnp.asarray(theta), jnp.asarray(xte))
    rng = np.random.default_rng(1)
    w_out = rng.uniform(6.0, 18.0, (74, 74)).astype(np.float32)
    order = rng.permutation(len(ytr))[:PRESENTATIONS]
    return np.asarray(rtr)[..., 64:], np.asarray(rte)[..., 64:], ytr, w_out, order


@pytest.mark.parametrize("backend", ol.BACKENDS)
def test_rstdp_present_and_readout_predict_match_reference(readout_inputs, backend):
    hid, hid_te, ytr, w_out, order = readout_inputs
    w = w_out
    preds = []
    for k, i in enumerate(order):
        jw2, jp = ref.rstdp_present(jnp.asarray(w), jnp.asarray(hid[:, i]), int(ytr[i]))
        tw_in = _t(w)
        tw2, tp = ol.rstdp_present(tw_in, _t(hid[:, i]), int(ytr[i]), backend=backend)
        assert int(tp) == int(jp), f"presentation {k}"
        assert tp.dtype == torch.int64 and tp.dim() == 0
        np.testing.assert_allclose(tw2.numpy(), np.asarray(jw2), **READOUT_TOL,
                                   err_msg=f"presentation {k}")
        assert torch.equal(tw_in, _t(w))
        preds.append(int(jp))
        w = np.asarray(jw2)
    assert not np.array_equal(w, w_out), "the readout never learned"
    assert len(set(preds)) > 1
    jpred = np.asarray(ref.readout_predict(jnp.asarray(w), jnp.asarray(hid_te)))
    tpred = ol.readout_predict(_t(w), _t(hid_te), backend=backend).numpy()
    np.testing.assert_array_equal(tpred, jpred)


def test_train_readout_draws_the_reference_init(readout_inputs):
    hid, _, ytr, w_out, _ = readout_inputs
    got = ol.train_readout(_t(hid), ytr, epochs=0, backend="jnp")
    np.testing.assert_array_equal(got.numpy(), w_out)


# -- readback -----------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_readback_roundtrip_is_byte_for_byte_the_reference(ref_chain, backend):
    _, w, theta = ref_chain
    j_bank, j_spikes = ref.readback_roundtrip(jnp.asarray(w), jnp.asarray(theta))
    t_bank, t_spikes = ol.readback_roundtrip(_t(w), _t(theta), backend=backend)
    assert t_bank.serialize() == j_bank.serialize()
    bd = t_bank.breakdown()
    assert (bd.total, bd.connection_list, bd.thresholds, bd.weights, bd.impulses) == (
        18576, 2048, 128, 16384, 16)
    assert t_spikes == j_spikes and t_spikes > 0


# -- the entry point --------------------------------------------------------------


@pytest.mark.parametrize("schedule", ["fast", "full"])
def test_schedules_and_split_are_the_reference_main_s(fast_data, schedule):
    """``SCHEDULES`` and ``load_split`` hold what the reference's ``main``
    spells inline: samples per class and both stages' epochs, and the seed-0
    split with the first fifth held out (bitwise its spikes and labels)."""
    src = (ROOT / "examples" / "online_learning.py").read_text()
    for line in ("n_per_class = 16 if args.fast else 40", "epochs = 2 if args.fast else 3",
                 "epochs=3 if args.fast else 8)"):
        assert line in src
    fast = schedule == "fast"
    assert ol.SCHEDULES[schedule] == ((16, 2, 3) if fast else (40, 3, 8))
    n_per_class = ol.SCHEDULES[schedule][0]
    got = ol.load_split(n_per_class)
    x, y = j_mnist.load(n_per_class=n_per_class, seed=0)
    s = j_mnist.to_spikes(x)
    n_test = len(y) // 5
    want = fast_data if fast else (s[n_test:], y[n_test:], s[:n_test], y[:n_test])
    assert [len(a) for a in got] == ([128, 128, 32, 32] if fast else [320, 320, 80, 80])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g, np.float32), np.asarray(w, np.float32))


def test_main_fast_passes_with_the_reference_figures(capsys):
    assert ol.main(["--fast", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    # The reference's figures on the same split, schedule and seed.
    assert "feature-cluster accuracy: random init 0.188 -> STDP 0.562" in out
    assert "end-to-end test accuracy: 0.219" in out
    assert "distinct class labels among 64 features: 10" in out
    assert ("18576 transactions (2048 CL + 128 th + 16384 w + 16 imp), spikes identical "
            "before/after (332 hidden spikes probed)") in out
    assert out.rstrip().endswith("PASS - on-device learning separates classes")


def test_backend_flag_defaults_to_the_kernels_and_sets_every_engine(monkeypatch, ref_chain,
                                                                   readout_inputs):
    """Deliberate difference: ``--backend`` takes ``jnp``, ``pallas`` (the
    default) or ``pallas_fused`` and sets all three engines; the reference's
    flag reaches stage 1 alone, defaults to ``jnp`` and runs inference and
    the readout on ``jnp``."""
    assert ol.DEFAULT_BACKEND == "pallas" and ol.BACKENDS == ("jnp", "pallas", "pallas_fused")
    for b, eng in ol.ENGINES.items():
        assert {e.options.backend for e in (eng.infer, eng.feature, eng.readout)} == {b}
        assert eng.infer.options.plasticity is None
        assert eng.feature.options.plasticity == t_cfg.RUN.feature
        assert eng.readout.options.plasticity == t_cfg.RUN.readout
        assert eng.feature.options.plasticity_pass() == ("jnp" if b == "jnp" else "pallas")

    class Stop(Exception):
        pass

    seen = []

    def first_rollout(*args, backend, **kw):
        seen.append(backend)
        raise Stop

    monkeypatch.setattr(ol, "feature_counts", first_rollout)
    for argv, want in (([], "pallas"), (["--backend", "jnp"], "jnp"),
                       (["--backend", "pallas_fused"], "pallas_fused")):
        with pytest.raises(Stop):
            ol.main(["--fast", "--device", "cpu"] + argv)
        assert seen.pop() == want
    with pytest.raises(SystemExit):
        ol.main(["--fast", "--device", "cpu", "--backend", "event"])
    monkeypatch.undo()

    # every stage's rollout runs on the engine of the flag's backend
    used = []
    scan = TickEngine.scan

    def recording(self, *args, **kw):
        used.append(self.options.backend)
        return scan(self, *args, **kw)

    monkeypatch.setattr(TickEngine, "scan", recording)
    steps, w, theta = ref_chain
    hid, hid_te, ytr, w_out, _ = readout_inputs
    w0, th0, x0 = steps[0]
    ol.stdp_present(_t(w0), _t(th0), _t(x0), backend="pallas_fused")
    ol.feature_counts(_t(w), _t(theta), _t(x0[None]), backend="pallas_fused")
    ol.rstdp_present(_t(w_out), _t(hid[:, 0]), int(ytr[0]), backend="pallas_fused")
    ol.readout_predict(_t(w_out), _t(hid_te), backend="pallas_fused")
    ol.readback_roundtrip(_t(w), _t(theta), backend="pallas_fused")
    assert used == ["pallas_fused"] * 6
