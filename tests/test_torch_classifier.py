"""The paper's classifiers end to end in the port (Iris §III.A, MNIST-8x8
§III.B) against the JAX package: data, quantization, the UART download,
integer and float inference, training, and the examples.

Tolerances: the datasets, the u8 quantization, the register bytes and the
integer inference are bitwise (integer arithmetic, or one correctly rounded
f32 division); the float readout's logits within ``1e-5`` (the drive's
matmul sums in another order). Training uses the port's AdamW
(``repro_torch.optim.adamw``, the reference's update) on autograd's
gradients, whose sums run in another order than JAX's: started from the
reference's ``jax.random`` init, the fitted weights and biases agree within
``rtol=1e-5, atol=2e-5`` after 100 epochs (measured: at most 4.3e-6 on Iris,
8.3e-6 on MNIST), and after the full 1500 epochs the test
predictions are equal (MNIST's weights of rarely lit pixels drift apart by
then: AdamW rescales their tiny gradients to full steps).
"""
import hypothesis.strategies as st
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings

from repro.configs import get_bundle as j_get_bundle
from repro.core import classifier as jc
from repro.core import quant as j_quant
from repro.data import iris as j_iris
from repro.data import mnist as j_mnist
from repro_torch import interop
from repro_torch.configs import get_bundle
from repro_torch.core import classifier as tc
from repro_torch.core import encoding as t_enc
from repro_torch.core import quant as t_quant
from repro_torch.core.registers import transaction_breakdown
from repro_torch.data import iris, mnist
from repro_torch.examples import mnist_snn as ex_mnist
from repro_torch.examples import quickstart as ex_quickstart
from repro_torch.kernels import spike_matmul as sm_kernel

NAMES = ("iris", "mnist")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _split(name):
    """The e2e tests' pipelines (tests/test_e2e_iris.py, test_e2e_mnist.py),
    from the port's own data modules."""
    if name == "iris":
        x, y = iris.load(seed=0)
        levels = t_enc.level_encode(torch.from_numpy(iris.normalize(x)), levels=4).numpy()
        return iris.train_test_split(levels, y, test_frac=0.3)
    x, y = mnist.load(n_per_class=40, seed=0)
    s = mnist.to_spikes(x)
    n_test = len(y) // 5
    return (s[n_test:], y[n_test:]), (s[:n_test], y[:n_test])


@pytest.fixture(scope="module")
def reference():
    """The reference's trained and deployed models, once per module."""
    out = {}
    for name in NAMES:
        cfg = j_get_bundle(f"{name}-snn").model
        (xtr, ytr), (xte, yte) = _split(name)
        model = jc.train(xtr, ytr, cfg)
        out[name] = dict(cfg=cfg, model=model, dep=jc.deploy(model, n_neurons=cfg.n_neurons),
                         train=(xtr, ytr), test=(xte, yte))
    return out


@pytest.fixture(scope="module")
def own():
    """The port's own models, ``train(seed=0)`` on the CPU."""
    out = {}
    for name in NAMES:
        cfg = get_bundle(f"{name}-snn").model
        (xtr, ytr), test = _split(name)
        model = tc.train(xtr, ytr, cfg, device="cpu")
        out[name] = dict(cfg=cfg, model=model, train=(xtr, ytr), test=test,
                         dep=tc.deploy(model, n_neurons=cfg.n_neurons, device="cpu"))
    return out


# -- data ----------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_datasets_equal_the_reference(seed):
    for got, want in ((iris.load(seed=seed), j_iris.load(seed=seed)),
                      (mnist.load(n_per_class=12, seed=seed), j_mnist.load(n_per_class=12,
                                                                            seed=seed))):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    x, y = iris.load(seed=seed)
    np.testing.assert_array_equal(iris.normalize(x), j_iris.normalize(x))
    for g, w in zip(iris.train_test_split(x, y, seed=seed + 1),
                    j_iris.train_test_split(x, y, seed=seed + 1)):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    xm, _ = mnist.load(n_per_class=5, seed=seed)
    np.testing.assert_array_equal(mnist.to_spikes(xm), j_mnist.to_spikes(xm))
    np.testing.assert_array_equal(mnist.TEMPLATES, j_mnist.TEMPLATES)


# -- quant ---------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quant_is_bitwise_the_reference(seed):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0, 3, (16, 9)).astype(np.float32)
    w[0, :3] = [0.0, -0.5, 3.0]
    signed = rng.normal(size=(8, 8)).astype(np.float32)
    v_th = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    t = torch.from_numpy
    for w_max in (None, 2.5, float(w.max())):
        got, want = t_quant.quantize_u8(t(w), w_max), j_quant.quantize_u8(jnp.asarray(w), w_max)
        assert got.q.dtype == torch.uint8 and got.scale.dtype == torch.float32
        assert got.scale.dim() == 0
        np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
        assert got.scale.item() == float(want.scale)
        np.testing.assert_array_equal(t_quant.dequantize_u8(got).numpy(),
                                      np.asarray(j_quant.dequantize_u8(want)))
    for g, j in zip(t_quant.quantize_signed(t(signed)),
                    j_quant.quantize_signed(jnp.asarray(signed))):
        np.testing.assert_array_equal(g.q.numpy(), np.asarray(j.q))
        assert g.scale.item() == float(j.scale)
    got_th = t_quant.quantize_threshold(t(v_th), torch.tensor(0.01, dtype=torch.float32))
    want_th = j_quant.quantize_threshold(jnp.asarray(v_th), jnp.float32(0.01))
    np.testing.assert_array_equal(got_th.numpy(), np.asarray(want_th))
    for g, j in zip(t_quant.integer_network(t(signed), t(v_th)),
                    j_quant.integer_network(jnp.asarray(signed), jnp.asarray(v_th))):
        np.testing.assert_array_equal(np.asarray(g.numpy()), np.asarray(j))


@settings(deadline=None, max_examples=30)
@given(st.integers(0, 2**31 - 1))
def test_u8_roundtrip_error_bounded(seed):
    """tests/test_encoding_quant.py::TestQuant, on the port (three tests)."""
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.uniform(0, 3, (16, 16)).astype(np.float32))
    qw = t_quant.quantize_u8(w)
    back = t_quant.dequantize_u8(qw)
    assert float((back - w).abs().max()) <= float(qw.scale) / 2 + 1e-6


def test_signed_split_reconstructs():
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.normal(size=(8, 8)).astype(np.float32))
    pos, neg = t_quant.quantize_signed(w)
    recon = t_quant.dequantize_u8(pos) - t_quant.dequantize_u8(neg)
    assert float((recon - w).abs().max()) <= float(pos.scale) + 1e-6


def test_integer_network_semantics():
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.normal(size=(8, 8)).astype(np.float32))
    v_th = torch.from_numpy(rng.uniform(0.5, 1.5, 8).astype(np.float32))
    w_int, th_int, scale = t_quant.integer_network(w, v_th)
    assert w_int.dtype == torch.int32 and th_int.dtype == torch.int32
    np.testing.assert_allclose(w_int.numpy() * float(scale), w.numpy(), atol=float(scale))


# -- deploy and inference --------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_deploy_bytes_and_integer_network_equal(reference, name):
    ref = reference[name]
    model = interop.trained_from_numpy(interop.trained_to_numpy(ref["model"]))
    dep = tc.deploy(model, n_neurons=ref["cfg"].n_neurons, device="cpu")
    jd = ref["dep"]
    assert dep.bank.serialize() == jd.bank.serialize()
    np.testing.assert_array_equal(dep.bank.bias, jd.bank.bias)
    for f in ("w_int", "th_int", "b_int"):
        assert getattr(dep, f).dtype == np.int32
        np.testing.assert_array_equal(getattr(dep, f), np.asarray(getattr(jd, f)))
    assert dep.scale == jd.scale and dep.n_ticks == jd.n_ticks


@pytest.mark.parametrize("name", NAMES)
def test_predict_int_is_bitwise_the_reference(reference, name):
    """The reference's deployed bank, carried across as its byte stream, gives
    the reference's predictions bitwise; the synaptic product (kernel B6's
    twin on the CPU) equals ``x @ w_int``."""
    ref = reference[name]
    dep = interop.deployed_from_numpy(interop.deployed_to_numpy(ref["dep"]))
    for x, _ in (ref["test"], ref["train"]):
        want = jc.predict_int(ref["dep"], x)
        got = tc.predict_int(dep, x, device="cpu")
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        syn = tc.synaptic_input(dep, x, device="cpu")
        assert syn.dtype == torch.int32
        np.testing.assert_array_equal(syn.numpy(), np.asarray(x, np.int32) @ ref["dep"].w_int)


@pytest.mark.parametrize("name", NAMES)
def test_predict_float_logits_within_1e5(reference, name):
    ref = reference[name]
    model = interop.trained_from_numpy(interop.trained_to_numpy(ref["model"]))
    for x, _ in (ref["test"], ref["train"]):
        want = jc._forward_float(jnp.asarray(ref["model"].w), jnp.asarray(ref["model"].bias),
                                 jnp.asarray(x, jnp.float32), v_th=ref["model"].v_th,
                                 n_ticks=ref["model"].n_ticks, leak=ref["model"].leak,
                                 surrogate=False)
        got = tc.logits_float(model, x, device="cpu")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(tc.predict_float(model, x, device="cpu"),
                                      jc.predict_float(ref["model"], x))


def test_exactness_guard_and_one_launch_per_call(reference):
    dep = interop.deployed_from_numpy(interop.deployed_to_numpy(reference["mnist"]["dep"]))
    x = reference["mnist"]["test"][0]
    reach = int(dep.bank.weights[:64, 64:74].astype(np.int64).sum(axis=0).max())
    big = np.zeros_like(x)
    big[0, 0] = 2 ** 24 // reach + 1
    with pytest.raises(ValueError, match="2\\^24"):
        tc.predict_int(dep, big, device="cpu")
    before = sm_kernel.launches
    tc.predict_int(dep, x, device="cpu")
    assert sm_kernel.launches == before          # CPU tensors run the twin


# -- training --------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_fit_from_the_reference_init_tracks_its_training(reference, name):
    ref = reference[name]
    cfg = ref["cfg"]
    n_in, n_out = cfg.layer_sizes
    xtr, ytr = ref["train"]
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))   # classifier.train's draw
    raw = {"w": torch.from_numpy(np.array(jax.random.normal(k1, (n_in, n_out)) * 0.3)),
           "b": torch.from_numpy(np.array(jax.random.normal(k2, (n_out,)) * 0.1))}
    xd = torch.from_numpy(np.asarray(xtr, np.float32))
    yd = torch.from_numpy(np.asarray(ytr)).long()
    early = tc.trained_from_raw(tc._fit(raw, xd, yd, 100, 0.1), xd, cfg.n_ticks)
    want = jc.train(xtr, ytr, cfg, epochs=100)
    np.testing.assert_allclose(early.w, want.w, rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(early.bias, want.bias, rtol=1e-5, atol=2e-5)
    full = tc.trained_from_raw(tc._fit(raw, xd, yd, 1500, 0.1), xd, cfg.n_ticks)
    xte = ref["test"][0]
    np.testing.assert_array_equal(tc.predict_float(full, xte, device="cpu"),
                                  jc.predict_float(ref["model"], xte))
    dep = tc.deploy(full, n_neurons=cfg.n_neurons, device="cpu")
    np.testing.assert_array_equal(tc.predict_int(dep, xte, device="cpu"),
                                  jc.predict_int(ref["dep"], xte))


def test_init_is_seeded_on_the_cpu():
    a = tc.init_raw(4, 3, 0, device="cpu")
    b = tc.init_raw(4, 3, 0, device="cpu")
    c = tc.init_raw(4, 3, 1, device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in a) and not torch.equal(a["w"], c["w"])


def test_iris_meets_the_reference_floors(own):
    """tests/test_e2e_iris.py's floors, on the port's own training."""
    m = own["iris"]
    (xtr, ytr), (xte, yte) = m["train"], m["test"]
    assert tc.accuracy(tc.predict_float(m["model"], xtr, device="cpu"), ytr) >= 0.90
    pi = tc.predict_int(m["dep"], xte, device="cpu")
    assert tc.accuracy(pi, yte) >= 0.85
    assert (tc.predict_float(m["model"], xte, device="cpu") == pi).mean() >= 0.9


def test_mnist_meets_the_reference_floors(own):
    """tests/test_e2e_mnist.py's floors, on the port's own training."""
    m = own["mnist"]
    (xtr, ytr), (xte, yte) = m["train"], m["test"]
    assert tc.accuracy(tc.predict_float(m["model"], xtr, device="cpu"), ytr) >= 0.9
    pred = tc.predict_int(m["dep"], xte, device="cpu")
    assert tc.accuracy(pred, yte) >= 0.8
    assert min((pred[yte == d] == d).mean() for d in range(10)) >= 0.5


# -- the register bank -------------------------------------------------------------


def test_register_counts_are_the_papers(own):
    iris_bank, mnist_bank = own["iris"]["dep"].bank, own["mnist"]["dep"].bank
    assert iris_bank.n == 7 and mnist_bank.n == 74
    bd = iris_bank.breakdown()
    assert (bd.connection_list, bd.weights, bd.total) == (7, 49, 64)
    assert bd.total == len(iris_bank.serialize())
    bd = mnist_bank.breakdown()
    assert (bd.connection_list, bd.impulses) == (74 * 10, 10)
    assert transaction_breakdown(74).total == 898


def test_models_round_trip_through_interop(own):
    m = own["mnist"]
    back = interop.trained_from_numpy(interop.trained_to_numpy(m["model"]))
    np.testing.assert_array_equal(back.w, m["model"].w)
    assert back.v_th == m["model"].v_th and back.n_ticks == m["model"].n_ticks
    dep = interop.deployed_from_numpy(interop.deployed_to_numpy(m["dep"]))
    assert dep.bank.serialize() == m["dep"].bank.serialize()
    np.testing.assert_array_equal(dep.bank.bias, m["dep"].bank.bias)
    x = m["test"][0]
    np.testing.assert_array_equal(tc.predict_int(dep, x, device="cpu"),
                                  tc.predict_int(m["dep"], x, device="cpu"))


def test_entry_points_default_to_the_card(own):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None runs there")
    m = own["iris"]
    x, y = m["train"]
    for call in (lambda: tc.train(x, y, m["cfg"], epochs=1),
                 lambda: tc.deploy(m["model"]), lambda: tc.predict_int(m["dep"], x),
                 lambda: tc.predict_float(m["model"], x)):
        with pytest.raises(RuntimeError, match="NVIDIA GPU"):
            call()


# -- examples ----------------------------------------------------------------------


def test_examples_run_on_the_cpu(capsys):
    pred = ex_quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "register download: 64 bytes" in out and len(pred) == 45
    acc, per_class = ex_mnist.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "CL 740 + th 74 + w 74 + imp 10 = 898 transactions" in out
    assert "paper timing: 93.54 ms" in out
    assert acc >= 0.8 and min(per_class.values()) >= 0.5
