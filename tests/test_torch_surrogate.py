"""The surrogate spike and surrogate-gradient BPTT in the port, against the
JAX package.

Tolerances: the forward spike is a Heaviside step, bitwise; the surrogate's
gradient ``1 / (beta*|x| + 1)^2`` is one division of the same f32 values,
held to ``rtol=1e-6``. The BPTT gradient of ``tests/test_network.py``'s
permutation loss (n = 8, 4 ticks, batch 16) is held to ``1e-5``: the
forward rasters are equal, and the backward sums run in other orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import connectivity as j_conn
from repro.core import network as j_net
from repro.core import surrogate as j_sur
from repro.core.engine import EngineOptions as JEngineOptions
from repro.core.engine import TickEngine as JTickEngine
from repro.core.lif import LIFParams as JLIFParams
from repro_torch.core import network as t_net
from repro_torch.core import surrogate as t_sur
from repro_torch.core.engine import EngineOptions, TickEngine
from repro_torch.core.lif import LIFParams

N = 8
TICKS = 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_forward_is_heaviside():
    x = np.asarray([-1.0, -1e-6, 0.0, 1e-6, 1.0], np.float32)
    want = np.asarray(j_sur.spike_surrogate(jnp.asarray(x)))
    got = t_sur.spike_surrogate(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, [0, 0, 1, 1, 1])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(t_sur.spike_hard(torch.from_numpy(x)).numpy(),
                                  np.asarray(j_sur.spike_hard(jnp.asarray(x))))


@pytest.mark.parametrize("beta", [j_sur.DEFAULT_BETA, 3.0])
def test_gradient_matches_jax_grad(beta):
    assert t_sur.DEFAULT_BETA == j_sur.DEFAULT_BETA
    x = np.random.default_rng(0).normal(size=257).astype(np.float32) * 2
    x[:5] = [-2.0, -0.1, 0.0, 0.1, 2.0]
    g = np.random.default_rng(1).normal(size=257).astype(np.float32)
    want = np.asarray(jax.vjp(lambda a: j_sur.spike_surrogate(a, beta), jnp.asarray(x))[1](
        jnp.asarray(g))[0])
    xt = torch.from_numpy(x).requires_grad_(True)
    t_sur.spike_surrogate(xt, beta).backward(torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-6, atol=0)
    ones = torch.from_numpy(x[:5]).requires_grad_(True)
    t_sur.spike_surrogate(ones, beta).sum().backward()
    gd = ones.grad.numpy()
    assert gd.argmax() == 2 and (gd > 0).all() and gd[0] < gd[1] < gd[2]


def _problem():
    """tests/test_network.py::TestSurrogate's permutation task."""
    rng = np.random.default_rng(0)
    c = j_conn.layered([4, 4]).astype(np.float32)
    x = (rng.random((16, 4)) > 0.5).astype(np.float32)
    targets = x[:, [1, 0, 3, 2]]
    ext = np.zeros((TICKS, 16, N), np.float32)
    ext[:, :, :4] = x[None]
    w0 = (rng.normal(size=(N, N)) * 0.3 - 0.5).astype(np.float32)
    return c, ext, targets, w0


def _j_loss(c, ext, targets, **kw):
    def loss_fn(w):
        p = j_net.SNNParams(w=jax.nn.softplus(w), c=jnp.asarray(c), w_in=jnp.eye(N) * 2.0,
                            lif=JLIFParams.make(N, v_th=1.0))
        _, raster = j_net.rollout(p, j_net.SNNState.zeros((16,), N), jnp.asarray(ext), TICKS,
                                  surrogate=True, **kw)
        return jnp.mean((raster.mean(0)[:, 4:] - targets) ** 2)
    return loss_fn


def _t_loss(c, ext, targets, **kw):
    ct, ext_t, tg = (torch.from_numpy(a) for a in (c, ext, targets))

    def loss_fn(w):
        p = t_net.SNNParams(w=torch.nn.functional.softplus(w), c=ct,
                            w_in=torch.eye(N) * 2.0,
                            lif=LIFParams.make(N, v_th=1.0, device="cpu"))
        _, raster = t_net.rollout(p, t_net.SNNState.zeros((16,), N, device="cpu"), ext_t,
                                  TICKS, surrogate=True, **kw)
        return torch.mean((raster.mean(0)[:, 4:] - tg) ** 2)
    return loss_fn


def _t_grad(loss_fn, w):
    wt = torch.from_numpy(np.array(w)).requires_grad_(True)
    loss = loss_fn(wt)
    loss.backward()
    return loss.item(), wt.grad.numpy()


def test_bptt_gradient_matches_jax_grad():
    c, ext, targets, w0 = _problem()
    j_loss = _j_loss(c, ext, targets)
    t_loss = _t_loss(c, ext, targets)
    rng = np.random.default_rng(5)
    for w in (w0, w0 + rng.normal(size=w0.shape).astype(np.float32) * 0.2):
        want_l, want_g = jax.value_and_grad(j_loss)(jnp.asarray(w))
        got_l, got_g = _t_grad(t_loss, w)
        assert np.abs(want_g).max() > 1e-3          # the surrogate gradient is live
        np.testing.assert_allclose(got_l, float(want_l), rtol=0, atol=1e-7)
        np.testing.assert_allclose(got_g, np.asarray(want_g), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dispatch", ["dense", "topk"])
def test_event_backend_plain_path_trains(dispatch):
    """The event backend runs the surrogate on its plain path (the kernel
    path is inference-only); its loss and gradient are the reference event
    backend's."""
    c, ext, targets, w0 = _problem()
    want_l, want_g = jax.value_and_grad(_j_loss(c, ext, targets, backend="event",
                                                dispatch=dispatch))(jnp.asarray(w0))
    got_l, got_g = _t_grad(_t_loss(c, ext, targets, dispatch=dispatch), w0)
    np.testing.assert_allclose(got_l, float(want_l), rtol=0, atol=1e-7)
    np.testing.assert_allclose(got_g, np.asarray(want_g), rtol=1e-5, atol=1e-5)


def test_training_through_rollout_reduces_loss():
    """200 steps of BPTT through the Python tick loop cut the loss below 0.6x."""
    c, ext, targets, w0 = _problem()
    loss_fn = _t_loss(c, ext, targets)
    w = torch.from_numpy(w0).requires_grad_(True)
    with torch.no_grad():
        l0 = float(loss_fn(w))
    for _ in range(200):
        w.grad = None
        loss_fn(w).backward()
        with torch.no_grad():
            w -= 1.0 * w.grad
    with torch.no_grad():
        l1 = float(loss_fn(w))
    assert l1 < l0 * 0.6, (l0, l1)


@pytest.mark.parametrize("backend", ["pallas", "pallas_fused"])
def test_kernel_backends_refuse_surrogate_at_the_tick(backend):
    """As tests/test_tick_fused.py::test_surrogate_rejected: the options are
    accepted, and the kernel backends raise the reference's ValueError when
    the tick runs."""
    n = 4
    c = torch.from_numpy(j_conn.ring(n).astype(np.float32))
    p = t_net.SNNParams(w=torch.ones(n, n), c=c, w_in=torch.eye(n) * 2.0,
                        lif=LIFParams.make(n, v_th=0.5, device="cpu"))
    eng = TickEngine(EngineOptions(backend=backend, surrogate=True))
    with pytest.raises(ValueError, match="inference-only"):
        eng.tick(t_net.SNNState.zeros((), n, device="cpu"), p, None)
    jp = j_net.SNNParams(w=jnp.ones((n, n)), c=jnp.asarray(c.numpy()), w_in=jnp.eye(n) * 2.0,
                         lif=JLIFParams.make(n, v_th=0.5))
    with pytest.raises(ValueError, match="inference-only"):
        JTickEngine(JEngineOptions(backend=backend, surrogate=True)).tick(
            j_net.SNNState.zeros((), n), jp, None)
