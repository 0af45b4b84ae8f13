"""``loss_fn``'s gradients under autograd (``repro_torch.models``) against
the reference's ``jax.value_and_grad`` for every f32 SMOKE config, on the
CPU, from the reference's parameters carried by ``interop`` and the same
batch (the helpers are ``tests/test_torch_train.py``'s).

Tolerance: each gradient leaf within ``1e-5`` of the reference's, relative
to the leaf's norm, and the loss within ``1e-5``; rwkv6 and jamba within
``5e-5``. rwkv6's group norm amplifies one ulp
(``tests/test_torch_lm_families.py``), and jamba's first mamba layer's
gradient moves by more than ``1e-5`` of its norm when the port's own
parameters move by ``1e-7`` relative
(``test_jamba_gradients_amplify_a_1e7_perturbation``): both sides sum in
other orders, so their rounding parts that far.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as JM
from repro_torch.configs import ASSIGNED_ARCHS
from repro_torch.util import tree
from test_torch_train import _batch, _named, _params, _port_grads, _port_params, _smoke

jax.config.update("jax_platform_name", "cpu")

GRAD_TOL = {"rwkv6-1.6b": 5e-5, "jamba-1.5-large-398b": 5e-5}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: under the test runner's parallel workers more
    threads only contend for the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=None)
def _ref_grads(arch):
    """The reference's loss, metrics and gradients at the first batch
    (``jax.value_and_grad`` of ``loss_fn``, jitted)."""
    cfg = _smoke(arch)
    jb = {k: jnp.asarray(v) for k, v in _batch(arch).items()}
    fn = jax.jit(jax.value_and_grad(lambda p: JM.loss_fn(p, cfg, jb, remat="none"),
                                    has_aux=True))
    (loss, metrics), grads = fn(jax.tree.map(jnp.asarray, _params(arch)))
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            [np.asarray(g, np.float32) for g in jax.tree.leaves(grads)])


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_loss_fn_gradients_match_the_reference(arch):
    loss, metrics, grads = _port_grads(arch)
    want_loss, want_metrics, want = _ref_grads(arch)
    tol = GRAD_TOL.get(arch, 1e-5)
    np.testing.assert_allclose(float(loss), want_loss, rtol=tol, atol=tol)
    for k in ("nll", "router_aux"):
        np.testing.assert_allclose(float(metrics[k]), want_metrics[k], rtol=tol, atol=tol)
    named = _named(grads)
    assert len(named) == len(want)
    for (path, g), w in zip(named, want):
        assert tuple(g.shape) == w.shape, path
        norm = max(float(np.linalg.norm(w)), 1e-30)
        err = float(np.linalg.norm(g.numpy() - w))
        assert err <= tol * norm, f"{arch} {path}: |diff| {err:.3g} over |grad| {norm:.3g}"


def test_jamba_gradients_amplify_a_1e7_perturbation():
    """Why jamba is held at 5e-5: moving the port's own parameters by 1e-7
    relative moves its first mamba layer's ``x_proj_b`` gradient by more than
    1e-5 of its norm."""
    arch = "jamba-1.5-large-398b"
    _, _, g0 = _port_grads(arch)
    gen = torch.Generator().manual_seed(1)
    moved = tree.map(lambda p: p * (1 + 1e-7 * torch.randn(p.shape, generator=gen)),
                     _port_params(arch))
    _, _, g1 = _port_grads(arch, params=moved)
    a = g0["stages"][0]["layer0"]["mixer"]["x_proj_b"]
    b = g1["stages"][0]["layer0"]["mixer"]["x_proj_b"]
    assert float(torch.linalg.norm(a - b) / torch.linalg.norm(a)) > 1e-5
