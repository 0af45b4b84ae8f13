"""Kernel B6 (``spike_matmul``): the port's plain twin and its bridge
``ops.spike_matmul`` against the JAX package's Pallas kernel, run in
interpret mode on the CPU, and the wrapper's contract.

The CUDA kernel runs only on an NVIDIA GPU: ``test_cuda_*`` launches it
against its twin there and skips elsewhere.

Tolerances: the reference's own (``tests/test_kernels.py``): ``1e-5`` on
normal float32 weights (the sums run in other orders) and ``2e-2`` in
bfloat16; bitwise for 0/1 spikes times u8-grid weights, where every partial
sum is an integer below 2^24 and so exact in any order.
"""
import hypothesis.strategies as st
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings

from repro.kernels import ops as j_ops
from repro.kernels.ref import spike_matmul_ref as j_spike_matmul_ref
from repro_torch.kernels import ops, ref
from repro_torch.kernels import spike_matmul as sm_kernel

# tests/test_kernels.py's sweep
SHAPES = [(1, 8, 8), (4, 74, 74), (17, 300, 139), (32, 512, 128), (8, 1024, 256)]
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
# ragged edges: the classifier's deploy shapes (Iris, MNIST), a lone element,
# widths off every tile size
RAGGED = [(45, 4, 3), (80, 64, 10), (1, 1, 1), (3, 37, 45), (9, 513, 33)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _case(rng, b, k, n, spike_rate=0.2):
    """tests/test_kernels.py's draw: 0/1 spikes, normal weights, a 0/1 mask."""
    s = (rng.random((b, k)) < spike_rate).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32)
    c = (rng.random((k, n)) < 0.5).astype(np.float32)
    return s, w, c


def _u8_case(rng, b, k, n):
    s = (rng.random((b, k)) < 0.5).astype(np.float32)
    w = rng.integers(0, 256, (k, n)).astype(np.float32)
    c = (rng.random((k, n)) < 0.5).astype(np.float32)
    return s, w, c


def _both(arrays, jdt, tdt):
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


@pytest.mark.parametrize("b,k,n", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_twin_and_bridge_match_the_interpreted_kernel(b, k, n, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(b * 1000 + k + n)
    (js, jw, jc), (ts, tw, tc) = _both(_case(rng, b, k, n), jdt, tdt)
    want = np.asarray(j_ops.spike_matmul(js, jw, jc), np.float32)
    for got in (ref.spike_matmul_ref(ts, tw, tc), ops.spike_matmul(ts, tw, tc)):
        assert got.dtype == torch.float32 and got.shape == (b, n)
        np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("b,k,n", RAGGED)
def test_ragged_u8_grid_is_bitwise(b, k, n):
    """No padding in the port: ragged edges on the u8 grid give the
    interpreted kernel's bits, in f32 and with bf16 spikes (u8 values and 0/1
    are exact in bf16's 8-bit mantissa)."""
    rng = np.random.default_rng(7 * b + k + 3 * n)
    s, w, c = _u8_case(rng, b, k, n)
    want = np.asarray(j_ops.spike_matmul(jnp.asarray(s), jnp.asarray(w), jnp.asarray(c)))
    got = ops.spike_matmul(*(torch.from_numpy(a) for a in (s, w, c)))
    np.testing.assert_array_equal(got.numpy(), want)
    got16 = ops.spike_matmul(torch.from_numpy(s).to(torch.bfloat16), torch.from_numpy(w),
                             torch.from_numpy(c))
    np.testing.assert_array_equal(got16.numpy(), want)


@settings(deadline=None, max_examples=25)
@given(b=st.integers(1, 24), k=st.integers(1, 200), n=st.integers(1, 200),
       seed=st.integers(0, 2**31 - 1))
def test_property_any_shape_matches_the_oracle(b, k, n, seed):
    """Any shape: bitwise against the reference's oracle on the u8 grid,
    within 1e-5 on normal weights."""
    rng = np.random.default_rng(seed)
    for case, exact in ((_u8_case(rng, b, k, n), True), (_case(rng, b, k, n), False)):
        want = np.asarray(j_spike_matmul_ref(*(jnp.asarray(a) for a in case)))
        got = ops.spike_matmul(*(torch.from_numpy(a) for a in case)).numpy()
        if exact:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_wrong_dtypes_shapes_and_devices_raise():
    rng = np.random.default_rng(3)
    s, w, c = (torch.from_numpy(a) for a in _case(rng, 2, 5, 4))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.spike_matmul(s.double(), w, c)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.spike_matmul(s, w.to(torch.int32), c.to(torch.int32))
    with pytest.raises(TypeError, match="dtype"):
        ops.spike_matmul(s, w, c.to(torch.bfloat16))
    with pytest.raises(ValueError, match="mask"):
        ops.spike_matmul(s, w, None)
    with pytest.raises(ValueError, match="shape"):
        ops.spike_matmul(s[:, :4], w, c)
    with pytest.raises(ValueError, match="shape"):
        ops.spike_matmul(s, w, c[:, :3])
    with pytest.raises(ValueError, match="device"):
        ops.spike_matmul(s, w.to("meta"), c)
    meta = [t.to("meta") for t in (s, w, c)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        sm_kernel.spike_matmul(*meta)


def test_cpu_tensors_run_the_twin_without_a_launch():
    rng = np.random.default_rng(4)
    s, w, c = (torch.from_numpy(a) for a in _u8_case(rng, 3, 9, 5))
    before = sm_kernel.launches
    got = sm_kernel.spike_matmul(s, w, c)
    assert sm_kernel.launches == before
    assert torch.equal(got, ref.spike_matmul_ref(s, w, c))
    assert torch.equal(got, s @ (w * c))


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the hand-written kernels have "
                    "no CPU mode (their plain twins are tested above)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cuda_kernel_matches_twin(dtype):
    """On the card: B6 against its twin on the sweep and ragged shapes,
    bitwise on the u8 grid, within the tolerance on normal weights; one
    launch per call."""
    dev = _cuda_or_skip()
    _, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(11)
    for b, k, n in SHAPES + RAGGED:
        for case, exact in ((_u8_case(rng, b, k, n), True), (_case(rng, b, k, n), False)):
            s, w, c = (torch.from_numpy(a).to(dev) for a in case)
            if not exact:
                s, w, c = s.to(tdt), w.to(tdt), c.to(tdt)
            before = sm_kernel.launches
            got = ops.spike_matmul(s, w, c)
            torch.cuda.synchronize()
            assert sm_kernel.launches == before + 1
            want = ref.spike_matmul_ref(s, w, c)
            if exact:
                assert torch.equal(got, want)
            else:
                torch.testing.assert_close(got, want, rtol=tol, atol=tol)
