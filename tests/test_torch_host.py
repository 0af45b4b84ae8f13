"""Host-side parity of the PyTorch port: register bank, UART, connectivity.

These modules are numpy-only copies in ``repro_torch`` (the port never
imports the JAX package), so every comparison is exact: equal bytes,
equal arrays.
"""
import numpy as np
import pytest

from repro.core import connectivity as j_conn
from repro.core import registers as j_reg
from repro.core import uart as j_uart
from repro_torch.core import connectivity as t_conn
from repro_torch.core import registers as t_reg
from repro_torch.core import uart as t_uart


def _bank(mod, n, layout, seed):
    rng = np.random.default_rng(seed)
    bank = mod.RegisterBank(n, weight_layout=mod.WeightLayout(layout))
    c = rng.random((n, n)) < 0.3
    bank.set_connection_list(c)
    wshape = (n,) if layout == "per_neuron" else (n, n)
    bank.set_weights(rng.integers(0, 256, wshape).astype(np.uint8))
    bank.set_thresholds(rng.integers(0, 256, (n,)).astype(np.uint8))
    bank.set_impulses(rng.random(n) < 0.5)
    bank.set_refractory(int(rng.integers(0, 4)))
    bank.set_leak(rng.integers(0, 8, (n,)))
    bank.set_bias(3)
    return bank


@pytest.mark.parametrize("n,layout", [(1, "per_neuron"), (74, "per_neuron"),
                                      (13, "per_synapse"), (40, "per_synapse")])
def test_register_bank_bytes_and_round_trip(n, layout):
    jb, tb = _bank(j_reg, n, layout, n), _bank(t_reg, n, layout, n)
    payload = jb.serialize()
    assert tb.serialize() == payload
    assert tb.breakdown().total == jb.breakdown().total == len(payload)
    assert tb.reprogram_time_s() == jb.reprogram_time_s()
    j2 = j_reg.RegisterBank(n, weight_layout=j_reg.WeightLayout(layout))
    t2 = t_reg.RegisterBank(n, weight_layout=t_reg.WeightLayout(layout))
    j2.load_bytes(payload)
    t2.load_bytes(payload)
    for key, val in j2.as_dict().items():
        np.testing.assert_array_equal(t2.as_dict()[key], val)
    np.testing.assert_array_equal(t2.get_connection_list(), jb.get_connection_list())


def test_transaction_breakdown_paper_arithmetic():
    for n in (1, 74, 300):
        for layout in ("per_neuron", "per_synapse"):
            a = t_reg.transaction_breakdown(n, t_reg.WeightLayout(layout))
            b = j_reg.transaction_breakdown(n, j_reg.WeightLayout(layout))
            assert dataclass_tuple(a) == dataclass_tuple(b)
    assert t_reg.transaction_breakdown(74).total == 898


def dataclass_tuple(b):
    return (b.connection_list, b.thresholds, b.weights, b.impulses, b.total)


def test_uart_frames_and_streams():
    for byte in (0, 1, 0x5A, 0xFF):
        assert t_uart.encode_frame(byte) == j_uart.encode_frame(byte)
        assert t_uart.decode_frame(t_uart.encode_frame(byte)) == byte
    payload = bytes(np.random.default_rng(1).integers(0, 256, 97).astype(np.uint8))
    bits = t_uart.encode_stream(payload)
    np.testing.assert_array_equal(bits, j_uart.encode_stream(payload))
    assert t_uart.decode_stream(bits) == j_uart.decode_stream(bits) == payload
    tl, jl = t_uart.HostLink(), j_uart.HostLink()
    assert tl.send(payload) == jl.send(payload) == payload
    assert tl.receive(payload[:9]) == payload[:9]
    jl.receive(payload[:9])
    assert tl.stats.time_s == jl.stats.time_s
    with pytest.raises(ValueError):
        t_uart.decode_frame([1] * 10)


@pytest.mark.parametrize("build", [
    lambda m: m.all_to_all(17),
    lambda m: m.all_to_all(9, self_connections=True),
    lambda m: m.layered([4, 3]),
    lambda m: m.layered([5, 7, 2]),
    lambda m: m.sparse_random(33, 0.2, seed=4),
    lambda m: m.ring(12, k=2),
])
def test_connectivity_builders_and_bits(build):
    c = build(t_conn)
    np.testing.assert_array_equal(c, build(j_conn))
    packed = t_conn.pack_bits(c)
    np.testing.assert_array_equal(packed, j_conn.pack_bits(c))
    np.testing.assert_array_equal(t_conn.unpack_bits(packed, c.shape[0]), c)
    np.testing.assert_array_equal(t_conn.fan_in(c), j_conn.fan_in(c))
    np.testing.assert_array_equal(t_conn.fan_out(c), j_conn.fan_out(c))


def test_connectivity_validate_rejects_like_reference():
    for bad in (np.zeros((3, 4), bool), np.zeros((3, 3), np.float32)):
        with pytest.raises(ValueError):
            t_conn.validate(bad)
        with pytest.raises(ValueError):
            j_conn.validate(bad)


@pytest.mark.parametrize("build", [
    lambda m: m.all_to_all(11),
    lambda m: m.layered([5, 7, 2]),
    lambda m: m.sparse_random(40, 0.1, seed=5),
    lambda m: m.ring(16, k=3),
    lambda m: np.zeros((6, 6), bool),
])
def test_compressed_layouts_byte_equal(build):
    """CSR, padded neighbour lists and the topology statistics the event
    backend plans from: equal arrays and equal fields."""
    c = build(j_conn)
    t_ptr, t_ind = t_conn.to_csr(c)
    j_ptr, j_ind = j_conn.to_csr(c)
    for got, want in ((t_ptr, j_ptr), (t_ind, j_ind)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(t_conn.csr_to_dense(t_ptr, t_ind, c.shape[0]), c)
    for name in ("padded_neighbors", "padded_fan_in"):
        for cap in (None, c.shape[0]):
            got, want = getattr(t_conn, name)(c, cap), getattr(j_conn, name)(c, cap)
            assert isinstance(got, t_conn.PaddedNeighbors)
            for field in ("idx", "mask"):
                assert getattr(got, field).dtype == getattr(want, field).dtype
                np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
            for field in ("cap", "axis", "n_edges", "max_degree", "mean_degree",
                          "padding_fraction"):
                assert getattr(got, field) == getattr(want, field), field
    assert t_conn.stats(c).__dict__ == j_conn.stats(c).__dict__
    assert isinstance(t_conn.stats(c), t_conn.ConnectivityStats)


def test_padded_lists_refuse_to_truncate_like_reference():
    c = j_conn.all_to_all(8)
    for mod in (t_conn, j_conn):
        with pytest.raises(ValueError, match="below max degree"):
            mod.padded_fan_in(c, 3)
