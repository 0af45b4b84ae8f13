"""Multi-tenant SNN serving: many resident networks, one tick datapath.

Counterpart of ``examples/serve_multi_tenant.py``. The paper's headline is
that swapping a network is a *parameter download*, never a re-synthesis. The
serving restatement: S tenant networks (heterogeneous topologies,
thresholds, leaks; some frozen, one learning online) time-share one tick
loop with a slot axis. Admitting a request is writing a slot's registers;
the demo asserts that the whole run puts one program into use, and then
serves more requests by continuous admission on the same fabric.

  PYTHONPATH=src python -m repro_torch.examples.serve_multi_tenant [--fast] [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import connectivity
from repro_torch.core.registers import RegisterBank, WeightLayout
from repro_torch.launch.serve import SNNServer, make_demo_requests, make_demo_tenants


def iris_like_bank(seed: int = 0) -> RegisterBank:
    """The paper's Iris shape (4 input -> 3 output) as a register image."""
    n = 7
    bank = RegisterBank(n, weight_layout=WeightLayout.PER_SYNAPSE)
    c = connectivity.layered([4, 3])
    bank.set_connection_list(c)
    rng = np.random.default_rng(seed)
    bank.set_weights((rng.integers(60, 200, (n, n)) * c).astype(np.uint8))
    bank.set_thresholds(np.full((n,), 100, np.uint8))
    bank.set_refractory(2)
    return bank


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    n_requests = 12 if args.fast else 48
    server = SNNServer(n_max=24, slots=args.slots, max_ticks=12, device=args.device)

    # 8 heterogeneous demo tenants (the last plastic) and the paper's Iris net.
    names = make_demo_tenants(server, 8, seed=0)
    server.add_tenant("iris", iris_like_bank(), n_in=4, n_out=3)
    names.append("iris")
    plastic = [t.name for t in server.tenants.values() if t.plastic]
    print(f"fabric n_max={server.n_max}, slots={server.slots} on {server.device}: "
          f"{len(server.tenants)} resident tenants ({', '.join(names)}); plastic: {plastic}")

    reqs = make_demo_requests(server, names, n_requests, seed=1)

    w_plastic0 = server.tenants[plastic[0]].params.w.cpu().numpy().copy()
    stats = server.serve(reqs)
    for k, v in stats.items():
        if k not in ("preds", "results"):
            print(f"  {k}: {v}")

    assert stats["compiles"] == 1, "tenant swaps must not put a new program into use"
    assert stats["recompiles_after_warmup"] == 0
    w_plastic1 = server.tenants[plastic[0]].params.w.cpu().numpy()
    drift = float(np.abs(w_plastic1 - w_plastic0).sum())
    print(f"  plastic tenant weight drift across waves: {drift:.1f} "
          "(frozen tenants: bit-identical by construction)")
    assert drift > 0, "the plastic tenant never learned"

    # Per-tenant activity from the telemetry riding the tick loop: spike
    # rates, refractory occupancy and (for the plastic tenant) the accumulated
    # |dw|, all measured on the device, no extra rollouts.
    print("per-tenant activity:")
    for name, row in server.tenant_report().items():
        print(f"  {name:>10}: requests={row['requests']:>2} "
              f"spike_rate={row['spike_rate']:.3f} "
              f"refractory={row['refractory_occupancy']:.3f} "
              f"dw_l1={row['dw_l1']:.1f}"
              f"{'  [plastic]' if row['plastic'] else ''}")
    assert server.tenant_report()[plastic[0]]["dw_l1"] > 0

    # Continuous admission: the same tenants and datapath, but slots retire
    # and refill one by one instead of draining whole waves, so short
    # requests stop waiting on the longest one of their wave.
    cont = server.serve_continuous(make_demo_requests(server, names, n_requests, seed=2))
    assert cont["recompiles_after_warmup"] == 0, \
        "a slot refill must not put a new program into use"
    print(f"continuous admission: served {cont['requests_served']} more "
          f"requests, mean TTFT {cont['mean_ttft_s'] * 1e3:.1f} ms, "
          f"p99 {cont['p99_ttft_s'] * 1e3:.1f} ms, 0 recompiles")

    print("PASS - one tick program served "
          f"{stats['n_tenants']} networks / {stats['n_requests']} requests")
    return stats


if __name__ == "__main__":
    main()
