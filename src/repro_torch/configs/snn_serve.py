"""The multi-tenant SNN serving fabric: one resident datapath, S slots.

Copy of ``repro.configs.snn_serve``. ``n_neurons`` is the fabric size
``n_max``: every tenant is zero-padded onto it (padded neurons carry an
unreachable threshold and never spike). ``n_ticks`` is the per-wave tick
ceiling; requests may ask for fewer and are masked at decode.
"""
import dataclasses

from repro_torch.configs import register
from repro_torch.configs.base import ArchBundle, ModelConfig, ParallelConfig

FULL = ModelConfig(
    name="snn-serve",
    family="snn",
    n_neurons=74,            # the paper's fabric, serving many tenants
    n_ticks=32,
    snn_mode="fixed_leak",
    dtype="float32",
    source="paper §II + multi-tenant serving (NeuroCoreX / low-end-FPGA time-sharing)",
)

SMOKE = dataclasses.replace(FULL, name="snn-serve-smoke", n_neurons=24, n_ticks=12)


@register("snn")
def bundle() -> ArchBundle:
    return ArchBundle(model=FULL, smoke=SMOKE, parallel={"*": ParallelConfig()})
