"""The 4096-neuron free-form fabric served through the whole-tick kernel.

Copy of ``repro.configs.snn_fused``: 4096 neurons, all-to-all topology as
data, 32 ticks per wave, fixed leak in f32, ``snn_backend="pallas_fused"``
(kernel B2, ``csrc/tick_fused.cu``, one launch per tick).
"""
from repro_torch.configs import register
from repro_torch.configs.base import ArchBundle, ModelConfig, ParallelConfig

FULL = ModelConfig(
    name="snn-fused",
    family="snn",
    n_neurons=4096,
    layer_sizes=(),          # free-form all-to-all, not layered
    n_ticks=32,
    snn_mode="fixed_leak",
    snn_backend="pallas_fused",
    dtype="float32",
    source="DESIGN.md §9 whole-tick fusion of paper §II",
)

SMOKE = ModelConfig(
    name="snn-fused-smoke",
    family="snn",
    n_neurons=256,
    layer_sizes=(),
    n_ticks=16,
    snn_mode="fixed_leak",
    snn_backend="pallas_fused",
    head_pad=1,
    dtype="float32",
)


@register("snn-fused")
def bundle() -> ArchBundle:
    return ArchBundle(model=FULL, smoke=SMOKE, parallel={"*": ParallelConfig()})
