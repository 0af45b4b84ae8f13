"""The paper's Iris network: 4 input + 3 output LIF neurons (Fig. 4).

Copy of ``repro.configs.iris_snn``. Threshold 1, refractory 2 ticks,
layered connectivity via connection list.
"""
from repro_torch.configs import register
from repro_torch.configs.base import ArchBundle, ModelConfig, ParallelConfig

FULL = ModelConfig(
    name="iris-snn",
    family="snn",
    n_neurons=7,
    layer_sizes=(4, 3),
    n_ticks=8,
    snn_mode="fixed_leak",
    dtype="float32",
    source="paper §III.A",
)


@register("iris-snn")
def bundle() -> ArchBundle:
    return ArchBundle(model=FULL, smoke=FULL, parallel={"*": ParallelConfig()})
