"""The paper's MNIST network: 64 input + 10 output LIF neurons (Fig. 6).

Copy of ``repro.configs.mnist_snn``. 8x8 binarized images, refractory 4
ticks, 74 neurons total -- the system whose register bank costs 898 UART
transactions (§III.B).
"""
from repro_torch.configs import register
from repro_torch.configs.base import ArchBundle, ModelConfig, ParallelConfig

FULL = ModelConfig(
    name="mnist-snn",
    family="snn",
    n_neurons=74,
    layer_sizes=(64, 10),
    n_ticks=4,
    snn_mode="fixed_leak",
    dtype="float32",
    source="paper §III.B",
)


@register("mnist-snn")
def bundle() -> ArchBundle:
    return ArchBundle(model=FULL, smoke=FULL, parallel={"*": ParallelConfig()})
