"""Production-scale SNN core: 65,536 neurons, all-to-all fabric.

Copy of ``repro.configs.snn_64k``, field for field: the paper's architecture
scaled to the point where the synapse matrix (64k x 64k = 4.3G synapses,
16 GiB in f32) is sharded by destination columns (DESIGN.md §15). The
implicit all-to-all (``c=None``) means no second mask matrix ever exists.
``snn_mesh=8`` is the reference's simulated mesh; the port's serve CLI
(``python -m repro_torch.launch.serve --arch snn-64k [--smoke]``) serves on
the ranks of the world it is started in, a lone process being one rank
(:func:`repro_torch.launch.serve.serve_sharded_main`).
"""
from repro_torch.configs import register
from repro_torch.configs.base import ArchBundle, ModelConfig, ParallelConfig

FULL = ModelConfig(
    name="snn-64k",
    family="snn",
    n_neurons=65536,
    layer_sizes=(),        # free-form all-to-all, not layered
    n_ticks=8,
    snn_mode="fixed_leak",
    snn_mesh=8,            # shard the fabric over 8 devices (DESIGN.md §15)
    dtype="float32",
    source="DESIGN.md §4 scale-up of paper §II.D",
)

SMOKE = ModelConfig(
    name="snn-64k-smoke",
    family="snn",
    n_neurons=256,
    layer_sizes=(),
    n_ticks=8,
    snn_mode="fixed_leak",
    snn_mesh=2,            # exercise the sharded path at smoke scale
    head_pad=1,
    dtype="float32",
)


@register("snn-64k")
def bundle() -> ArchBundle:
    return ArchBundle(model=FULL, smoke=SMOKE, parallel={"*": ParallelConfig()})
