"""The large sparse fabric served through event-driven dispatch.

Copy of ``repro.configs.snn_event``: 4096 neurons at density 0.05 and input
rate 0.05, 32 ticks, fixed leak, ``snn_backend="event"`` with
``snn_dispatch="auto"`` (:func:`repro_torch.core.dispatch_policy.plan`
picks the formulation). At that operating point the dense product spends
nearly all of its ``B*K*N`` multiply-adds on silent neurons; the spike-list
kernel B3 (``csrc/event_dispatch.cu``) reads only the spiking neurons'
fan-out rows.
"""
from repro_torch.configs import register
from repro_torch.configs.base import ArchBundle, ModelConfig, ParallelConfig

FULL = ModelConfig(
    name="snn-event",
    family="snn",
    n_neurons=4096,
    layer_sizes=(),
    n_ticks=32,
    snn_mode="fixed_leak",
    snn_backend="event",
    snn_dispatch="auto",
    snn_density=0.05,
    snn_rate=0.05,
    dtype="float32",
    source="DESIGN.md §10/§12 event dispatch of paper §II mux fabric",
)

SMOKE = ModelConfig(
    name="snn-event-smoke",
    family="snn",
    n_neurons=1024,
    layer_sizes=(),
    n_ticks=16,
    snn_mode="fixed_leak",
    snn_backend="event",
    snn_dispatch="auto",
    snn_density=0.05,
    snn_rate=0.05,
    head_pad=1,
    dtype="float32",
)


@register("snn-event")
def bundle() -> ArchBundle:
    return ArchBundle(model=FULL, smoke=SMOKE, parallel={"*": ParallelConfig()})
