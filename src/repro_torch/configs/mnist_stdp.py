"""On-device learning system: MNIST-8x8 with STDP features + R-STDP readout.

Copy of ``repro.configs.mnist_stdp`` (beyond the paper; the NeuroCoreX
direction, arXiv:2506.14138): the same 64-input fabric as the paper's MNIST
system, but the weights are *learned on the device* instead of streamed in
over the UART.

Stage 1 -- unsupervised features: 64 input neurons drive ``N_HIDDEN``
feature neurons through a bipartite connection list; pair STDP moves each
feature neuron's fan-in toward the digit patterns it fires for. Two
competition mechanisms make the features diverge: a *fixed* lateral
winner-take-all block (negative hidden->hidden weights, frozen by the
plastic mask), and a host-side homeostasis loop that nudges per-neuron
threshold *registers* up on every win.

Stage 2 -- supervised readout: feature spike trains drive 10 output
neurons; R-STDP banks an eligibility trace during the presentation and a
terminal +/- reward (was the argmax right?) converts it into a weight
update.

All weights live on the u8 register grid's range throughout, so the learned
network serializes back through the RegisterBank byte protocol
(``repro_torch.examples.online_learning`` asserts the round trip).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import register
from repro_torch.configs.base import ArchBundle, ModelConfig, ParallelConfig
from repro_torch.plasticity.stdp import PlasticityParams

N_INPUT = 64
N_HIDDEN = 64     # ~6 feature neurons per class: enough WTA capacity for the
                  # dataset's +/-1-pixel shift variants of each digit
N_CLASSES = 10

FULL = ModelConfig(
    name="mnist-stdp",
    family="snn",
    n_neurons=N_INPUT + N_HIDDEN,
    layer_sizes=(N_INPUT, N_HIDDEN),
    n_ticks=8,
    snn_mode="fixed_leak",
    dtype="float32",
    source="beyond paper: NeuroCoreX-style on-device learning (2506.14138)",
)


@dataclasses.dataclass(frozen=True)
class STDPRunConfig:
    """Everything the online-learning example needs beyond ModelConfig."""

    # stage 1: unsupervised STDP feature layer
    feature: PlasticityParams = PlasticityParams.make(
        "stdp",
        tau_pre=2.0, tau_post=2.0,
        a_plus=0.5, a_minus=0.1,
        w_min=0.0, w_max=12.0,      # low band of the u8 grid: keeps the
    )                               # summed drive inside u8 thresholds
    w_init_lo: float = 2.0
    w_init_hi: float = 10.0
    w_init_density: float = 0.25    # sparse random receptive fields: the
                                     # across-neuron drive variance that lets
                                     # the WTA desynchronize threshold crossings
    v_th_base: float = 96.0          # feature threshold register at init
    theta_init_jitter: float = 40.0  # random initial theta: breaks residual
                                     # first-spike ties
    leak: float = 48.0               # fixed-leak lambda: sub-threshold drives
                                     # (pattern overlaps) never accumulate
    lateral_inhibition: float = 127.0   # fixed hidden->hidden WTA weight (the
                                        # parallel inhibitory bank: u8 magnitude,
                                        # subtracted on-chip)
    theta_plus: float = 8.0          # homeostatic threshold bump per spike
    theta_drift: float = 1.0         # per-presentation downward drift: silent
                                     # neurons get easier to fire until they
                                     # claim a pattern (no dead units)
    theta_min: float = -56.0         # v_th_base + theta >= 40 (a valid u8
                                     # threshold register)
    theta_max: float = 159.0         # v_th_base + theta stays u8 (<= 255)
    w_total: float = 192.0           # per-neuron fan-in budget (synaptic
                                     # scaling): winning one pattern costs
                                     # weight elsewhere
    ticks_per_sample: int = 8

    # stage 2: R-STDP readout
    readout: PlasticityParams = PlasticityParams.make(
        "rstdp",
        tau_pre=2.0, tau_post=2.0, tau_elig=6.0,
        a_plus=1.0, a_minus=0.25,
        lr_reward=0.7,
        w_min=0.0, w_max=48.0,
    )
    readout_w_init: float = 12.0
    readout_v_th: float = 20.0
    reward_correct: float = 1.0
    reward_wrong: float = -1.0


RUN = STDPRunConfig()


@register("mnist-stdp")
def bundle() -> ArchBundle:
    return ArchBundle(model=FULL, smoke=FULL, parallel={"*": ParallelConfig()})
