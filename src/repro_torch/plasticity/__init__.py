"""On-device plasticity: trace-based STDP / R-STDP inside the tick loop.

Counterpart of ``repro.plasticity``. Pair-based STDP with pre/post traces
and a reward-modulated variant (R-STDP); weights stay on the register
bank's u8 domain ``[0, 255]``, so a learned network serialises back through
:class:`repro_torch.core.registers.RegisterBank` byte-exactly.

* :mod:`repro_torch.plasticity.traces` -- exponential spike traces.
* :mod:`repro_torch.plasticity.stdp` -- ``PlasticityParams`` /
  ``PlasticityState`` and the reference update.
* :mod:`repro_torch.plasticity.rules` -- rule dispatch and the backend
  switch (plain twin vs kernel B5, ``csrc/stdp_update.cu``).
* ``repro_torch.core.network.learning_rollout`` -- the tick loop whose
  carry holds the mutable weights.
"""
from repro_torch.plasticity.stdp import (  # noqa: F401
    PlasticityParams,
    PlasticityState,
    apply_reward,
    quantize_weights,
    weights_from_bank,
    weights_to_bank,
)
from repro_torch.plasticity.rules import plasticity_step  # noqa: F401
