"""On-device tick telemetry: per-rollout accumulators that ride the tick loop.

Counterpart of ``repro.obs.telemetry``. :class:`TickTelemetry` is a small
record of batch-shaped tensors that rides the
:class:`~repro_torch.core.engine.TickCarry` when the engine's
``telemetry=True`` option is set:

* **Nothing when off.** With the option off the carry holds no telemetry
  and a rollout launches exactly the kernels it launched before.
* **Reductions only, no host syncs.** Every tick folds a reduction over the
  neuron axis into batch-shaped accumulators on the device; the tick loop
  never keeps a per-tick series and never reads back to the host.
* **Per slot.** The accumulators keep the state's batch shape, so a slot
  axis (the multi-tenant server's) gives per-slot (per-tenant) telemetry.

On the card one launch of the telemetry kernel folds a tick in
(:mod:`repro_torch.kernels.telemetry`); :meth:`TickTelemetry.accumulate` is
its plain twin, in the reference's arithmetic. The accumulators that
:meth:`TickTelemetry.zeros` and :meth:`TickTelemetry.clone` make are nine
views of one int32 buffer (the float fields reinterpret their rows), so a
rollout seeds them with one allocation, the kernel takes one pointer, and
the numbers come off the device in one copy, at
:meth:`TickTelemetry.summary`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

FIELDS = ("ticks", "spikes", "v_sum", "v_max", "ref_sum", "overflow", "policy_dense",
          "dw_l1", "dw_sq")
INT_FIELDS = ("ticks", "overflow", "policy_dense")


def per_row(x: torch.Tensor, batch_shape) -> torch.Tensor:
    """A per-network value (0-d, or ``(G,)`` for G leading groups such as the
    slot axis) broadcast against the batch shape: group ``g`` covers the
    ``g``-th leading block of rows."""
    shape = tuple(batch_shape)
    if x.dim() == 0 or x.numel() == 1:
        return x.reshape(()).expand(shape)
    return x.reshape((x.numel(),) + (1,) * (len(shape) - 1)).expand(shape)


@dataclasses.dataclass(frozen=True)
class TickTelemetry:
    """Per-rollout accumulators; every field has the state's batch shape.

    Attributes:
      ticks: ticks accumulated so far (int32).
      spikes: total spikes emitted, ``sum_t sum_n y``; equals ``raster.sum()``
        over the same rows.
      v_sum: sum over ticks of the mean membrane potential (divide by
        ``ticks`` for the time average).
      v_max: running max of the membrane potential after any tick (from 0).
      ref_sum: sum over ticks of the refractory occupancy ``mean_n 1{r > 0}``.
      overflow: event-backend ticks whose spike count passed ``k_active``
        (int32; 0 on the dense backends and the fan-in gather).
      policy_dense: event-backend ticks the adaptive knee sent to the dense
        arm for speed, within ``k_active`` (int32; disjoint from
        ``overflow``).
      dw_l1: accumulated ``sum |dw|`` of the committed weight updates of the
        row's network (0 when frozen).
      dw_sq: accumulated ``sum dw^2``; its square root is the L2 norm of the
        update stream.
    """

    ticks: torch.Tensor
    spikes: torch.Tensor
    v_sum: torch.Tensor
    v_max: torch.Tensor
    ref_sum: torch.Tensor
    overflow: torch.Tensor
    policy_dense: torch.Tensor
    dw_l1: torch.Tensor
    dw_sq: torch.Tensor
    # The ``(9, *batch)`` int32 buffer the fields view, in ``FIELDS`` order,
    # or None for separate tensors (what ``accumulate`` returns).
    buf: Optional[torch.Tensor] = dataclasses.field(default=None, repr=False, compare=False)

    @staticmethod
    def of_buffer(buf: torch.Tensor) -> "TickTelemetry":
        """The nine accumulators as views of a ``(9, *batch)`` int32 buffer."""
        rows = buf.unbind(0)
        return TickTelemetry(buf=buf, **{
            f: t if f in INT_FIELDS else t.view(torch.float32) for f, t in zip(FIELDS, rows)})

    @staticmethod
    def zeros(batch_shape=(), device=None) -> "TickTelemetry":
        """Zeroed accumulators of ``batch_shape`` in one buffer (``device=None``:
        the card)."""
        from repro_torch import device as _device

        dev = _device.resolve(device)
        shape = (len(FIELDS),) + tuple(batch_shape)
        return TickTelemetry.of_buffer(torch.zeros(shape, dtype=torch.int32, device=dev))

    def clone(self) -> "TickTelemetry":
        """A copy in one buffer of its own."""
        if self.buf is not None:
            return TickTelemetry.of_buffer(self.buf.clone())
        return TickTelemetry.zeros(self.ticks.shape, self.ticks.device).copy_(self)

    def copy_(self, other: "TickTelemetry") -> "TickTelemetry":
        """Write ``other``'s values into these buffers; returns self."""
        for f in FIELDS:
            getattr(self, f).copy_(getattr(other, f))
        return self

    def accumulate(self, lif_state, *, overflow_inc: Optional[torch.Tensor] = None,
                   policy_inc: Optional[torch.Tensor] = None,
                   dw_stats: Optional[torch.Tensor] = None) -> "TickTelemetry":
        """Fold one tick in: the plain twin of the telemetry kernel.

        Args:
          lif_state: the post-tick :class:`~repro_torch.core.lif.LIFState`.
          overflow_inc, policy_inc: optional int increments, batch-shaped or
            per network (see :func:`per_row`).
          dw_stats: optional ``(G, P, 2)`` partial sums of ``|dw|`` and
            ``dw^2`` of the committed weight update, per weight group (the
            slot axis, or one shared matrix); the ``P`` partials of a group
            add in order and the total goes to every row of the group.
        """
        y, v, r = lif_state.y, lif_state.v, lif_state.r
        # Divide by a tensor on y's device: PyTorch's CUDA division by a
        # Python number multiplies by its reciprocal, which rounds otherwise.
        n = torch.full((), float(y.shape[-1]), dtype=torch.float32, device=y.device)
        shape = tuple(self.ticks.shape)
        s_y = y.to(torch.float32).sum(-1)
        vf = v.to(torch.float32)
        s_v = vf.sum(-1)
        m_v = vf.amax(-1)
        s_r = (r > 0).to(torch.float32).sum(-1)
        dw_l1, dw_sq = self.dw_l1, self.dw_sq
        if dw_stats is not None:
            sums = dw_stats.to(torch.float32).sum(-2)           # (G, 2)
            dw_l1 = dw_l1 + per_row(sums[:, 0], shape)
            dw_sq = dw_sq + per_row(sums[:, 1], shape)
        overflow, policy = self.overflow, self.policy_dense
        if overflow_inc is not None:
            overflow = overflow + per_row(overflow_inc.to(torch.int32), shape)
        if policy_inc is not None:
            policy = policy + per_row(policy_inc.to(torch.int32), shape)
        return TickTelemetry(
            ticks=self.ticks + 1,
            spikes=self.spikes + s_y,
            v_sum=self.v_sum + s_v / n,
            v_max=torch.maximum(self.v_max, m_v),
            ref_sum=self.ref_sum + s_r / n,
            overflow=overflow,
            policy_dense=policy,
            dw_l1=dw_l1,
            dw_sq=dw_sq)

    # -- host-side readout -------------------------------------------------

    def numpy(self) -> Dict[str, np.ndarray]:
        """Every field on the host, as numpy arrays (one copy of the buffer)."""
        if self.buf is None:
            return {f: getattr(self, f).detach().cpu().numpy() for f in FIELDS}
        host = self.buf.detach().cpu().numpy()
        return {f: host[i] if f in INT_FIELDS else host[i].view(np.float32)
                for i, f in enumerate(FIELDS)}

    def summary(self, n: int) -> Dict[str, float]:
        """Reduce to host floats (the one device->host hop), key for key the
        reference's.

        Args:
          n: live neuron count, for the spike-rate normalisation
            (``spikes / (ticks * n)``, mean spikes per neuron per tick).
        """
        a = self.numpy()
        ticks = float(a["ticks"].max()) if a["ticks"].size else 0.0
        spikes = float(a["spikes"].sum())
        batch = max(1, int(a["spikes"].size))
        denom = max(1.0, ticks * n * batch)
        return {
            "ticks": ticks,
            "spikes": spikes,
            "spike_rate": spikes / denom,
            "v_mean": float(a["v_sum"].mean()) / max(1.0, ticks),
            "v_max": float(a["v_max"].max()),
            "refractory_occupancy": float(a["ref_sum"].mean()) / max(1.0, ticks),
            "overflow_ticks": float(a["overflow"].sum()),
            "policy_dense_ticks": float(a["policy_dense"].sum()),
            "dw_l1": float(a["dw_l1"].sum()),
            "dw_l2": float(np.sqrt(a["dw_sq"].sum())),
        }
