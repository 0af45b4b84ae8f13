"""PyTorch + CUDA counterpart of the ``repro`` package.

The module tree mirrors ``src/repro/`` one to one, so each module here
names its reference. It imports ``torch`` and numpy only, never ``jax``
and never ``repro``: the host-side helpers it needs are copied in.

Entry points that create tensors take ``device=``; ``None`` means the
CUDA card, and a missing card raises instead of falling back to the CPU
(see :func:`repro_torch.device.resolve`). The hand-written Hopper
kernels live under ``csrc/`` and are built at first use by
:mod:`repro_torch.kernels._build`.
"""
