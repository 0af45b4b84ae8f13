"""repro_torch.analysis -- the static analysis gate of the port.

Counterpart of ``repro.analysis``. Records the op trace of every shipped
program (4 backends x frozen/learning x telemetry on/off, the sharded tick
loop, and the serve wave/chunk/refill programs) at a small operating point
and lints every CUDA kernel's launch descriptor at the shapes the port
launches. See ``python -m repro_torch.analysis.check --help`` for the CLI.
"""

from repro_torch.analysis.findings import ERROR, INFO, WARNING, Finding, Report

__all__ = ["Finding", "Report", "ERROR", "WARNING", "INFO"]
