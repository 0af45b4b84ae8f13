"""The analysis gate: sweep every shipped program through every rule.

Counterpart of ``repro.analysis.check``. Usage::

    python -m repro_torch.analysis.check --all            # the full shipped matrix
    python -m repro_torch.analysis.check --list           # what --all covers
    python -m repro_torch.analysis.check --program tick/event/frozen/notelem
    python -m repro_torch.analysis.check --all --include-info --device cpu

Exit status is nonzero iff any ``error``-severity finding fired. Findings
also mirror through the shared JSON-lines event log (``REPRO_EVENT_LOG=path``,
see :mod:`repro_torch.obs.log`).

Tick and serve programs run once at ``n <= 24`` under the op recorder
(eager PyTorch has nothing to trace without running), on the card unless
``--device cpu`` is given, as every port entry point; kernels are linted from
their launch descriptors (host Python: the same on either device); statics
and planners are hashed and called twice. A full ``--all`` sweep runs in
seconds.
"""
from __future__ import annotations

import argparse
import sys
import traceback
from typing import List, Optional, Sequence

from repro_torch import device as _device
from repro_torch.analysis import launch_rules, op_rules, programs, sharding_rules, static_rules
from repro_torch.analysis.findings import ERROR, Finding, Report
from repro_torch.analysis.programs import Program

STATIC = ("static/plan-surface", "static/dispatch-plan")


def check_program(prog: Program, report: Report) -> None:
    """Run every applicable rule family on one program."""
    report.mark_checked(prog.name)
    if prog.run is not None:
        records = op_rules.record(prog.run)
        report.extend(op_rules.check_hot_loop_purity(records, prog.name))
        report.extend(op_rules.check_dtype_discipline(records, prog.name))
        report.extend(op_rules.check_hoist(records, prog.name, n=prog.n, expect=prog.hoist))
        report.extend(sharding_rules.check_no_w_gather_in_loop(
            records, prog.name, n=prog.n, n_devices=max(1, prog.sharded)))
        if prog.sharded:
            report.extend(sharding_rules.check_one_collective_per_tick(
                records, prog.name, ticks=prog.ticks))
    if prog.options_factory is not None:
        report.extend(static_rules.check_hashable_static(
            prog.options_factory(), prog.name, name="EngineOptions"))
        report.extend(static_rules.check_hash_stability(
            prog.options_factory, prog.name, name="EngineOptions"))
    for launch in prog.launches:
        report.extend(launch_rules.check_launch(launch, prog.name))
    if prog.k_split:
        report.extend(launch_rules.check_k_split(prog.launches, prog.name,
                                                 severity=prog.k_split))


def check_static_surface(report: Report) -> None:
    """The program-independent new-plan hazard surface: every planner and
    launch descriptor function a kernel wrapper calls, and the admission-time dispatch
    plan (which must stay UNhashable -- it carries neighbour lists)."""
    name = STATIC[0]
    report.mark_checked(name)
    for fn, args, kwargs in programs.planner_registry():
        label = getattr(fn, "__name__", repr(fn))
        report.extend(static_rules.check_planner(fn, args, kwargs, name, name=label))
    report.mark_checked(STATIC[1])
    report.extend(static_rules.check_dispatch_plan(programs.demo_dispatch_plan(), STATIC[1]))


def run(names: Optional[Sequence[str]] = None, *, include_static: bool = True,
        device=None) -> Report:
    """Build and check the named programs (default: the full registry) on
    ``device`` (None: the card). A program that fails to build or run is
    itself an error finding (``analysis.build``): a rule that cannot run must
    not pass silently."""
    dev = _device.resolve(device)
    report = Report()
    for name in (names or programs.program_names()):
        try:
            check_program(programs.build_program(name, dev), report)
        except Exception as e:  # noqa: BLE001 - reported as a finding
            report.mark_checked(name)
            report.add(Finding(
                rule="analysis.build", severity=ERROR, program=name,
                message=f"program failed to build/run: {type(e).__name__}: {e}"))
            traceback.print_exc(file=sys.stderr)
    if include_static:
        check_static_surface(report)
    return report


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.check",
        description="Static analysis gate over every shipped program of the port (op-trace "
                    "invariants + CUDA kernel launch lint).")
    ap.add_argument("--all", action="store_true",
                    help="sweep the full program registry (default when no --program is given)")
    ap.add_argument("--program", action="append", default=[], metavar="NAME",
                    help="check one program (repeatable; see --list)")
    ap.add_argument("--list", action="store_true", help="print the registry and exit")
    ap.add_argument("--include-info", action="store_true",
                    help="show info-severity findings in the table")
    ap.add_argument("--device", default=None, choices=("cpu", "cuda"),
                    help="where the tick and serve programs run (default: the card)")
    args = ap.parse_args(argv)

    if args.list:
        for name in programs.program_names() + STATIC:
            print(name)
        return 0

    names: Optional[List[str]] = args.program or None
    if names:
        known = set(programs.program_names())
        bad = [n for n in names if n not in known]
        if bad:
            ap.error(f"unknown program(s) {bad}; see --list")
    report = run(names, include_static=not names, device=args.device)
    print(report.table(include_info=args.include_info))
    report.emit_json()
    print(report.summary())
    return report.exit_code()


if __name__ == "__main__":
    sys.exit(main())
