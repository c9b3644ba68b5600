"""cascade-lint driver for the port: run every pass over a tree, enforce
global budgets.

Per-pass scope mirrors where each invariant lives:

- ``lock-discipline`` and ``donation``/``recompile`` run over the whole
  tree (any module may grow threads or fused calls);
- ``host-sync`` runs only over the fast path: the packages in
  ``_FASTPATH_PARTS`` (``serving/``, ``models/``, ``kernels/``,
  ``launch/``: a sharded tick's placements and gathers) plus the
  named files in ``_FASTPATH_FILES`` (``core/store.py``, the spill pool on
  the preemption path).  The JAX scope has no ``kernels/``: a JAX kernel
  wrapper is traced under ``jit`` and cannot sync, while the port's
  wrappers are eager Python on the tick's path and inside its captures.
  The rest of ``core`` is offline tooling and may sync freely.

One check is global rather than per-file: across the fast-path scope
there must be at most ONE ``sync-site`` pragma.  The invariant is "one
sync per tick", and a second sanctioned site would erode it one
annotation at a time.
"""
from __future__ import annotations

import argparse
import sys

from .base import Finding, SourceInfo, iter_python_files
from .donation import DonationPass
from .lock_discipline import LockDisciplinePass
from .sync_discipline import SyncDisciplinePass, SyncSite

ALL_PASSES = (LockDisciplinePass, SyncDisciplinePass, DonationPass)

_FASTPATH_PARTS = ("serving", "models", "kernels", "launch")
_FASTPATH_FILES = ("core/store.py",)
MAX_SYNC_SITES = 1


def _in_fastpath(path: str) -> bool:
    norm = path.replace("\\", "/")
    parts = norm.split("/")
    return (any(p in parts for p in _FASTPATH_PARTS)
            or any(norm.endswith(f) for f in _FASTPATH_FILES))


def lint_paths(paths: list[str]) -> list[Finding]:
    """Run every pass over ``paths`` (files or directories)."""
    lock_pass = LockDisciplinePass()
    sync_pass = SyncDisciplinePass()
    donation_pass = DonationPass()

    findings: list[Finding] = []
    sync_sites: list[SyncSite] = []
    for path in iter_python_files(paths):
        try:
            src = SourceInfo.parse(path)
        except SyntaxError as exc:
            findings.append(Finding(path, exc.lineno or 1, "parse",
                                    f"cannot parse: {exc.msg}"))
            continue
        findings.extend(lock_pass.run(src))
        findings.extend(donation_pass.run(src))
        if _in_fastpath(path):
            report = sync_pass.run_full(src)
            findings.extend(report.findings)
            sync_sites.extend(report.sync_sites)

    if len(sync_sites) > MAX_SYNC_SITES:
        keep = sync_sites[0]
        for extra in sync_sites[1:]:
            findings.append(Finding(
                extra.path, extra.line, "host-sync",
                f"second `sync-site` pragma ({extra.qualname}): the fast "
                f"path allows exactly one sync site and it is already "
                f"{keep.qualname} ({keep.path}:{keep.line})"))
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule))


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="cascade-lint",
        description="invariant checks of the port: lock discipline, "
                    "host-sync discipline, donation/recompile hazards")
    parser.add_argument("paths", nargs="+",
                        help="files or directories to lint")
    args = parser.parse_args(argv)

    findings = lint_paths(args.paths)
    for f in findings:
        print(f.render())
    if findings:
        print(f"cascade-lint: {len(findings)} finding(s)", file=sys.stderr)
        return 1
    print("cascade-lint: clean", file=sys.stderr)
    return 0
