"""ut-torch-lint CLI: `python -m uptune_tpu_torch.analysis [paths...]`,
the JAX package's `ut-lint` with the port's tree as its default path
(the rules, their findings and the output formats are the same).

Exit codes: 0 clean (no non-suppressed, non-baselined findings),
1 findings, 2 usage error.  `--write-baseline` grandfathers the current
findings so `scripts/lint.sh` fails only on NEW hazards.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import List, Optional, Set

from .core import Finding, all_rules, lint_paths
from .reporters import format_json, format_sarif, format_text


def _load_baseline(path: str) -> Set[str]:
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    return set(doc.get("fingerprints", []))


def _write_baseline(path: str, findings: List[Finding]) -> int:
    # E000 (parse error) is never baselined: its fingerprint is
    # location-independent, so grandfathering one syntax error would
    # exempt the file from every rule forever
    broken = sorted({f.path for f in findings if f.rule == "E000"})
    if broken:
        print(f"ut-lint: refusing to baseline unparseable file(s): "
              f"{broken} — fix the syntax errors first",
              file=sys.stderr)
    fps = sorted({f.fingerprint() for f in findings
                  if not f.suppressed and f.rule != "E000"})
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"tool": "ut-lint", "fingerprints": fps}, f, indent=1)
        f.write("\n")
    return len(fps)


def _git_changed(base: str) -> Optional[List[str]]:
    """Changed (vs ``base``) plus untracked ``*.py`` files, as
    cwd-relative paths — or None when git is unavailable or the ref is
    bad, so the caller can fall back to a full lint rather than
    silently passing an unlinted change."""
    def run(*a: str) -> "subprocess.CompletedProcess[str]":
        return subprocess.run(["git", *a], capture_output=True,
                              text=True)
    try:
        top = run("rev-parse", "--show-toplevel")
        diff = run("diff", "--name-only", "--diff-filter=d", base,
                   "--", "*.py")
        extra = run("ls-files", "--others", "--exclude-standard",
                    "--", "*.py")
    except OSError:
        return None
    if top.returncode or diff.returncode or extra.returncode:
        return None
    root = top.stdout.strip()
    names = (set(diff.stdout.splitlines())
             | set(extra.stdout.splitlines()))
    out = []
    for n in sorted(n for n in names if n.strip()):
        p = os.path.relpath(os.path.join(root, n))
        if os.path.exists(p):
            out.append(p)
    return out


def _in_scope(path: str, roots: List[str]) -> bool:
    ap = os.path.abspath(path)
    for r in roots:
        ar = os.path.abspath(r)
        if ap == ar or ap.startswith(ar + os.sep):
            return True
    return False


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="ut-torch-lint",
        description="JAX-hazard static analysis for uptune-tpu "
                    "(see docs/LINT.md)")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files/directories to lint "
                         "(default: uptune_tpu_torch/)")
    ap.add_argument("--format", choices=("text", "json", "sarif"),
                    default="text")
    ap.add_argument("--select", metavar="R001,R002",
                    help="run only these rule ids")
    ap.add_argument("--disable", metavar="R00X,...",
                    help="skip these rule ids")
    ap.add_argument("--baseline", metavar="FILE",
                    help="ignore findings whose fingerprint is in this "
                         "baseline file (grandfathered)")
    ap.add_argument("--write-baseline", metavar="FILE",
                    help="write current findings as the new baseline "
                         "and exit 0")
    ap.add_argument("--changed", action="store_true",
                    help="lint only files changed vs --changed-base "
                         "(git diff + untracked), intersected with "
                         "the requested paths; falls back to a full "
                         "lint if git fails")
    ap.add_argument("--changed-base", metavar="REF", default="HEAD",
                    help="base ref for --changed (default: HEAD)")
    ap.add_argument("--show-suppressed", action="store_true",
                    help="include '# ut-lint: disable' findings in "
                         "text/json output")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    rules = all_rules()
    if args.list_rules:
        for rid, r in sorted(rules.items()):
            print(f"{rid}  {r.name:24s} {r.short}")
        return 0

    select: Optional[Set[str]] = None
    if args.select:
        select = {r.strip() for r in args.select.split(",") if r.strip()}
        unknown = select - set(rules)
        if unknown:
            print(f"ut-lint: unknown rule id(s): {sorted(unknown)}",
                  file=sys.stderr)
            return 2
    if args.disable:
        disabled = {r.strip() for r in args.disable.split(",")
                    if r.strip()}
        unknown = disabled - set(rules)
        if unknown:
            print(f"ut-lint: unknown rule id(s): {sorted(unknown)}",
                  file=sys.stderr)
            return 2
        select = (select or set(rules)) - disabled

    paths = args.paths or ["uptune_tpu_torch"]
    missing = [p for p in paths if not os.path.exists(p)]
    if missing:
        print(f"ut-lint: no such path(s): {missing}", file=sys.stderr)
        return 2

    if args.changed:
        changed = _git_changed(args.changed_base)
        if changed is None:
            # better to lint everything than to green-light a change
            # the diff scoping could not see
            print("ut-lint: --changed: git unavailable or bad ref "
                  f"{args.changed_base!r}; falling back to full lint",
                  file=sys.stderr)
        else:
            scoped = [c for c in changed if _in_scope(c, paths)]
            print(f"ut-lint: --changed vs {args.changed_base}: "
                  f"{len(scoped)} file(s) in scope", file=sys.stderr)
            # note: package-wide rules (R101) only see the changed
            # modules under --changed; the full gate still runs them
            # repo-wide
            paths = scoped

    findings = lint_paths(paths, select)

    if args.write_baseline:
        n = _write_baseline(args.write_baseline, findings)
        print(f"ut-lint: baseline with {n} fingerprint(s) written to "
              f"{args.write_baseline}", file=sys.stderr)
        return 0

    if args.baseline and os.path.exists(args.baseline):
        grandfathered = _load_baseline(args.baseline)
        findings = [f for f in findings
                    if f.rule == "E000"       # parse errors never pass
                    or f.suppressed
                    or f.fingerprint() not in grandfathered]

    if args.format == "text":
        print(format_text(findings, args.show_suppressed))
    elif args.format == "json":
        print(format_json(findings, args.show_suppressed))
    else:
        print(format_sarif(findings))

    return 1 if any(not f.suppressed for f in findings) else 0


if __name__ == "__main__":
    sys.exit(main())
