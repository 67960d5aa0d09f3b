"""Finding reporters: text (human / pre-commit), json (scripts,
baselines), sarif (code-scanning UIs — GitHub, VS Code SARIF viewer)."""
from __future__ import annotations

import json
from typing import Dict, List

from .core import Finding, all_rules


def _summary(findings: List[Finding]) -> Dict:
    active = [f for f in findings if not f.suppressed]
    by_rule: Dict[str, int] = {}
    for f in active:
        by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
    return {"total": len(active),
            "suppressed": sum(1 for f in findings if f.suppressed),
            "by_rule": dict(sorted(by_rule.items()))}


def format_text(findings: List[Finding],
                show_suppressed: bool = False) -> str:
    rules = all_rules()
    out = []
    for f in findings:
        if f.suppressed and not show_suppressed:
            continue
        tag = " (suppressed)" if f.suppressed else ""
        name = rules[f.rule].name if f.rule in rules else "parse-error"
        out.append(f"{f.path}:{f.line}:{f.col + 1}: {f.rule} "
                   f"{f.message} [{name}]{tag}")
    s = _summary(findings)
    out.append(f"ut-lint: {s['total']} finding(s)"
               + (f", {s['suppressed']} suppressed"
                  if s["suppressed"] else ""))
    return "\n".join(out)


def format_json(findings: List[Finding],
                show_suppressed: bool = False) -> str:
    rows = [f.to_dict() for f in findings
            if show_suppressed or not f.suppressed]
    return json.dumps({"tool": "ut-lint", "findings": rows,
                       "summary": _summary(findings)}, indent=1)


def format_sarif(findings: List[Finding]) -> str:
    rules = all_rules()
    rule_meta = [{
        "id": rid,
        "name": r.name,
        "shortDescription": {"text": r.short},
        "fullDescription": {"text": r.why},
        "helpUri": "docs/LINT.md",
    } for rid, r in sorted(rules.items())]
    results = [{
        "ruleId": f.rule,
        "level": "warning" if f.suppressed else "error",
        "message": {"text": f.message},
        "suppressions": ([{"kind": "inSource"}] if f.suppressed else []),
        "locations": [{
            "physicalLocation": {
                "artifactLocation": {"uri": f.path.replace("\\", "/")},
                "region": {"startLine": f.line,
                           "startColumn": f.col + 1},
            },
        }],
        "partialFingerprints": {"utLint/v1": f.fingerprint()},
    } for f in findings]
    doc = {
        "$schema": "https://json.schemastore.org/sarif-2.1.0.json",
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "ut-lint",
                "informationUri":
                    "https://github.com/cornell-zhang/uptune",
                "rules": rule_meta,
            }},
            "results": results,
        }],
    }
    return json.dumps(doc, indent=1)
