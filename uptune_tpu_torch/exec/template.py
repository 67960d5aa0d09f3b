"""Template (non-intrusive) tuning mode: comment-directive extraction +
per-trial rendering.

The reference scans the user file for `{% x = TuneInt(2, (1, 8)) %}`
comment annotations, rewrites them into a Jinja2 `.tpl` with `${{ }}`
variable delimiters and renders one source file per trial
(`python/uptune/src/codegen.py:153-196`,
`src/template.py:13-46`).  Differences here, both deliberate:

* unnamed annotations get the *annotated variable's own name* instead of
  a random 8-char string (codegen.py:58-67) — deterministic across runs,
  so archives resume without the reference's name-reload dance
  (codegen.py:42-52);
* values are rendered with Python repr semantics via a `py` filter, so
  enum strings/bools arrive as valid source without the reference's
  bool `patch` filter hack (template.py:40-46).

Supported annotation calls: TuneInt, TuneFloat, TuneEnum, TuneBool,
TuneLog (log-scale int), TunePow2, TunePermutation.
"""
from __future__ import annotations

import json
import re
from typing import Any, Dict, List, Optional, Tuple

ANNOT_RE = re.compile(
    r"\{%\s*([A-Za-z_]\w*)\s*=\s*(Tune\w+)\s*\((.*?)\)\s*%\}")

VAR_OPEN, VAR_CLOSE = "${{", "}}"


def _rec(name, type_, default, **kw):
    rec = {"name": name, "type": type_, "default": default}
    rec.update(kw)
    return rec


def _builders(var: str):
    """Annotation-call namespace; `var` is the annotated variable name,
    used when no explicit name is given."""
    def TuneInt(default, scope, name=None):
        return _rec(name or var, "int", int(default),
                    lo=int(scope[0]), hi=int(scope[1]))

    def TuneFloat(default, scope, name=None):
        return _rec(name or var, "float", float(default),
                    lo=float(scope[0]), hi=float(scope[1]))

    def TuneEnum(default, options, name=None):
        return _rec(name or var, "enum", default, options=list(options))

    def TuneBool(default, name=None):
        return _rec(name or var, "bool", bool(default))

    def TuneLog(default, scope, name=None):
        return _rec(name or var, "log_int", int(default),
                    lo=int(scope[0]), hi=int(scope[1]))

    def TunePow2(default, scope, name=None):
        return _rec(name or var, "pow2", int(default),
                    lo=int(scope[0]), hi=int(scope[1]))

    def TunePermutation(default, name=None):
        return _rec(name or var, "perm", list(default),
                    items=list(default))

    return {k: v for k, v in locals().items() if k.startswith("Tune")}


class TemplateProgram:
    """An annotated source file compiled to (param records, Jinja tpl)."""

    def __init__(self, path: str):
        self.path = path
        with open(path) as f:
            src = f.read()
        self.records: List[Dict[str, Any]] = []
        lines = []
        seen = set()
        for lineno, line in enumerate(src.splitlines(keepends=True), 1):
            m = ANNOT_RE.search(line)
            if not m:
                lines.append(line)
                continue
            var, call, args = m.groups()
            try:
                rec = eval(f"{call}({args})", {"__builtins__": {}},
                           _builders(var))
            except Exception as e:
                raise ValueError(
                    f"{path}:{lineno}: bad annotation "
                    f"{{% {var} = {call}({args}) %}}: {e}") from e
            if rec["name"] in seen:
                raise ValueError(
                    f"{path}:{lineno}: duplicate tunable name "
                    f"{rec['name']!r}")
            seen.add(rec["name"])
            self.records.append(rec)
            # rewrite `var = <anything>  # {% ... %}` into a render slot
            assign = re.match(rf"(\s*){re.escape(var)}\s*=", line)
            if assign is None:
                raise ValueError(
                    f"{path}:{lineno}: annotation variable {var!r} does "
                    f"not match the line's assignment target")
            indent = assign.group(1)
            lines.append(
                f"{indent}{var} = {VAR_OPEN} cfg[{rec['name']!r}] | py "
                f"{VAR_CLOSE}\n")
        self.tpl = "".join(lines)

    @property
    def is_template(self) -> bool:
        return bool(self.records)

    # ------------------------------------------------------------------
    def render(self, cfg: Optional[Dict[str, Any]] = None) -> str:
        """Render source with `cfg` (defaults when None)."""
        import jinja2
        env = jinja2.Environment(
            block_start_string="{#", block_end_string="#}",
            variable_start_string=VAR_OPEN, variable_end_string=VAR_CLOSE,
            keep_trailing_newline=True)
        env.filters["py"] = repr
        full = dict(self.defaults())
        full.update(cfg or {})
        return env.from_string(self.tpl).render(cfg=full)

    def render_to(self, path: str, cfg: Optional[Dict[str, Any]] = None
                  ) -> None:
        import os
        if os.path.islink(path):
            os.unlink(path)   # replace the sandbox symlink, not its target
        with open(path, "w") as f:
            f.write(self.render(cfg))

    def defaults(self) -> Dict[str, Any]:
        return {r["name"]: r["default"] for r in self.records}

    def write_params(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump([self.records], f, indent=1)


def detect_template(path: str) -> Optional[TemplateProgram]:
    """Return a TemplateProgram if the file carries annotations."""
    tp = TemplateProgram(path)
    return tp if tp.is_template else None
