"""odlint core (the port's copy): findings, annotations, module/project
model, rule runner.

Everything here is dependency-free (stdlib ``ast`` + ``tokenize`` only)
so the linter runs where neither torch nor a card is present and costs
nothing to import.

Annotation grammar (all live in comments, parsed by tokenize so they
work on any line, including continuation lines).  ``# odlint:`` and
``# odlint(torch):`` are read alike; the second spelling is for the two
annotations only this linter knows (``donates``, ``captured``), in a tree
that the JAX package's linter also reads: that linter reports every
``# odlint:`` annotation it does not know as ODL000.

  # odlint: disable=ODL001[,ODL005] -- <reason>
      Suppress findings of the listed rules on this line (or, when the
      comment is alone on a line, on the next code line).  The reason
      after ``--`` is REQUIRED: a suppression without one is itself a
      finding (ODL000) — zero bare suppressions, ever.

  # odlint: guarded-by(<lock>)
      Declares that the attribute assigned on this line is protected by
      ``self.<lock>`` — the lock-discipline rule then checks every
      write site of that attribute.

  # odlint: holds-lock(<lock>)
      On a ``def`` line: every caller of this method already holds
      ``self.<lock>``; writes inside it count as guarded.

  # odlint: shard-local
      On a ``def`` line: this function issues shard-local (single
      device) dispatches; when called inside an active ``activate(mesh)``
      scope it must sit under ``sharding.deactivate()``.

  # odlint(torch): donates(<positions>)
      On a ``def`` line: the arguments at these positions are donated —
      their buffers may receive the result.  When the def is a factory
      (it returns a callable it defines), the positions belong to the
      callables bound from it.

  # odlint(torch): captured
      On a ``def`` line: a tick function that runs inside a CUDA graph
      capture (or is written to): a clock read or a global-RNG draw in it
      runs once, at capture.
"""

from __future__ import annotations

import ast
import io
import json
import re
import tokenize
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable, Optional

# ---------------------------------------------------------------------------
# Findings
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Finding:
    """One lint finding, pointing at a source line.

    ``fingerprint`` deliberately omits the line number so baselines
    survive unrelated edits above the finding.
    """

    rule: str
    path: str
    line: int
    message: str
    hint: str = ""

    def format_text(self) -> str:
        s = f"{self.path}:{self.line} {self.rule} {self.message}"
        if self.hint:
            s += f"  [fix: {self.hint}]"
        return s

    @property
    def fingerprint(self) -> str:
        return f"{self.rule}:{self.path}:{self.message}"

    def to_json(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "message": self.message,
            "hint": self.hint,
            "fingerprint": self.fingerprint,
        }


# ---------------------------------------------------------------------------
# Comment annotations
# ---------------------------------------------------------------------------

_ODLINT_RE = re.compile(r"#\s*odlint(?:\(torch\))?:\s*(.+?)\s*$")
_DISABLE_RE = re.compile(r"disable=([A-Z0-9,\s]+?)(?:\s*--\s*(.*))?$")
_GUARDED_RE = re.compile(r"guarded-by\(\s*([A-Za-z_][A-Za-z0-9_]*)\s*\)")
_HOLDS_RE = re.compile(r"holds-lock\(\s*([A-Za-z_][A-Za-z0-9_]*)\s*\)")
_SHARD_LOCAL_RE = re.compile(r"shard-local\b")
_DONATES_RE = re.compile(r"^donates\(\s*(\d+(?:\s*,\s*\d+)*)\s*\)$")
_CAPTURED_RE = re.compile(r"^captured$")


@dataclass
class Annotation:
    """A parsed ``# odlint:`` comment at a specific source line."""

    line: int
    kind: str  # "disable" | "guarded-by" | "holds-lock" | "shard-local" | "donates" | "captured"
    rules: tuple = ()  # for disable
    positions: tuple = ()  # for donates
    reason: str = ""  # for disable
    lock: str = ""  # for guarded-by / holds-lock
    standalone: bool = False  # comment is alone on its line


def _parse_annotations(source: str, path: str) -> tuple:
    """Extract odlint annotations + raw comment map via tokenize.

    Returns (annotations, findings) — a malformed annotation is a
    finding (ODL000), never silently ignored.
    """
    annotations: list[Annotation] = []
    findings: list[Finding] = []
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(source).readline))
    except (tokenize.TokenError, IndentationError):  # pragma: no cover
        return [], []
    # A comment token is "standalone" when nothing but indentation
    # precedes it on its line.
    lines = source.splitlines()
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        m = _ODLINT_RE.search(tok.string)
        if not m:
            continue
        body = m.group(1)
        lineno = tok.start[0]
        text_before = lines[lineno - 1][: tok.start[1]] if lineno <= len(lines) else ""
        standalone = not text_before.strip()
        dm = _DISABLE_RE.match(body)
        if dm:
            rules = tuple(r.strip() for r in dm.group(1).split(",") if r.strip())
            reason = (dm.group(2) or "").strip()
            annotations.append(
                Annotation(
                    line=lineno,
                    kind="disable",
                    rules=rules,
                    reason=reason,
                    standalone=standalone,
                )
            )
            if not reason:
                findings.append(
                    Finding(
                        rule="ODL000",
                        path=path,
                        line=lineno,
                        message=(
                            "bare suppression: 'odlint: disable' requires a "
                            "reason after ' -- '"
                        ),
                        hint="append ' -- <why this is safe>' to the comment",
                    )
                )
            continue
        gm = _GUARDED_RE.search(body)
        if gm:
            annotations.append(
                Annotation(line=lineno, kind="guarded-by", lock=gm.group(1),
                           standalone=standalone)
            )
            continue
        hm = _HOLDS_RE.search(body)
        if hm:
            annotations.append(
                Annotation(line=lineno, kind="holds-lock", lock=hm.group(1),
                           standalone=standalone)
            )
            continue
        if _SHARD_LOCAL_RE.search(body):
            annotations.append(
                Annotation(line=lineno, kind="shard-local", standalone=standalone)
            )
            continue
        dn = _DONATES_RE.match(body)
        if dn:
            positions = tuple(int(p) for p in dn.group(1).split(","))
            annotations.append(
                Annotation(line=lineno, kind="donates", positions=positions,
                           standalone=standalone)
            )
            continue
        if _CAPTURED_RE.match(body):
            annotations.append(
                Annotation(line=lineno, kind="captured", standalone=standalone)
            )
            continue
        findings.append(
            Finding(
                rule="ODL000",
                path=path,
                line=lineno,
                message=f"unrecognized odlint annotation: {body!r}",
                hint="see src/repro_torch/analysis/README.md for the grammar",
            )
        )
    return annotations, findings


# ---------------------------------------------------------------------------
# Module / Project
# ---------------------------------------------------------------------------


@dataclass
class Module:
    """One parsed source file plus its odlint annotations."""

    path: str  # as given on the command line (relative ok)
    name: str  # dotted module name, e.g. "repro_torch.engine.stream"
    source: str
    tree: ast.Module
    annotations: list = field(default_factory=list)
    parse_findings: list = field(default_factory=list)

    @classmethod
    def load(cls, path: Path, root: Optional[Path] = None) -> "Module":
        source = path.read_text()
        tree = ast.parse(source, filename=str(path))
        rel = path
        if root is not None:
            try:
                rel = path.relative_to(root)
            except ValueError:
                rel = path
        parts = list(rel.with_suffix("").parts)
        # Strip leading src/-style dirs so names read repro_torch.engine.stream
        while parts and parts[0] in ("src", "."):
            parts.pop(0)
        name = ".".join(parts)
        annotations, findings = _parse_annotations(source, str(path))
        return cls(
            path=str(path),
            name=name,
            source=source,
            tree=tree,
            annotations=annotations,
            parse_findings=findings,
        )

    # -- annotation queries -------------------------------------------------

    def disables_for_line(self, line: int) -> list:
        """Disable annotations covering ``line``.

        A disable comment covers its own line, and — when it stands
        alone on a line — the next code line below it.
        """
        out = []
        for a in self.annotations:
            if a.kind != "disable":
                continue
            if a.line == line:
                out.append(a)
            elif a.standalone and line > a.line and self._next_code_line(a.line) == line:
                out.append(a)
        return out

    def _next_code_line(self, after: int) -> int:
        lines = self.source.splitlines()
        for i in range(after, len(lines)):
            stripped = lines[i].strip()
            if stripped and not stripped.startswith("#"):
                return i + 1
        return -1

    def annotations_on(self, line: int, kind: str) -> list:
        return [a for a in self.annotations if a.kind == kind and a.line == line]

    def annotation_in_range(self, lo: int, hi: int, kind: str) -> list:
        return [a for a in self.annotations if a.kind == kind and lo <= a.line <= hi]


@dataclass
class Project:
    """All modules under analysis; rules use it for cross-file checks."""

    modules: dict = field(default_factory=dict)  # name -> Module

    @classmethod
    def load(cls, paths: Iterable[Path], root: Optional[Path] = None) -> "Project":
        proj = cls()
        for p in sorted(set(paths)):
            mod = Module.load(p, root=root)
            proj.modules[mod.name] = mod
        return proj

    def find(self, suffix: str) -> Optional[Module]:
        """Find a module whose dotted name ends with ``suffix``.

        Matching is by whole dotted segments ("engine.rpc" matches
        "repro_torch.engine.rpc" but not "repro_torch.engine.grpc"), so rules work
        both on the real tree and on mutation-test temp copies whose
        top-level package name differs.
        """
        want = suffix.split(".")
        for name, mod in self.modules.items():
            if name.split(".")[-len(want):] == want:
                return mod
        return None


def collect_files(paths: Iterable[str]) -> list:
    """Expand files/dirs into a sorted list of .py files."""
    out = []
    for p in paths:
        path = Path(p)
        if path.is_dir():
            out.extend(sorted(path.rglob("*.py")))
        elif path.suffix == ".py":
            out.append(path)
    return out


# ---------------------------------------------------------------------------
# Rules
# ---------------------------------------------------------------------------


class Rule:
    """Base class: subclass, set ``rule_id``/``title``, implement a hook.

    ``check_module`` runs once per module; ``check_project`` once per
    run (for cross-file rules).  Either may yield/return Findings.
    """

    rule_id: str = "ODL???"
    title: str = ""
    rationale: str = ""  # one-liner pointing at the motivating bug/PR

    def check_module(self, module: Module, project: Project) -> Iterable[Finding]:
        return ()

    def check_project(self, project: Project) -> Iterable[Finding]:
        return ()


def run_rules(
    project: Project,
    rules: Iterable[Rule],
    with_suppression_findings: bool = True,
) -> list:
    """Run rules over a project, honoring per-line suppressions.

    Returns the surviving findings sorted by (path, line, rule).
    ODL000 findings (bare/malformed suppressions) are appended from the
    annotation parse and are themselves unsuppressable.
    """
    raw: list[Finding] = []
    rules = list(rules)
    for rule in rules:
        for mod in project.modules.values():
            raw.extend(rule.check_module(mod, project))
        raw.extend(rule.check_project(project))

    kept: list[Finding] = []
    for f in raw:
        mod = _module_for_path(project, f.path)
        if mod is not None and any(
            f.rule in d.rules and d.reason
            for d in mod.disables_for_line(f.line)
        ):
            continue
        kept.append(f)

    if with_suppression_findings:
        for mod in project.modules.values():
            kept.extend(mod.parse_findings)
    kept.sort(key=lambda f: (f.path, f.line, f.rule))
    return kept


def _module_for_path(project: Project, path: str) -> Optional[Module]:
    for mod in project.modules.values():
        if mod.path == path:
            return mod
    return None


# ---------------------------------------------------------------------------
# Baseline + reports
# ---------------------------------------------------------------------------


def load_baseline(path: Path) -> set:
    if not path.exists():
        return set()
    doc = json.loads(path.read_text() or "{}")
    return set(doc.get("fingerprints", []))


def write_baseline(path: Path, findings: Iterable[Finding]) -> None:
    doc = {
        "comment": (
            "odlint baseline: fingerprints of accepted pre-existing findings. "
            "New findings not listed here fail CI."
        ),
        "fingerprints": sorted({f.fingerprint for f in findings}),
    }
    path.write_text(json.dumps(doc, indent=2) + "\n")


def apply_baseline(findings: Iterable[Finding], baseline: set) -> list:
    return [f for f in findings if f.fingerprint not in baseline]


def report_json(findings: Iterable[Finding], rules: Iterable[Rule]) -> str:
    doc = {
        "tool": "odlint",
        "rules": [
            {"id": r.rule_id, "title": r.title, "rationale": r.rationale}
            for r in rules
        ],
        "findings": [f.to_json() for f in findings],
        "count": len(list(findings)),
    }
    # recompute count defensively (findings may be a generator)
    doc["count"] = len(doc["findings"])
    return json.dumps(doc, indent=2)


def report_text(findings: Iterable[Finding]) -> str:
    findings = list(findings)
    if not findings:
        return "odlint: clean (0 findings)"
    lines = [f.format_text() for f in findings]
    lines.append(f"odlint: {len(findings)} finding(s)")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Small AST helpers shared by rules
# ---------------------------------------------------------------------------


def dotted(node: ast.AST) -> str:
    """Render Name/Attribute chains as 'a.b.c' ('' when not a chain)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def call_name(node: ast.Call) -> str:
    return dotted(node.func)


def str_const(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None
