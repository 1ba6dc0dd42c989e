"""odlint rules (the port's copy): the repo's cross-file invariants as
parse-time checks on ``src/repro_torch``.

Each rule is a ``core.Rule`` subclass with the JAX package's ID and title.
Three checks follow the port's idioms where the JAX package's follow its
own: ODL002 finds donating callables by their ``donates`` annotation (the
port has no ``jax.jit(..., donate_argnums=)``), ODL004 compares
``snapshot.py`` with the module that assigns the ``WIRE_V*`` constants,
and ODL005 (1) looks in tick functions captured into CUDA graphs (the
port's counterpart of a jitted function).  Rule catalog:
``src/repro_torch/analysis/README.md``; tests:
``tests/test_torch_odlint.py``.
"""

from __future__ import annotations

import ast
from typing import Iterable, Optional

from .core import Finding, Module, Project, Rule, call_name, dotted, str_const

# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

_LOCK_CTORS = {
    "threading.Lock",
    "threading.RLock",
    "threading.Condition",
    "lockdebug.make_lock",
    "lockdebug.make_rlock",
    "lockdebug.make_condition",
    "make_lock",
    "make_rlock",
    "make_condition",
}

def _self_attr(node: ast.AST) -> Optional[str]:
    """'attr' when node is ``self.attr``, else None."""
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _iter_classes(tree: ast.Module) -> Iterable[ast.ClassDef]:
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            yield node


def _iter_funcs(node: ast.AST) -> Iterable[ast.FunctionDef]:
    for child in ast.walk(node):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield child


def _assigned_self_attrs(stmt: ast.stmt) -> list:
    """(attr, node) pairs for every self.<attr> write in one statement.

    Covers ``self.a = ...``, ``self.a += ...``, ``self.a[k] = ...``,
    ``del self.a[k]``, and tuple targets.  Method-call mutators
    (``self.a.append(...)``) are deliberately untracked: too many false
    positives on single-threaded helper containers.
    """
    out = []

    def visit_target(t: ast.AST) -> None:
        attr = _self_attr(t)
        if attr is not None:
            out.append((attr, t))
            return
        if isinstance(t, (ast.Tuple, ast.List)):
            for el in t.elts:
                visit_target(el)
        elif isinstance(t, ast.Subscript):
            attr = _self_attr(t.value)
            if attr is not None:
                out.append((attr, t))
        elif isinstance(t, ast.Starred):
            visit_target(t.value)

    if isinstance(stmt, ast.Assign):
        for t in stmt.targets:
            visit_target(t)
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        if stmt.target is not None:
            visit_target(stmt.target)
    elif isinstance(stmt, ast.Delete):
        for t in stmt.targets:
            visit_target(t)
    return out


def _with_held_locks(with_node: ast.With) -> list:
    """Lock attrs acquired by ``with self.<lock>:`` items."""
    held = []
    for item in with_node.items:
        ctx = item.context_expr
        attr = _self_attr(ctx)
        if attr is not None:
            held.append(attr)
            continue
        # with self._cond: via a Condition is the same acquire; also
        # accept self._lock.acquire-style helpers spelled as calls
        if isinstance(ctx, ast.Call):
            attr = _self_attr(ctx.func)
            if attr is not None:
                held.append(attr)
    return held


# ---------------------------------------------------------------------------
# ODL001 — lock discipline
# ---------------------------------------------------------------------------


class LockDisciplineRule(Rule):
    """Writes to guarded attributes of threaded classes must hold the lock.

    A class is *threaded* when it owns a lock attribute (assigned from
    ``threading.Lock/RLock/Condition()`` or ``lockdebug.make_*``) and
    either spawns a ``threading.Thread`` or carries an explicit
    ``guarded-by`` annotation.  An attribute is *guarded* when at least
    one write outside ``__init__`` happens under ``with self.<lock>:``
    (inference), or when any of its writes carries
    ``# odlint: guarded-by(<lock>)``.  Every other write to that
    attribute outside ``__init__`` must then hold the same lock, be
    inside a method annotated ``# odlint: holds-lock(<lock>)``, or be
    suppressed with a reason.
    """

    rule_id = "ODL001"
    title = "unguarded write to a lock-protected attribute"
    rationale = (
        "unsynchronized socket writes from two threads once interleaved "
        "partial frames, and SpanTracer.dropped was once mutated outside "
        "its lock"
    )

    def check_module(self, module: Module, project: Project):
        for cls in _iter_classes(module.tree):
            yield from self._check_class(module, cls)

    def _check_class(self, module: Module, cls: ast.ClassDef):
        lock_attrs = self._lock_attrs(cls)
        if not lock_attrs:
            return

        # Gather every self-attr write with its context:
        # (attr, node, held_locks, func)
        writes = []
        for func in self._methods(cls):
            # the annotation may sit on the def line, anywhere in a
            # multi-line signature, or standalone directly above the def
            holds = {
                a.lock
                for a in module.annotation_in_range(
                    func.lineno - 1,
                    func.body[0].lineno if func.body else func.lineno,
                    "holds-lock",
                )
            }
            self._collect_writes(module, func, func.body, set(holds), writes)

        # Explicit guarded-by annotations on write lines
        guarded: dict[str, set] = {}
        for attr, node, held, func in writes:
            for a in module.annotations_on(node.lineno, "guarded-by"):
                guarded.setdefault(attr, set()).add(a.lock)

        # Inference: owning a lock marks the class threaded (the lock
        # exists *because* of cross-thread access — SpanTracer never
        # spawns a Thread itself yet is mutated from every session
        # thread).  An attr is guarded by the intersection of held-lock
        # sets over its non-__init__ locked writes, unless an explicit
        # annotation already names a lock.
        locked_by_attr: dict[str, list] = {}
        for attr, node, held, func in writes:
            if func.name == "__init__" or attr in lock_attrs:
                continue
            locked_by_attr.setdefault(attr, []).append(held & lock_attrs)
        for attr, heldsets in locked_by_attr.items():
            if attr in guarded:
                continue
            nonempty = [h for h in heldsets if h]
            if not nonempty:
                continue
            common = set.intersection(*nonempty)
            if common:
                guarded[attr] = common

        for attr, node, held, func in writes:
            if func.name == "__init__" or attr not in guarded:
                continue
            want = guarded[attr]
            if held & want:
                continue
            lock_name = sorted(want)[0]
            yield Finding(
                rule=self.rule_id,
                path=module.path,
                line=node.lineno,
                message=(
                    f"{cls.name}.{attr} is guarded by self.{lock_name} but "
                    f"written here without holding it"
                ),
                hint=(
                    f"wrap in 'with self.{lock_name}:' or annotate the "
                    f"enclosing def with '# odlint: holds-lock({lock_name})'"
                ),
            )

    def _methods(self, cls: ast.ClassDef) -> list:
        return [
            n for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        ]

    def _lock_attrs(self, cls: ast.ClassDef) -> set:
        attrs = set()
        for func in self._methods(cls):
            for stmt in ast.walk(func):
                if not isinstance(stmt, ast.Assign):
                    continue
                if not isinstance(stmt.value, ast.Call):
                    continue
                if call_name(stmt.value) not in _LOCK_CTORS:
                    continue
                for t in stmt.targets:
                    attr = _self_attr(t)
                    if attr is not None:
                        attrs.add(attr)
        return attrs

    def _collect_writes(self, module, func, body, held, out) -> None:
        """Walk statements tracking the set of held self-locks."""
        for stmt in body:
            if isinstance(stmt, ast.With):
                inner = set(held) | set(_with_held_locks(stmt))
                self._collect_writes(module, func, stmt.body, inner, out)
                continue
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # nested defs (thread targets): fresh lock context
                self._collect_writes(module, stmt, stmt.body, set(), out)
                continue
            for attr, node in _assigned_self_attrs(stmt):
                out.append((attr, node, set(held), func))
            # recurse into compound statements
            for field_body in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, field_body, None)
                if isinstance(sub, list) and sub:
                    self._collect_writes(module, func, sub, held, out)
            for handler in getattr(stmt, "handlers", []) or []:
                self._collect_writes(module, func, handler.body, held, out)


# ---------------------------------------------------------------------------
# ODL002 — donation safety
# ---------------------------------------------------------------------------


class DonationSafetyRule(Rule):
    """No read of a value after it was passed at a donated position.

    A donating callable is a def annotated ``# odlint: donates(<positions>)``
    (or ``# odlint(torch): donates(...)``).  When the def is a factory (it
    returns a callable it defines), the positions belong to the callables
    bound from it: inside every function, calls through a variable or
    ``self.<attr>`` bound to such a factory mark the Name / self-attr
    arguments at donated positions dead.  Otherwise calls of the def
    itself do, in any module of the project (``f(...)``, ``self.f(...)``,
    ``mod.f(...)``), its donated parameters passed by position or by
    keyword; a call passing the literal ``donate=False`` donates nothing.
    A later load of a dead name is a finding.  Reassignment (including in the same statement, the
    repo's idiom) revives it.  ``If`` branches merge dead sets by union (a
    read that is dead on any path is flagged); loops are checked one pass,
    conservatively.
    """

    rule_id = "ODL002"
    title = "use after donation to a jitted runner"
    _remote: dict = {}  # the project's direct donors, set per module checked
    rationale = (
        "a donated state's buffers receive the runner's result (the chunk "
        "runner writes the new state into them), so a later read of the "
        "passed name is silently the new state, not an error"
    )

    def check_module(self, module: Module, project: Project):
        factories, direct = self._donating_defs(module)
        self._remote = remote = self._project_direct(project)
        if not factories and not direct and not remote:
            return
        bindings = self._bindings(module.tree, factories)
        for name, nums in direct.items():
            bindings.setdefault(name, nums)
            bindings.setdefault(f"self.{name}", nums)
        for func in _iter_funcs(module.tree):
            yield from self._check_func(module, func, factories, bindings)

    # -- donating defs ------------------------------------------------------

    def _project_direct(self, project: Project) -> dict:
        """Direct (non-factory) donating defs of every module: name ->
        ({positions}, (parameter names))."""
        cached = getattr(project, "_odl002_direct", None)
        if cached is None:
            cached = {}
            for mod in project.modules.values():
                _, direct = self._donating_defs(mod)
                for func in _iter_funcs(mod.tree):
                    if func.name in direct:
                        params = tuple(a.arg for a in func.args.posonlyargs + func.args.args)
                        cached[func.name] = (direct[func.name], params)
            project._odl002_direct = cached
        return cached

    def _donating_defs(self, module: Module) -> tuple:
        """(factories, direct): def name -> set of donated positions."""
        factories, direct = {}, {}
        for func in _iter_funcs(module.tree):
            end = func.body[0].lineno if func.body else func.lineno
            marks = module.annotation_in_range(func.lineno - 1, end, "donates")
            if not marks:
                continue
            nums = {p for a in marks for p in a.positions}
            (factories if self._is_factory(func) else direct)[func.name] = nums
        return factories, direct

    @staticmethod
    def _is_factory(func) -> bool:
        """The def returns a callable it defines: a lambda, or a nested
        def by name (a lambda used inside a body does not count)."""
        nested = {n.name for stmt in func.body for n in ast.walk(stmt)
                  if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        for stmt in func.body:
            for n in ast.walk(stmt):
                if isinstance(n, ast.Return) and n.value is not None and (
                        isinstance(n.value, ast.Lambda)
                        or isinstance(n.value, ast.Name) and n.value.id in nested):
                    return True
        return False

    def _bindings(self, tree: ast.Module, factories: dict) -> dict:
        """'name' or 'self.attr' -> donated positions, from assignments."""
        out = {}
        for node in ast.walk(tree):
            if not isinstance(node, ast.Assign):
                continue
            if not isinstance(node.value, ast.Call):
                continue
            fname = call_name(node.value)
            if fname not in factories:
                continue
            for t in node.targets:
                key = self._value_key(t)
                if key:
                    out[key] = factories[fname]
        return out

    # -- per-function dataflow ----------------------------------------------

    def _value_key(self, node: ast.AST) -> str:
        if isinstance(node, ast.Name):
            return node.id
        attr = _self_attr(node)
        if attr is not None:
            return f"self.{attr}"
        return ""

    def _check_func(self, module, func, factories, bindings):
        findings: list[Finding] = []
        self._walk(module, func.body, factories, bindings, set(), findings)
        return findings

    def _walk(self, module, body, factories, bindings, dead, findings) -> None:
        """dead: set of value-keys whose buffer was donated."""
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._walk(module, stmt.body, factories, bindings, set(), findings)
                continue
            if isinstance(stmt, ast.If):
                d1 = set(dead)
                d2 = set(dead)
                self._stmt_reads(module, stmt.test, dead, findings)
                self._walk(module, stmt.body, factories, bindings, d1, findings)
                self._walk(module, stmt.orelse, factories, bindings, d2, findings)
                dead.clear()
                dead.update(d1 | d2)
                continue
            if isinstance(stmt, (ast.For, ast.While)):
                if isinstance(stmt, ast.For):
                    self._stmt_reads(module, stmt.iter, dead, findings)
                    dead.discard(self._value_key(stmt.target))
                else:
                    self._stmt_reads(module, stmt.test, dead, findings)
                self._walk(module, stmt.body, factories, bindings, dead, findings)
                self._walk(module, stmt.orelse, factories, bindings, dead, findings)
                continue
            if isinstance(stmt, (ast.With, ast.Try)):
                for field_body in ("body", "orelse", "finalbody"):
                    sub = getattr(stmt, field_body, None)
                    if isinstance(sub, list):
                        self._walk(module, sub, factories, bindings, dead, findings)
                for handler in getattr(stmt, "handlers", []) or []:
                    self._walk(module, handler.body, factories, bindings, dead,
                               findings)
                continue

            # simple statement: reads first (RHS), then donation marks,
            # then assignment targets revive.
            value = getattr(stmt, "value", None)
            donated_now = []
            if value is not None:
                for call in [n for n in ast.walk(value) if isinstance(n, ast.Call)]:
                    nums, params = self._call_donations(call, factories, bindings)
                    if not nums or self._opts_out(call):
                        continue
                    # a *args splat makes positional indices unknowable —
                    # skip rather than mis-attribute donation
                    if any(isinstance(a, ast.Starred) for a in call.args):
                        continue
                    passed = {i: a for i, a in enumerate(call.args)}
                    for kw in call.keywords:
                        if kw.arg in params:
                            passed[params.index(kw.arg)] = kw.value
                    for i in nums:
                        if i in passed:
                            key = self._value_key(passed[i])
                            if key:
                                donated_now.append((key, call))
                self._stmt_reads(module, value, dead, findings)
            for key, call in donated_now:
                dead.add(key)
            if isinstance(stmt, ast.Assign):
                for t in stmt.targets:
                    self._revive_target(t, dead)
            elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
                if isinstance(stmt, ast.AugAssign):
                    self._stmt_reads(module, stmt.target, dead, findings)
                if stmt.target is not None:
                    self._revive_target(stmt.target, dead)

    def _call_donations(self, call, factories, bindings) -> tuple:
        """(donated positions, parameter names) of a call."""
        key = ""
        if isinstance(call.func, ast.Name):
            key = call.func.id
        else:
            attr = _self_attr(call.func)
            if attr is not None:
                key = f"self.{attr}"
        if key in bindings:
            return bindings[key], ()
        if key in factories:
            return set(), ()  # calling the factory itself donates nothing
        # a direct donor of any module: ``f(...)`` or ``mod.f(...)``
        name = ""
        if isinstance(call.func, ast.Name):
            name = call.func.id
        elif isinstance(call.func, ast.Attribute) and isinstance(call.func.value, ast.Name):
            name = call.func.attr
        if name in self._remote:
            return self._remote[name]
        return set(), ()

    @staticmethod
    def _opts_out(call: ast.Call) -> bool:
        """The call passes the literal ``donate=False``."""
        return any(kw.arg == "donate" and isinstance(kw.value, ast.Constant)
                   and kw.value.value is False for kw in call.keywords)

    def _revive_target(self, t: ast.AST, dead: set) -> None:
        key = self._value_key(t)
        if key:
            dead.discard(key)
            return
        if isinstance(t, (ast.Tuple, ast.List)):
            for el in t.elts:
                self._revive_target(el, dead)
        elif isinstance(t, ast.Starred):
            self._revive_target(t.value, dead)

    def _stmt_reads(self, module, expr, dead, findings) -> None:
        if expr is None or not dead:
            return
        for node in ast.walk(expr):
            key = ""
            if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
                key = node.id
            else:
                attr = _self_attr(node)
                if attr is not None and isinstance(
                    getattr(node, "ctx", ast.Load()), ast.Load
                ):
                    key = f"self.{attr}"
            if key and key in dead:
                findings.append(
                    Finding(
                        rule=self.rule_id,
                        path=module.path,
                        line=node.lineno,
                        message=(
                            f"'{key}' is read after being passed at a donated "
                            f"position of a donating runner"
                        ),
                        hint=(
                            "rebind the result over the donated name in the "
                            "same statement, or drop donation for this arg"
                        ),
                    )
                )
                dead.discard(key)  # report each donation once


# ---------------------------------------------------------------------------
# ODL003 — counter-mirror completeness
# ---------------------------------------------------------------------------


class CounterMirrorRule(Rule):
    """StreamStats fields ⊆ telemetry mirror ∪ exclusions; identity keys exist.

    Statically re-derives the runtime growth guard: every field of
    ``StreamStats`` must appear in ``telemetry.STREAM_COUNTER_FIELDS``,
    ``STREAM_GAUGE_FIELDS``, or ``STREAM_MIRROR_EXCLUDED``; every name
    in those telemetry tuples must exist on ``StreamStats``; and every
    counter named in ``elastic.reconcile``'s identity key tuple must be
    a mirrored counter.
    """

    rule_id = "ODL003"
    title = "StreamStats / telemetry mirror drift"
    rationale = (
        "a runtime growth guard locks the registry view identical to "
        "StreamStats; this catches the drift at parse time"
    )

    def check_project(self, project: Project):
        stream = project.find("engine.stream")
        telem = project.find("runtime.telemetry")
        if stream is None or telem is None:
            return

        fields = self._dataclass_fields(stream, "StreamStats")
        if fields is None:
            return
        mirrors = {}
        for name in ("STREAM_COUNTER_FIELDS", "STREAM_GAUGE_FIELDS",
                     "STREAM_MIRROR_EXCLUDED"):
            val = self._str_tuple(telem, name)
            if val is None:
                yield Finding(
                    rule=self.rule_id,
                    path=telem.path,
                    line=1,
                    message=f"telemetry is missing the {name} tuple",
                    hint="define it next to sync_stream_stats",
                )
                val = ((), 1)
            mirrors[name] = val
        mirrored = set()
        for name, (vals, line) in mirrors.items():
            for v in vals:
                if v not in fields:
                    yield Finding(
                        rule=self.rule_id,
                        path=telem.path,
                        line=line,
                        message=(
                            f"{name} names '{v}' which is not a StreamStats "
                            f"field"
                        ),
                        hint="remove it or add the field to StreamStats",
                    )
            mirrored |= set(vals)
        for fname, fline in fields.items():
            if fname not in mirrored:
                yield Finding(
                    rule=self.rule_id,
                    path=stream.path,
                    line=fline,
                    message=(
                        f"StreamStats.{fname} is neither mirrored "
                        f"(STREAM_COUNTER_FIELDS/STREAM_GAUGE_FIELDS) nor "
                        f"excluded (STREAM_MIRROR_EXCLUDED) in telemetry"
                    ),
                    hint="add it to the mirror or the explicit exclusion set",
                )

        # identity keys in elastic.reconcile must be mirrored counters
        elastic = project.find("runtime.elastic")
        counters = set(mirrors["STREAM_COUNTER_FIELDS"][0])
        if elastic is not None and counters:
            for node in ast.walk(elastic.tree):
                if not (isinstance(node, ast.FunctionDef)
                        and node.name == "reconcile"):
                    continue
                for sub in ast.walk(node):
                    if not isinstance(sub, ast.Assign):
                        continue
                    if not any(
                        isinstance(t, ast.Name) and t.id == "keys"
                        for t in sub.targets
                    ):
                        continue
                    if not isinstance(sub.value, ast.Tuple):
                        continue
                    for el in sub.value.elts:
                        s = str_const(el)
                        if s is not None and s not in counters:
                            yield Finding(
                                rule=self.rule_id,
                                path=elastic.path,
                                line=el.lineno,
                                message=(
                                    f"reconcile() keys names '{s}' which is "
                                    f"not a mirrored StreamStats counter"
                                ),
                                hint=(
                                    "fix the key or add the counter to "
                                    "STREAM_COUNTER_FIELDS"
                                ),
                            )

    def _dataclass_fields(self, module: Module, cls_name: str) -> Optional[dict]:
        for cls in _iter_classes(module.tree):
            if cls.name != cls_name:
                continue
            fields = {}
            for stmt in cls.body:
                if isinstance(stmt, ast.AnnAssign) and isinstance(
                    stmt.target, ast.Name
                ):
                    fields[stmt.target.id] = stmt.lineno
            return fields
        return None

    def _str_tuple(self, module: Module, name: str):
        """((values...), lineno) for a module-level tuple of str consts."""
        for stmt in module.tree.body:
            if not isinstance(stmt, ast.Assign):
                continue
            if not any(
                isinstance(t, ast.Name) and t.id == name for t in stmt.targets
            ):
                continue
            vals = []
            value = stmt.value
            if isinstance(value, ast.Call) and call_name(value) in (
                "frozenset", "set", "tuple"
            ):
                value = value.args[0] if value.args else ast.Tuple(elts=[])
            if isinstance(value, (ast.Tuple, ast.List, ast.Set)):
                for el in value.elts:
                    s = str_const(el)
                    if s is not None:
                        vals.append(s)
            return tuple(vals), stmt.lineno
        return None


# ---------------------------------------------------------------------------
# ODL004 — wire-protocol exhaustiveness
# ---------------------------------------------------------------------------


class WireExhaustivenessRule(Rule):
    """Every sent control 'kind' has a worker handler branch, and back.

    Sent kinds: string literals under a ``"kind"`` key in dict literals
    passed to ``self._request(...)`` / ``_encode_frame(...)`` in
    ``runtime/elastic.py``.  Handled kinds: string literals compared
    against (a variable assigned from) ``header.get("kind")`` in
    ``runtime/worker.py``.  Also: ``snapshot.py`` must reference the frame
    version symbols (``wire.WIRE_V2``) of the module that assigns the
    ``WIRE_V*`` constants (``engine/wire.py`` in the port, ``rpc.py`` in
    the JAX package), and must not re-declare them.
    """

    rule_id = "ODL004"
    title = "wire 'kind' without a matching handler (or version drift)"
    rationale = (
        "the control protocol grows a kind per feature (metrics came "
        "later); a sent-but-unhandled kind fails at runtime on the "
        "first scrape"
    )

    def check_project(self, project: Project):
        elastic = project.find("runtime.elastic")
        worker = project.find("runtime.worker")
        if elastic is not None and worker is not None:
            sent = self._sent_kinds(elastic)
            handled = self._handled_kinds(worker)
            for kind, line in sorted(sent.items()):
                if kind not in handled:
                    yield Finding(
                        rule=self.rule_id,
                        path=elastic.path,
                        line=line,
                        message=(
                            f"control kind '{kind}' is sent by WorkerClient "
                            f"but has no handler branch in runtime/worker.py"
                        ),
                        hint="add a branch on header.get('kind') in Worker._handle",
                    )
            for kind, line in sorted(handled.items()):
                if kind not in sent:
                    yield Finding(
                        rule=self.rule_id,
                        path=worker.path,
                        line=line,
                        message=(
                            f"worker handles control kind '{kind}' that no "
                            f"WorkerClient call site sends (dead protocol arm)"
                        ),
                        hint="remove the branch or add the client sender",
                    )

        snapshot = project.find("engine.snapshot")
        if snapshot is not None:
            yield from self._check_version_bytes(snapshot, project)

    def _sent_kinds(self, module: Module) -> dict:
        out = {}
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            fname = dotted(node.func)
            if not (fname.endswith("._request") or fname.endswith("_encode_frame")
                    or fname == "_encode_frame"):
                continue
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                if not isinstance(arg, ast.Dict):
                    continue
                for k, v in zip(arg.keys, arg.values):
                    if k is not None and str_const(k) == "kind":
                        s = str_const(v)
                        if s is not None:
                            out.setdefault(s, v.lineno)
        return out

    def _handled_kinds(self, module: Module) -> dict:
        # variables assigned from <x>.get("kind") — only those; a loop
        # variable merely *named* "kind" (e.g. the frame-format tag from
        # rpc._iter_wire) is not a control kind
        kind_vars = set()
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
                call = node.value
                if (
                    dotted(call.func).endswith(".get")
                    and call.args
                    and str_const(call.args[0]) == "kind"
                ):
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            kind_vars.add(t.id)
        out = {}
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Compare):
                operands = [node.left] + list(node.comparators)
                refs_kind = any(
                    (isinstance(o, ast.Name) and o.id in kind_vars)
                    or (
                        isinstance(o, ast.Call)
                        and dotted(o.func).endswith(".get")
                        and o.args
                        and str_const(o.args[0]) == "kind"
                    )
                    for o in operands
                )
                if not refs_kind:
                    continue
                for o in operands:
                    s = str_const(o)
                    if s is not None:
                        out.setdefault(s, o.lineno)
                    elif isinstance(o, (ast.Tuple, ast.List, ast.Set)):
                        for el in o.elts:
                            s = str_const(el)
                            if s is not None:
                                out.setdefault(s, el.lineno)
        return out

    @staticmethod
    def _wire_versions(module: Module) -> dict:
        """Module-level ``WIRE_V* = <constant>`` assignments: name -> line."""
        out = {}
        for stmt in module.tree.body:
            if isinstance(stmt, ast.Assign) and isinstance(stmt.value, ast.Constant):
                for t in stmt.targets:
                    if isinstance(t, ast.Name) and t.id.startswith("WIRE_V"):
                        out[t.id] = stmt.lineno
        return out

    def _check_version_bytes(self, snapshot: Module, project: Project):
        versions = {}
        for mod in project.modules.values():
            if mod is not snapshot:
                versions.update(self._wire_versions(mod))
        if not versions:
            return
        # snapshot.py must not re-declare a WIRE_V* constant of its own
        for name, line in sorted(self._wire_versions(snapshot).items()):
            yield Finding(
                rule=self.rule_id,
                path=snapshot.path,
                line=line,
                message=(
                    f"snapshot re-declares {name}, which the wire module "
                    f"already assigns"
                ),
                hint="import the constant from engine.wire instead",
            )
        # snapshot's frame-magic check must reference the wire's symbol
        uses_symbol = any(
            isinstance(n, (ast.Attribute, ast.Name))
            and dotted(n).split(".")[-1] in versions
            and not isinstance(getattr(n, "ctx", None), ast.Store)
            for n in ast.walk(snapshot.tree)
        )
        if not uses_symbol:
            yield Finding(
                rule=self.rule_id,
                path=snapshot.path,
                line=1,
                message=(
                    "snapshot never references the wire's WIRE_V* symbols — "
                    "its frame magic check can silently drift from the wire format"
                ),
                hint="compare against wire.WIRE_V2 (symbol, not literal)",
            )


# ---------------------------------------------------------------------------
# ODL005 — forbidden APIs
# ---------------------------------------------------------------------------


class ForbiddenApiRule(Rule):
    """Wall-clock/global RNG in captured tick functions, bare except on
    socket paths, print() in the engine.

    * ``time.time``/``time.perf_counter``/``time.monotonic``/
      ``np.random.*``/``numpy.random.*`` calls inside code captured into a
      CUDA graph: a def passed as the tick function to ``graphs.run`` or
      ``graphs.TickGraph`` (resolved by name in its module, as the JAX
      package's rule resolves ``jax.jit(f)``), a def annotated
      ``# odlint: captured``, or a ``with torch.cuda.graph(...)`` body —
      run once at capture, frozen in every replay.
    * ``except:`` (bare) in modules that import ``socket`` — swallows
      KeyboardInterrupt/SystemExit on serving threads.
    * ``print(...)`` anywhere under ``engine/`` — the engine is a library;
      humans read telemetry, not stdout.
    """

    rule_id = "ODL005"
    title = "forbidden API on a hot/serving path"
    rationale = (
        "a clock read or a global-RNG draw in a tick function runs once, "
        "when the CUDA graph is captured, and every replay reuses that "
        "value; bare except on the socket threads ate shutdown signals "
        "during debugging"
    )

    _CLOCKS = {"time.time", "time.perf_counter", "time.monotonic"}
    # Where a capturing call takes its tick function: (positional index, keyword).
    _CAPTURERS = {"graphs.run": (3, "fn"), "graphs.TickGraph": (1, "fn"),
                  "TickGraph": (1, "fn")}

    def _forbidden(self, node: ast.AST) -> str:
        if not isinstance(node, ast.Call):
            return ""
        fname = call_name(node)
        if fname in self._CLOCKS or fname.startswith(("np.random.", "numpy.random.")):
            return fname
        return ""

    def check_module(self, module: Module, project: Project):
        for func in self._captured_funcs(module):
            for node in ast.walk(func):
                fname = self._forbidden(node)
                if fname:
                    yield Finding(
                        rule=self.rule_id,
                        path=module.path,
                        line=node.lineno,
                        message=(
                            f"'{fname}' inside captured '{func.name}' is frozen "
                            f"at capture time"
                        ),
                        hint="pass the value in as an input tensor of the tick",
                    )
        for with_node in self._graph_captures(module.tree):
            for stmt in with_node.body:
                for node in ast.walk(stmt):
                    fname = self._forbidden(node)
                    if fname:
                        yield Finding(
                            rule=self.rule_id,
                            path=module.path,
                            line=node.lineno,
                            message=(
                                f"'{fname}' under torch.cuda.graph(...) is frozen "
                                f"at capture time"
                            ),
                            hint="read it outside the capture and pass it in",
                        )
        if self._imports(module.tree, "socket"):
            for node in ast.walk(module.tree):
                if isinstance(node, ast.ExceptHandler) and node.type is None:
                    yield Finding(
                        rule=self.rule_id,
                        path=module.path,
                        line=node.lineno,
                        message=(
                            "bare 'except:' in a socket-handling module "
                            "swallows KeyboardInterrupt/SystemExit"
                        ),
                        hint="catch Exception (or OSError) instead",
                    )
        if "/engine/" in module.path.replace("\\", "/") or (
            ".engine." in f".{module.name}."
        ):
            for node in ast.walk(module.tree):
                if (
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id == "print"
                ):
                    yield Finding(
                        rule=self.rule_id,
                        path=module.path,
                        line=node.lineno,
                        message="print() in src/repro/engine/ (library code)",
                        hint="use telemetry spans/counters or return the value",
                    )

    def _captured_funcs(self, module: Module) -> list:
        """Defs passed by name as a capturing call's tick function, and
        defs annotated ``captured``."""
        names = set()
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            where = self._CAPTURERS.get(call_name(node))
            if where is None:
                continue
            index, keyword = where
            args = [a for a in node.args[index:index + 1]]
            args += [kw.value for kw in node.keywords if kw.arg == keyword]
            names.update(a.id for a in args if isinstance(a, ast.Name))
        out = []
        for func in _iter_funcs(module.tree):
            end = func.body[0].lineno if func.body else func.lineno
            if func.name in names or module.annotation_in_range(func.lineno - 1, end,
                                                                "captured"):
                out.append(func)
        return out

    def _graph_captures(self, tree: ast.Module) -> list:
        """``with torch.cuda.graph(...)`` statements."""
        return [
            node for node in ast.walk(tree)
            if isinstance(node, ast.With)
            and any(isinstance(item.context_expr, ast.Call)
                    and call_name(item.context_expr) in ("torch.cuda.graph", "cuda.graph")
                    for item in node.items)
        ]

    def _imports(self, tree: ast.Module, name: str) -> bool:
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                if any(alias.name == name for alias in node.names):
                    return True
            elif isinstance(node, ast.ImportFrom):
                if node.module == name:
                    return True
        return False


# ---------------------------------------------------------------------------
# ODL006 — sharding scope
# ---------------------------------------------------------------------------


class ShardingScopeRule(Rule):
    """Shard-local calls inside ``activate(mesh)`` need ``deactivate()``.

    Functions annotated ``# odlint: shard-local`` on their ``def`` line
    issue single-device dispatches.  Any call to one of them that sits
    lexically inside a ``with sharding.activate(...)`` / ``with
    activate(...)`` block must be nested under a ``with
    sharding.deactivate():`` — otherwise the active mesh's fleet axis
    reaches the shard-local code (``sharding.fleet_axis_size()`` and
    ``fleet_devices()`` answer for the whole mesh there).
    """

    rule_id = "ODL006"
    title = "shard-local dispatch under an active mesh without deactivate()"
    rationale = (
        "under sharding.activate a shard-local call sees fleet_axis_size() "
        "> 1 (distributed/sharding.py), so a shard's session or block splits "
        "its rows again or sizes its padding for the whole mesh"
    )

    def check_module(self, module: Module, project: Project):
        shard_local = self._shard_local_names(project)
        if not shard_local:
            return
        yield from self._scan(module, module.tree.body, shard_local,
                              in_activate=False, in_deactivate=False)

    def _shard_local_names(self, project: Project) -> set:
        # cached per project — this scans every function of every module
        cached = getattr(project, "_odl006_names", None)
        if cached is not None:
            return cached
        names = set()
        for mod in project.modules.values():
            for func in _iter_funcs(mod.tree):
                end = func.body[0].lineno if func.body else func.lineno
                if mod.annotation_in_range(func.lineno - 1, end, "shard-local"):
                    names.add(func.name)
        project._odl006_names = names
        return names

    def _with_kind(self, stmt: ast.With) -> str:
        for item in stmt.items:
            ctx = item.context_expr
            if isinstance(ctx, ast.Call):
                fname = dotted(ctx.func)
                last = fname.split(".")[-1]
                if last == "activate":
                    return "activate"
                if last == "deactivate":
                    return "deactivate"
        return ""

    def _scan(self, module, body, shard_local, in_activate, in_deactivate):
        for stmt in body:
            if isinstance(stmt, ast.With):
                kind = self._with_kind(stmt)
                if in_activate and not in_deactivate:
                    for item in stmt.items:
                        yield from self._check_expr(
                            module, item.context_expr, shard_local
                        )
                yield from self._scan(
                    module, stmt.body, shard_local,
                    in_activate or kind == "activate",
                    (in_deactivate or kind == "deactivate")
                    and kind != "activate",
                )
                continue
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # a nested def is not executed here; scan it with a
                # fresh scope (it may be called elsewhere)
                yield from self._scan(module, stmt.body, shard_local,
                                      False, False)
                continue
            if in_activate and not in_deactivate:
                # only this statement's own expressions — nested
                # statement bodies are handled by the recursion below
                # with their own (possibly deactivated) scope
                for expr in self._stmt_exprs(stmt):
                    yield from self._check_expr(module, expr, shard_local)
            # recurse into compound statements, preserving scope flags
            for field_body in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, field_body, None)
                if isinstance(sub, list) and sub:
                    yield from self._scan(module, sub, shard_local,
                                          in_activate, in_deactivate)
            for handler in getattr(stmt, "handlers", []) or []:
                yield from self._scan(module, handler.body, shard_local,
                                      in_activate, in_deactivate)

    def _stmt_exprs(self, stmt: ast.stmt):
        """Direct expression children of a statement (no nested stmts)."""
        for _name, value in ast.iter_fields(stmt):
            if isinstance(value, ast.expr):
                yield value
            elif isinstance(value, list):
                for el in value:
                    if isinstance(el, ast.expr):
                        yield el

    def _check_expr(self, module, expr, shard_local):
        for node in ast.walk(expr):
            if not isinstance(node, ast.Call):
                continue
            fname = dotted(node.func).split(".")[-1]
            if fname in shard_local:
                yield Finding(
                    rule=self.rule_id,
                    path=module.path,
                    line=node.lineno,
                    message=(
                        f"shard-local '{fname}' called inside an "
                        f"activate(mesh) scope without sharding.deactivate()"
                    ),
                    hint="wrap the call in 'with sharding.deactivate():'",
                )


ALL_RULES = (
    LockDisciplineRule(),
    DonationSafetyRule(),
    CounterMirrorRule(),
    WireExhaustivenessRule(),
    ForbiddenApiRule(),
    ShardingScopeRule(),
)
