"""The port's odlint (``repro_torch.analysis``): a firing and a clean
snippet per rule, parity with the JAX package's linter, mutations of the
real port, and the CLI.

* **Snippets** — for every rule (ODL000-ODL006) a small tree written to
  ``tmp_path`` from this file must fire it, and its clean twin must not
  fire anything; every rule in ``ALL_RULES`` has one that fires.
* **Parity** — on the JAX package's fixture trees for ODL000, ODL001,
  ODL003 and ODL006, and for ODL005's sub-checks (2) and (3), both linters
  give the same findings (rule, relative path, line, message).
* **Mutations** — a copy of ``src/repro_torch`` in ``tmp_path`` with one
  invariant broken must fire the rule that guards it.  The ODL002, ODL004
  and ODL005 mutations break the shapes the JAX package's linter cannot
  see in the port (the chunk runner's donation, the wire constants living
  in ``engine/wire.py``, a clock in a captured tick function): that linter
  must stay silent on them, which pins the blind spot the port's closes.

Stdlib and the two linters only (no torch, no jax).
"""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

from repro.analysis import core as j_core
from repro.analysis.rules import ALL_RULES as J_RULES
from repro_torch.analysis import core
from repro_torch.analysis.rules import ALL_RULES

REPO = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures" / "odlint"
RULE_IDS = tuple(r.rule_id for r in ALL_RULES)


def lint_tree(root: pathlib.Path, pkg=core, rules=ALL_RULES) -> list:
    files = pkg.collect_files([str(root)])
    assert files, f"no files under {root}"
    return pkg.run_rules(pkg.Project.load(files, root=root), rules)


def reference_lint(root: pathlib.Path) -> list:
    return lint_tree(root, j_core, J_RULES)


def write_tree(root: pathlib.Path, files: dict) -> pathlib.Path:
    for rel, src in files.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(src)
    return root


# ---------------------------------------------------------------------------
# Snippets: (firing tree, clean tree) per rule
# ---------------------------------------------------------------------------

_ODL001 = '''
import threading


class Counter:
    def __init__(self):
        self._lock = threading.Lock()
        self.count = 0

    def bump(self):
        with self._lock:
            self.count += 1

    def reset(self):
        {reset}
'''

_ODL002 = '''
import functools


@functools.lru_cache(maxsize=4)
def _runner(cfg):  # odlint(torch): donates(0)
    def run(state, x):
        return state + x
    return run


def drive(state, xs, cfg):
    runner = _runner(cfg)
    for x in xs:
        {call}
    return state
'''

_ODL003_STREAM = '''
import dataclasses


@dataclasses.dataclass
class StreamStats:
    ticks: int = 0
    queries_issued: int = 0
{extra}
'''
_ODL003_TELEMETRY = '''
STREAM_COUNTER_FIELDS = ("ticks", "queries_issued")
STREAM_GAUGE_FIELDS = ()
STREAM_MIRROR_EXCLUDED = ()
'''

_ODL004_WIRE = "WIRE_V2 = 0x02\nWIRE_V3_ZLIB = 0x03\n"
_ODL004_SNAPSHOT = '''
from pkg.engine import wire


def check(data):
    return data[0] == {magic}
'''

_ODL005 = '''
import time

from pkg.engine import graphs


def make(cfg):
    def tick(src, dst, x):
        {body}
        dst.copy_(src + x)
    return tick


def drive(cache, src, dst, x, cfg):
    return graphs.run(cache, 0, "tick", make_tick, (src, dst), [x])


def make_tick(src, dst, x):
    {body}
    dst.copy_(src + x)
'''

_ODL006 = '''
from pkg.distributed import sharding


# odlint: shard-local
def _block_body(x):
    return x


def run(mesh, x):
    with sharding.activate(mesh):
        {call}
'''

SNIPPETS = {
    "ODL000": (
        {"mod.py": "def f():\n    # odlint: disable=ODL005\n    return 1\n"},
        {"mod.py": "def f():\n    # odlint: disable=ODL005 -- a CLI status line\n    return 1\n"},
    ),
    "ODL001": (
        {"mod.py": _ODL001.format(reset="self.count = 0")},
        {"mod.py": _ODL001.format(reset="with self._lock:\n            self.count = 0")},
    ),
    "ODL002": (
        {"mod.py": _ODL002.format(call="new = runner(state, x)\n        print(state)\n"
                                       "        state = new")},
        {"mod.py": _ODL002.format(call="state = runner(state, x)")},
    ),
    "ODL003": (
        {"pkg/engine/stream.py": _ODL003_STREAM.format(extra="    queries_lost: int = 0"),
         "pkg/runtime/telemetry.py": _ODL003_TELEMETRY},
        {"pkg/engine/stream.py": _ODL003_STREAM.format(extra=""),
         "pkg/runtime/telemetry.py": _ODL003_TELEMETRY},
    ),
    "ODL004": (
        {"pkg/engine/wire.py": _ODL004_WIRE,
         "pkg/engine/snapshot.py": _ODL004_SNAPSHOT.format(magic="0x02")},
        {"pkg/engine/wire.py": _ODL004_WIRE,
         "pkg/engine/snapshot.py": _ODL004_SNAPSHOT.format(magic="wire.WIRE_V2")},
    ),
    "ODL005": (
        {"pkg/lib/mod.py": _ODL005.format(body="stamp = time.perf_counter()")},
        {"pkg/lib/mod.py": _ODL005.format(body="stamp = x.sum()")},
    ),
    "ODL006": (
        {"mod.py": _ODL006.format(call="return _block_body(x)")},
        {"mod.py": _ODL006.format(call="with sharding.deactivate():\n"
                                        "            return _block_body(x)")},
    ),
}


@pytest.mark.parametrize("rule_id", sorted(SNIPPETS))
def test_firing_snippet_fires(tmp_path, rule_id):
    findings = lint_tree(write_tree(tmp_path, SNIPPETS[rule_id][0]))
    assert rule_id in {f.rule for f in findings}, findings


@pytest.mark.parametrize("rule_id", sorted(SNIPPETS))
def test_clean_snippet_is_clean(tmp_path, rule_id):
    findings = lint_tree(write_tree(tmp_path, SNIPPETS[rule_id][1]))
    assert not findings, [f.format_text() for f in findings]


def test_every_rule_fires_on_a_snippet(tmp_path):
    fired = set()
    for k, rule_id in enumerate(sorted(SNIPPETS)):
        fired |= {f.rule for f in lint_tree(write_tree(tmp_path / str(k),
                                                       SNIPPETS[rule_id][0]))}
    assert set(RULE_IDS) | {"ODL000"} <= fired
    assert set(SNIPPETS) == set(RULE_IDS) | {"ODL000"}


def test_rules_keep_the_reference_ids_and_titles():
    assert [(r.rule_id, r.title) for r in ALL_RULES] == [(r.rule_id, r.title) for r in J_RULES]
    assert all(r.rationale for r in ALL_RULES)


def test_odl005_covers_every_capture_shape(tmp_path):
    """By name through ``graphs.run``/``TickGraph``, by annotation, and
    under ``with torch.cuda.graph``; a factory's nested tick through the
    annotation."""
    src = '''
import time

import numpy as np
import torch

from pkg.engine import graphs


def by_name(a):
    return time.time()


# odlint(torch): captured
def by_mark(a):
    return np.random.rand()


def capture(g, a):
    graphs.TickGraph("t", by_name, (), [a])
    with torch.cuda.graph(g):
        time.monotonic()


def not_captured(a):
    return time.perf_counter()
'''
    findings = lint_tree(write_tree(tmp_path, {"pkg/lib/mod.py": src}))
    lines = sorted(f.line for f in findings if f.rule == "ODL005")
    assert lines == [11, 16, 22], [f.format_text() for f in findings]


def test_odl002_direct_donor_and_self_binding(tmp_path):
    src = '''
class Session:
    def __init__(self, cfg):
        self.step = make(cfg)

    def tick(self, state, x):
        new = self.step(state, x)
        return state, new


def make(cfg):  # odlint(torch): donates(0)
    return lambda state, x: state + x


def advance(state, x):  # odlint(torch): donates(0)
    return state + x


def drive(state, x):
    out = advance(state, x)
    return out + state
'''
    findings = [f for f in lint_tree(write_tree(tmp_path, {"mod.py": src}))
                if f.rule == "ODL002"]
    assert sorted(f.line for f in findings) == [8, 21], [f.format_text() for f in findings]


def test_odl002_direct_donor_across_modules_and_the_donate_false_opt_out(tmp_path):
    """A direct donor is seen from every module (``f(...)`` and
    ``mod.f(...)``), its donated parameter passed by position or keyword;
    the literal ``donate=False`` opts a call out."""
    lib = '''
def run_fleet(state, xs, cfg, donate=None):  # odlint(torch): donates(0)
    return state
'''
    use = '''
from pkg import lib
from pkg.lib import run_fleet


def by_module(st, xs, cfg):
    new = lib.run_fleet(st, xs, cfg)
    return new, st


def by_keyword(st, xs, cfg):
    new = run_fleet(state=st, xs=xs, cfg=cfg)
    return new, st


def opted_out(st, xs, cfg):
    new = lib.run_fleet(st, xs, cfg, donate=False)
    return new, st


def rebound(st, xs, cfg):
    st = run_fleet(st, xs, cfg)
    return st
'''
    root = write_tree(tmp_path, {"pkg/__init__.py": "", "pkg/lib.py": lib, "pkg/use.py": use})
    findings = [f for f in lint_tree(root) if f.rule == "ODL002"]
    assert sorted((pathlib.Path(f.path).name, f.line) for f in findings) == [
        ("use.py", 8), ("use.py", 13)], [f.format_text() for f in findings]


# ---------------------------------------------------------------------------
# Parity with the JAX package's linter on its fixture trees
# ---------------------------------------------------------------------------


def _rows(findings, root):
    return sorted((f.rule, str(pathlib.Path(f.path).relative_to(root)), f.line, f.message)
                  for f in findings)


@pytest.mark.parametrize("side", ["bad", "clean"])
@pytest.mark.parametrize("stem", ["odl000", "odl001", "odl003", "odl006"])
def test_same_findings_as_the_reference_on_its_fixtures(stem, side):
    root = FIXTURES / f"{stem}_{side}"
    assert _rows(lint_tree(root), root) == _rows(reference_lint(root), root)


@pytest.mark.parametrize("side", ["bad", "clean"])
def test_odl005_socket_and_print_checks_equal_the_reference(side):
    root = FIXTURES / f"odl005_{side}"

    def sub23(findings):
        return [f for f in findings if f.rule == "ODL005" and "frozen" not in f.message
                and "trace time" not in f.message]

    mine, ref = sub23(lint_tree(root)), sub23(reference_lint(root))
    assert _rows(mine, root) == _rows(ref, root)
    if side == "bad":
        assert {"bare 'except:'" in f.message for f in mine} == {True, False}


# ---------------------------------------------------------------------------
# Mutations of the real port
# ---------------------------------------------------------------------------


@pytest.fixture
def port(tmp_path):
    root = tmp_path / "tree"
    shutil.copytree(REPO / "src" / "repro_torch", root / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "*.cu", "*.md"))
    return root


def _mutate(root, rel, old, new, count=1):
    path = root / "repro_torch" / rel
    src = path.read_text()
    assert src.count(old) >= count, f"{rel}: {old!r} moved — update the mutation"
    path.write_text(src.replace(old, new) if count > 1 else src.replace(old, new, 1))


def test_the_port_is_clean_under_both_linters(port):
    assert not lint_tree(port), [f.format_text() for f in lint_tree(port)]
    assert not reference_lint(port), [f.format_text() for f in reference_lint(port)]


def test_mutation_unlocked_write_fires_odl001(port):
    _mutate(port, "runtime/telemetry.py",
            "                    self.dropped += 1  # odlint: guarded-by(_lock)",
            "                    pass")
    _mutate(port, "runtime/telemetry.py", "        return (name, time.monotonic_ns())",
            "        self.dropped += 1  # odlint: guarded-by(_lock)\n"
            "        return (name, time.monotonic_ns())")
    assert any(f.rule == "ODL001" and "dropped" in f.message for f in lint_tree(port))


def test_mutation_read_after_the_chunk_runner_fires_odl002(port):
    _mutate(port, "engine/fleet.py",
            "        state, out = runner(state, xs[t:t + c], labels[t:t + c], "
            "teacher_available[t:t + c])",
            "        new, out = runner(state, xs[t:t + c], labels[t:t + c], "
            "teacher_available[t:t + c])\n"
            "        stale = state.elm.P\n"
            "        state = new")
    mine = [f for f in lint_tree(port) if f.rule == "ODL002"]
    assert any("'state'" in f.message and f.path.endswith("fleet.py") for f in mine), mine
    assert not [f for f in reference_lint(port) if f.rule == "ODL002"]


def test_mutation_read_after_run_fleet_fires_odl002(port):
    """``run_fleet`` itself donates on the card: a caller that keeps
    reading the fleet it passed reads the new state."""
    _mutate(port, "examples/quickstart.py", "    fleet, outs = engine.run_fleet(",
            "    after, outs = engine.run_fleet(")
    mine = [f for f in lint_tree(port) if f.rule == "ODL002"]
    assert any("'fleet'" in f.message and f.path.endswith("quickstart.py") for f in mine), mine
    assert not [f for f in reference_lint(port) if f.rule == "ODL002"]
    _mutate(port, "examples/quickstart.py", "        chunk=engine.CHUNK_TICKS,\n",
            "        chunk=engine.CHUNK_TICKS, donate=False,\n")
    assert not [f for f in lint_tree(port) if f.rule == "ODL002"]


@pytest.mark.parametrize("what", ["mirror", "field"])
def test_mutation_mirror_drift_fires_odl003(port, what):
    if what == "mirror":
        _mutate(port, "runtime/telemetry.py", '"asks_deferred", "tickets_reasked",',
                '"asks_deferred",')
        want = "tickets_reasked"
    else:
        anchor = "    tickets_reasked: int = 0"
        _mutate(port, "engine/stream.py", anchor, "    queries_forgotten: int = 0\n" + anchor)
        want = "queries_forgotten"
    assert any(f.rule == "ODL003" and want in f.message for f in lint_tree(port))


def test_mutation_deleted_handler_branch_fires_odl004(port):
    _mutate(port, "runtime/worker.py",
            '            if cmd == "metrics":\n'
            '                return self._metrics(bool(header.get("trace", False)))\n', "")
    assert any(f.rule == "ODL004" and "'metrics'" in f.message and "no handler" in f.message
               for f in lint_tree(port))


def test_mutation_literal_frame_byte_fires_odl004(port):
    _mutate(port, "engine/snapshot.py", "wire.WIRE_V2", "0x02", count=2)
    mine = [f for f in lint_tree(port) if f.rule == "ODL004"]
    assert any("WIRE_V*" in f.message and f.path.endswith("snapshot.py") for f in mine), mine
    assert not reference_lint(port)


def test_mutation_redeclared_frame_byte_fires_odl004(port):
    _mutate(port, "engine/snapshot.py", "SNAPSHOT_WIRE_VERSION = 1",
            "SNAPSHOT_WIRE_VERSION = 1\nWIRE_V2 = 0x02")
    assert any(f.rule == "ODL004" and "re-declares WIRE_V2" in f.message
               for f in lint_tree(port))


@pytest.mark.parametrize("where", ["inferred", "annotated"])
def test_mutation_clock_in_a_captured_tick_fires_odl005(port, where):
    if where == "inferred":  # the chunk runner's tick, passed to graphs.TickGraph
        rel, anchor = "engine/fleet.py", "        n = (len(leaves) - 3) // 2\n        xs, "
        _mutate(port, rel, anchor, "        stamp = time.perf_counter()\n" + anchor)
        _mutate(port, rel, "import functools\n", "import functools\nimport time\n")
        name = "run_chunk"
    else:  # a stream runner's nested tick, reaching graphs.run through a variable
        rel = "engine/stream.py"
        anchor = "        new, p = fleet.plan(src, x, cfg, mode=mode, out=dst)"
        _mutate(port, rel, anchor, "        stamp = time.perf_counter()\n" + anchor)
        name = "run_plan"
    mine = [f for f in lint_tree(port) if f.rule == "ODL005"]
    assert any(f"captured '{name}'" in f.message for f in mine), mine
    assert not reference_lint(port)


def test_mutation_shard_local_call_under_activate_fires_odl006(port):
    _mutate(port, "engine/fleet.py",
            "    with sharding.deactivate():\n        return _run_fleet_shards_body(",
            "    with sharding.activate(sharding.mesh_or_none()):\n"
            "        return _run_fleet_shards_body(")
    assert any(f.rule == "ODL006" and "_run_fleet_shards_body" in f.message
               for f in lint_tree(port))


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def run_cli(*args):
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis", *args],
                          capture_output=True, text=True, cwd=REPO, timeout=120,
                          env=dict(os.environ, PYTHONPATH=str(REPO / "src")))


def test_cli_clean_on_the_port_exits_zero():
    proc = run_cli("src/repro_torch")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "clean" in proc.stdout


def test_cli_findings_exit_one_and_json_report(tmp_path):
    out = tmp_path / "report.json"
    proc = run_cli(str(FIXTURES / "odl001_bad"), "--format", "json", "--output", str(out))
    assert proc.returncode == 1
    doc = json.loads(out.read_text())
    assert doc["tool"] == "odlint" and doc["count"] == len(doc["findings"]) > 0
    assert any(f["rule"] == "ODL001" for f in doc["findings"])
    assert {r["id"] for r in doc["rules"]} == set(RULE_IDS)


def test_cli_baseline_suppresses_known_findings(tmp_path):
    base = tmp_path / "baseline.json"
    target = str(FIXTURES / "odl001_bad")
    assert run_cli(target, "--write-baseline").returncode == 2  # needs --baseline
    proc = run_cli(target, "--baseline", str(base), "--write-baseline")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert run_cli(target, "--baseline", str(base)).returncode == 0
    assert run_cli(str(FIXTURES / "odl006_bad"), "--baseline", str(base)).returncode == 1


def test_cli_rule_selection_and_listing():
    assert run_cli(str(FIXTURES / "odl001_bad"), "--rules", "ODL004").returncode == 0
    assert run_cli(str(FIXTURES / "odl001_bad"), "--rules", "NOPE").returncode == 2
    assert run_cli(str(REPO / "tests" / "fixtures" / "no-such-dir")).returncode == 2
    proc = run_cli("--list-rules")
    assert proc.returncode == 0
    for rid in RULE_IDS:
        assert rid in proc.stdout
