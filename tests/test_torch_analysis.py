"""The port's lock checker (repro_torch.analysis: findings, lock_lint and
the CLI) against the reference's on the same fixture sources, and over
the port's own tree.

The fixtures are those of ``tests/test_analysis.py``'s lock cases; each
gives the port the reference's findings, field for field.  Over
``src/repro_torch`` the check must report zero findings, and the
inventories it reads must be there: the service's ``_lock``, the
daemon's ``_cond`` and kernel K4's row-list ``_lock``.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro.analysis import findings as jfindings  # noqa: E402
from repro.analysis import lock_lint as jlock_lint  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch.analysis import CHECKS, run_checks  # noqa: E402
from repro_torch.analysis import findings, lock_lint  # noqa: E402

PORT_ROOT = os.path.dirname(os.path.abspath(repro_torch.__file__))

FIXTURE_LOCKS = textwrap.dedent('''\
    import threading

    class Svc:
        def __init__(self):
            # lock: self._lock
            #   _queue _count
            self._lock = threading.RLock()
            self._queue = []
            self._count = 0

        def submit(self, x):
            with self._lock:
                self._queue.append(x)

        def bump(self):
            self._count += 1          # line 16: unlocked field write

        def _drain_locked(self):
            out, self._queue = self._queue, []
            return out

        def flush(self):
            return self._drain_locked()   # line 23: _locked outside lock

        def flush_ok(self):
            with self._lock:
                return self._drain_locked()
''')

FIXTURE_NESTED = textwrap.dedent('''\
    import threading

    class Daemon:
        def __init__(self):
            # lock: self._cond
            #   _queue _closed
            self._cond = threading.Condition()
            self._queue = []
            self._closed = False

        def run(self):
            with self._cond:
                def later():
                    return self._queue      # line 14: nested def, unlocked
                best = max(self._queue, key=lambda e: e)
                return later, best

        def close(self):
            self._closed = True  # analysis: allow(lock-unguarded-field): test
''')


def _as_tuples(fs):
    return [(f.file, f.line, f.rule, f.message, f.severity) for f in fs]


def test_ruleset_is_the_reference_lock_and_meta_rules():
    ref = {r.id: r for r in jfindings.RULES if r.checker in ("locks", "meta")}
    mine = {r.id: r for r in findings.RULES}
    assert set(mine) == set(ref) == {"lock-unguarded-field",
                                     "lock-unlocked-call", "meta-bare-allow"}
    for rid, rule in mine.items():
        assert dataclasses.asdict(rule) == dataclasses.asdict(ref[rid])
    assert findings.RULE_IDS == frozenset(mine)
    assert CHECKS == ("locks",)


@pytest.mark.parametrize("source", [FIXTURE_LOCKS, FIXTURE_NESTED],
                         ids=["locks", "nested"])
def test_findings_equal_the_reference(source):
    mine = lock_lint.check_source(source, "fix.py")
    ref = jlock_lint.check_source(source, "fix.py")
    assert _as_tuples(mine) == _as_tuples(ref)
    assert mine                              # each fixture fires


def test_fixture_rules_and_lines():
    fs = lock_lint.check_source(FIXTURE_LOCKS, "fix_locks.py")
    (unguarded,) = [f for f in fs if f.rule == "lock-unguarded-field"]
    assert (unguarded.file, unguarded.line) == ("fix_locks.py", 16)
    assert "_count" in unguarded.message
    (unlocked,) = [f for f in fs if f.rule == "lock-unlocked-call"]
    assert (unlocked.file, unlocked.line) == ("fix_locks.py", 23)
    assert "_drain_locked" in unlocked.message
    fs = lock_lint.check_source(FIXTURE_NESTED, "fix_nested.py")
    # the nested def is unlocked, the lambda under the lock is not, and
    # the reasoned pragma silences line 19
    assert [(f.line, f.rule) for f in fs] == [(14, "lock-unguarded-field")]


def test_lock_inventory_parsing():
    (inv,) = lock_lint.parse_inventories(FIXTURE_LOCKS)
    assert inv.lock_attr == "_lock" and inv.fields == {"_queue", "_count"}
    assert [(i.lock_attr, i.fields, i.line) for i in
            lock_lint.parse_inventories(FIXTURE_LOCKS)] == \
        [(i.lock_attr, i.fields, i.line) for i in
         jlock_lint.parse_inventories(FIXTURE_LOCKS)]


@pytest.mark.parametrize("line,rules", [
    ("x = 1  # analysis: allow(lock-unguarded-field): init-only path",
     {"lock-unguarded-field"}),
    ("x = 1  # analysis: allow(lock-unlocked-call)", None),
    ("x = 1  # analysis: allow(no-such-rule): a reason", None),
])
def test_pragmas(line, rules):
    allowed, fs = findings.scan_pragmas(line + "\n", "p.py")
    ref_allowed, ref_fs = jfindings.scan_pragmas(line + "\n", "p.py")
    assert allowed == ref_allowed
    if rules is None:
        assert allowed == {} and [f.rule for f in fs] == ["meta-bare-allow"]
        assert [f.line for f in fs] == [f.line for f in ref_fs]
    else:
        assert allowed == {1: rules} and fs == [] == ref_fs


def test_apply_pragmas_is_line_and_rule_scoped():
    fs = [findings.Finding("a.py", 3, "lock-unguarded-field", "m"),
          findings.Finding("a.py", 3, "lock-unlocked-call", "m"),
          findings.Finding("a.py", 4, "lock-unguarded-field", "m")]
    kept = findings.apply_pragmas(fs, {3: {"lock-unguarded-field"}})
    assert [(f.line, f.rule) for f in kept] == [(3, "lock-unlocked-call"),
                                               (4, "lock-unguarded-field")]


def test_port_tree_is_clean_and_agrees_with_the_reference_checker():
    per_check = run_checks(["locks"])
    assert per_check == {"locks": []}
    assert jlock_lint.check_tree(PORT_ROOT) == []
    with pytest.raises(ValueError, match="unknown check"):
        run_checks(["trace"])


def test_real_inventories_declared():
    want = {"solver/service.py": ("_lock", {"_pending", "_sched",
                                            "_solvers"}),
            "serve/solver_daemon.py": ("_cond", {"_queue", "_lanes",
                                                 "_closed", "_expired"}),
            "kernels/similarity.py": ("_lock", {"_epoch"})}
    for rel, (lock, fields) in want.items():
        with open(os.path.join(PORT_ROOT, rel)) as f:
            invs = lock_lint.parse_inventories(f.read())
        assert [i.lock_attr for i in invs] == [lock], rel
        assert fields <= invs[0].fields, rel


def test_checker_catches_an_unlocked_k4_launch_number():
    """Take the lock away from K4's launch numbering, in a copy of the
    source: the checker must flag the unguarded read-modify-write."""
    with open(os.path.join(PORT_ROOT, "kernels", "similarity.py")) as f:
        src = f.read()
    guarded = "        with self._lock:\n            self._epoch += 1\n"
    assert guarded in src
    broken = src.replace(guarded, "        if True:\n"
                                  "            self._epoch += 1\n")
    fs = lock_lint.check_source(broken, "similarity.py")
    assert {f.rule for f in fs} == {"lock-unguarded-field"}
    assert all("_epoch" in f.message for f in fs)


def test_cli_exit_code_and_json(tmp_path):
    out = tmp_path / "findings.json"
    env = {**os.environ, "PYTHONPATH": os.path.dirname(PORT_ROOT)}
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--check", "locks",
         "--json", str(out)], capture_output=True, text=True, timeout=120,
        env=env)
    assert run.returncode == 0, run.stdout + run.stderr
    assert "OK — 0 finding(s) (locks: 0)" in run.stdout
    doc = json.loads(out.read_text())
    assert doc["records"]["checks_run"] == ["locks"]
    assert doc["records"]["finding_count"] == 0
    bad = tmp_path / "pkg"
    bad.mkdir()
    (bad / "fix.py").write_text(FIXTURE_LOCKS)
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--check", "locks",
         "--root", str(bad)], capture_output=True, text=True, timeout=120,
        env=env)
    assert run.returncode == 1
    assert "pkg/fix.py:16: [lock-unguarded-field]" in run.stdout
