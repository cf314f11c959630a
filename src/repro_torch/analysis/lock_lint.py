"""AST lock-discipline checker for the threaded serving plane.

The port of ``repro.analysis.lock_lint``.

The service/daemon threading relies on a convention: shared mutable state
hangs off ``self`` and is only touched while holding the instance lock,
either inside a ``with self._lock:`` block or from a method whose name
ends in ``_locked`` (which callers must invoke under the lock).  This
checker turns the convention into a machine-checked contract.

The contract is declared in the source itself as a ``# lock:`` inventory
block — canonical documentation and checker input in one place::

    # lock: self._lock
    #   _pending _next_ticket _sched
    #   _warmed _conv_digests

Every field named in the inventory of the enclosing class may only be
read/written

* inside a ``with self.<lock>:`` statement,
* inside a method whose name ends with ``_locked``,
* or inside ``__init__`` (construction precedes sharing).

and every ``self.*_locked(...)`` call must itself happen under one of the
first two.  Two rules:

``lock-unguarded-field``
    inventory field accessed outside the lock.

``lock-unlocked-call``
    ``*_locked`` method called outside the lock.

Purely AST-based: no imports of the checked modules, no runtime state.
The lock attribute can be any ``self.<name>`` (the daemon guards with a
``threading.Condition`` named ``_cond`` — a Condition wraps an RLock, so
``with self._cond`` is the guard there).  Re-entrant acquisition is
assumed (both planes use RLock semantics), so nested ``with`` blocks and
``_locked`` calls from ``_locked`` methods are fine.
"""
from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.findings import Finding, apply_pragmas, scan_pragmas

_BLOCK_HEAD_RE = re.compile(r"^\s*#\s*lock:\s*self\.(\w+)\s*$")
_BLOCK_FIELDS_RE = re.compile(r"^\s*#\s+((?:_\w+\s*)+)$")

_EXEMPT_METHODS = {"__init__", "__del__"}


class _Inventory:
    """One ``# lock:`` block: the guarding attribute and its fields."""

    def __init__(self, lock_attr: str, line: int):
        self.lock_attr = lock_attr
        self.line = line
        self.fields: Set[str] = set()


def parse_inventories(source: str) -> List[_Inventory]:
    """Extract ``# lock: self.X`` blocks and their indented field lists."""
    out: List[_Inventory] = []
    current: Optional[_Inventory] = None
    for i, text in enumerate(source.splitlines(), start=1):
        m = _BLOCK_HEAD_RE.match(text)
        if m:
            current = _Inventory(m.group(1), i)
            out.append(current)
            continue
        if current is not None:
            m = _BLOCK_FIELDS_RE.match(text)
            if m:
                current.fields.update(m.group(1).split())
            else:
                current = None
    return [inv for inv in out if inv.fields]


def _enclosing_class(tree: ast.Module, line: int) -> Optional[ast.ClassDef]:
    best: Optional[ast.ClassDef] = None
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            end = getattr(node, "end_lineno", node.lineno)
            if node.lineno <= line <= end:
                if best is None or node.lineno > best.lineno:
                    best = node
    return best


def _with_holds_lock(node: ast.With, lock_attr: str) -> bool:
    for item in node.items:
        expr = item.context_expr
        # with self._lock: …  — also accept self._lock: acquire-style
        # wrappers like `with self._cond:` (Condition wraps an RLock)
        if isinstance(expr, ast.Attribute) and expr.attr == lock_attr \
                and isinstance(expr.value, ast.Name) \
                and expr.value.id == "self":
            return True
    return False


class _MethodChecker(ast.NodeVisitor):
    """Walk one method body tracking whether the lock is held."""

    def __init__(self, method: ast.AST, inv: _Inventory, path: str,
                 findings: List[Finding]):
        self.inv = inv
        self.path = path
        self.findings = findings
        name = getattr(method, "name", "")
        self.held = name.endswith("_locked") or name in _EXEMPT_METHODS
        self.method_name = name

    def visit_With(self, node: ast.With):
        if _with_holds_lock(node, self.inv.lock_attr):
            prev, self.held = self.held, True
            for child in node.body:
                self.visit(child)
            self.held = prev
        else:
            self.generic_visit(node)

    def visit_FunctionDef(self, node):
        # nested defs (e.g. callbacks handed elsewhere) run who-knows-when:
        # treat them as unlocked regardless of the definition site.
        # Lambdas deliberately have NO such override — the codebase uses
        # them as sort/max keys that execute synchronously under the lock.
        prev, self.held = self.held, False
        self.generic_visit(node)
        self.held = prev

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Attribute(self, node: ast.Attribute):
        if not self.held \
                and isinstance(node.value, ast.Name) \
                and node.value.id == "self" \
                and node.attr in self.inv.fields:
            self.findings.append(Finding(
                file=self.path, line=node.lineno, rule="lock-unguarded-field",
                message=f"self.{node.attr} accessed in {self.method_name}() "
                        f"outside 'with self.{self.inv.lock_attr}' — field "
                        f"is in the lock inventory (line {self.inv.line})"))
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call):
        fn = node.func
        if not self.held \
                and isinstance(fn, ast.Attribute) \
                and fn.attr.endswith("_locked") \
                and isinstance(fn.value, ast.Name) and fn.value.id == "self":
            self.findings.append(Finding(
                file=self.path, line=node.lineno, rule="lock-unlocked-call",
                message=f"self.{fn.attr}() called from "
                        f"{self.method_name}() without holding "
                        f"self.{self.inv.lock_attr} — the _locked suffix "
                        f"is a promise the caller already owns the lock"))
        self.generic_visit(node)


def check_source(source: str, path: str) -> List[Finding]:
    """Check one module; no-op (zero findings) if it declares no
    ``# lock:`` inventory."""
    inventories = parse_inventories(source)
    if not inventories:
        return []
    allowed, findings = scan_pragmas(source, path)
    out: List[Finding] = list(findings)
    tree = ast.parse(source, filename=path)

    for inv in inventories:
        cls = _enclosing_class(tree, inv.line)
        methods: List[ast.AST]
        if cls is not None:
            methods = [n for n in cls.body
                       if isinstance(n, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))]
        else:  # file-level inventory: every method in the module
            methods = [n for n in ast.walk(tree)
                       if isinstance(n, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))]
        for method in methods:
            checker = _MethodChecker(method, inv, path, out)
            for child in method.body:
                checker.visit(child)
    return apply_pragmas(out, allowed)


def check_tree(root: str) -> List[Finding]:
    """Check every ``.py`` under ``root`` that declares an inventory."""
    out: List[Finding] = []
    for dirpath, _, files in sorted(os.walk(root)):
        for name in sorted(files):
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            with open(path) as f:
                src = f.read()
            if "# lock:" not in src:
                continue
            rel = os.path.relpath(path, os.path.dirname(root))
            out.extend(check_source(src, rel))
    return out
