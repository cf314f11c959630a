"""AST host-sync lint of the modules that run on every solve.

The port of ``repro.analysis.trace_lint``.  PyTorch runs eagerly, so the
reference's "jit-traced scope" has no counterpart: the scope is a list of
hot modules (:data:`HOT_MODULES`), the modules a solve, a V-cycle or a
kernel launch runs through, linted file-wide.  What the lint protects is
what a CUDA graph of the solve loop needs: no host sync hidden inside it.

Three rules:

``sync-host-sync``
    ``float(e)`` / ``int(e)`` / ``bool(e)`` / ``e.item()`` /
    ``e.tolist()`` / ``e.cpu()`` / ``e.numpy()`` where ``e`` is a tensor:
    it contains a ``torch.*`` call or a method call on a tensor, directly
    or through a local name assigned from one.  Each is a blocking device
    round trip.  The designated syncs (the solve's test of "all done"
    every ``_PCG_CHECK_EVERY`` trips, a build's read-back of its
    estimates) carry a reasoned ``allow`` pragma.

``sync-numpy-on-tensor``
    an ``np.*`` call whose arguments are tensors: numpy copies a CUDA
    tensor to the host (or raises).

``sync-tensor-branch``
    ``if`` / ``while`` / a conditional expression whose test is a tensor:
    an implicit ``bool()``.  Exempt: ``is None`` / ``is not None``,
    ``isinstance``, and anything reached only through ``.shape`` /
    ``.ndim`` / ``.dtype`` / ``.device`` / ``.numel()`` / ``len()`` —
    metadata lives on the host.

The dataflow is the reference's: flow-insensitive, per function, seeded
with the enclosing functions' tensor names, a short fixpoint over
assignments.  Function parameters are not known to be tensors, so a sync
on a bare parameter is not seen; the dispatch audit
(:mod:`repro_torch.analysis.dispatch_audit`) sees those at run time.  The
results of the syncing calls above are host values, so dataflow stops
there: ``int(x.tolist()[0])`` is one finding, not two.  Re-binding a
tensor name to a host value does not clear it; bind the host value to a
new name.
"""
from __future__ import annotations

import ast
import os
from typing import Iterable, List, Optional, Set, Tuple

from repro_torch.analysis.findings import (Finding, apply_pragmas,
                                           scan_pragmas)

#: the modules a solve, a V-cycle or a kernel launch runs through,
#: relative to the ``repro_torch`` package directory
HOT_MODULES = (
    "solver/device_pcg.py",
    "solver/sharded.py",
    "kernels/vcycle_fused.py",
    "kernels/spmv_ell.py",
    "kernels/similarity.py",
    "kernels/ssm_scan.py",
    "kernels/laplacian_residual.py",
    "kernels/_launch.py",
    "spectral/harmonic.py",
    "core/collectives.py",
)

_SCALARIZE = {"float", "int", "bool"}
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
# metadata: attributes and methods of a tensor that live on the host
_META_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout",
               "requires_grad"}
_META_METHODS = {"numel", "dim", "size", "stride", "data_ptr",
                 "element_size", "is_contiguous", "nelement", "get_device",
                 "is_floating_point", "storage_offset"}
# torch callables whose result is a host value, not a tensor
_TORCH_HOST = {"device", "finfo", "iinfo", "Size", "is_tensor", "cuda",
               "backends", "get_default_dtype", "Generator", "dtype",
               "promote_types", "is_floating_point", "is_grad_enabled",
               "autograd", "profiler", "utils"}
_NP_ROOTS = {"np", "numpy"}


def _attr_path(node: ast.AST) -> Optional[Tuple[str, ...]]:
    """``a.b.c`` -> ("a", "b", "c"); None for anything not a pure path."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return None


def _is_sync_call(node: ast.AST) -> bool:
    """A call whose result is a host value that crossed from the device:
    ``float/int/bool(...)`` or ``.item()/.tolist()/.cpu()/.numpy()``."""
    if not isinstance(node, ast.Call):
        return False
    if isinstance(node.func, ast.Name):
        return node.func.id in _SCALARIZE
    return isinstance(node.func, ast.Attribute) and \
        node.func.attr in _SYNC_METHODS and not node.args


class _Tensorness(ast.NodeVisitor):
    """Whether an expression is a tensor: it calls ``torch.*`` (not a host
    helper), calls a method on a tensor, or names a tensor by value.
    Metadata, ``len``/``isinstance`` and the syncing calls (host results)
    are not visited."""

    def __init__(self, tensors: Set[str]):
        self.tensors = tensors
        self.hit = False

    def visit_Attribute(self, node: ast.Attribute):
        if node.attr in _META_ATTRS:
            return
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call):
        if _is_sync_call(node):
            return
        func = node.func
        if isinstance(func, ast.Name) and func.id in ("len", "isinstance"):
            return
        if isinstance(func, ast.Attribute) and func.attr in _META_METHODS:
            return
        path = _attr_path(func)
        if path and path[0] == "torch":
            if len(path) < 2 or path[1] not in _TORCH_HOST:
                self.hit = True
            return
        if isinstance(func, ast.Attribute):
            # a method call: a tensor when its receiver is one
            self.visit(func.value)
        for arg in node.args:
            self.visit(arg)
        for kw in node.keywords:
            self.visit(kw.value)

    def visit_Name(self, node: ast.Name):
        if node.id in self.tensors:
            self.hit = True

    def visit_Lambda(self, node: ast.Lambda):
        return          # a function value, not a tensor


def _is_tensor(node: ast.AST, tensors: Set[str]) -> bool:
    v = _Tensorness(tensors)
    v.visit(node)
    return v.hit


def _tensor_names(node: ast.AST, tensors: Set[str]) -> Set[str]:
    """The names of ``tensors`` an expression uses by value."""
    out: Set[str] = set()

    class _Names(_Tensorness):
        def visit_Name(self, n):
            if n.id in self.tensors:
                out.add(n.id)

    _Names(tensors).visit(node)
    return out


def _targets(t: ast.AST) -> Iterable[str]:
    if isinstance(t, ast.Name):
        yield t.id
    elif isinstance(t, (ast.Tuple, ast.List)):
        for e in t.elts:
            yield from _targets(e)
    elif isinstance(t, ast.Starred):
        yield from _targets(t.value)


def _own_nodes(fn) -> Iterable[ast.AST]:
    """Nodes of ``fn``'s body excluding nested function bodies."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def _params(fn) -> Set[str]:
    a = fn.args
    names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    names += [p.arg for p in (a.vararg, a.kwarg) if p is not None]
    return set(names)


def _flow(nodes: List[ast.AST], seed: Set[str]) -> Set[str]:
    """Names assigned (transitively) from tensor expressions."""
    tensors = set(seed)
    for _ in range(4):        # a small fixpoint: assignment chains are short
        before = len(tensors)
        for node in nodes:
            if isinstance(node, ast.Assign):
                rhs, tgts = node.value, node.targets
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)) and \
                    node.value is not None:
                rhs, tgts = node.value, [node.target]
            elif isinstance(node, ast.NamedExpr):
                rhs, tgts = node.value, [node.target]
            else:
                continue
            if _is_tensor(rhs, tensors):
                for t in tgts:
                    tensors.update(_targets(t))
        if len(tensors) == before:
            break
    return tensors


def _exempt_test(test: ast.AST) -> bool:
    """``x is None`` / ``x is not None`` / ``isinstance`` are static."""
    if isinstance(test, ast.Compare) and all(
            isinstance(op, (ast.Is, ast.IsNot)) for op in test.ops):
        return True
    if isinstance(test, ast.Call):
        path = _attr_path(test.func)
        if path and path[-1] == "isinstance":
            return True
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        return _exempt_test(test.operand)
    return False


def _lint_scope(scope, nodes: List[ast.AST], tensors: Set[str], path: str,
                out: List[Finding]) -> None:
    name = getattr(scope, "name", "<module>")
    for node in nodes:
        if isinstance(node, ast.Call):
            func = node.func
            if isinstance(func, ast.Name) and func.id in _SCALARIZE \
                    and node.args and _is_tensor(node.args[0], tensors):
                out.append(Finding(
                    file=path, line=node.lineno, rule="sync-host-sync",
                    message=f"{func.id}() of a tensor in {name}() — a "
                            f"blocking device round trip; keep it on the "
                            f"device, or mark a designated sync with a "
                            f"reasoned allow pragma"))
            elif isinstance(func, ast.Attribute) and \
                    func.attr in _SYNC_METHODS and not node.args and \
                    _is_tensor(func.value, tensors):
                out.append(Finding(
                    file=path, line=node.lineno, rule="sync-host-sync",
                    message=f".{func.attr}() of a tensor in {name}() — a "
                            f"blocking device round trip"))
            else:
                p = _attr_path(func)
                if p and p[0] in _NP_ROOTS:
                    used: Set[str] = set()
                    hit = False
                    for a in list(node.args) + [k.value
                                                for k in node.keywords]:
                        used |= _tensor_names(a, tensors)
                        hit = hit or _is_tensor(a, tensors)
                    if hit:
                        out.append(Finding(
                            file=path, line=node.lineno,
                            rule="sync-numpy-on-tensor",
                            message=f"np.{'.'.join(p[1:])}() applied to a "
                                    f"tensor {sorted(used) or '(torch expr)'}"
                                    f" in {name}() — a silent host copy; "
                                    f"use torch, or cross to the host at a "
                                    f"designated sync"))
        if isinstance(node, (ast.If, ast.While, ast.IfExp)):
            test = node.test
            if not _exempt_test(test) and _is_tensor(test, tensors):
                kind = {ast.If: "if", ast.While: "while",
                        ast.IfExp: "conditional expression"}[type(node)]
                used = sorted(_tensor_names(test, tensors)) or "(torch expr)"
                out.append(Finding(
                    file=path, line=node.lineno, rule="sync-tensor-branch",
                    message=f"{kind} on a tensor {used} in {name}() — an implicit bool(), a host "
                            f"sync a CUDA graph cannot capture; use "
                            f"torch.where, or test on the host at a "
                            f"designated sync"))


def check_source(source: str, path: str) -> List[Finding]:
    """Lint one module's source; returns pragma-filtered findings."""
    allowed, findings = scan_pragmas(source, path)
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding(file=path, line=e.lineno or 1, rule="sync-host-sync",
                        message=f"unparseable module: {e.msg}")]
    out: List[Finding] = list(findings)

    def visit(scope, seed: Set[str]):
        nodes = list(_own_nodes(scope))
        tensors = _flow(nodes, seed)
        _lint_scope(scope, nodes, tensors, path, out)
        for node in nodes:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                visit(node, tensors - _params(node))
            elif isinstance(node, ast.ClassDef):
                visit(node, set())

    visit(tree, set())
    return apply_pragmas(out, allowed)


def check_tree(root: str, modules: Optional[Iterable[str]] = None
               ) -> List[Finding]:
    """Lint the hot modules under ``root`` (the ``repro_torch`` package
    directory); ``modules`` overrides :data:`HOT_MODULES`.  A listed
    module that is missing is itself a finding: the scope would shrink
    silently."""
    out: List[Finding] = []
    for rel in (HOT_MODULES if modules is None else modules):
        path = os.path.join(root, rel)
        shown = os.path.relpath(path, os.path.dirname(root))
        if not os.path.exists(path):
            out.append(Finding(file=shown, line=1, rule="meta-not-run",
                               message="hot module listed in "
                                       "sync_lint.HOT_MODULES is missing"))
            continue
        with open(path) as f:
            out.extend(check_source(f.read(), shown))
    return out
