"""CUDA resource and launch-limit check of the port's kernels.

The port of ``repro.analysis.vmem_check``.  The TPU kernels held whole
levels in VMEM, so the reference checked a capacity budget.  The CUDA
kernels stream their levels, so what can break on the card is a block's
resources (what ``nvcc -Xptxas -v`` reports at every build) and the
integer types of the launch arithmetic.  Four rules:

``cuda-smem-budget``
    a kernel's static shared memory above 48 KiB, or static plus the
    dynamic shared memory of its launch above the 227 KiB per-block
    opt-in (232,448 bytes).

``cuda-register-budget``
    registers a thread x the block's threads x its minimum blocks an SM
    (``__launch_bounds__(threads, min blocks)``; without it, the threads
    its launch site gives and one block) above the 65,536 registers of an
    SM.  Spill stores or loads are reported as warnings.

    Both read the ``ptxas info`` lines of the build log
    (``_build/<hash>/ptxas.log``, written by
    :func:`repro_torch.kernels._build.build`), per entry function, each
    matched to its ``.cu`` by the log's ``== <file>`` headers.

``cuda-launch-limits``
    for every suite graph's hierarchy,
    :func:`repro_torch.launch.roofline.hierarchy_level_triples` at ``k =
    16``: each K1-K3 launch's arithmetic must fit the types its ``.cu``
    uses, read from the source — the entry's ``int n, L, k`` arguments,
    the integer locals computed from them, the grid in the type it is
    cast to (and below the 2^31 - 1 blocks of ``gridDim.x``) and the
    block's threads.  This module owns the overflow decision: the
    wrappers in ``kernels/_launch.py`` pass the sizes through as they are.

``cuda-tile-halo``
    the sharded slab layout of
    :func:`repro_torch.solver.sharded.shard_ell_slabs` over the suite at 2
    and 4 shards (:func:`validate_shard_layout`, the reference's
    predicate).

The launch and layout rules need no card.  The ptxas rules need the
build log: on the card :func:`check_suite` builds the library and reads
its log; on the CPU it reads a log path if one is given, else its
:class:`CudaReport` lists them in ``not_run``, which is not a pass.
"""
from __future__ import annotations

import ast
import dataclasses
import functools
import os
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis.findings import SEV_WARNING, Finding

SMEM_STATIC_MAX = 48 * 1024          # static __shared__ a block
SMEM_OPTIN_MAX = 232_448             # 227 KiB: the per-block opt-in
REGS_PER_SM = 65_536
MAX_THREADS = 1024                   # threads a block
MAX_GRID_X = 2 ** 31 - 1             # gridDim.x
DEFAULT_K = 16                       # the widest bucket the service warms

CSRC = Path(__file__).resolve().parents[1] / "kernels" / "csrc"

#: K1-K3 (K2: its step and its two sweep launches): source, entry
#: function, and its arguments from a level's
#: ``(n, L, n_coarse)`` at ``k`` right-hand sides
LAUNCH_SOURCES = (
    ("spmv_ell_batched.cu", "repro_spmv_ell_batched",
     lambda n, L, nc, k: {"n": n, "L": L, "k": k}),
    ("cheby_step.cu", "repro_cheby_step",
     lambda n, L, nc, k: {"n": n, "L": L, "k": k}),
    ("cheby_smooth.cu", "repro_cheby_smooth_zero",
     lambda n, L, nc, k: {"n": n, "L": L, "k": k}),
    ("cheby_smooth.cu", "repro_cheby_prolong_step",
     lambda n, L, nc, k: {"n": n, "L": L, "k": k}),
    ("restrict_residual.cu", "repro_restrict_residual",
     lambda n, L, nc, k: {"n_coarse": nc, "L": L, "k": k}),
)

_INT_MAX = {"int": 2 ** 31 - 1, "unsigned": 2 ** 32 - 1,
            "long long": 2 ** 63 - 1, "size_t": 2 ** 64 - 1}
# what evaluating a C expression from the source can raise
_CERR = (KeyError, ValueError, SyntaxError, ZeroDivisionError)


# ---------------------------------------------------------------------------
# reading CUDA sources
# ---------------------------------------------------------------------------

def _strip_comments(text: str) -> str:
    """Comments blanked out, line numbers kept."""
    text = re.sub(r"/\*.*?\*/",
                  lambda m: re.sub(r"[^\n]", " ", m.group(0)), text,
                  flags=re.S)
    return re.sub(r"//[^\n]*", "", text)


def _c_type(decl: str) -> Optional[str]:
    """The integer type a declaration's words name, or None."""
    words = decl.replace("*", " ").split()
    words = [w for w in words if w not in ("const", "constexpr", "static",
                                           "__restrict__", "inline")]
    s = " ".join(words[:-1]) if len(words) > 1 else ""
    for t in ("unsigned long long", "long long", "size_t", "int64_t",
              "unsigned", "int", "bool", "float", "double"):
        if s == t or s.endswith(" " + t) or s.startswith(t + " "):
            return t
    return s or None


def c_eval(expr: str, env: Dict[str, int]) -> int:
    """Evaluate a C integer expression over ``env`` (casts dropped,
    ``/`` as integer division); raises ``KeyError`` or ``ValueError`` when
    it cannot."""
    e = re.sub(r"\(\s*(?:const\s+)?(?:unsigned long long|long long|"
               r"unsigned|int|size_t|int64_t|long)\s*\)", " ", expr)
    e = re.sub(r"sizeof\s*\(\s*(\w+)\s*\)", r"sizeof_\1", e)
    e = re.sub(r"\b(\d+)(?:[uUlL]+)\b", r"\1", e)
    e = e.replace(".", "_")
    node = ast.parse(e.strip(), mode="eval").body

    def ev(n):
        if isinstance(n, ast.Constant) and isinstance(n.value, int):
            return n.value
        if isinstance(n, ast.Name):
            return env[n.id]
        if isinstance(n, ast.UnaryOp) and isinstance(n.op, ast.USub):
            return -ev(n.operand)
        if isinstance(n, ast.BinOp):
            a, b = ev(n.left), ev(n.right)
            ops = {ast.Add: lambda: a + b, ast.Sub: lambda: a - b,
                   ast.Mult: lambda: a * b, ast.Div: lambda: a // b,
                   ast.FloorDiv: lambda: a // b, ast.Mod: lambda: a % b,
                   ast.LShift: lambda: a << b, ast.RShift: lambda: a >> b}
            if type(n.op) in ops:
                return ops[type(n.op)]()
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Name) and \
                n.func.id in ("min", "max"):
            return {"min": min, "max": max}[n.func.id](
                *(ev(a) for a in n.args))
        raise ValueError(f"cannot evaluate {expr!r}")

    return ev(node)


@dataclasses.dataclass
class CFunction:
    """One function of a CUDA source: name, return type, parameters
    ``{name: declared text}``, body and first line; kernels also carry
    their template parameters and ``__launch_bounds__`` arguments."""

    name: str
    ret: str
    params: Dict[str, str]
    body: str
    line: int
    body_line: int = 0       # the line the body starts on (its ``{``)
    kernel: bool = False
    template: Tuple[str, ...] = ()
    launch_bounds: Tuple[str, ...] = ()


_FN_RE = re.compile(
    r"(?:template\s*<(?P<tpl>[^<>]*)>\s*)?"
    r"(?P<head>(?:extern\s+\"C\"\s+)?(?:(?:__global__|__device__|"
    r"__forceinline__|inline|static|__host__)\s+)*)"
    r"(?P<ret>[A-Za-z_][\w]*(?:\s+[A-Za-z_][\w]*)*\s*\**)\s+"
    r"(?:__launch_bounds__\((?P<lb>[^()]*)\)\s*)?"
    r"(?P<name>[A-Za-z_]\w*)\s*\((?P<params>[^()]*)\)\s*\{")


_KEYWORDS = {"if", "else", "for", "while", "switch", "return", "do",
             "case", "struct", "class", "constexpr", "__forceinline__"}


def _split_top(text: str) -> List[str]:
    """Split at the commas outside parentheses and angle brackets."""
    out, depth, cur = [], 0, []
    for ch in text:
        if ch in "(<[":
            depth += 1
        elif ch in ")>]":
            depth -= 1
        if ch == "," and depth == 0:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if "".join(cur).strip():
        out.append("".join(cur))
    return [s.strip() for s in out]


@functools.lru_cache(maxsize=None)
def read_source(path: str) -> Tuple[Dict[str, int], Tuple[CFunction, ...]]:
    """``(constants, functions)`` of a ``.cu`` file:
    the file's named integer constants (``constexpr``/``const`` with a
    value computable from earlier ones) and every function definition."""
    with open(path) as f:
        text = _strip_comments(f.read())
    consts: Dict[str, int] = {}
    for m in re.finditer(r"(?:constexpr|const)\s+(?:unsigned\s+long\s+long|"
                         r"long\s+long|unsigned|int|size_t)\s+(\w+)\s*="
                         r"\s*([^;{}]+);", text):
        try:
            consts.setdefault(m.group(1), c_eval(m.group(2), consts))
        except _CERR:
            pass
    fns = []
    for m in _FN_RE.finditer(text):
        if {m.group("name"), m.group("ret").split()[0]} & _KEYWORDS:
            continue
        depth, i = 0, m.end() - 1
        while i < len(text):
            depth += {"{": 1, "}": -1}.get(text[i], 0)
            if depth == 0:
                break
            i += 1
        params = {}
        for p in _split_top(m.group("params")):
            words = p.replace("*", " * ").split()
            if words and words != ["void"]:
                params[words[-1]] = p
        tpl = tuple(_split_top(m.group("tpl") or ""))
        fns.append(CFunction(
            name=m.group("name"), ret=m.group("ret").strip(), params=params,
            body=text[m.end():i], line=text.count("\n", 0, m.start()) + 1,
            body_line=text.count("\n", 0, m.end()) + 1,
            kernel="__global__" in m.group("head"),
            template=tpl,
            launch_bounds=tuple(_split_top(m.group("lb") or ""))))
    return consts, tuple(fns)


def _locals(fn: CFunction) -> List[Tuple[str, str, str, int]]:
    """``(type, name, initializer, line)`` of the function's initialized
    integer locals, in order (``for`` loop variables included)."""
    return [(re.sub(r"\s+", " ", m.group(1)), m.group(2), m.group(3),
             fn.body_line + fn.body.count("\n", 0, m.start()))
            for m in re.finditer(
                r"(?:const\s+|constexpr\s+)?(unsigned\s+long\s+long|"
                r"long\s+long|unsigned|int|size_t|int64_t)\s+(\w+)\s*="
                r"\s*([^;]+);", fn.body)]


def _scope(fn: CFunction, consts: Dict[str, int], values: Dict[str, int]):
    """``(env, decls)`` of a function: the values it can name (the file's
    constants, the level's values of its arguments and its evaluable
    locals) and each name's declaration text."""
    env = dict(consts)
    env.update({p: values[p] for p in fn.params if p in values})
    decls = dict(fn.params)
    for t, v, init, _ in _locals(fn):
        decls[v] = f"{t} {v}"
        try:
            env[v] = c_eval(init, env)
        except _CERR:
            env.pop(v, None)
    return env, decls


# ---------------------------------------------------------------------------
# cuda-launch-limits
# ---------------------------------------------------------------------------

def check_launch_source(path: str, entry: str, values: Dict[str, int],
                        where: str) -> List[Finding]:
    """``cuda-launch-limits`` of one ``.cu`` file: ``entry`` is its C
    entry point and ``values`` the level's value of each of its integer
    arguments."""
    consts, fns = read_source(path)
    shown = f"repro_torch/kernels/csrc/{os.path.basename(path)}"
    out: List[Finding] = []

    def bad(line, msg):
        out.append(Finding(file=shown, line=line, rule="cuda-launch-limits",
                           message=f"{msg} ({where})"))

    by_name = {f.name: f for f in fns}
    ent = by_name.get(entry)
    if ent is None:
        bad(1, f"entry function {entry} not found")
        return out
    for arg, v in values.items():
        t = _c_type(ent.params.get(arg, ""))
        if t not in _INT_MAX:
            bad(ent.line, f"{entry} has no integer argument {arg!r}")
        elif v > _INT_MAX[t]:
            bad(ent.line, f"{arg} = {v} does not fit {entry}'s `{t} {arg}`"
                          f" (at most {_INT_MAX[t]}): widen the argument "
                          f"to long long, or route this level elsewhere")
    for fn in fns:
        env, decls = _scope(fn, consts, values)
        for t, v, init, line in _locals(fn):
            if v in env and t in _INT_MAX and env[v] > _INT_MAX[t]:
                bad(line, f"{fn.name}: local `{t} {v} = {init.strip()}` is "
                          f"{env[v]}, above its type's {_INT_MAX[t]}: "
                          f"widen it to long long")
        _launch_sites(fn, by_name, env, decls, bad)
    return out


def _launch_sites(fn, by_name, env, decls, bad) -> None:
    """Check every ``<<<grid, block, ...>>>`` in ``fn``: the grid against
    the type it is formed in and ``gridDim.x``, the block against 1024
    threads."""
    for m in re.finditer(r"(\w+)\s*(?:<[^<>;]*>)?\s*<<<(.*?)>>>", fn.body,
                         flags=re.S):
        kernel = m.group(1)
        cfg = _split_top(m.group(2))
        grid, block = cfg[0], cfg[1]
        line = fn.body_line + fn.body.count("\n", 0, m.start())
        cast = re.match(r"\(\s*(unsigned|int|long long)\s*\)\s*(.+)$", grid,
                        flags=re.S)
        call = re.match(r"(\w+)\s*\((.*)\)$", grid, flags=re.S)
        try:
            if cast:
                gtype, gval = cast.group(1), c_eval(cast.group(2), env)
            elif call and call.group(1) in by_name:
                f = by_name[call.group(1)]
                ret = re.search(r"return\s+([^;]+);", f.body).group(1)
                (param,) = f.params
                gtype = _c_type(f.ret + " x") or f.ret
                gval = c_eval(ret, {**env, param: c_eval(call.group(2),
                                                         env)})
            else:
                gtype = _c_type(decls.get(grid, "int x")) or "int"
                gval = c_eval(grid, env)
            threads = c_eval(block, env)
        except _CERR + (AttributeError,):
            bad(line, f"cannot evaluate the launch of {kernel} "
                      f"(<<<{grid}, {block}>>>) from the source: name the "
                      f"grid's and block's values in the launching function")
            continue
        if gval > _INT_MAX.get(gtype, MAX_GRID_X):
            bad(line, f"{kernel}: the grid of {gval} blocks overflows its "
                      f"`{gtype}`: compute it in a wider type")
        if gval > MAX_GRID_X:
            bad(line, f"{kernel}: {gval} blocks exceed gridDim.x's "
                      f"{MAX_GRID_X}: more work a thread, or a 2-D grid")
        if threads > MAX_THREADS:
            bad(line, f"{kernel}: {threads} threads a block exceed "
                      f"{MAX_THREADS}")


def check_level_triples(triples: Sequence[Tuple[int, int, int]], *,
                        k: int = DEFAULT_K, graph: str = "<synthetic>",
                        csrc: Path = CSRC) -> List[Finding]:
    """Hold every level's K1-K3 launch arithmetic to the types of their
    sources; injectable ``triples`` so that a planted oversized level can
    be checked without building it."""
    out: List[Finding] = []
    for i, (n, L, nc) in enumerate(triples):
        where = (f"level {i} of graph '{graph}': n={n}, L={L}, "
                 f"n_coarse={nc}, k={k}")
        for src, entry, values in LAUNCH_SOURCES:
            out.extend(check_launch_source(str(csrc / src), entry,
                                        values(n, L, nc, k), where))
    return out


# ---------------------------------------------------------------------------
# ptxas resources: cuda-smem-budget, cuda-register-budget
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class KernelResources:
    """What ``ptxas -v`` reported for one entry function."""

    source: str
    mangled: str
    name: str                 # demangled base name
    template_args: Tuple
    registers: int = 0
    smem: int = 0
    stack: int = 0
    spill_stores: int = 0
    spill_loads: int = 0


def demangle(mangled: str) -> Tuple[str, Tuple]:
    """``(name, template args)`` of an Itanium-mangled function: its last
    name component and its integer/bool template arguments (``None`` for
    a type argument), e.g. ``_Z21restrict_residual_vecILi3EEv...`` ->
    ``("restrict_residual_vec", (3,))``."""
    s = mangled
    if not s.startswith("_Z"):
        return s, ()
    i = 2
    nested = s[i] == "N"
    i += nested
    name = ""
    while i < len(s) and s[i].isdigit():
        j = i
        while s[j].isdigit():
            j += 1
        ln = int(s[i:j])
        name = s[j:j + ln]
        i = j + ln
        if not nested:
            break
    args: List = []
    if i < len(s) and s[i] == "I":
        i += 1
        while i < len(s) and s[i] != "E":
            if s[i] == "L":
                j = s.index("E", i)
                lit = s[i + 2:j]
                val = -int(lit[1:]) if lit.startswith("n") else int(lit)
                args.append(val)
                i = j + 1
            elif s[i].isdigit():
                j = i
                while s[j].isdigit():
                    j += 1
                i = j + int(s[i:j])
                args.append(None)
            else:
                i += 1
                args.append(None)
    return name, tuple(args)


def parse_ptxas_log(text: str) -> List[KernelResources]:
    """Every entry function of a build log (``== <file>`` headers, then
    ``nvcc -Xptxas -v`` output): its registers, static shared memory,
    stack and spills."""
    out: Dict[str, KernelResources] = {}
    source, current, props = "", None, None
    for line in text.splitlines():
        m = re.match(r"==\s*(\S+)", line)
        if m:
            source = m.group(1)
            continue
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, targs = demangle(m.group(1))
            current = out.setdefault(m.group(1), KernelResources(
                source, m.group(1), name, targs))
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = out.get(m.group(1))
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and props is not None:
            props.stack, props.spill_stores, props.spill_loads = map(
                int, m.groups())
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and current is not None:
            current.registers = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            current.smem = int(s.group(1)) if s else 0
    return list(out.values())


def _block_shape(res: KernelResources, csrc: Path):
    """``(threads, min blocks, dynamic smem, how known, line)`` of a
    kernel from its source: ``__launch_bounds__`` with the template
    arguments bound, else its launch site's block and one block; unknown:
    1024 threads."""
    path = csrc / res.source
    if not path.exists():
        return MAX_THREADS, 1, 0, "source not found: 1024 threads assumed", 1
    consts, fns = read_source(str(path))
    kern = next((f for f in fns if f.kernel and f.name == res.name), None)
    line = kern.line if kern is not None else 1
    env = dict(consts)
    if kern is not None:
        names = [p.split()[-1] for p in kern.template]
        env.update({n: a for n, a in zip(names, res.template_args)
                    if a is not None})
        if kern.launch_bounds:
            try:
                vals = [c_eval(x, env) for x in kern.launch_bounds]
                return vals[0], (vals[1] if len(vals) > 1 else 1), 0, \
                    "__launch_bounds__", line
            except _CERR:
                pass
    for fn in fns:
        m = re.search(rf"\b{re.escape(res.name)}\s*(?:<[^<>;]*>)?\s*<<<"
                      rf"(.*?)>>>", fn.body, flags=re.S)
        if m:
            cfg = _split_top(m.group(1))
            local = _scope(fn, env, {})[0]
            try:
                dyn = c_eval(cfg[2], local) if len(cfg) > 2 else 0
                return c_eval(cfg[1], local), 1, dyn, "launch site", line
            except _CERR:
                break
    return MAX_THREADS, 1, 0, "no launch bounds or launch site: 1024 " \
                              "threads assumed", line


def check_ptxas(text: str, csrc: Path = CSRC
                ) -> Tuple[List[Finding], List[KernelResources]]:
    """The two ptxas rules over a build log; also returns what it read."""
    kernels = parse_ptxas_log(text)
    out: List[Finding] = []
    for r in kernels:
        shown = f"repro_torch/kernels/csrc/{r.source}"
        label = r.name + ("<" + ", ".join(
            "T" if a is None else str(a) for a in r.template_args) + ">"
            if r.template_args else "")
        threads, blocks, dyn, how, line = _block_shape(r, csrc)
        if r.smem > SMEM_STATIC_MAX:
            out.append(Finding(
                file=shown, line=line, rule="cuda-smem-budget",
                message=f"{label}: {r.smem} bytes of static shared memory, "
                        f"above the {SMEM_STATIC_MAX} a block can declare "
                        f"statically: move it to dynamic shared memory "
                        f"with the opt-in attribute"))
        if r.smem + dyn > SMEM_OPTIN_MAX:
            out.append(Finding(
                file=shown, line=line, rule="cuda-smem-budget",
                message=f"{label}: {r.smem} static + {dyn} dynamic bytes of "
                        f"shared memory, above the {SMEM_OPTIN_MAX}-byte "
                        f"per-block opt-in: smaller tiles"))
        need = r.registers * threads * blocks
        if need > REGS_PER_SM:
            out.append(Finding(
                file=shown, line=line, rule="cuda-register-budget",
                message=f"{label}: {r.registers} registers x {threads} "
                        f"threads x {blocks} blocks ({how}) = {need}, above "
                        f"the {REGS_PER_SM} registers of an SM: cap the "
                        f"registers or shrink the block"))
        if r.spill_stores or r.spill_loads:
            out.append(Finding(
                file=shown, line=line, rule="cuda-register-budget",
                severity=SEV_WARNING,
                message=f"{label}: {r.spill_stores} bytes of spill stores "
                        f"and {r.spill_loads} of spill loads: registers "
                        f"spill to local memory"))
    return out, kernels


# ---------------------------------------------------------------------------
# cuda-tile-halo (the reference's predicate, unchanged)
# ---------------------------------------------------------------------------

def validate_shard_layout(*, n_pad: int, n_loc: int, n_sh: int,
                          halo, idx) -> List[str]:
    """Pure layout predicate, the fixture-test entry point.

    ``halo``: ``[n_sh, H]`` global row ids each shard gathers;
    ``idx``: ``[n_pad, L]`` local column coordinates into the
    ``n_loc + H`` extended local vector."""
    problems: List[str] = []
    if n_pad % n_sh != 0:
        problems.append(
            f"padded row count {n_pad} not divisible by shard count "
            f"{n_sh}")
    if n_loc * n_sh != n_pad:
        problems.append(
            f"local rows {n_loc} * shards {n_sh} != padded rows {n_pad}")
    H = int(halo.shape[1]) if getattr(halo, "ndim", 0) == 2 else 0
    if (halo < 0).any() or (halo >= max(n_pad, 1)).any():
        problems.append(
            f"halo ids outside [0, {n_pad}) — the all-gather would "
            f"index out of range")
    ext = n_loc + H
    if (idx < 0).any() or (idx >= ext).any():
        problems.append(
            f"local ELL coordinates outside the extended width "
            f"{ext} (= n_loc {n_loc} + halo {H}) — the local gather "
            f"would read past the staged halo")
    return problems


def check_shard_layout(idx, val, graph: str) -> List[Finding]:
    """:func:`validate_shard_layout` of ``shard_ell_slabs`` at 2 and 4
    shards."""
    from repro_torch.solver.sharded import shard_ell_slabs

    out: List[Finding] = []
    n = int(idx.shape[0])
    for n_sh in (2, 4):
        if n < n_sh:
            continue
        slab, meta = shard_ell_slabs(idx, val, n_sh)
        halo = slab.halo.cpu().numpy().reshape(n_sh, int(meta.halo))
        for msg in validate_shard_layout(
                n_pad=int(meta.n_pad), n_loc=int(meta.n_loc), n_sh=n_sh,
                halo=halo, idx=slab.idx.cpu().numpy()):
            out.append(Finding(
                file="repro_torch/solver/sharded.py", line=1,
                rule="cuda-tile-halo",
                message=f"{msg} (graph '{graph}', n_sh={n_sh})"))
    return out


# ---------------------------------------------------------------------------
# the suite
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _suite():
    """The reference's capacity-check suite: the solver bench's shapes
    plus the hub topology whose star levels stress the ELL width."""
    from repro_torch.core.graph import (barabasi_albert, grid2d, mesh2d,
                                        star_hub)
    return (
        ("mesh2d-16x16", mesh2d(16, 16, seed=0)),
        ("grid2d-20x20", grid2d(20, 20, seed=0)),
        ("ba-300", barabasi_albert(300, 3, seed=1)),
        ("star-200", star_hub(200, extra=64, seed=2)),
    )


def ptxas_log_path() -> Path:
    """Where the build writes its log: ``_build/<hash>/ptxas.log``."""
    from repro_torch.kernels import _build
    return _build.BUILD_ROOT / _build.source_hash() / _build.PTXAS_LOG


@dataclasses.dataclass
class CudaReport:
    """What :func:`check_suite` found and what it could not check:
    ``not_run`` holds the ids of rules that did not run (not a pass),
    ``kernels`` the :class:`KernelResources` the ptxas rules read."""

    findings: List[Finding]
    not_run: List[str]
    kernels: List[KernelResources]


def check_suite(*, device="cuda", k: int = DEFAULT_K,
                ptxas_log: Optional[str] = None) -> CudaReport:
    """All four rules.  The suite's hierarchies are built on the CPU (the
    launch and layout rules are arithmetic).  The ptxas rules read
    ``ptxas_log``; without one, on a CUDA device they build the library
    and read its log (missing: a ``meta-not-run`` error), and on the CPU
    they do not run and are listed in the report's ``not_run``."""
    import torch

    from repro_torch.launch.roofline import hierarchy_level_triples
    from repro_torch.solver.device_pcg import ell_laplacian
    from repro_torch.solver.hierarchy import build_hierarchy

    out: List[Finding] = []
    report = CudaReport(out, [], [])
    for name, g in _suite():
        hier = build_hierarchy(g, coarse_n=32, device="cpu")
        out.extend(check_level_triples(hierarchy_level_triples(hier), k=k,
                                       graph=name))
        idx, val = ell_laplacian(g, device="cpu")
        out.extend(check_level_triples([(g.n, int(idx.shape[1]), 0)], k=k,
                                       graph=name + " (top operator)"))
        out.extend(check_shard_layout(idx, val, name))

    log = ptxas_log
    if log is None and torch.device(device).type == "cuda":
        from repro_torch.kernels import _build
        try:
            _build.library()
            log = str(ptxas_log_path())
        except (RuntimeError, OSError) as e:
            out.append(Finding(file="repro_torch/kernels/_build.py", line=1,
                               rule="meta-not-run",
                               message=f"the ptxas rules need the kernel "
                                       f"build on the card: {e}"))
            return report
    if log is None:
        report.not_run.extend(["cuda-smem-budget", "cuda-register-budget"])
        return report
    if not os.path.exists(log):
        out.append(Finding(file=str(log), line=1, rule="meta-not-run",
                           message="the ptxas log is missing: the ptxas "
                                   "rules cannot run"))
        return report
    with open(log) as f:
        found, report.kernels = check_ptxas(f.read())
    if not report.kernels:
        out.append(Finding(file=str(log), line=1, rule="meta-not-run",
                           message="the ptxas log names no entry function"))
    out.extend(found)
    return report
