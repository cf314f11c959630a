"""The port's checkers (repro_torch.analysis) against the reference's on
the same fixtures, and over the port's own tree.

* The lock checker: the fixtures of ``tests/test_analysis.py``'s lock
  cases give the port the reference's findings, field for field; over
  ``src/repro_torch`` it reports zero findings, and the inventories it
  reads are there.
* The sync lint, the dispatch audit and the CUDA check: planted fixtures
  mirroring ``tests/test_analysis.py``, one rule each, each asserting
  exactly that rule; the reference's shard-layout fixture gives the
  reference's problem list; the designated sync of the solve loop is
  reported without its pragmas and clean with them.
* The real tree: the sync, lock and CUDA checks report nothing on the
  CPU (the ptxas rules are listed as not run), the six registry entries
  audit clean on the CPU, and the CLI writes its artifact.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import warnings

import pytest

import numpy as np
import torch

from repro.analysis import findings as jfindings  # noqa: E402
from repro.analysis import lock_lint as jlock_lint  # noqa: E402
from repro.analysis import vmem_check as jvmem_check  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch.analysis import CHECKS, run_checks  # noqa: E402
from repro_torch.analysis import (cuda_check, dispatch_audit,  # noqa: E402
                                  findings, lock_lint, sync_lint)
from repro_torch.analysis.registry import HOT_ENTRIES  # noqa: E402

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
    assert set(ref) == {"lock-unguarded-field", "lock-unlocked-call",
                        "meta-bare-allow"}
    for rid, rule in ref.items():
        assert dataclasses.asdict(mine[rid]) == dataclasses.asdict(rule)
    assert set(mine) - set(ref) == {
        "sync-host-sync", "sync-numpy-on-tensor", "sync-tensor-branch",
        "audit-host-transfer", "audit-loop-transfer", "audit-f64-promotion",
        "audit-structure-hazard", "cuda-smem-budget", "cuda-register-budget",
        "cuda-launch-limits", "cuda-tile-halo", "meta-not-run"}
    assert {r.checker for r in findings.RULES} == \
        {"audit", "sync", "locks", "cuda", "meta"}
    assert findings.RULE_IDS == frozenset(mine)
    assert CHECKS == ("audit", "sync", "locks", "cuda")


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


def _rules_of(fs):
    return sorted({f.rule for f in fs})


# ---------------------------------------------------------------------------
# sync lint: planted fixtures, one rule each
# ---------------------------------------------------------------------------

FIXTURE_ITEM = textwrap.dedent('''\
    import torch

    def solve(b):
        r = torch.linalg.vector_norm(b)
        scale = r.item()          # line 5: the violation
        return b / scale
''')


@pytest.mark.parametrize("source,rule,line,word", [
    (FIXTURE_ITEM, "sync-host-sync", 5, ".item()"),
    (textwrap.dedent('''\
        import torch

        def step(x):
            y = torch.abs(x).sum()
            if y > 0:              # line 5: a branch on a tensor
                return x
            return -x
    '''), "sync-tensor-branch", 5, "if on a tensor"),
    (textwrap.dedent('''\
        import numpy as np
        import torch

        def host(x):
            y = torch.cumsum(x, 0)
            return np.max(y)       # line 6: numpy on a tensor
    '''), "sync-numpy-on-tensor", 6, "np.max()"),
], ids=["item", "branch", "numpy"])
def test_sync_fixture_fires_exactly_its_rule(source, rule, line, word):
    fs = sync_lint.check_source(source, "fix.py")
    assert _rules_of(fs) == [rule]
    (f,) = fs
    assert (f.file, f.line) == ("fix.py", line) and word in f.message


def test_sync_lint_exemptions_stay_quiet():
    src = textwrap.dedent('''\
        import torch

        def ok(x, n: int, scale):
            k = x.shape[1]
            if k % 4 == 0 and x.dim() == 2 and x.numel():
                pass
            if x.device.type == "cuda" or x is None or isinstance(x, int):
                pass
            h = x.sum().tolist()   # analysis: allow(sync-host-sync): ok
            if h[0] > 0:           # a host value since the sync
                pass
            return int(n), float(scale), len(x)
    ''')
    assert sync_lint.check_source(src, "ok.py") == []


def test_comment_line_pragma_applies_to_the_next_code_line():
    src = textwrap.dedent('''\
        import torch

        def f(x):
            y = torch.sum(x)
            # analysis: allow(sync-host-sync): planted, and reasoned
            # a second comment line of the run
            return float(y)        # line 7
    ''')
    allowed, fs = findings.scan_pragmas(src, "p.py")
    assert allowed == {7: {"sync-host-sync"}} and fs == []
    assert sync_lint.check_source(src, "p.py") == []
    # a blank line ends the run: the pragma covers nothing below it
    stray = src.replace("    # a second comment line of the run\n", "\n")
    allowed, fs = findings.scan_pragmas(stray, "p.py")
    assert allowed == {} and fs == []
    assert [(f.line, f.rule) for f in sync_lint.check_source(
        stray, "p.py")] == [(7, "sync-host-sync")]


def _designated_sync(src):
    """Line of the solve loop's designated sync, and ``src`` without the
    allow pragmas of the lines above it."""
    lines = src.splitlines()
    (at,) = [i for i, t in enumerate(lines)
             if t.strip().startswith("busy = bool(")]
    j = at
    while lines[j - 1].strip().startswith("# analysis: allow("):
        j -= 1
    assert at - j == 3
    return at - 3 + 1, "\n".join(lines[:j] + lines[at:]) + "\n"


def test_designated_sync_is_reported_without_its_pragmas():
    path = os.path.join(PORT_ROOT, "solver", "device_pcg.py")
    with open(path) as f:
        src = f.read()
    line, stripped = _designated_sync(src)
    fs = sync_lint.check_source(stripped, "device_pcg.py")
    assert [(f.line, f.rule) for f in fs] == [(line, "sync-host-sync")]
    assert "bool()" in fs[0].message
    assert not [f for f in sync_lint.check_source(src, "device_pcg.py")]

    # the audit sees it too, through the spectral plane's PCG entry: the
    # site grows by one transfer every _PCG_CHECK_EVERY trips
    entry = {e.name: e for e in HOT_ENTRIES}["harmonic_pcg"]
    rel = "repro_torch/solver/device_pcg.py"
    rep = dispatch_audit.audit_entry(
        entry, "cpu", source=lambda p: stripped if p == rel else
        open(os.path.join(os.path.dirname(PORT_ROOT), p)).read())
    got = {(f.file, f.line, f.rule) for f in rep.findings}
    assert got == {(rel, line + 3, "audit-host-transfer"),
                   (rel, line + 3, "audit-loop-transfer")}
    assert rep.transfers_per_trip == 1 / 8
    assert dispatch_audit.audit_entry(entry, "cpu").findings == []


# ---------------------------------------------------------------------------
# dispatch audit: planted fixtures, one rule each
# ---------------------------------------------------------------------------

def _f64_accumulate(x):
    acc = x.to(torch.float64) * 2.0          # widens to float64
    return acc.to(torch.float32)


def _item_in_loop(x, tol, maxiter):
    for _ in range(maxiter):
        # analysis: allow(audit-host-transfer): planted, once a call it says
        x = x * float(x.sum().item() > tol)
    return x


def _width_branch(x):
    if x.shape[1] % 2 == 0:                  # structure differs in a bucket
        return x * 2.0
    return x + torch.sum(x)


@pytest.mark.parametrize("name,fn,args,sibling,trips_arg,rule", [
    ("planted_f64", _f64_accumulate, (torch.ones(8),), None, None,
     "audit-f64-promotion"),
    ("planted_loop", _item_in_loop, (torch.ones(4), 0.0, 16), None, 2,
     "audit-loop-transfer"),
    ("planted_bucket", _width_branch, (torch.ones(4, 6),),
     (torch.ones(4, 7),), None, "audit-structure-hazard"),
], ids=["f64", "loop", "bucket"])
def test_audit_fixture_fires_exactly_its_rule(name, fn, args, sibling,
                                              trips_arg, rule):
    rep = dispatch_audit.audit_callable(name, fn, args, sibling,
                                        trips_arg=trips_arg)
    assert _rules_of(rep.findings) == [rule]
    f = rep.findings[0]
    if rule != "audit-structure-hazard":
        assert f.file == os.path.abspath(__file__) and f.line > 0
    if rule == "audit-loop-transfer":
        assert rep.transfers_per_trip == 1.0 and "1 host transfer" in \
            f.message


def test_audit_reports_a_host_transfer_and_an_entry_that_cannot_run():
    rep = dispatch_audit.audit_callable(
        "planted_item", lambda x: x / x.sum().item(), (torch.ones(3),))
    assert _rules_of(rep.findings) == ["audit-host-transfer"]
    assert "_local_scalar_dense" in rep.findings[0].message

    def broken(device):
        raise RuntimeError("no such graph")

    bad = dispatch_audit.HotEntry("planted_broken", "fixture", broken)
    fs = dispatch_audit.audit_entry(bad, "cpu").findings
    assert _rules_of(fs) == ["meta-not-run"]


def _warns_like_the_card(x):
    # the warning PyTorch raises at a synchronizing call under
    # torch.cuda.set_sync_debug_mode("warn"), raised here by hand
    warnings.warn("called a synchronizing CUDA operation")  # the site
    return x + 1.0


def test_audit_hook_locates_a_sync_warning():
    """The ``showwarning`` hook is the half of the audit that sees syncs
    the dispatch mode cannot: a planted sync warning is a host transfer at
    the line that raised it, and nothing else."""
    with warnings.catch_warnings():      # the audit's unrecorded warm-up
        warnings.simplefilter("ignore")
        rep = dispatch_audit.audit_callable("planted_warning",
                                            _warns_like_the_card,
                                            (torch.ones(3),))
    assert _rules_of(rep.findings) == ["audit-host-transfer"]
    (f,) = rep.findings
    with open(__file__) as src:
        (line,) = [i for i, t in enumerate(src, start=1)
                   if t.rstrip().endswith("# the site")]
    assert (f.file, f.line) == (os.path.abspath(__file__), line)
    assert "a CUDA sync warning" in f.message and rep.transfers == 1


def test_audit_takes_its_device_from_the_arguments():
    assert dispatch_audit.device_of((torch.ones(2), 3, [torch.ones(1)])) \
        == torch.device("cpu")
    with pytest.raises(ValueError, match="no tensor argument"):
        dispatch_audit.device_of((1, 2.0))


@pytest.mark.parametrize("entry", HOT_ENTRIES, ids=lambda e: e.name)
def test_registry_entry_audits_clean_on_the_cpu(entry):
    rep = dispatch_audit.audit_entry(entry, "cpu")
    assert rep.findings == [], [f.format() for f in rep.findings]
    assert rep.ops > 0
    if entry.trips_arg is not None:
        # the designated test of "all done", once every 8 trips
        assert rep.transfers_per_trip == 1 / 8
        assert rep.ops_per_trip > 0
    if entry.name == "batched_pcg":
        # the trip cap read once, and the designated test at 8 and 16 of
        # the 16 trips (the card adds the trip caps' copy to the device)
        assert rep.transfers == 3


def test_registry_holds_the_six_entries():
    assert [e.name for e in HOT_ENTRIES] == [
        "batched_pcg", "vcycle_plain", "vcycle_fused", "sharded_solver",
        "device_contraction", "harmonic_pcg"]
    assert all(e.declared_dtype == "float32" for e in HOT_ENTRIES)


# ---------------------------------------------------------------------------
# CUDA check: planted fixtures, the reference's layout fixture
# ---------------------------------------------------------------------------

def test_oversized_level_breaks_the_launch_limits():
    fs = cuda_check.check_level_triples([(2 ** 31, 8, 500_000)], k=16,
                                        graph="planted")
    assert _rules_of(fs) == ["cuda-launch-limits"]
    assert {os.path.basename(f.file) for f in fs} == {
        "spmv_ell_batched.cu", "cheby_step.cu", "cheby_smooth.cu"}
    assert all("widen" in f.message and "int n" in f.message for f in fs)
    # a realistic level is within every limit
    assert cuda_check.check_level_triples([(2 ** 20, 7, 397_553)]) == []


def test_launch_limits_read_the_types_from_the_source(tmp_path):
    cu = tmp_path / "planted.cu"
    cu.write_text(textwrap.dedent('''\
        __global__ void kern(const int* idx, float* y, int n, int k) {
          long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
          if (t >= (long long)n * k) return;
          y[t] = idx[t];
        }
        extern "C" int repro_planted(const void* idx, void* y, int n, int k,
                                     void* stream) {
          int total = n * k;
          const int threads = 256;
          int blocks = (total + threads - 1) / threads;
          kern<<<blocks, threads, 0, (cudaStream_t)stream>>>(
              (const int*)idx, (float*)y, n, k);
          return 0;
        }
    '''))
    small = cuda_check.check_launch_source(str(cu), "repro_planted",
                                           {"n": 1000, "k": 16}, "small")
    assert small == []
    big = cuda_check.check_launch_source(str(cu), "repro_planted",
                                         {"n": 2 ** 28, "k": 16}, "big")
    assert _rules_of(big) == ["cuda-launch-limits"]
    assert {f.line for f in big} == {8}
    assert any("`int total = n * k` is 4294967296" in f.message
               for f in big)


PTXAS_SMEM = """== spmv_ell_batched.cu
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z23spmv_ell_batched_kernelPKiPKfS2_Pfiii' for 'sm_90a'
ptxas info    : Function properties for _Z23spmv_ell_batched_kernelPKiPKfS2_Pfiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 16 registers, used 0 barriers, 61440 bytes smem, 380 bytes cmem[0]
"""


@pytest.mark.parametrize("log,rule,severity", [
    (PTXAS_SMEM, "cuda-smem-budget", "error"),
    (PTXAS_SMEM.replace("61440 bytes smem, ", "").replace(
        "0 bytes spill stores, 0 bytes spill loads",
        "24 bytes spill stores, 24 bytes spill loads"),
     "cuda-register-budget", "warning"),
], ids=["smem", "spills"])
def test_ptxas_fixture_fires_exactly_its_rule(log, rule, severity):
    fs, kernels = cuda_check.check_ptxas(log)
    assert _rules_of(fs) == [rule]
    (f,) = fs
    assert f.severity == severity
    assert f.file == "repro_torch/kernels/csrc/spmv_ell_batched.cu"
    (k,) = kernels
    assert (k.name, k.registers) == ("spmv_ell_batched_kernel", 16)


def test_ptxas_register_budget_reads_the_launch_bounds():
    """ssm_scan_kernel<16, 2, ...> carries __launch_bounds__(kThreads,
    2 * LANES) = (128, 4): 128 registers fit an SM, 130 do not."""
    mangled = ("_Z15ssm_scan_kernelILi16ELi2ELi32E13__nv_bfloat16Lb1EEvPKT2_"
               "S3_S3_S3_xxxxPKfS5_PfS6_ii")
    assert cuda_check.demangle(mangled) == \
        ("ssm_scan_kernel", (16, 2, 32, None, 1))
    assert cuda_check.demangle("_ZN12_GLOBAL__N_121restrict_residual_vecILi3"
                               "EEEvPK4int4") == ("restrict_residual_vec",
                                                  (3,))
    log = (f"== ssm_scan.cu\nptxas info    : Compiling entry function "
           f"'{mangled}' for 'sm_90a'\nptxas info    : Used {{}} registers, "
           f"40000 bytes smem, 456 bytes cmem[0]\n")
    assert cuda_check.check_ptxas(log.format(128))[0] == []
    fs = cuda_check.check_ptxas(log.format(130))[0]
    assert _rules_of(fs) == ["cuda-register-budget"]
    assert "130 registers x 128 threads x 4 blocks" in fs[0].message


def test_ptxas_register_budget_reads_k6b_template_launch_bounds():
    """ssm_scan_bwd_kernel<16, bf16> carries __launch_bounds__(kCh * NS /
    kSpl, 512 / kCh * kSpl / NS) = (256, 2), both read from the source's
    constants with the state bound: 128 registers fit an SM, 130 do
    not."""
    mangled = ("_ZN12_GLOBAL__N_119ssm_scan_bwd_kernelILi16E13__nv_bfloat16"
               "EEvPKT0_S4_S4_S4_xxxxPKfS6_S6_S6_S6_PfS7_S7_S7_S7_iii")
    assert cuda_check.demangle(mangled) == \
        ("ssm_scan_bwd_kernel", (16, None))
    log = (f"== ssm_scan_bwd.cu\nptxas info    : Compiling entry function "
           f"'{mangled}' for 'sm_90a'\nptxas info    : Used {{}} registers, "
           f"456 bytes cmem[0]\n")
    assert cuda_check.check_ptxas(log.format(128))[0] == []
    fs = cuda_check.check_ptxas(log.format(130))[0]
    assert _rules_of(fs) == ["cuda-register-budget"]
    assert "130 registers x 256 threads x 2 blocks" in fs[0].message


def test_shard_layout_validator_matches_the_reference():
    kw = dict(n_pad=9, n_loc=4, n_sh=2, halo=np.array([[4, 99], [0, 1]]),
              idx=np.full((9, 3), 7, np.int32))
    bad = cuda_check.validate_shard_layout(**kw)
    assert bad == jvmem_check.validate_shard_layout(**kw)
    assert len(bad) == 4
    ok = dict(n_pad=8, n_loc=4, n_sh=2, halo=np.array([[4, 5], [0, 1]]),
              idx=np.zeros((8, 3), np.int32))
    assert cuda_check.validate_shard_layout(**ok) == []


# ---------------------------------------------------------------------------
# the real tree
# ---------------------------------------------------------------------------

def test_real_tree_is_clean_on_the_cpu():
    per_check = run_checks(["sync", "locks", "cuda"], device="cpu")
    assert per_check == {"sync": [], "locks": [], "cuda": []}
    assert per_check.not_run == ["cuda-smem-budget", "cuda-register-budget"]
    # the hot modules are all there, and the lint read them
    assert len(sync_lint.HOT_MODULES) == 10
    assert all(os.path.exists(os.path.join(PORT_ROOT, m))
               for m in sync_lint.HOT_MODULES)


def test_audit_on_a_missing_card_is_an_error(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fs = dispatch_audit.check_registry(device="cuda")
    assert _rules_of(fs) == ["meta-not-run"]


def test_cuda_check_defaults_to_the_card_and_says_what_did_not_run(
        monkeypatch):
    """With its defaults the check is the card's: a build that cannot run
    is an error finding.  On the CPU the ptxas rules are in the report's
    ``not_run``, not dropped."""
    from repro_torch.kernels import _build

    def no_build():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "library", no_build)
    report = cuda_check.check_suite()
    assert _rules_of(report.findings) == ["meta-not-run"]
    assert "nvcc not found" in report.findings[0].message
    cpu = cuda_check.check_suite(device="cpu")
    assert cpu.findings == [] and cpu.kernels == []
    assert cpu.not_run == ["cuda-smem-budget", "cuda-register-budget"]


def test_cli_reads_a_ptxas_log(tmp_path, capsys):
    from repro_torch.analysis.__main__ import main

    log = tmp_path / "ptxas.log"
    log.write_text(PTXAS_SMEM)
    out = tmp_path / "findings.json"
    rc = main(["--check", "cuda", "--device", "cpu", "--ptxas-log",
               str(log), "--json", str(out)])
    text = capsys.readouterr().out
    assert rc == 1
    assert "repro_torch/kernels/csrc/spmv_ell_batched.cu" in text
    assert "[cuda-smem-budget]" in text and "NOT RUN" not in text
    doc = json.loads(out.read_text())
    assert [f["rule"] for f in doc["records"]["findings"]] == \
        ["cuda-smem-budget"]
    assert doc["not_run"] == []


def test_cli_writes_its_artifact_for_the_cpu_checks(tmp_path):
    out = tmp_path / "findings.json"
    env = {**os.environ, "PYTHONPATH": os.path.dirname(PORT_ROOT)}
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--check", "sync",
         "--check", "locks", "--check", "cuda", "--device", "cpu",
         "--json", str(out)], capture_output=True, text=True, timeout=300,
        env=env)
    assert run.returncode == 0, run.stdout + run.stderr
    assert "OK — 0 finding(s) (cuda: 0, locks: 0, sync: 0)" in run.stdout
    assert "NOT RUN on cpu: cuda-smem-budget, cuda-register-budget" in \
        run.stdout
    doc = json.loads(out.read_text())
    assert doc["records"]["checks_run"] == ["cuda", "locks", "sync"]
    assert doc["records"]["finding_count"] == 0
    assert doc["device"] == "cpu"
    assert doc["not_run"] == ["cuda-smem-budget", "cuda-register-budget"]
    assert {r["id"] for r in doc["records"]["ruleset"]} == findings.RULE_IDS
