"""The port's graftlint rules: seven of the JAX package's nine, three of
them in their torch meaning.

Counterpart of kmamiz_tpu/analysis/rules.py. Each rule is a function
(module, context) -> [Finding] registered via framework.rule().

- Carried over with the same logic: ``unguarded-shared-state``,
  ``hot-path-metric-label``, ``hot-path-clock`` and ``prof-counter-wire``
  (its pair is csrc/kmamiz_spans.cpp and native/__init__.py).
- In their torch meaning: ``unregistered-jit`` (no ``torch.compile`` and
  no TorchScript anywhere: the port has no program registry and
  compiles nothing per shape, and a compiled plain version is no
  stand-in for a hand-written kernel), ``host-sync-in-hot-path`` (the
  synchronising torch calls on values that ``torch.*`` produced) and
  ``dtype-drift`` (float64 on the hot path; torch constructors that rely
  on the default dtype).
- Left out: ``shape-hazard`` and ``donation-miss`` guard XLA retraces and
  buffer donation; eager PyTorch has neither.
"""
from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Set

from kmamiz_tpu_torch.analysis.framework import (
    Finding,
    LintContext,
    ModuleInfo,
    rule,
)

# ---------------------------------------------------------------------------
# shared AST plumbing
# ---------------------------------------------------------------------------


def _parents(tree: ast.AST) -> Dict[ast.AST, ast.AST]:
    return {
        child: parent
        for parent in ast.walk(tree)
        for child in ast.iter_child_nodes(parent)
    }


def _attr_chain(node: ast.AST) -> Optional[List[str]]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return list(reversed(parts))
    return None


def _chain_str(node: ast.AST) -> str:
    chain = _attr_chain(node)
    return ".".join(chain) if chain else ""


def _walk_own(fn_node: ast.AST):
    """Walk a function body without descending into nested defs (they
    lint under their own qualname)."""
    stack = list(ast.iter_child_nodes(fn_node))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            stack.extend(ast.iter_child_nodes(node))


def _functions(mod: ModuleInfo):
    """(qualname-suffix, node) for every def, class-qualified."""

    def visit(node, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qn = f"{prefix}{child.name}"
                yield qn, child
                yield from visit(child, f"{qn}.")
            elif isinstance(child, ast.ClassDef):
                yield from visit(child, f"{prefix}{child.name}.")

    yield from visit(mod.tree, "")


# ---------------------------------------------------------------------------
# rule 1: unregistered-jit (torch meaning: no compiled entry points)
# ---------------------------------------------------------------------------

_COMPILE_NAMES = {
    "torch.compile",
    "torch.jit.script",
    "torch.jit.trace",
    "torch.jit.trace_module",
    "jit.script",
    "jit.trace",
    "jit.trace_module",
}


def _compile_call(call: ast.Call) -> Optional[str]:
    """The compile entry point a call applies: torch.compile(f, ...),
    torch.compile(mode=...) as a decorator factory, or
    partial(torch.compile, ...); else None."""
    cs = _chain_str(call.func)
    if cs in _COMPILE_NAMES:
        return cs
    if cs in {"partial", "functools.partial"} and call.args:
        inner = _chain_str(call.args[0])
        if inner in _COMPILE_NAMES:
            return inner
    return None


def _compile_decorator(dec: ast.AST) -> Optional[str]:
    """The compile entry point a decorator applies, or None."""
    cs = _chain_str(dec)
    if cs in _COMPILE_NAMES:
        return cs
    if isinstance(dec, ast.Call):
        return _compile_call(dec)
    return None


@rule(
    "unregistered-jit",
    "no torch.compile / torch.jit.script / torch.jit.trace in the port: it "
    "has no program registry and compiles nothing per shape, and a compiled "
    "plain version is no stand-in for a hand-written kernel",
)
def check_unregistered_jit(mod: ModuleInfo, ctx: LintContext) -> List[Finding]:
    findings: List[Finding] = []
    decorator_calls: Set[int] = set()
    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                kind = _compile_decorator(dec)
                if kind is None:
                    continue
                decorator_calls.add(id(dec))
                findings.append(
                    Finding(
                        "unregistered-jit",
                        mod.rel_path,
                        node.lineno,
                        f"'{node.name}' is compiled by @{kind}: the port runs "
                        "eager PyTorch and hand-written kernels only",
                    )
                )
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call) or id(node) in decorator_calls:
            continue
        kind = _compile_call(node)
        if kind is not None:
            findings.append(
                Finding(
                    "unregistered-jit",
                    mod.rel_path,
                    node.lineno,
                    f"{kind}() compiles a program: the port runs eager "
                    "PyTorch and hand-written kernels only",
                )
            )
    return findings


# ---------------------------------------------------------------------------
# rule 2: host-sync-in-hot-path (the synchronising torch calls)
# ---------------------------------------------------------------------------

# calls that wait for the card whatever their argument
_SYNC_CALLS = {
    "torch.cuda.synchronize": "blocks the host on device work",
    "cuda.synchronize": "blocks the host on device work",
}
# methods that copy a tensor back (or wait for the card) on any receiver
_SYNC_METHODS = {
    "item": ".item() forces a device->host sync on the hot path",
    "cpu": ".cpu() copies a tensor device->host on the hot path",
    "synchronize": ".synchronize() stalls the hot path on device work",
}
# methods that sync only when their receiver is a tensor
_TENSOR_SYNC_METHODS = {"tolist", "numpy"}
# host copies of their argument: a sync when that is a tensor
_HOST_COPY_CALLS = {"np.asarray", "numpy.asarray", "np.array", "numpy.array"}

_DEVICE_PRODUCERS = ("torch.",)
_HOST_PRODUCERS = {
    "np.asarray",
    "numpy.asarray",
    "np.array",
    "numpy.array",
    "torch.device",
    "torch.cuda.is_available",
    "torch.cuda.device_count",
    "torch.cuda.get_device_name",
    "torch.cuda.current_device",
    "torch.cuda.memory_allocated",
    "torch.cuda.max_memory_allocated",
    "torch.cuda.memory_reserved",
    "torch.get_default_dtype",
}
# attribute reads that return host metadata, not device data
_METADATA_ATTRS = {"shape", "size", "ndim", "dtype", "device", "numel", "is_cuda"}


def _device_taint(fn_node: ast.AST) -> Set[str]:
    """Names in this function assigned from torch.* calls, i.e. likely
    tensors (on the card when the caller's device is)."""
    taint: Set[str] = set()
    for node in _walk_own(fn_node):
        if not isinstance(node, ast.Assign) or not isinstance(node.value, ast.Call):
            continue
        cs = _chain_str(node.value.func)
        if not cs.startswith(_DEVICE_PRODUCERS) or cs in _HOST_PRODUCERS:
            continue
        for tgt in node.targets:
            if isinstance(tgt, ast.Name):
                taint.add(tgt.id)
            elif isinstance(tgt, ast.Tuple):
                taint.update(
                    e.id for e in tgt.elts if isinstance(e, ast.Name)
                )
    return taint


def _mentions_taint(node: ast.AST, taint: Set[str]) -> bool:
    """Does the expression read tensor DATA (not host metadata like
    .shape/.size, and not through a host producer)?"""
    stack = [node]
    while stack:
        sub = stack.pop()
        if isinstance(sub, ast.Attribute) and sub.attr in _METADATA_ATTRS:
            continue  # x.shape[...] etc. never touch device data
        if isinstance(sub, ast.Call):
            cs = _chain_str(sub.func)
            if cs in _HOST_PRODUCERS:
                continue  # returns a host value; the sync is its own finding
            if cs.startswith(_DEVICE_PRODUCERS):
                return True
        if isinstance(sub, ast.Name) and sub.id in taint:
            return True
        stack.extend(ast.iter_child_nodes(sub))
    return False


def _sync_finding(mod: ModuleInfo, line: int, message: str) -> Finding:
    return Finding("host-sync-in-hot-path", mod.rel_path, line, message)


@rule(
    "host-sync-in-hot-path",
    "no device->host synchronization (.item(), .cpu(), torch.cuda."
    "synchronize(); .tolist()/.numpy()/float()/int()/bool()/np.asarray of a "
    "tensor) in functions reachable from the tick/serve entry points",
)
def check_host_sync(mod: ModuleInfo, ctx: LintContext) -> List[Finding]:
    findings: List[Finding] = []
    for suffix, fn_node in _functions(mod):
        if not ctx.is_hot(f"{mod.rel_path}:{suffix}"):
            continue
        taint = _device_taint(fn_node)
        for node in _walk_own(fn_node):
            if not isinstance(node, ast.Call):
                continue
            cs = _chain_str(node.func)
            if cs in _SYNC_CALLS:
                findings.append(
                    _sync_finding(
                        mod, node.lineno, f"{cs}() on the hot path: {_SYNC_CALLS[cs]}"
                    )
                )
                continue
            if isinstance(node.func, ast.Attribute) and not node.args:
                attr = node.func.attr
                if attr in _SYNC_METHODS:
                    findings.append(_sync_finding(mod, node.lineno, _SYNC_METHODS[attr]))
                    continue
                if attr in _TENSOR_SYNC_METHODS and _mentions_taint(
                    node.func.value, taint
                ):
                    findings.append(
                        _sync_finding(
                            mod,
                            node.lineno,
                            f".{attr}() of a tensor copies it device->host on "
                            "the hot path",
                        )
                    )
                    continue
            if cs in _HOST_COPY_CALLS and node.args:
                if _mentions_taint(node.args[0], taint):
                    findings.append(
                        _sync_finding(
                            mod,
                            node.lineno,
                            f"{cs}() of a tensor on the hot path: device->host copy",
                        )
                    )
                continue
            if cs in {"float", "int", "bool"} and node.args:
                if _mentions_taint(node.args[0], taint):
                    findings.append(
                        _sync_finding(
                            mod,
                            node.lineno,
                            f"{cs}() of a tensor forces a device->host sync on "
                            "the hot path",
                        )
                    )
    return findings


# ---------------------------------------------------------------------------
# rule 3: dtype-drift
# ---------------------------------------------------------------------------

# torch constructors whose floating result takes the default dtype
# (torch.set_default_dtype) when no dtype= is passed
_TORCH_CTORS = {"zeros", "ones", "full", "empty", "rand", "randn", "linspace", "eye"}
_FLOAT64_NAMES = {"np.float64", "numpy.float64", "torch.float64", "torch.double"}


@rule(
    "dtype-drift",
    "no float64 on the hot path (.double(), torch.float64, np.float64: the "
    "card's f64 rate is a fraction of f32's and the reference computes in "
    "f32) and no torch constructors relying on the default dtype",
)
def check_dtype_drift(mod: ModuleInfo, ctx: LintContext) -> List[Finding]:
    findings: List[Finding] = []
    for suffix, fn_node in _functions(mod):
        hot = ctx.is_hot(f"{mod.rel_path}:{suffix}")
        for node in _walk_own(fn_node):
            if isinstance(node, ast.Call):
                chain = _attr_chain(node.func)
                if (
                    chain
                    and len(chain) == 2
                    and chain[0] == "torch"
                    and chain[1] in _TORCH_CTORS
                    and not any(k.arg == "dtype" for k in node.keywords)
                ):
                    findings.append(
                        Finding(
                            "dtype-drift",
                            mod.rel_path,
                            node.lineno,
                            f"torch.{chain[1]} without dtype=: inherits the "
                            "default dtype (torch.set_default_dtype)",
                        )
                    )
                if hot and isinstance(node.func, ast.Attribute):
                    attr = node.func.attr
                    is64 = attr == "double" and not node.args
                    if attr == "astype" and node.args:
                        a = node.args[0]
                        is64 = (
                            isinstance(a, ast.Constant) and a.value == "float64"
                        ) or _chain_str(a) in _FLOAT64_NAMES
                    if is64:
                        findings.append(
                            Finding(
                                "dtype-drift",
                                mod.rel_path,
                                node.lineno,
                                f".{attr}(float64) on the hot path: the card's "
                                "f64 rate is a fraction of f32's",
                            )
                        )
            elif hot and isinstance(node, ast.Attribute):
                if _chain_str(node) in _FLOAT64_NAMES:
                    findings.append(
                        Finding(
                            "dtype-drift",
                            mod.rel_path,
                            node.lineno,
                            "float64 dtype on the hot path: the card's f64 "
                            "rate is a fraction of f32's (use f32 + "
                            "compensated sums)",
                        )
                    )
    return findings


# ---------------------------------------------------------------------------
# rule 4: unguarded-shared-state
# ---------------------------------------------------------------------------

_MUTABLE_CTORS = {
    "dict",
    "list",
    "set",
    "defaultdict",
    "deque",
    "OrderedDict",
    "Counter",
    "bytearray",
}
_MUTATORS = {
    "append",
    "add",
    "update",
    "clear",
    "pop",
    "popitem",
    "extend",
    "setdefault",
    "remove",
    "discard",
    "insert",
    "appendleft",
}
_STATE_SCOPES = (
    "kmamiz_tpu_torch/server/",
    "kmamiz_tpu_torch/core/",
    # the resilience registries (breakers, counters, quarantine default)
    # are written from scheduler threads, server threads, AND the ingest
    # producer at once — exactly the state this rule exists for
    "kmamiz_tpu_torch/resilience/",
    # the tenancy layer's process-wide registries (arena, per-tenant
    # runtimes, micro-batch queue) take writes from every server thread
    "kmamiz_tpu_torch/tenancy/",
    # the scenario runner's shared mutables (the completed-run registry,
    # per-tenant source queues) are written from the driving thread, the
    # reader thread, and HTTP handler threads of the live soak server
    "kmamiz_tpu_torch/scenarios/",
    # the fleet coordinator's routing state (overrides, drain flags,
    # queues) is written by request threads AND the migration driver;
    # the module counters take increments from every worker thread
    "kmamiz_tpu_torch/fleet/",
    # the STLGT continual trainer's ring/stale/params state is written
    # from the processor's fold path while /model/forecast and
    # /model/stlgt read it from server threads
    "kmamiz_tpu_torch/models/stlgt/",
    # the graftpilot controller's decision stores (admission states,
    # cost table, warmed-breaker sets) are swapped from the fold path
    # while every serving thread reads verdicts per tick
    "kmamiz_tpu_torch/control/",
    # the soak's cell costs (cost/scenario.py, the one part of the
    # graftcost plane the port has) are read by the sweep's planner
    # while workers record cells
    "kmamiz_tpu_torch/cost/",
    # the graftsoak engine's completed-sweep registry is appended from
    # whichever thread drove run_sweep while tests and observability
    # readers snapshot it; the manifest layer itself is cross-PROCESS
    # shared state (O_EXCL claims + atomic renames stand in for locks,
    # but any in-process mutable module state still needs one)
    "kmamiz_tpu_torch/soak/",
)


def _module_mutables(mod: ModuleInfo) -> Set[str]:
    names: Set[str] = set()
    for node in mod.tree.body:
        if isinstance(node, ast.If):
            stmts = list(node.body) + list(node.orelse)
        else:
            stmts = [node]
        for stmt in stmts:
            if not isinstance(stmt, ast.Assign):
                continue
            v = stmt.value
            mutable = isinstance(
                v, (ast.Dict, ast.List, ast.Set, ast.ListComp, ast.DictComp)
            ) or (
                isinstance(v, ast.Call)
                and _chain_str(v.func).split(".")[-1] in _MUTABLE_CTORS
            )
            if not mutable:
                continue
            names.update(
                t.id for t in stmt.targets if isinstance(t, ast.Name)
            )
    return names


def _lockish(expr: ast.AST) -> bool:
    return "lock" in _chain_str(expr).lower() or (
        isinstance(expr, ast.Call) and "lock" in _chain_str(expr.func).lower()
    )


@rule(
    "unguarded-shared-state",
    "module-level mutable containers in server/, core/ and resilience/ "
    "may only be written under a lock (or inside *_locked helpers)",
)
def check_unguarded_shared_state(
    mod: ModuleInfo, ctx: LintContext
) -> List[Finding]:
    if not mod.rel_path.startswith(_STATE_SCOPES):
        return []
    shared = _module_mutables(mod)
    if not shared:
        return []
    findings: List[Finding] = []

    def visit(node, fn_stack, lock_depth):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            fn_stack = fn_stack + [node.name]
            # a lock held when the closure was entered does not extend
            # into the nested def's own call time
            lock_depth = 0
        if isinstance(node, ast.With) and any(
            _lockish(item.context_expr) for item in node.items
        ):
            lock_depth += 1
        if fn_stack and lock_depth == 0 and not fn_stack[-1].endswith("_locked"):
            hit = _write_to_shared(node, shared)
            if hit:
                findings.append(
                    Finding(
                        "unguarded-shared-state",
                        mod.rel_path,
                        node.lineno,
                        f"module-level '{hit}' written outside a lock "
                        "(wrap in `with <lock>:` or a *_locked helper)",
                    )
                )
        for child in ast.iter_child_nodes(node):
            visit(child, fn_stack, lock_depth)

    visit(mod.tree, [], 0)
    return findings


def _write_to_shared(node: ast.AST, shared: Set[str]) -> Optional[str]:
    if isinstance(node, (ast.Assign, ast.AugAssign)):
        targets = node.targets if isinstance(node, ast.Assign) else [node.target]
        for t in targets:
            if (
                isinstance(t, ast.Subscript)
                and isinstance(t.value, ast.Name)
                and t.value.id in shared
            ):
                return t.value.id
    elif isinstance(node, ast.Delete):
        for t in node.targets:
            if (
                isinstance(t, ast.Subscript)
                and isinstance(t.value, ast.Name)
                and t.value.id in shared
            ):
                return t.value.id
    elif isinstance(node, ast.Expr) and isinstance(node.value, ast.Call):
        f = node.value.func
        if (
            isinstance(f, ast.Attribute)
            and f.attr in _MUTATORS
            and isinstance(f.value, ast.Name)
            and f.value.id in shared
        ):
            return f.value.id
    elif isinstance(node, ast.Global):
        hit = [n for n in node.names if n in shared]
        if hit:
            return hit[0]
    return None


# ---------------------------------------------------------------------------
# rule 5: hot-path-metric-label
# ---------------------------------------------------------------------------

# methods that mint a new metric child / family: calling one per tick
# means a dict lookup + possible allocation under the registry lock on
# every increment, instead of a one-time lookup at import
_HANDLE_ACQUIRERS = {
    "handle",
    "labels",
    "counter",
    "gauge",
    "histogram",
    "counter_family",
    "gauge_family",
    "histogram_family",
}
# metric write methods whose first argument names the counter/series
_METRIC_WRITERS = {"incr", "inc", "observe"}
# the registry implementation itself necessarily calls these
_METRIC_IMPL_PATHS = ("kmamiz_tpu_torch/telemetry/",)


def _is_stringy(node: ast.AST) -> bool:
    return (
        isinstance(node, ast.Constant) and isinstance(node.value, str)
    ) or isinstance(node, ast.JoinedStr)


def _formatted_name(node: ast.AST) -> bool:
    """Is this expression a metric name/label built per call — f-string
    with interpolation, str.format(), %-format, or string concatenation?"""
    if isinstance(node, ast.JoinedStr):
        return any(isinstance(v, ast.FormattedValue) for v in node.values)
    if (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Attribute)
        and node.func.attr == "format"
        and _is_stringy(node.func.value)
    ):
        return True
    if isinstance(node, ast.BinOp) and isinstance(node.op, (ast.Mod, ast.Add)):
        return _is_stringy(node.left) or _is_stringy(node.right)
    return False


@rule(
    "hot-path-metric-label",
    "hot-path metric writes must go through handles preallocated at "
    "import time: no handle/family acquisition and no per-call label "
    "formatting (f-string/.format/%/concat names) in functions reachable "
    "from the tick/serve entry points",
)
def check_hot_path_metric_label(
    mod: ModuleInfo, ctx: LintContext
) -> List[Finding]:
    if mod.rel_path.startswith(_METRIC_IMPL_PATHS):
        return []
    findings: List[Finding] = []
    for suffix, fn_node in _functions(mod):
        if not ctx.is_hot(f"{mod.rel_path}:{suffix}"):
            continue
        for node in _walk_own(fn_node):
            if not isinstance(node, ast.Call) or not isinstance(
                node.func, ast.Attribute
            ):
                continue
            attr = node.func.attr
            if attr in _HANDLE_ACQUIRERS:
                findings.append(
                    Finding(
                        "hot-path-metric-label",
                        mod.rel_path,
                        node.lineno,
                        f"metric handle acquisition '.{attr}(...)' on the "
                        "hot path: look the handle up once at import time "
                        "and write through it",
                    )
                )
                continue
            if (
                attr in _METRIC_WRITERS
                and node.args
                and _formatted_name(node.args[0])
            ):
                findings.append(
                    Finding(
                        "hot-path-metric-label",
                        mod.rel_path,
                        node.lineno,
                        f"per-call label formatting in '.{attr}(...)' on "
                        "the hot path: a formatted metric name allocates "
                        "every call and has unbounded cardinality — use a "
                        "preallocated handle",
                    )
                )
    return findings


# ---------------------------------------------------------------------------
# rule 6: hot-path-clock
# ---------------------------------------------------------------------------

# raw clock reads: each is a syscall-backed read the profiler cannot see.
# Hot code routes through telemetry/profiling/events.now_ns/now_ms/wall_ms
# — one blessed, greppable detour that keeps every hot clock swappable
# (and lets graftprof account for the reads it makes itself).
_RAW_CLOCKS = {
    "time.time",
    "time.time_ns",
    "time.perf_counter",
    "time.perf_counter_ns",
    "time.monotonic",
    "time.monotonic_ns",
}
# bare names from `from time import perf_counter` style imports
_RAW_CLOCK_BASENAMES = {c.split(".", 1)[1] for c in _RAW_CLOCKS}
# the sanctioned clock helpers (and the step timer that predates them)
# necessarily read the raw clocks
_CLOCK_IMPL_PATHS = (
    "kmamiz_tpu_torch/telemetry/",
    "kmamiz_tpu_torch/core/profiling.py",
)


@rule(
    "hot-path-clock",
    "hot-path code must read clocks through the graftprof helpers "
    "(telemetry.profiling.events.now_ns/now_ms/wall_ms), not raw "
    "time.time()/perf_counter(): raw reads scatter unaccountable timing "
    "syscalls through the tick and dodge the host event ring",
)
def check_hot_path_clock(mod: ModuleInfo, ctx: LintContext) -> List[Finding]:
    if mod.rel_path.startswith(_CLOCK_IMPL_PATHS):
        return []
    # a module that imports the time module under a different alias is
    # out of scope for the chain match; the common idioms are covered
    findings: List[Finding] = []
    bare_clock_imports: Set[str] = set()
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.ImportFrom) and node.module == "time":
            for alias in node.names:
                if alias.name in _RAW_CLOCK_BASENAMES:
                    bare_clock_imports.add(alias.asname or alias.name)
    for suffix, fn_node in _functions(mod):
        if not ctx.is_hot(f"{mod.rel_path}:{suffix}"):
            continue
        for node in _walk_own(fn_node):
            if not isinstance(node, ast.Call):
                continue
            chain = _chain_str(node.func)
            if chain in _RAW_CLOCKS or (
                chain in bare_clock_imports and "." not in chain
            ):
                findings.append(
                    Finding(
                        "hot-path-clock",
                        mod.rel_path,
                        node.lineno,
                        f"raw clock read '{chain}()' on the hot path: "
                        "route it through the graftprof clock helpers "
                        "(telemetry.profiling.events.now_ns/now_ms/"
                        "wall_ms) so tick timing stays attributable",
                    )
                )
    return findings


# ---------------------------------------------------------------------------
# rule 7: prof-counter-wire
# ---------------------------------------------------------------------------

# the ctypes decoder module whose _PROF_SCALARS tuples name the wire
_PROF_DECODER = "kmamiz_tpu_torch/native/__init__.py"
_PROF_CPP_REL = os.path.join("kmamiz_tpu_torch", "csrc", "kmamiz_spans.cpp")
_PROF_TUPLE_NAMES = {"_PROF_SCALARS", "_PROF_SCALARS_V1"}
# a cumulative scalar in the ProfCounters struct: `uint64_t name = 0;`
# (the per-shard arrays initialize with `= {0}` and never match)
_PROF_SCALAR_RE = re.compile(r"^\s*uint64_t\s+(\w+)\s*=\s*0\s*;")
_PROF_STRUCT_RE = re.compile(r"struct\s+ProfCounters\s*\{(.*?)\n\};", re.S)


def _cpp_prof_scalars(root: str) -> Optional[List[str]]:
    """Scalar counter names in csrc/kmamiz_spans.cpp's ProfCounters
    struct, declaration (= wire) order; None when the source or struct
    is absent (fixture repos without a native tree)."""
    try:
        with open(os.path.join(root, _PROF_CPP_REL), encoding="utf-8") as fh:
            source = fh.read()
    except OSError:
        return None
    m = _PROF_STRUCT_RE.search(source)
    if not m:
        return None
    return [
        sm.group(1)
        for line in m.group(1).splitlines()
        if (sm := _PROF_SCALAR_RE.match(line))
    ]


@rule(
    "prof-counter-wire",
    "every cumulative uint64 scalar in native ProfCounters "
    "(kmamiz_tpu_torch/csrc/kmamiz_spans.cpp) must be named in _PROF_SCALARS in "
    "kmamiz_tpu_torch/native/__init__.py, and vice versa: the snapshot wire "
    "serializes the struct in declaration order, so an unlisted scalar "
    "silently shifts every later field the Python decoder reads",
)
def check_prof_counter_wire(mod: ModuleInfo, ctx: LintContext) -> List[Finding]:
    if mod.rel_path != _PROF_DECODER:
        return []
    cpp_scalars = _cpp_prof_scalars(ctx.root)
    if cpp_scalars is None:
        return []
    declared: Set[str] = set()
    anchor = 1
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Assign):
            continue
        targets = {t.id for t in node.targets if isinstance(t, ast.Name)}
        if not targets & _PROF_TUPLE_NAMES:
            continue
        anchor = max(anchor, node.lineno)
        for sub in ast.walk(node.value):
            if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
                declared.add(sub.value)
    findings: List[Finding] = []
    for name in cpp_scalars:
        if name not in declared:
            findings.append(
                Finding(
                    "prof-counter-wire",
                    mod.rel_path,
                    anchor,
                    f"native ProfCounters scalar '{name}' is not listed in "
                    "_PROF_SCALARS: the snapshot wire serializes struct "
                    "declaration order, so the decoder misreads every "
                    "field after it (bump kProfWireVersion and append the "
                    "name)",
                )
            )
    for name in sorted(declared - set(cpp_scalars)):
        findings.append(
            Finding(
                "prof-counter-wire",
                mod.rel_path,
                anchor,
                f"_PROF_SCALARS entry '{name}' has no matching uint64_t "
                "scalar in the native ProfCounters struct: a stale "
                "decoder entry misaligns the counter wire",
            )
        )
    return findings
