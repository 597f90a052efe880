"""graftrace lock model: lock inventory, held-set flow, order graph.

Static, best-effort, and biased the same way callgraph.py is — toward
*coverage*. The model keeps two precisions side by side:

- **confident** resolution (self-methods, module-local names, direct
  imports, ``self.<attr>`` whose type is pinned by an ``__init__``
  constructor assignment) drives the rules that accuse code of a bug:
  ``lock-order-cycle`` edges and the held-set context used by
  ``blocking-call-under-lock`` / ``inconsistent-guard``. A false edge
  here would fabricate a deadlock report, so no guessing.
- **wide** resolution additionally takes callgraph.py's receiver-blind
  fallback. It only feeds the *coverage universe* the runtime witness
  compares against: a witnessed edge outside even the wide model means
  the extractor has a real blind spot, not that resolution was shy.

Held sets propagate interprocedurally with matching bias: a *may*-held
union feeds the order graph (missing an edge hides a deadlock), while
the accusing rules only trust locally-held locks plus a *must*-held
intersection for underscore-private helpers (public entry points can be
called lock-free from anywhere, including tests we cannot see).

Dynamic dispatch through callable objects (e.g. a registered Program
instance invoked under a store lock) is invisible to any AST pass; the
``DECLARED_EDGES`` table below names those edges explicitly, the same
guard-table pattern the JAX package's core/programs.py uses for jit
sites. Stale entries (naming unknown locks) are themselves findings.

Counterpart of kmamiz_tpu/analysis/concurrency/locks.py: the same model
over the port's tree.
"""
from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from kmamiz_tpu_torch.analysis.framework import LintContext, ModuleInfo
from kmamiz_tpu_torch.analysis.callgraph import _ModuleIndex, _module_to_rel
from kmamiz_tpu_torch.analysis.rules import (
    _MUTABLE_CTORS,
    _attr_chain,
    _chain_str,
    _module_mutables,
)

_LOCK_CTORS = {"Lock", "RLock", "Condition"}

# Acquisition-order edges taken through dynamic dispatch the AST cannot
# see (callable objects, registry indirection). Each entry is
# (src lock id, dst lock id, reason) and is merged into BOTH edge sets;
# entries naming a lock the extractor does not know are reported stale.
# The JAX table's one entry orders the store's lock before
# core/programs.py's Program._lock (a jitted Program handle's __call__);
# the port has no program registry, so its store dispatches plain
# functions the resolver can name, and that entry is not here.
DECLARED_EDGES: Tuple[Tuple[str, str, str], ...] = (
    (
        "kmamiz_tpu_torch/server/processor.py:DataProcessor.tick_lock",
        "kmamiz_tpu_torch/resilience/breaker.py:CircuitBreaker._lock",
        "the tick calls its trace source, a callable attribute, under "
        "tick_lock; the DP's main() wires it to ZipkinClient."
        "get_trace_list, whose GETs run through the zipkin breaker's call "
        "(witnessed on the DP's tick)",
    ),
)


@dataclass(frozen=True)
class LockSite:
    lock_id: str  # "rel/path.py:Class.attr" | "rel/path.py:name" | fn-local
    rel_path: str
    line: int  # creation line (the threading.Lock() call)
    kind: str  # Lock | RLock | Condition
    alias_of: Optional[str] = None  # Condition(lock) -> underlying lock id


@dataclass(frozen=True)
class Acquisition:
    fn: str  # "rel/path.py:Qual.name"
    lock_id: str  # canonical
    line: int
    held_before: Tuple[str, ...]  # canonical, locally-held only
    blocking: bool  # False for acquire(blocking=False) try-locks


@dataclass(frozen=True)
class CallRec:
    fn: str
    line: int
    held: Tuple[str, ...]  # locally-held at the call
    chain: Tuple[str, ...]  # attr chain of the callee expr (may be 1-long)
    nonblocking_kw: bool  # block=False / blocking=False / timeout=0
    thread_join: bool  # .join() on a local threading.Thread
    recv_lock: Optional[str]  # receiver resolves to a known lock/condition
    confident: Tuple[str, ...]  # confident callee qualnames
    wide: Tuple[str, ...]  # wide callee qualnames (superset)


@dataclass(frozen=True)
class Access:
    fn: str
    line: int
    held: Tuple[str, ...]  # locally-held
    key: Tuple[str, ...]  # ("rel", name) module var | ("rel", cls, attr)


@dataclass(frozen=True)
class OrderEdge:
    src: str
    dst: str
    rel_path: str
    line: int
    fn: str
    blocking: bool


@dataclass
class LockModel:
    locks: Dict[str, LockSite] = field(default_factory=dict)
    acquisitions: List[Acquisition] = field(default_factory=list)
    calls: List[CallRec] = field(default_factory=list)
    accesses: List[Access] = field(default_factory=list)
    # fn qual -> held-at-entry sets under the three propagation modes
    entry_may: Dict[str, FrozenSet[str]] = field(default_factory=dict)
    entry_may_wide: Dict[str, FrozenSet[str]] = field(default_factory=dict)
    entry_must: Dict[str, FrozenSet[str]] = field(default_factory=dict)
    edges: List[OrderEdge] = field(default_factory=list)  # confident
    wide_edge_pairs: Set[Tuple[str, str]] = field(default_factory=set)
    # (rel, cls) -> mutable attrs assigned in __init__ (lock-owning classes)
    mutable_attrs: Dict[Tuple[str, str], Set[str]] = field(default_factory=dict)
    stale_declared: List[Tuple[str, str, str]] = field(default_factory=list)
    # locks only ever acquired with blocking=False (nobody can stall on them)
    trylock_only: Set[str] = field(default_factory=set)

    def canon(self, lock_id: str) -> str:
        seen = set()
        while lock_id in self.locks and self.locks[lock_id].alias_of:
            if lock_id in seen:  # defensive: alias cycles
                break
            seen.add(lock_id)
            lock_id = self.locks[lock_id].alias_of
        return lock_id

    def creation_site(self, lock_id: str) -> Optional[Tuple[str, int]]:
        site = self.locks.get(lock_id)
        return (site.rel_path, site.line) if site else None

    def edge_pairs(self) -> Set[Tuple[str, str]]:
        return {(e.src, e.dst) for e in self.edges}


def _lock_ctor_kind(call: ast.AST, idx: _ModuleIndex) -> Optional[str]:
    if not isinstance(call, ast.Call):
        return None
    chain = _attr_chain(call.func)
    if not chain:
        return None
    if len(chain) == 2 and chain[0] == "threading" and chain[1] in _LOCK_CTORS:
        return chain[1]
    if len(chain) == 1 and chain[0] in _LOCK_CTORS:
        if idx.from_symbols.get(chain[0]) == ("threading", chain[0]):
            return chain[0]
    return None


def _mutable_value(v: ast.AST) -> bool:
    return isinstance(
        v, (ast.Dict, ast.List, ast.Set, ast.ListComp, ast.DictComp)
    ) or (
        isinstance(v, ast.Call)
        and _chain_str(v.func).split(".")[-1] in _MUTABLE_CTORS
    )


class _ClassInfo:
    def __init__(self) -> None:
        self.lock_attrs: Set[str] = set()
        self.mutable_attrs: Set[str] = set()
        # attr -> (target_rel, ClassName) when __init__ pins the type
        self.attr_types: Dict[str, Tuple[str, str]] = {}


class _ModScan:
    """Per-module extraction state shared by both passes."""

    def __init__(self, mod: ModuleInfo):
        self.mod = mod
        self.rel = mod.rel_path
        self.idx = _ModuleIndex(mod)
        self.classes: Dict[str, _ClassInfo] = {}
        self.class_defs: Dict[str, ast.ClassDef] = {}
        self.shared_vars: Set[str] = _module_mutables(mod)
        for node in mod.tree.body:
            if isinstance(node, ast.ClassDef):
                self.class_defs[node.name] = node


def _module_rels(dotted: str) -> Tuple[str, str]:
    """Candidate rel paths for a dotted module: the plain module file and
    the package ``__init__``.  callgraph's ``_module_to_rel`` only knows
    the former, which would lose every lock edge into a package's own
    ``__init__.py`` (e.g. the fleet counters behind ``fleet_mod.incr``)."""
    return _module_to_rel(dotted), dotted.replace(".", "/") + "/__init__.py"


def _scan_for_module(
    dotted: str, scans: Dict[str, "_ModScan"]
) -> Tuple[Optional[str], Optional["_ModScan"]]:
    for rel in _module_rels(dotted):
        tgt = scans.get(rel)
        if tgt is not None:
            return rel, tgt
    return None, None


def _resolve_class(
    name: str, scan: _ModScan, scans: Dict[str, "_ModScan"]
) -> Optional[Tuple[str, str]]:
    """Resolve a constructor name to (rel_path, ClassName)."""
    if name in scan.class_defs:
        return (scan.rel, name)
    sym = scan.idx.from_symbols.get(name)
    if sym:
        target_rel, tgt = _scan_for_module(sym[0], scans)
        if tgt and sym[1] in tgt.class_defs:
            return (target_rel, sym[1])
    return None


def _collect_sites(scans: Dict[str, _ModScan], model: LockModel) -> None:
    """Pass A: lock sites, Condition aliases, class attr inventories."""
    pending_aliases: List[Tuple[str, str, Optional[str], ast.Call]] = []
    for rel, scan in scans.items():
        # module-level locks
        for stmt in scan.mod.tree.body:
            if isinstance(stmt, ast.Assign):
                kind = _lock_ctor_kind(stmt.value, scan.idx)
                if kind:
                    for t in stmt.targets:
                        if isinstance(t, ast.Name):
                            lid = f"{rel}:{t.id}"
                            model.locks[lid] = LockSite(
                                lid, rel, stmt.value.lineno, kind
                            )
                            if kind == "Condition":
                                pending_aliases.append(
                                    (lid, rel, None, stmt.value)
                                )
        # class-attr locks + mutable attrs + attr types
        for cls_name, cls_node in scan.class_defs.items():
            info = scan.classes.setdefault(cls_name, _ClassInfo())
            for meth in cls_node.body:
                if not isinstance(
                    meth, (ast.FunctionDef, ast.AsyncFunctionDef)
                ):
                    continue
                for node in ast.walk(meth):
                    if not isinstance(node, ast.Assign):
                        continue
                    for t in node.targets:
                        chain = _attr_chain(t)
                        if not (
                            chain and len(chain) == 2 and chain[0] == "self"
                        ):
                            continue
                        attr = chain[1]
                        kind = _lock_ctor_kind(node.value, scan.idx)
                        if kind:
                            lid = f"{rel}:{cls_name}.{attr}"
                            if lid not in model.locks:
                                model.locks[lid] = LockSite(
                                    lid, rel, node.value.lineno, kind
                                )
                            info.lock_attrs.add(attr)
                            if kind == "Condition":
                                pending_aliases.append(
                                    (lid, rel, cls_name, node.value)
                                )
                        elif meth.name == "__init__":
                            if _mutable_value(node.value):
                                info.mutable_attrs.add(attr)
                            elif isinstance(node.value, ast.Call):
                                fchain = _attr_chain(node.value.func)
                                if fchain and len(fchain) == 1:
                                    tgt = _resolve_class(
                                        fchain[0], scan, scans
                                    )
                                    if tgt:
                                        info.attr_types[attr] = tgt
        # function-local locks (closures: per enclosing-def qualname)
        for suffix, fn_node in scan.idx.defs.items():
            for node in ast.walk(fn_node):
                if isinstance(node, ast.Assign):
                    kind = _lock_ctor_kind(node.value, scan.idx)
                    if kind:
                        for t in node.targets:
                            if isinstance(t, ast.Name):
                                lid = f"{rel}:{suffix}.{t.id}"
                                if lid not in model.locks:
                                    model.locks[lid] = LockSite(
                                        lid, rel, node.value.lineno, kind
                                    )
    # resolve Condition(underlying) aliases now that all sites exist
    for lid, rel, cls_name, call in pending_aliases:
        if not call.args:
            continue
        chain = _attr_chain(call.args[0])
        target: Optional[str] = None
        if chain and chain[0] == "self" and len(chain) == 2 and cls_name:
            target = f"{rel}:{cls_name}.{chain[1]}"
        elif chain and len(chain) == 1:
            target = f"{rel}:{chain[0]}"
        if target and target in model.locks:
            old = model.locks[lid]
            model.locks[lid] = LockSite(
                lid, old.rel_path, old.line, old.kind, alias_of=target
            )


class _FnScanner:
    """Pass B: walk one function body tracking the locally-held set."""

    def __init__(
        self,
        scan: _ModScan,
        scans: Dict[str, _ModScan],
        suffix: str,
        fn_node: ast.AST,
        model: LockModel,
    ):
        self.scan = scan
        self.scans = scans
        self.rel = scan.rel
        self.suffix = suffix
        self.fn = f"{scan.rel}:{suffix}"
        self.fn_node = fn_node
        self.model = model
        parts = suffix.split(".")
        self.cls = (
            parts[-2]
            if len(parts) >= 2 and parts[-2] in scan.class_defs
            else None
        )
        self.local_threads: Set[str] = set()
        # parameter name -> annotated class name, so `with session.lock:`
        # resolves when the signature says `session: RawIngestSession`
        self.param_types: Dict[str, str] = {}
        if isinstance(fn_node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            a = fn_node.args
            for arg in [*a.posonlyargs, *a.args, *a.kwonlyargs]:
                ann = arg.annotation
                if isinstance(ann, ast.Name):
                    self.param_types[arg.arg] = ann.id
                elif isinstance(ann, ast.Constant) and isinstance(
                    ann.value, str
                ):
                    self.param_types[arg.arg] = ann.value
        self.acquisitions: List[Acquisition] = []
        self.calls: List[CallRec] = []
        self.accesses: List[Access] = []

    # -- resolution -----------------------------------------------------

    def resolve_lock(self, expr: ast.AST) -> Optional[str]:
        chain = _attr_chain(expr)
        if not chain:
            return None
        locks = self.model.locks
        if chain[0] == "self" and len(chain) == 2 and self.cls:
            cand = f"{self.rel}:{self.cls}.{chain[1]}"
            if cand in locks:
                return self.model.canon(cand)
        if len(chain) == 1:
            # fn-local (walk enclosing-def prefixes), then module-level
            parts = self.suffix.split(".")
            for i in range(len(parts), 0, -1):
                cand = f"{self.rel}:{'.'.join(parts[:i])}.{chain[0]}"
                if cand in locks:
                    return self.model.canon(cand)
            cand = f"{self.rel}:{chain[0]}"
            if cand in locks:
                return self.model.canon(cand)
        if len(chain) == 2:
            dotted = self.scan.idx.import_aliases.get(chain[0])
            if dotted is None and chain[0] in self.scan.idx.from_symbols:
                base, sym_name = self.scan.idx.from_symbols[chain[0]]
                dotted = f"{base}.{sym_name}"
            if dotted:
                for rel in _module_rels(dotted):
                    cand = f"{rel}:{chain[1]}"
                    if cand in locks:
                        return self.model.canon(cand)
            ann = self.param_types.get(chain[0])
            if ann:
                cls = _resolve_class(ann, self.scan, self.scans)
                if cls:
                    cand = f"{cls[0]}:{cls[1]}.{chain[1]}"
                    if cand in locks:
                        return self.model.canon(cand)
        return None

    def _resolve_callees(
        self, call: ast.Call
    ) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
        idx = self.scan.idx
        confident: Set[str] = set()
        wide: Set[str] = set()
        chain = _attr_chain(call.func)
        if chain is None:
            return (), ()
        if len(chain) == 1:
            name = chain[0]
            for cand in idx.by_basename.get(name, []):
                confident.add(f"{self.rel}:{cand}")
            sym = idx.from_symbols.get(name)
            if sym:
                target_rel, tgt = _scan_for_module(sym[0], self.scans)
                if tgt:
                    for cand in tgt.idx.by_basename.get(sym[1], []):
                        confident.add(f"{target_rel}:{cand}")
            cls = _resolve_class(name, self.scan, self.scans)
            if cls and f"{cls[1]}.__init__" in self.scans[cls[0]].idx.defs:
                confident.add(f"{cls[0]}:{cls[1]}.__init__")
            return tuple(sorted(confident)), tuple(sorted(confident))
        meth = chain[-1]
        if chain[0] == "self" and len(chain) == 2 and self.cls:
            cand = f"{self.cls}.{meth}"
            if cand in idx.defs:
                confident.add(f"{self.rel}:{cand}")
                return tuple(sorted(confident)), tuple(sorted(confident))
        if chain[0] == "self" and len(chain) == 3 and self.cls:
            info = self.scan.classes.get(self.cls)
            typed = info.attr_types.get(chain[1]) if info else None
            if typed:
                target_rel, target_cls = typed
                cand = f"{target_cls}.{meth}"
                if cand in self.scans[target_rel].idx.defs:
                    confident.add(f"{target_rel}:{cand}")
                    return tuple(sorted(confident)), tuple(sorted(confident))
        if len(chain) == 2:
            dotted = idx.import_aliases.get(chain[0])
            if dotted is None and chain[0] in idx.from_symbols:
                base, sym_name = idx.from_symbols[chain[0]]
                dotted = f"{base}.{sym_name}"
            if dotted:
                target_rel, tgt = _scan_for_module(dotted, self.scans)
                if tgt:
                    for cand in tgt.idx.by_basename.get(meth, []):
                        confident.add(f"{target_rel}:{cand}")
                    if confident:
                        return (
                            tuple(sorted(confident)),
                            tuple(sorted(confident)),
                        )
        # receiver-blind fallback (wide only), mirroring callgraph.py
        for cand in idx.by_basename.get(meth, []):
            wide.add(f"{self.rel}:{cand}")
        for target_rel in idx.imported_rels:
            tgt = self.scans.get(target_rel)
            if tgt is None and target_rel.endswith(".py"):
                # imported_rels carries the dotted-path rel; packages
                # actually live in <pkg>/__init__.py
                target_rel = target_rel[:-3] + "/__init__.py"
                tgt = self.scans.get(target_rel)
            if not tgt:
                continue
            for cand in tgt.idx.by_basename.get(meth, []):
                wide.add(f"{target_rel}:{cand}")
        return tuple(sorted(confident)), tuple(sorted(wide | confident))

    # -- recording ------------------------------------------------------

    def _record_acq(
        self, lid: str, line: int, held: Tuple[str, ...], blocking: bool
    ) -> None:
        self.acquisitions.append(
            Acquisition(self.fn, lid, line, tuple(held), blocking)
        )

    def _record_call(self, call: ast.Call, held: Tuple[str, ...]) -> None:
        chain = _attr_chain(call.func)
        if chain is None:
            chain_t: Tuple[str, ...] = ()
        else:
            chain_t = tuple(chain)
        nonblocking = False
        for kw in call.keywords:
            if kw.arg in ("block", "blocking") and (
                isinstance(kw.value, ast.Constant) and kw.value.value is False
            ):
                nonblocking = True
            if kw.arg == "timeout" and (
                isinstance(kw.value, ast.Constant) and kw.value.value == 0
            ):
                nonblocking = True
        thread_join = bool(
            chain_t
            and chain_t[-1] == "join"
            and len(chain_t) >= 2
            and chain_t[0] in self.local_threads
        )
        recv_lock = None
        if isinstance(call.func, ast.Attribute):
            recv = call.func.value
            recv_chain = _attr_chain(recv)
            if recv_chain:
                lid = self.resolve_lock(recv)
                if lid is None and recv_chain[0] == "self" and self.cls:
                    # `self._barrier.wait()` resolves through the alias id
                    cand = f"{self.rel}:{self.cls}.{recv_chain[-1]}"
                    if cand in self.model.locks:
                        lid = self.model.canon(cand)
                recv_lock = lid
        confident, wide = self._resolve_callees(call)
        self.calls.append(
            CallRec(
                self.fn,
                call.lineno,
                tuple(held),
                chain_t,
                nonblocking,
                thread_join,
                recv_lock,
                confident,
                wide,
            )
        )

    def _record_accesses(self, node: ast.AST, held: Tuple[str, ...]) -> None:
        if isinstance(node, ast.Name):
            if node.id in self.scan.shared_vars:
                self.accesses.append(
                    Access(self.fn, node.lineno, tuple(held), (self.rel, node.id))
                )
        elif isinstance(node, ast.Attribute):
            chain = _attr_chain(node)
            if not chain:
                return
            if chain[0] == "self" and len(chain) == 2 and self.cls:
                info = self.scan.classes.get(self.cls)
                if info and chain[1] in info.mutable_attrs:
                    self.accesses.append(
                        Access(
                            self.fn,
                            node.lineno,
                            tuple(held),
                            (self.rel, self.cls, chain[1]),
                        )
                    )
            elif len(chain) == 2:
                dotted = self.scan.idx.import_aliases.get(chain[0])
                if dotted:
                    target_rel, tgt = _scan_for_module(dotted, self.scans)
                    if tgt and chain[1] in tgt.shared_vars:
                        self.accesses.append(
                            Access(
                                self.fn,
                                node.lineno,
                                tuple(held),
                                (target_rel, chain[1]),
                            )
                        )

    # -- expression / statement walks -----------------------------------

    def scan_expr(self, expr: Optional[ast.AST], held: Tuple[str, ...]) -> None:
        if expr is None:
            return
        stack = [expr]
        while stack:
            node = stack.pop()
            if isinstance(node, ast.Lambda):
                continue  # runs later, under whoever calls it
            if isinstance(node, ast.Call):
                acq = self._acquire_release(node)
                if acq is None:
                    self._record_call(node, held)
                elif acq[1] == "acquire":
                    # acquire inside an expression: handled by the
                    # statement-level walkers when it affects flow; still
                    # record the event so the order graph sees it
                    self._record_acq(acq[0], node.lineno, held, acq[2])
            self._record_accesses(node, held)
            stack.extend(ast.iter_child_nodes(node))

    def _acquire_release(
        self, call: ast.Call
    ) -> Optional[Tuple[str, str, bool]]:
        """(lock_id, 'acquire'|'release', blocking) for lock method calls."""
        if not isinstance(call.func, ast.Attribute):
            return None
        verb = call.func.attr
        if verb not in ("acquire", "release"):
            return None
        lid = self.resolve_lock(call.func.value)
        if lid is None:
            return None
        blocking = True
        if call.args and isinstance(call.args[0], ast.Constant):
            if call.args[0].value in (False, 0):
                blocking = False
        for kw in call.keywords:
            if kw.arg == "blocking" and (
                isinstance(kw.value, ast.Constant)
                and kw.value.value in (False, 0)
            ):
                blocking = False
        return (lid, verb, blocking)

    def _trylock_in_test(
        self, test: ast.AST
    ) -> Optional[Tuple[str, bool, int]]:
        """(lock_id, negated, line) for `[not] X.acquire(blocking=False)`."""
        negated = False
        node = test
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
            negated = True
            node = node.operand
        if isinstance(node, ast.Call):
            acq = self._acquire_release(node)
            if acq and acq[1] == "acquire" and not acq[2]:
                return (acq[0], negated, node.lineno)
        return None

    @staticmethod
    def _terminates(body: Sequence[ast.stmt]) -> bool:
        return bool(body) and isinstance(
            body[-1], (ast.Return, ast.Raise, ast.Continue, ast.Break)
        )

    def scan_stmts(
        self, stmts: Sequence[ast.stmt], held: Tuple[str, ...]
    ) -> Tuple[str, ...]:
        for st in stmts:
            held = self.scan_stmt(st, held)
        return held

    def scan_stmt(self, st: ast.stmt, held: Tuple[str, ...]) -> Tuple[str, ...]:
        if isinstance(
            st, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
        ):
            # nested defs run later under their own qualname; a held lock
            # here does not extend into their call time
            for dec in getattr(st, "decorator_list", []):
                self.scan_expr(dec, held)
            return held
        if isinstance(st, (ast.With, ast.AsyncWith)):
            inner = held
            for item in st.items:
                lid = self.resolve_lock(item.context_expr)
                if lid is not None:
                    self._record_acq(
                        lid, item.context_expr.lineno, inner, True
                    )
                    if lid not in inner:
                        inner = inner + (lid,)
                else:
                    self.scan_expr(item.context_expr, inner)
            self.scan_stmts(st.body, inner)
            return held
        if isinstance(st, ast.Expr) and isinstance(st.value, ast.Call):
            acq = self._acquire_release(st.value)
            if acq is not None:
                lid, verb, blocking = acq
                if verb == "acquire":
                    self._record_acq(lid, st.value.lineno, held, blocking)
                    if blocking and lid not in held:
                        held = held + (lid,)
                else:
                    held = tuple(h for h in held if h != lid)
                return held
            self._track_thread_assign(st)
            self.scan_expr(st.value, held)
            return held
        if isinstance(st, ast.If):
            tl = self._trylock_in_test(st.test)
            if tl is not None:
                lid, negated, line = tl
                self._record_acq(lid, line, held, False)
                with_lock = held + ((lid,) if lid not in held else ())
                if negated:
                    self.scan_stmts(st.body, held)
                    self.scan_stmts(st.orelse, with_lock)
                    if self._terminates(st.body):
                        return with_lock
                    return held
                self.scan_stmts(st.body, with_lock)
                self.scan_stmts(st.orelse, held)
                return held
            self.scan_expr(st.test, held)
            self.scan_stmts(st.body, held)
            self.scan_stmts(st.orelse, held)
            return held
        if isinstance(st, (ast.While,)):
            self.scan_expr(st.test, held)
            self.scan_stmts(st.body, held)
            self.scan_stmts(st.orelse, held)
            return held
        if isinstance(st, (ast.For, ast.AsyncFor)):
            self.scan_expr(st.iter, held)
            self.scan_expr(st.target, held)
            self.scan_stmts(st.body, held)
            self.scan_stmts(st.orelse, held)
            return held
        if isinstance(st, ast.Try):
            after_body = self.scan_stmts(st.body, held)
            for handler in st.handlers:
                self.scan_stmts(handler.body, held)
            after_else = self.scan_stmts(st.orelse, after_body)
            return self.scan_stmts(st.finalbody, after_else)
        if isinstance(st, ast.Assign):
            self._track_thread_assign(st)
            self.scan_expr(st.value, held)
            for t in st.targets:
                self.scan_expr(t, held)
            return held
        # everything else: walk child expressions with the current held set
        for child in ast.iter_child_nodes(st):
            if isinstance(child, ast.stmt):
                held = self.scan_stmt(child, held)
            else:
                self.scan_expr(child, held)
        return held

    def _track_thread_assign(self, st: ast.stmt) -> None:
        if not isinstance(st, ast.Assign):
            return
        v = st.value
        if isinstance(v, ast.Call) and _chain_str(v.func) in (
            "threading.Thread",
            "Thread",
        ):
            for t in st.targets:
                if isinstance(t, ast.Name):
                    self.local_threads.add(t.id)

    def run(self) -> None:
        body = getattr(self.fn_node, "body", [])
        self.scan_stmts(body, ())
        self.model.acquisitions.extend(self.acquisitions)
        self.model.calls.extend(self.calls)
        seen = set()
        for a in self.accesses:
            k = (a.fn, a.key, a.line)
            if k not in seen:
                seen.add(k)
                self.model.accesses.append(a)


def _propagate(
    calls: List[CallRec],
    mode: str,
) -> Dict[str, FrozenSet[str]]:
    """Fixpoint held-at-entry propagation.

    mode 'may'      union over confident call sites
    mode 'may_wide' union over confident+wide call sites
    mode 'must'     intersection over confident call sites, and only for
                    underscore-private basenames (public fns may be
                    called lock-free from outside the repo's own code)
    """
    entry: Dict[str, FrozenSet[str]] = {}
    by_caller: Dict[str, List[CallRec]] = {}
    for c in calls:
        by_caller.setdefault(c.fn, []).append(c)

    if mode == "must":
        seen_vals: Dict[str, Optional[FrozenSet[str]]] = {}
        changed = True
        while changed:
            changed = False
            for c in calls:
                ctx_held = (entry.get(c.fn) or frozenset()) | frozenset(c.held)
                for callee in c.confident:
                    base = callee.rsplit(".", 1)[-1]
                    if not base.startswith("_") or base.startswith("__"):
                        continue
                    prev = seen_vals.get(callee, None)
                    new = ctx_held if prev is None else (prev & ctx_held)
                    if new != prev:
                        seen_vals[callee] = new
                        entry[callee] = new
                        changed = True
        return {k: v for k, v in entry.items() if v}

    changed = True
    while changed:
        changed = False
        for c in calls:
            ctx_held = (entry.get(c.fn) or frozenset()) | frozenset(c.held)
            if not ctx_held:
                continue
            targets = c.confident if mode == "may" else c.wide
            for callee in targets:
                prev = entry.get(callee, frozenset())
                new = prev | ctx_held
                if new != prev:
                    entry[callee] = new
                    changed = True
    return entry


def build_model(ctx: LintContext) -> LockModel:
    """Build (and cache on the context) the repo-wide lock model."""
    cached = getattr(ctx, "_graftrace_model", None)
    if cached is not None:
        return cached
    model = LockModel()
    scans = {rel: _ModScan(m) for rel, m in ctx.modules.items()}
    _collect_sites(scans, model)
    for rel, scan in scans.items():
        for cls_name, info in scan.classes.items():
            if info.lock_attrs and info.mutable_attrs:
                model.mutable_attrs[(rel, cls_name)] = set(info.mutable_attrs)
        for suffix, fn_node in scan.idx.defs.items():
            _FnScanner(scan, scans, suffix, fn_node, model).run()

    model.entry_may = _propagate(model.calls, "may")
    model.entry_may_wide = _propagate(model.calls, "may_wide")
    model.entry_must = _propagate(model.calls, "must")

    blocking_by_lock: Dict[str, bool] = {}
    for acq in model.acquisitions:
        blocking_by_lock[acq.lock_id] = (
            blocking_by_lock.get(acq.lock_id, False) or acq.blocking
        )
    model.trylock_only = {
        lid for lid, any_blocking in blocking_by_lock.items() if not any_blocking
    }

    seen_edges: Set[Tuple[str, str, str, int]] = set()
    for acq in model.acquisitions:
        rel = acq.fn.split(":", 1)[0]
        dst = acq.lock_id
        for entry_map, wide in (
            (model.entry_may, False),
            (model.entry_may_wide, True),
        ):
            held = set(acq.held_before) | entry_map.get(acq.fn, frozenset())
            for src in held:
                if src == dst:
                    continue  # reentrant re-acquire, not an order edge
                model.wide_edge_pairs.add((src, dst))
                if not wide:
                    key = (src, dst, rel, acq.line)
                    if key not in seen_edges:
                        seen_edges.add(key)
                        model.edges.append(
                            OrderEdge(
                                src, dst, rel, acq.line, acq.fn, acq.blocking
                            )
                        )
    for src, dst, reason in DECLARED_EDGES:
        if src not in model.locks or dst not in model.locks:
            model.stale_declared.append((src, dst, reason))
            continue
        csrc, cdst = model.canon(src), model.canon(dst)
        model.wide_edge_pairs.add((csrc, cdst))
        site = model.locks[csrc]
        model.edges.append(
            OrderEdge(
                csrc, cdst, site.rel_path, site.line, "<declared>", True
            )
        )

    model.edges.sort(key=lambda e: (e.rel_path, e.line, e.src, e.dst))
    ctx._graftrace_model = model
    return model


def repo_model() -> LockModel:
    """The lock model for the in-repo kmamiz_tpu_torch package — parsing only
    (no hot-set), so the runtime witness can cross-check
    without paying a full lint context."""
    from kmamiz_tpu_torch.analysis import framework

    root = framework.repo_root()
    ctx = LintContext(root=root)
    for rel in framework._iter_py_files(root, None):
        try:
            with open(os.path.join(root, rel), encoding="utf-8") as fh:
                ctx.modules[rel.replace("\\", "/")] = ModuleInfo(
                    rel, fh.read()
                )
        except (SyntaxError, UnicodeDecodeError, OSError):
            continue
    return build_model(ctx)


def find_cycles(model: LockModel) -> List[List[OrderEdge]]:
    """Cycles in the blocking confident order graph, one per SCC.

    Try-lock edges (acquire(blocking=False)) cannot stall a thread, so
    they are excluded; so are edges *into* locks that are only ever
    try-acquired (nobody can block on them).
    """
    edges = [
        e
        for e in model.edges
        if e.blocking and e.dst not in model.trylock_only
    ]
    adj: Dict[str, Set[str]] = {}
    for e in edges:
        adj.setdefault(e.src, set()).add(e.dst)

    index_counter = [0]
    stack: List[str] = []
    lowlink: Dict[str, int] = {}
    index: Dict[str, int] = {}
    on_stack: Set[str] = set()
    sccs: List[List[str]] = []

    def strongconnect(v: str) -> None:
        work = [(v, iter(sorted(adj.get(v, ()))))]
        index[v] = lowlink[v] = index_counter[0]
        index_counter[0] += 1
        stack.append(v)
        on_stack.add(v)
        while work:
            node, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = lowlink[w] = index_counter[0]
                    index_counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(sorted(adj.get(w, ())))))
                    advanced = True
                    break
                elif w in on_stack:
                    lowlink[node] = min(lowlink[node], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                lowlink[parent] = min(lowlink[parent], lowlink[node])
            if lowlink[node] == index[node]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == node:
                        break
                if len(comp) > 1:
                    sccs.append(sorted(comp))

    for v in sorted(adj):
        if v not in index:
            strongconnect(v)

    cycles: List[List[OrderEdge]] = []
    for comp in sccs:
        comp_set = set(comp)
        cyc = sorted(
            (
                e
                for e in edges
                if e.src in comp_set and e.dst in comp_set
            ),
            key=lambda e: (e.rel_path, e.line, e.src, e.dst),
        )
        if cyc:
            cycles.append(cyc)
    return cycles
