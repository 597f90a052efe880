"""Import+call-graph reachability for the hot-path-gated rules.

Static, best-effort, and deliberately over-approximate: a function is
"hot" when it is reachable from the tick/serve entry modules
(server/processor.py, server/dp_server.py, models/serving.py) through

- direct calls to names defined or imported in the caller's module,
- ``self.method()`` calls within a class,
- bare references to local functions (callbacks: scan bodies, jit
  arguments, thread targets), and
- a receiver-blind fallback: ``obj.method()`` on an unresolvable
  receiver links to any ``method`` defined in a module the caller
  imports (so ``self.traces.ingest()`` reaches core/spans.py).

Over-approximation errs toward more functions being checked by the
host-sync/dtype rules — a false "hot" costs a suppression comment, a
false "cold" hides a tick stall.

Counterpart of kmamiz_tpu/analysis/callgraph.py; its seeds are the JAX
package's, each at its path in the port.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from kmamiz_tpu_torch.analysis.framework import LintContext, ModuleInfo

DEFAULT_SEED_MODULES = (
    "kmamiz_tpu_torch/server/processor.py",
    "kmamiz_tpu_torch/server/dp_server.py",
    "kmamiz_tpu_torch/models/serving.py",
    # the STLGT continual trainer runs inside the tick's fold path and
    # its quantile forward inside the forecast route — both hot
    "kmamiz_tpu_torch/models/stlgt/trainer.py",
    "kmamiz_tpu_torch/models/stlgt/serving.py",
    # graftpilot: admission_verdict runs on the serving edge and the
    # decision recompute inside the tick's fold path — hot by seed so
    # the hot-path rules cover the whole control plane
    "kmamiz_tpu_torch/control/__init__.py",
    "kmamiz_tpu_torch/control/admission.py",
    "kmamiz_tpu_torch/control/policy.py",
    "kmamiz_tpu_torch/control/warmup.py",
    # the fused SDDMM/SpMM kernels sit under every sparse-backend
    # consumer (scorers, packed walk, graphsage, stlgt bias) — seed the
    # module itself so the hot-path rules see its helpers even when the
    # consumer dispatch is behind the KMAMIZ_SPARSE knob
    "kmamiz_tpu_torch/ops/sparse.py",
    # graftstream: the micro-tick engine's produce/consume loops run
    # every prepared window through prepare/merge/finish — hot by seed
    # so the hot-path rules reach it even though the dispatch sits
    # behind the KMAMIZ_STREAM knob
    "kmamiz_tpu_torch/server/stream.py",
    # graftfleet: route_ingest sits on every frame's path and the
    # worker's ingest/drain/replay verbs ARE the DP hot loop when the
    # fleet fronts it — hot by seed so the rules reach them even though
    # fleet mode hides behind KMAMIZ_FLEET_SIZE
    "kmamiz_tpu_torch/fleet/coordinator.py",
    "kmamiz_tpu_torch/fleet/worker.py",
    # the placement scorer, the migration protocol, and the soak driver
    # run inside the archetype-10 scenario's tick loop — seed them so the
    # hot-path rules see the whole fleet subsystem, not just the two
    # verbs the coordinator/worker seeds happen to reach
    "kmamiz_tpu_torch/fleet/placement.py",
    "kmamiz_tpu_torch/fleet/migration.py",
    "kmamiz_tpu_torch/fleet/soak.py",
    # graftsoak: the WAL-replay scenario's ingest loop drives the DP
    # ingest hot path record by record, and the sweep worker's
    # claim/run/record cycle wraps every scenario the sweep executes —
    # seed both so the hot-path rules cover the soak plane
    "kmamiz_tpu_torch/soak/walreplay.py",
    "kmamiz_tpu_torch/soak/worker.py",
)


def _module_to_rel(dotted: str) -> str:
    return dotted.replace(".", "/") + ".py"


class _ModuleIndex:
    def __init__(self, mod: ModuleInfo):
        self.mod = mod
        self.defs: Dict[str, ast.AST] = {}  # qualname suffix -> node
        self.by_basename: Dict[str, List[str]] = {}
        self.import_aliases: Dict[str, str] = {}  # alias -> dotted module
        self.from_symbols: Dict[str, Tuple[str, str]] = {}  # name -> (mod, sym)
        self.imported_rels: Set[str] = set()
        self._collect()

    def _pkg(self, level: int) -> str:
        parts = self.mod.rel_path[:-3].split("/")
        return ".".join(parts[: len(parts) - level])

    def _collect(self) -> None:
        for node in ast.walk(self.mod.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.import_aliases[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0]
                    )
                    if a.asname:
                        self.import_aliases[a.asname] = a.name
                    self.imported_rels.add(_module_to_rel(a.name))
            elif isinstance(node, ast.ImportFrom):
                base = node.module or ""
                if node.level:
                    pkg = self._pkg(node.level)
                    base = f"{pkg}.{base}" if base else pkg
                for a in node.names:
                    name = a.asname or a.name
                    # `from pkg import mod` may bind a submodule
                    sub_rel = _module_to_rel(f"{base}.{a.name}")
                    self.from_symbols[name] = (base, a.name)
                    self.imported_rels.add(_module_to_rel(base))
                    self.imported_rels.add(sub_rel)
        # defs with class-qualified names
        def visit(node, prefix):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    qn = f"{prefix}{child.name}"
                    self.defs[qn] = child
                    self.by_basename.setdefault(child.name, []).append(qn)
                    visit(child, f"{qn}.")
                elif isinstance(child, ast.ClassDef):
                    visit(child, f"{prefix}{child.name}.")

        visit(self.mod.tree, "")


def _attr_chain(node: ast.AST) -> Optional[List[str]]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return list(reversed(parts))
    return None


def build_edges(ctx: LintContext) -> Dict[str, Set[str]]:
    """qualname ('rel/path.py:Class.fn') -> callee qualnames."""
    indexes = {rel: _ModuleIndex(m) for rel, m in ctx.modules.items()}
    edges: Dict[str, Set[str]] = {}

    def qual(rel: str, suffix: str) -> str:
        return f"{rel}:{suffix}"

    for rel, idx in indexes.items():
        for suffix, fn_node in idx.defs.items():
            out: Set[str] = set()
            cls_prefix = suffix.rsplit(".", 1)[0] + "." if "." in suffix else ""
            for node in ast.walk(fn_node):
                if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
                    # bare reference: local function used as a callback
                    for cand in idx.by_basename.get(node.id, []):
                        out.add(qual(rel, cand))
                    sym = idx.from_symbols.get(node.id)
                    if sym:
                        target_rel = _module_to_rel(sym[0])
                        tgt = indexes.get(target_rel)
                        if tgt:
                            for cand in tgt.by_basename.get(sym[1], []):
                                out.add(qual(target_rel, cand))
                elif isinstance(node, ast.Call):
                    chain = _attr_chain(node.func)
                    if not chain or len(chain) == 1:
                        continue
                    head, meth = chain[0], chain[-1]
                    if head == "self" and len(chain) == 2:
                        cand = f"{cls_prefix}{meth}"
                        if cand in idx.defs:
                            out.add(qual(rel, cand))
                            continue
                    resolved = False
                    dotted = idx.import_aliases.get(head)
                    if dotted is None and head in idx.from_symbols:
                        base, sym_name = idx.from_symbols[head]
                        dotted = f"{base}.{sym_name}"
                    if dotted and len(chain) == 2:
                        target_rel = _module_to_rel(dotted)
                        tgt = indexes.get(target_rel)
                        if tgt:
                            resolved = True
                            for cand in tgt.by_basename.get(meth, []):
                                out.add(qual(target_rel, cand))
                    if not resolved:
                        # receiver-blind fallback: any `meth` in this
                        # module or a directly-imported one
                        for cand in idx.by_basename.get(meth, []):
                            out.add(qual(rel, cand))
                        for target_rel in idx.imported_rels:
                            tgt = indexes.get(target_rel)
                            if not tgt:
                                continue
                            for cand in tgt.by_basename.get(meth, []):
                                out.add(qual(target_rel, cand))
            edges[qual(rel, suffix)] = out
    return edges


def hot_functions(
    ctx: LintContext, seeds: Optional[Sequence[str]] = None
) -> Set[str]:
    """Qualnames reachable from the seed entry points. Seeds may be
    module rel-paths (every function in the module seeds) or explicit
    'rel/path.py:fn' qualnames."""
    edges = build_edges(ctx)
    seed_set: Set[str] = set()
    for s in seeds if seeds is not None else DEFAULT_SEED_MODULES:
        if ":" in s:
            if s in edges:
                seed_set.add(s)
        else:
            prefix = s.replace("\\", "/") + ":"
            seed_set.update(q for q in edges if q.startswith(prefix))
    hot = set(seed_set)
    frontier = list(seed_set)
    while frontier:
        cur = frontier.pop()
        for nxt in edges.get(cur, ()):
            if nxt not in hot:
                hot.add(nxt)
                frontier.append(nxt)
    return hot
