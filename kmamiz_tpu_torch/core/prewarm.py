"""The boot prewarm and its readiness state.

Stands for kmamiz_tpu/core/programs.py's `boot_prewarm_from_env`,
`start_background_prewarm`, `run_prewarm` (less its shape-hint replay
and cost ranking: the port has no per-shape programs), `warm_state` and
`ready_gate_enabled`. What a restart pays in the port
is not XLA compiles but each library's first use: g++ for the host
library and nvcc for each kernel library when no build is found
(core/compile_cache.py), the dlopen, and CUDA's lazy load of a kernel's
module at its first launch. The plan pays all of it before traffic:

1. the host library and, on a card, both kernel libraries, built or
   loaded at once (a thread each);
2. the processor's `warm_up`: two scratch ticks on its device, which
   launch kernel 1 (segment stats) and take the allocator's first blocks;
3. kernel 2 (the fused SDDMM/SpMM forward, and the keys kernel of its
   edge index) launched on scratch inputs at each vector width, ungated
   and gated, so that the first forecast GET loads no module.

On the CPU the plan loads the host library only; without a processor
(simulator and serve-only modes) it loads nothing. Its report names every
library this process has loaded: built or loaded, with its build and load
milliseconds (compile_cache.loads).

KMAMIZ_PREWARM: "0" off (status "disabled"), "sync" blocks the boot,
anything else runs the plan on a daemon thread. While it runs the status
is "warming"; then "ready", or "error" with the error's text. The health
routes (api/handlers/health.py, the DP server's GET /) answer 503 while
`serving_blocked()`: the status is "warming" or "error" and
KMAMIZ_PREWARM_READY_GATE is not "0". The JAX package answers 200 on
"error", since it serves degraded and compiles at first use; in the port
a library that failed to build fails again at its first launch, so the
gate keeps the pod out of service instead. Ticks that arrive while the
plan runs (the gate holds only the health routes) run beside its scratch
ticks.
"""
from __future__ import annotations

import logging
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional

from kmamiz_tpu_torch.core import compile_cache
from kmamiz_tpu_torch.telemetry.profiling.events import now_ms, wall_ms

logger = logging.getLogger("kmamiz_tpu_torch.prewarm")

#: node-table widths of kernel 2's scratch launches: vector widths 1, 2, 4
FORWARD_WIDTHS = (1, 2, 4)
SCRATCH_NODES = 64
SCRATCH_EDGES = 256

_warm_lock = threading.Lock()
_warm: Dict[str, Any] = {"status": "cold"}
_warm_thread: Optional[threading.Thread] = None


def warm_state() -> dict:
    with _warm_lock:
        return dict(_warm)


def ready_gate_enabled() -> bool:
    return os.environ.get("KMAMIZ_PREWARM_READY_GATE", "1") != "0"


def serving_blocked() -> bool:
    """Whether the health routes answer 503: the plan runs or failed, and
    the ready gate is on."""
    return warm_state().get("status") in ("warming", "error") and ready_gate_enabled()


def _load_libraries(device) -> None:
    """The host library and, on a card, every main-path kernel library,
    built or loaded at once."""
    from kmamiz_tpu_torch import native

    jobs = [native.available]
    if device.type == "cuda":
        from kmamiz_tpu_torch.ops import cuda_build

        jobs += [lambda name=name: cuda_build.load(name) for name in compile_cache.main_path_kernels()]
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        for job in [pool.submit(fn) for fn in jobs]:
            job.result()


def _launch_kernel_2(device) -> int:
    """Kernel 2's forward on seeded scratch inputs at every vector width,
    ungated and gated, with the edge index's keys kernel: CUDA loads each
    kernel's module at its first launch. Returns the forward launches."""
    import torch

    from kmamiz_tpu_torch.ops import sparse

    gen = torch.Generator().manual_seed(0)
    n, e = SCRATCH_NODES, SCRATCH_EDGES
    src = torch.randint(0, n, (e,), generator=gen, dtype=torch.int32).to(device)
    dst = torch.randint(0, n, (e,), generator=gen, dtype=torch.int32).to(device)
    mask = (torch.arange(e) % 4 != 0).to(device)
    index = sparse.edge_index(src, dst, mask, n)
    launches = 0
    with torch.no_grad():
        for h in FORWARD_WIDTHS:
            v, q, k = (torch.randn(n, h, generator=gen, dtype=torch.float32).to(device) for _ in range(3))
            b_edge = torch.zeros(1, dtype=torch.float32, device=device)
            sparse.fused_sddmm_spmm(v, src, dst, mask, index=index)
            sparse.fused_sddmm_spmm(v, src, dst, mask, q, k, b_edge, index=index)
            launches += 2
    # graftlint: disable=host-sync-in-hot-path -- boot work: the plan waits for its launches before it reports ready
    torch.cuda.synchronize(device)
    return launches


def run_prewarm(processor=None) -> dict:
    """Execute the boot prewarm plan synchronously on `processor`'s device
    (see the module docstring). Returns its report (also stored in
    warm_state() by the dispatchers)."""
    t0 = now_ms()
    mark = compile_cache.snapshot()
    report: Dict[str, Any] = {"device": None if processor is None else str(processor.device)}
    if processor is not None:
        device = processor.device
        _load_libraries(device)
        t = now_ms()
        processor.warm_up()
        report["warmUpMs"] = now_ms() - t
        if device.type == "cuda":
            t = now_ms()
            report["kernel2Launches"] = _launch_kernel_2(device)
            report["kernel2Ms"] = now_ms() - t
    loaded = compile_cache.loads()
    report["libraries"] = {
        entry["library"]: {
            "kind": entry["kind"],
            "built": entry["built"],
            "buildMs": entry["buildMs"],
            "loadMs": entry["loadMs"],
            "inPlan": i >= mark,
            "path": entry["path"],
        }
        for i, entry in enumerate(loaded)
    }
    report["loadedInPlan"] = len(loaded) - mark
    report["builtInPlan"] = sum(entry["built"] for entry in loaded[mark:])
    report["elapsedS"] = (now_ms() - t0) / 1e3
    return report


def start_background_prewarm(processor=None) -> Optional[threading.Thread]:
    """Run the plan on a daemon thread; the health routes answer WARMING
    (503 while the ready gate is on) until it completes. Idempotent."""
    global _warm_thread
    with _warm_lock:
        if _warm["status"] in ("warming", "ready", "error"):
            return _warm_thread
        _warm.clear()
        _warm.update({"status": "warming", "startedAt": wall_ms() / 1e3})

    def _run() -> None:
        status = "ready"
        report: Dict[str, Any] = {}
        try:
            report = run_prewarm(processor)
        except Exception as e:  # noqa: BLE001 - the health routes report it
            logger.exception("background prewarm failed")
            status, report = "error", {"error": str(e)}
        with _warm_lock:
            _warm["status"] = status
            _warm["report"] = report
        logger.info("prewarm %s: %s", status, report)

    thread = threading.Thread(target=_run, name="kmamiz-prewarm", daemon=True)
    with _warm_lock:
        _warm_thread = thread
    thread.start()
    return thread


def boot_prewarm_from_env(processor=None) -> Optional[threading.Thread]:
    """KMAMIZ_PREWARM dispatcher for the server mains: "0" off, "sync"
    blocking, anything else (default "1") in the background behind the
    readiness gate. Returns the background thread, if one started."""
    mode = os.environ.get("KMAMIZ_PREWARM", "1")
    if mode == "0":
        with _warm_lock:
            _warm.update({"status": "disabled"})
        return None
    if mode == "sync":
        with _warm_lock:
            _warm.update({"status": "warming", "startedAt": wall_ms() / 1e3})
        report = run_prewarm(processor)
        with _warm_lock:
            _warm.update({"status": "ready", "report": report})
        return None
    return start_background_prewarm(processor)
