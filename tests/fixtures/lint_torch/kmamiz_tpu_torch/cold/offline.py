"""graftlint fixture — COLD module: the exact host-sync patterns the hot
twin (server/processor.py) gets flagged for, but unreachable from the
tick/serve seeds, so the call-graph gating must produce ZERO findings
here (the fixture test asserts exact equality, which covers this)."""
import time

import torch
from torch import cuda


def export_report(arr):
    dev = torch.as_tensor(arr, device="cuda")
    host = dev.cpu()  # cold path: fine
    cuda.synchronize()  # cold path: fine
    return float(dev.sum()), host.item()  # cold path: fine


def export_timing():
    t0 = time.perf_counter()  # cold path: fine
    return time.time() - t0  # cold path: fine


def export_metrics(counters, reason):
    h = counters.handle("exports")  # cold path: fine
    counters.incr(f"exports.{reason}")  # cold path: fine
    return h
