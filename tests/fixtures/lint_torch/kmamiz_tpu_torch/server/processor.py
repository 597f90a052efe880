"""graftlint fixture — hot seed module (mirrors the real processor's
place in the call graph; parsed by the linter, never imported).

Violation lines carry EXPECT markers naming their rule; the test
computes the expected finding set from them and requires exact equality.
"""
import time
from time import perf_counter

import numpy as np

import torch


from kmamiz_tpu_torch.cold import offline  # noqa: F401  (imported, never called)
from kmamiz_tpu_torch.ops import shapes


def tick(batch):
    dev = torch.as_tensor(batch, device="cuda")
    stats = dev.cpu()  # EXPECT: host-sync-in-hot-path
    flag = bool(dev.any())  # EXPECT: host-sync-in-hot-path
    return stats, flag


def tick_item(batch):
    dev = torch.as_tensor(batch, device="cuda")
    return dev.sum().item()  # EXPECT: host-sync-in-hot-path


def tick_float(batch):
    dev = torch.as_tensor(batch, device="cuda")
    return float(dev.sum())  # EXPECT: host-sync-in-hot-path


def tick_blocked(batch):
    dev = torch.as_tensor(batch, device="cuda")
    torch.cuda.synchronize()  # EXPECT: host-sync-in-hot-path
    return dev


def tick_suppressed(batch):
    dev = torch.as_tensor(batch, device="cuda")
    return dev.tolist()  # graftlint: disable=host-sync-in-hot-path -- fixture: suppressed on purpose


def tick_dtype(batch):
    acc = np.zeros(8, dtype=np.float64)  # EXPECT: dtype-drift
    buf = torch.zeros(8)  # EXPECT: dtype-drift
    wide = batch.double()  # EXPECT: dtype-drift
    return acc, buf, wide


def tick_clean(batch):
    dev = torch.as_tensor(batch, dtype=torch.float32, device="cuda")
    n_meta = int(dev.shape[0])  # metadata read, not a device sync
    return shapes.prepare_clean(dev), n_meta


# stands in for a handle preallocated at import time (the fixture is
# parsed, never imported, so the value is irrelevant)
DROP_HANDLE = None


def tick_metrics(registry, counters, reason):
    h = counters.handle("drops")  # EXPECT: hot-path-metric-label
    fam = registry.counter_family("d", "help", ("r",))  # EXPECT: hot-path-metric-label
    counters.incr(f"drops.{reason}")  # EXPECT: hot-path-metric-label
    counters.incr("drops." + reason)  # EXPECT: hot-path-metric-label
    counters.observe("lat_%s" % reason, 1.0)  # EXPECT: hot-path-metric-label
    return h, fam


def tick_metrics_suppressed(counters, reason):
    counters.incr(f"drops.{reason}")  # graftlint: disable=hot-path-metric-label -- fixture: suppressed on purpose


def tick_timed(batch):
    t0 = time.perf_counter()  # EXPECT: hot-path-clock
    stamp = time.time()  # EXPECT: hot-path-clock
    t1 = perf_counter()  # EXPECT: hot-path-clock
    return batch, t0, t1, stamp


def tick_timed_suppressed(batch):
    return batch, time.time()  # graftlint: disable=hot-path-clock -- fixture: suppressed on purpose


def tick_timed_clean(batch, prof_events):
    t0 = prof_events.now_ms()  # sanctioned graftprof clock helper: fine
    return batch, prof_events.wall_ms() - t0


def tick_metrics_clean(counters):
    DROP_HANDLE.inc()  # write through a preallocated handle: fine
    counters.incr("drops")  # constant name: fine
    counters.observe(12.5)  # plain value, no label: fine


def tick_host_copies(batch):
    dev = torch.as_tensor(batch, device="cuda")
    rows = dev.tolist()  # EXPECT: host-sync-in-hot-path
    arr = dev.numpy()  # EXPECT: host-sync-in-hot-path
    mirror = np.asarray(dev)  # EXPECT: host-sync-in-hot-path
    done = torch.cuda.Event()
    done.synchronize()  # EXPECT: host-sync-in-hot-path
    return rows, arr, mirror


def tick_host_copies_clean(batch):
    host = np.asarray(batch)  # host data: no sync
    rows = host.tolist()  # a numpy array's list: no sync
    n = int(batch.shape[0])  # metadata read, not a device sync
    return rows, n, torch.float32


def tick_dtype_more(batch):
    acc = torch.zeros(8, dtype=torch.float64)  # EXPECT: dtype-drift
    noise = torch.randn(4)  # EXPECT: dtype-drift
    cast = batch.to(torch.double)  # EXPECT: dtype-drift
    return acc, noise, cast


def tick_dtype_clean(batch):
    buf = torch.zeros(8, dtype=torch.float32)
    ids = torch.arange(8)  # an integer arange takes no default dtype
    return buf, ids, batch.float()
