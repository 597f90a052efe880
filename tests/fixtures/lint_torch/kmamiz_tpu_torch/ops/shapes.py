"""graftlint fixture — the JAX corpus's shape hazards, which the port has
no rule for (eager PyTorch does not retrace per shape): no finding here."""
from kmamiz_tpu_torch.ops.kernels import kernel


def _pad_size(n):
    return max(8, 1 << (int(n) - 1).bit_length())


def prepare(arr):
    n = arr.shape[0]
    return kernel(arr, n)  # no shape-hazard rule in the port


def prepare_inline(arr):
    return kernel(arr, arr.shape[0] * 2)  # no shape-hazard rule in the port


def prepare_fstring(arr):
    n = arr.shape[0]
    return f"rows={n}"  # no shape-hazard rule in the port


def prepare_keyed(cache, arr):
    cache[arr.shape] = arr  # no shape-hazard rule in the port
    return cache


def prepare_clean(arr):
    n = _pad_size(arr.shape[0])  # bucketed: launders the scalar
    return kernel(arr, n)


def prepare_clean_raise(arr):
    if arr.shape[0] % 8:
        raise ValueError(f"bad row count {arr.shape[0]}")  # diagnostic
    return arr
