"""graftlint fixture — compiled entry points: the port compiles nothing
(no torch.compile, no TorchScript); one seeded violation per form."""
from functools import partial

import torch
from torch import jit

from kmamiz_tpu_torch.ops import segment_stats


@torch.compile
def kernel(x, n):  # EXPECT: unregistered-jit
    return x * n


@segment_stats.counted
@torch.no_grad()
def padded_kernel(x, n):  # clean twin: eager, under plain decorators
    return x + n


inline = torch.compile(lambda x: x - 1)  # EXPECT: unregistered-jit


def scan_walk(xs):
    def step(c, x):
        return c + x, c

    return jit.script(step)  # EXPECT: unregistered-jit


@partial(torch.compile, mode="max-autotune")
@torch.no_grad()
def train_epoch(params, opt_state, batch):  # EXPECT: unregistered-jit
    def step(carry, x):
        return carry, x

    return torch.jit.trace(step, (params, opt_state))  # EXPECT: unregistered-jit


@segment_stats.counted
@torch.no_grad()
def train_epoch_donated(params, opt_state, batch):  # clean twin: eager
    def step(carry, x):
        return carry, x

    out = step((params, opt_state), batch)
    return out
