"""Golden fixture for the port's jit-purity checker (never imported: torch and
triton names are only referenced lexically; same lines as the JAX fixture)."""

import functools
import time

import torch
import triton

_cache = {}


@torch.compile
def impure_host_call(x):
    t0 = time.perf_counter()  # line 15: VIOLATION host call
    return x + t0


@functools.partial(triton.jit, do_not_specialize=("x",))
def branch_ok_static(x, n: triton.language.constexpr):
    if n > 4:  # CLEAN: n is a Triton constexpr
        return x * 2
    return x


@torch.compile
def branch_on_traced(x, y):
    if y > 0:  # line 28: VIOLATION branch on non-static parameter
        return x
    return -x


@torch.compile
def shape_branch_ok(x):
    if x.shape[0] > 128:  # CLEAN: shape is trace-static
        return x[:128]
    return x


@torch.compile
def mutates_closure(x):
    _cache["last"] = x  # line 42: VIOLATION trace-time mutation
    return x


@torch.compile
def suppressed_mutation(x):
    _cache["ok"] = x  # pinotlint: disable=jit-purity — fixture: deliberate trace-time capture
    return x


def make_kernel():
    def run(x):
        print(x)  # line 54: VIOLATION host call inside torch.compile(run)
        return torch.sum(x)

    return torch.compile(run)


def _helper(x):
    time.sleep(0.1)  # line 61: VIOLATION reachable from compiled caller
    return x


@torch.compile
def calls_impure_helper(x):
    return _helper(x)


def pure_helper(x):
    return torch.tanh(x)


@torch.compile
def calls_pure_helper(x):  # CLEAN
    return pure_helper(x)
