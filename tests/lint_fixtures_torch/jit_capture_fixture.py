"""Golden fixture for the port's other compiled roots: torch.jit.script,
Triton kernels with tl.constexpr parameters, torch.compile of a lambda and
with options, and CUDA graph capture. Parsed only, never imported."""

import logging

import numba
import torch
import triton
import triton.language as tl

_graphs = {}


@torch.jit.script
def scripted(x):
    logging.info("traced")  # line 17: VIOLATION host call
    return x


@triton.autotune(configs=[], key=["n"])
@triton.jit
def kernel(x_ptr, n, BLOCK: tl.constexpr):
    if BLOCK > 64:  # CLEAN: BLOCK is tl.constexpr
        tl.store(x_ptr, 1)
    if n > 0:  # line 26: VIOLATION branch on a runtime argument
        tl.store(x_ptr, 2)


_lam = torch.compile(lambda x: print(x))  # line 30: VIOLATION host call in a lambda root


@torch.compile(mode="max-autotune")
def with_options(x, flag):
    if x.device.type == "cuda":  # CLEAN: .device is trace-static
        return x
    if flag:  # line 37: VIOLATION branch on non-static parameter
        return -x
    return x


@numba.jit
def not_a_root(x):  # CLEAN: only the port's compilers make roots
    print(x)
    return x


def capture(graph, x, out, n):
    with torch.cuda.graph(graph):
        y = x * 2
        out[:] = y  # CLEAN: store into a parameter's buffer
        _graphs["last"] = y  # line 52: VIOLATION store into module state at capture
        if n > 1:  # line 53: VIOLATION branch decided once, at capture
            out.add_(1)
        if x.dtype == torch.float32:  # CLEAN: dtype is static
            out.mul_(2)
        logging.debug("captured")  # line 57: VIOLATION host call at capture
    print("after capture")  # CLEAN: outside the captured body
    return graph


def capture_suppressed(graph, x):
    with torch.cuda.graph(graph):
        _graphs["warm"] = x  # pinotlint: disable=jit-purity — fixture: deliberate capture-time bookkeeping
    return graph
