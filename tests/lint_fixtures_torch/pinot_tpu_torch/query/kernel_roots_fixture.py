"""kernel-registry golden fixture: compiled roots under query/ are held to the
launch rule at their calls. Parsed by pinotlint only, never imported."""

import torch
import triton
import triton.language as tl

from pinot_tpu_torch.common.kernel_obs import KERNELS


@triton.jit
def _add_one(x_ptr, n, BLOCK: tl.constexpr):
    tl.store(x_ptr, n)


@triton.jit
def _bare(x_ptr):
    tl.store(x_ptr, 1)


@torch.compile
def _fused(x):
    return x * 2


def _plain(x):
    return x + 1


_compiled = torch.compile(_plain)


@torch.compile
def _registered_elsewhere(x):  # CLEAN: launched by another module, named by a register call
    return x


@torch.compile
def _orphan(x):  # line 39: VIOLATION never launched here, never registered
    return x


def launch_triton(x):
    return KERNELS.launch("fx.add_one", lambda: _add_one[(1,)](x, x.numel(), BLOCK=128), x)  # CLEAN


def launch_bare(x):
    _bare[(1,)](x)  # line 48: VIOLATION outside KERNELS.launch


def run_fused(x):
    return _fused(x)  # line 52: VIOLATION outside KERNELS.launch


def run_compiled(x):
    return KERNELS.launch("fx.compiled", lambda: _compiled(x), x)  # line 56: VIOLATION name not registered


def replay(graph, x):
    with torch.cuda.graph(graph):
        x.add_(1)
    return KERNELS.launch("fx.graph", lambda: graph.replay(), x)  # CLEAN


def replay_bare(g2, x):
    with torch.cuda.graph(g2):
        x.mul_(2)
    g2.replay()  # line 68: VIOLATION outside KERNELS.launch


def capture_elsewhere(g3, x):
    with torch.cuda.graph(g3):  # line 72: VIOLATION never replayed here, no register names it
        x.sub_(1)
    return g3


def capture_suppressed(g4, x):
    with torch.cuda.graph(g4):  # pinotlint: disable=kernel-registry — fixture: the caller replays it under KERNELS.launch
        x.sub_(2)
    return g4


def _cost(shape):
    return (1.0, 1.0)


KERNELS.register("fx.add_one", launch_triton, cost_model=_cost)
KERNELS.register("fx.graph", replay, cost_model=_cost)
KERNELS.register("_registered_elsewhere")


def replay_in_program(g5, x, out):
    with capture_graph(g5, None, x.device):  # the port's capture (query/graphs.py)
        x.add_(3)
    with KERNELS.program("fx.graph", x.device, rows=1):
        g5.replay()  # CLEAN: inside the registered program record
        out.copy_(x)


def replay_in_timed_sync(g6, x):
    with capture_graph(g6, None, x.device):
        x.add_(4)
    return KERNELS.timed_sync("fx.graph", lambda: g6.replay(), x.device)  # CLEAN: inside a registered record


def replay_under_unregistered_program(g7, x):
    with capture_graph(g7, None, x.device):
        x.add_(5)
    with KERNELS.program("fx.unregistered", x.device):
        g7.replay()  # VIOLATION: the program record's name is not registered
