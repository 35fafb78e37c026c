"""kernel-registry golden fixture: a fake ops/ module that launches the
entries of csrc/launch_fixture.cu. Parsed by pinotlint only, never imported."""

import ctypes

from pinot_tpu_torch.common.kernel_obs import KERNELS


def _library():
    lib = ctypes.CDLL("launch_fixture.so")
    lib.fx_registered.restype = ctypes.c_int  # CLEAN: an attribute, not a call
    return lib


def registered(x, stream):
    lib = _library()
    return KERNELS.launch("fx.registered", lambda: lib.fx_registered(x, 1, stream), x)  # CLEAN


def unwrapped(x, stream):
    return _library().fx_unwrapped(x, 1, stream)  # line 21: VIOLATION outside KERNELS.launch


def unregistered(x, stream):
    lib = _library()
    return KERNELS.launch("fx.unknown", lambda: lib.fx_unregistered(x, 1, stream), x)  # line 26: VIOLATION


def dynamic(x, stream, name):
    lib = _library()
    return KERNELS.launch(name, lambda: lib.fx_dynamic_name(x, 1, stream), x)  # line 31: VIOLATION


def by_reference(x, stream):
    lib = _library()

    def body():
        return lib.fx_by_reference(x, 1, stream)  # line 38: VIOLATION a def is not the launch's argument

    return KERNELS.launch("fx.registered", body, x)


def plan(n):
    return _library().fx_plan(n, None)  # CLEAN: a host query


def suppressed(x, stream):
    return _library().fx_registered(x, 2, stream)  # pinotlint: disable=kernel-registry — fixture: a warm-up call the registry should not count


def _cost(shape):
    return (1.0, 1.0)


KERNELS.register("fx.registered", registered, cost_model=_cost)
