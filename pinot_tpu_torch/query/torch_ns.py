"""An array namespace over torch tensors for `transforms.DEVICE_FUNCS`.

The transform functions are written once, against an array namespace passed
as their first argument (`fn(xp, *args)`): the host executor passes numpy and
the JAX package's device program passes jnp. The per-segment program passes
`XP`, this module's namespace, and wraps each argument in `Arr`, so the same
functions run as torch ops on the tensors' device. `Arr` carries the array
methods and operators the functions use (`astype`, arithmetic, compares,
`&` / `|`, `**`, unary minus) and reproduces jnp's dtypes:

 * a Python scalar is weakly typed: it takes the array's dtype, except that a
   float scalar beside an integer array gives float64 (jnp under x64; torch
   would give its default float32);
 * `where` of two Python scalars is weakly typed too (jnp.where(c, 3, -9)
   added to an int32 array stays int32);
 * two arrays promote by torch.promote_types, a 0-d operand included (jnp's
   rule; torch would let the dimensioned side win within a category).

`mod` is floor-mod (torch.remainder, not fmod), `floor_divide` floors (an
integer divisor of 0 gives XLA's results, where torch's CPU ops raise), and
`cbrt`, which torch lacks, is sign(x) * |x|^(1/3): within 2 ulp of np.cbrt
(tests/test_torch_tags.py holds it to rtol 4.5e-16).
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

float64 = torch.float64


class Arr:
    """A torch tensor with jnp's array surface; `weak` marks a value built
    from Python scalars alone (it adopts its partner's dtype)."""

    __slots__ = ("t", "weak")

    def __init__(self, t: torch.Tensor, weak: bool = False):
        self.t = t
        self.weak = weak

    def astype(self, dtype) -> "Arr":
        return Arr(self.t.to(dtype))

    def _bin(self, other, fn, reflected=False) -> "Arr":
        a, b = _pair(self, other)
        return Arr(fn(b, a) if reflected else fn(a, b), self.weak and _is_weak(other))

    def __add__(self, o):
        return self._bin(o, torch.add)

    def __radd__(self, o):
        return self._bin(o, torch.add, True)

    def __sub__(self, o):
        return self._bin(o, torch.sub)

    def __rsub__(self, o):
        return self._bin(o, torch.sub, True)

    def __mul__(self, o):
        return self._bin(o, torch.mul)

    def __rmul__(self, o):
        return self._bin(o, torch.mul, True)

    def __truediv__(self, o):
        return self._bin(o, _true_div)

    def __rtruediv__(self, o):
        return self._bin(o, _true_div, True)

    def __pow__(self, o):
        return self._bin(o, torch.pow)

    def __neg__(self):
        return Arr(-self.t, self.weak)

    def __and__(self, o):
        return self._bin(o, torch.bitwise_and)

    def __or__(self, o):
        return self._bin(o, torch.bitwise_or)

    def __lt__(self, o):
        return self._bin(o, torch.lt)

    def __le__(self, o):
        return self._bin(o, torch.le)

    def __gt__(self, o):
        return self._bin(o, torch.gt)

    def __ge__(self, o):
        return self._bin(o, torch.ge)

    def __eq__(self, o):  # noqa: D105 - elementwise, as jnp's
        return self._bin(o, torch.eq)

    def __ne__(self, o):
        return self._bin(o, torch.ne)

    __hash__ = None


def _is_weak(x) -> bool:
    return isinstance(x, (bool, int, float)) or (isinstance(x, Arr) and x.weak)


def _true_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # jnp's true_divide of integers is float64 under x64
    if not a.dtype.is_floating_point:
        a = a.to(float64)
    return a / b


def _pair(a, b) -> tuple[torch.Tensor, torch.Tensor]:
    """Both operands as tensors of jnp's result dtype."""
    if isinstance(a, Arr) and isinstance(b, Arr):
        if a.weak != b.weak:
            strong, weak = (a, b) if b.weak else (b, a)
            dt = _with_weak(strong.t.dtype, weak.t.dtype)
        else:
            dt = torch.promote_types(a.t.dtype, b.t.dtype)
        return a.t.to(dt), b.t.to(dt)
    arr, scalar = (a, b) if isinstance(a, Arr) else (b, a)
    t = arr.t
    if isinstance(scalar, float) and not t.dtype.is_floating_point:
        t = t.to(float64)
    s = torch.tensor(scalar, dtype=t.dtype, device=t.device)
    return (t, s) if isinstance(a, Arr) else (s, t)


def _with_weak(strong: torch.dtype, weak: torch.dtype) -> torch.dtype:
    """jnp's dtype for a strong array beside a weakly typed one: the strong
    dtype, unless a weak float meets an integer (then float64)."""
    if weak.is_floating_point and not strong.is_floating_point:
        return float64
    return strong


def _unary(fn, float_only: bool = False):
    def op(x):
        t = x.t
        if float_only and not t.dtype.is_floating_point:
            t = t.to(float64)
        return Arr(fn(t), x.weak)

    return op


abs = _unary(torch.abs)  # noqa: A001 - the namespace's name
sign = _unary(torch.sign)
floor = _unary(torch.floor, True)
ceil = _unary(torch.ceil, True)
trunc = _unary(torch.trunc, True)
sqrt = _unary(torch.sqrt, True)
exp = _unary(torch.exp, True)
log = _unary(torch.log, True)
log2 = _unary(torch.log2, True)
log10 = _unary(torch.log10, True)
sin = _unary(torch.sin, True)
cos = _unary(torch.cos, True)
tan = _unary(torch.tan, True)
arcsin = _unary(torch.asin, True)
arccos = _unary(torch.acos, True)
arctan = _unary(torch.atan, True)
sinh = _unary(torch.sinh, True)
cosh = _unary(torch.cosh, True)
tanh = _unary(torch.tanh, True)
degrees = _unary(torch.rad2deg, True)
radians = _unary(torch.deg2rad, True)


def cbrt(x: Arr) -> Arr:
    t = x.t if x.t.dtype.is_floating_point else x.t.to(float64)
    return Arr(torch.sign(t) * torch.abs(t).pow(1.0 / 3.0), x.weak)


def _binary(fn):
    """fn(a, b) with jnp's promotion; at least one side is an Arr."""

    def op(a, b):
        x, y = _pair(a, b)
        return Arr(fn(x, y), _is_weak(a) and _is_weak(b))

    return op


def _floor_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.dtype.is_floating_point:
        return torch.div(a, b, rounding_mode="floor")
    # an integer divisor of 0 gives what XLA's does (-1 for 0 / 0, else -2)
    # where torch's CPU division would raise
    zero = b == 0
    q = torch.div(a, torch.where(zero, 1, b), rounding_mode="floor")
    return torch.where(zero, torch.where(a == 0, -1, -2).to(q.dtype), q)


def remainder(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """jnp.mod: floor-mod (torch.remainder, not fmod); an integer divisor of
    0 gives 0, as XLA's, where torch's CPU remainder would raise."""
    if a.dtype.is_floating_point:
        return torch.remainder(a, b)
    zero = b == 0
    return torch.where(zero, 0, torch.remainder(a, torch.where(zero, 1, b))).to(a.dtype)


floor_divide = _binary(_floor_div)
mod = _binary(remainder)
minimum = _binary(torch.minimum)
maximum = _binary(torch.maximum)
arctan2 = _binary(torch.atan2)


def power(a, b) -> Arr:
    if not isinstance(a, Arr):
        # a Python scalar base: jnp.power(10.0, s)
        t = b.t if b.t.dtype.is_floating_point or not isinstance(a, float) else b.t.to(float64)
        return Arr(torch.pow(a, t), b.weak)
    x, y = _pair(a, b)
    return Arr(torch.pow(x, y), a.weak and _is_weak(b))


def where(cond: Arr, a, b) -> Arr:
    c = cond.t
    if isinstance(a, Arr) or isinstance(b, Arr):
        ta = a if isinstance(a, Arr) else Arr(torch.tensor(a, device=c.device), True)
        tb = b if isinstance(b, Arr) else Arr(torch.tensor(b, device=c.device), True)
        x, y = _pair(ta, tb)
        return Arr(torch.where(c, x, y), ta.weak and tb.weak)
    # two Python scalars: weakly typed, int64 or float64 until it meets an array
    dt = float64 if isinstance(a, float) or isinstance(b, float) else torch.int64
    return Arr(torch.where(c, torch.tensor(a, dtype=dt, device=c.device), torch.tensor(b, dtype=dt, device=c.device)), True)


def ones_like(x: Arr) -> Arr:
    return Arr(torch.ones_like(x.t), x.weak)


#: the namespace handed to DEVICE_FUNCS
XP = SimpleNamespace(**{
    name: globals()[name]
    for name in (
        "float64", "abs", "sign", "floor", "ceil", "trunc", "sqrt", "exp", "log", "log2", "log10",
        "sin", "cos", "tan", "arcsin", "arccos", "arctan", "arctan2", "sinh", "cosh", "tanh", "degrees", "radians",
        "cbrt", "floor_divide", "mod", "minimum", "maximum", "power", "where", "ones_like",
    )
})


def apply(fn, args: list[torch.Tensor]) -> torch.Tensor:
    """DEVICE_FUNCS' builder `fn` over torch tensors: the result tensor."""
    out = fn(XP, *(Arr(a) for a in args))
    return out.t if isinstance(out, Arr) else out
