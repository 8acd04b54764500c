"""Scope — name -> tensor environment (the port's counterpart of
``paddle_tpu/core/scope.py``).

A Scope holds the *persistable* state between Executor runs: parameters,
optimizer moments, beta powers, the learning rate and the RNG state —
torch tensors on the device of the Executor that wrote them.  The
Executor updates parameters and moments **in place**, so a tensor taken
from the scope before a step shows the step's update afterwards.

:func:`load_numpy_state` carries the JAX package's persistables (a
``{name: numpy array}`` dict) into a scope under the same names, shapes,
``[in, out]`` layout and dtypes.
"""

import contextlib

import numpy as np
import torch

from .place import resolve_device

RNG_VAR = "@RNG@"
# the step's global gradient norm, written by the Executor after every
# training step; like @RNG@ it is scope state, not a Program variable
GRAD_NORM_VAR = "@GRAD_NORM@"


def tensor_from_numpy(value):
    """A CPU tensor holding a copy of ``value`` (numpy array, anything
    ``np.asarray`` takes, or a tensor).  numpy has no bfloat16 of its own:
    arrays of the ``bfloat16`` extension type cross as raw 16-bit words."""
    if isinstance(value, torch.Tensor):
        return value
    a = np.asarray(value)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(
            np.array(a.view(np.uint16), copy=True)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def tensor_to_numpy(t):
    """A numpy copy of a tensor; bfloat16 is widened to float32 (exact),
    because plain numpy cannot hold it."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


class Scope:
    def __init__(self, parent=None):
        self._vars = {}
        self.parent = parent

    def find_var(self, name):
        s = self
        while s is not None:
            if name in s._vars:
                return s._vars[name]
            s = s.parent
        return None

    def var_names(self):
        return list(self._vars)

    def get(self, name):
        v = self.find_var(name)
        if v is None:
            raise KeyError(f"variable {name!r} not found in scope")
        return v

    def set(self, name, value):
        self._vars[name] = value

    def update(self, mapping):
        self._vars.update(mapping)

    def delete(self, name):
        self._vars.pop(name, None)

    def numpy(self, name):
        return tensor_to_numpy(self.get(name))

    def new_scope(self):
        return Scope(parent=self)

    def ensure_rng(self, seed=0, device="cpu"):
        """The ``@RNG@`` entry is the state of the ``torch.Generator``
        (Philox on the card) that the step's random ops draw from."""
        if self.find_var(RNG_VAR) is None:
            gen = torch.Generator(device=device)
            gen.manual_seed(int(seed))
            self.set(RNG_VAR, gen.get_state())


def load_numpy_state(scope, arrays, device=None):
    """Put ``{name: numpy array}`` — the reference's persistables after
    its startup program ran: weights, Adam moments, beta powers,
    ``learning_rate_0`` — into ``scope`` as tensors on ``device`` (default:
    the card; ``"cpu"`` must be asked for).  Names, shapes, the
    ``[in, out]`` layout and dtypes are kept (bfloat16 arrives as the
    numpy extension type and stays bfloat16).  Returns the scope."""
    dev = resolve_device(device)
    for name, value in arrays.items():
        scope.set(name, tensor_from_numpy(value).to(dev))
    return scope


_global_scope = Scope()
_scope_stack = [_global_scope]


def global_scope():
    return _scope_stack[-1]


@contextlib.contextmanager
def scope_guard(scope):
    _scope_stack.append(scope)
    try:
        yield scope
    finally:
        _scope_stack.pop()
