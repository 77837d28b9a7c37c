"""A dataset's external force: loading ``force.py`` without JAX, and
applying it per particle.

A LagrangeBench dataset may ship a ``force.py`` defining ``force_fn(r)``, a
per-particle body force ``(dim,) -> (dim,)`` written in ``jax.numpy``
(the reference's RPF datasets, the JAX package's generator). The port runs
such a file with ``jax.numpy`` bound to :class:`JnpNamespace`, which maps
the calls these files make onto torch, for the duration of the load only:
no ``jax`` entry stays in ``sys.modules``, and a real JAX installed beside
the port comes back unchanged. A name the namespace lacks raises an
AttributeError naming it and the file; it never falls back to numpy.

:func:`apply_force` applies such a function (or one written in torch) per
particle, as the JAX package's ``jax.vmap`` does, with ``torch.func.vmap``
over the flattened ``(..., dim)`` positions: inside it ``r[1]`` is the
y-coordinate, not the second particle.
"""

from __future__ import annotations

import contextlib
import contextvars
import importlib.util
import math
import sys
import types
from typing import Callable

import torch

# (dtype, device) of the positions being forced: the namespace makes its
# constants there, as jnp makes them in the positions' precision under x64
_TARGET = contextvars.ContextVar("force_target", default=None)


def _target(*args):
    """dtype and device for new tensors: those of the first tensor among
    ``args``, else those of the positions being forced, else torch's
    default dtype on the CPU."""
    for a in args:
        if isinstance(a, torch.Tensor):
            dtype = a.dtype if a.is_floating_point() else None
            target = _TARGET.get()
            if dtype is None:
                dtype = target[0] if target else torch.get_default_dtype()
            return dtype, a.device
    target = _TARGET.get()
    return target if target else (torch.get_default_dtype(), torch.device("cpu"))


def _tensor(x, dtype=None, like=()):
    """``x`` as a tensor; a Python number lands beside the tensors of
    ``like`` (in the forced positions' dtype if it is a float)."""
    if isinstance(x, torch.Tensor):
        return x if dtype is None else x.to(dtype)
    tdtype, device = _target(*like)
    if dtype is None and not isinstance(x, float):
        return torch.as_tensor(x, device=device)
    return torch.as_tensor(x, dtype=dtype or tdtype, device=device)


def _flat(obj):
    if isinstance(obj, (list, tuple)):
        for o in obj:
            yield from _flat(o)
    else:
        yield obj


def _array(obj, dtype=None, like=()):
    """``jnp.array``: nested lists of numbers and tensors (0-d or not),
    e.g. ``jnp.array([sign, 0.0])``."""
    if not isinstance(obj, (list, tuple)):
        return _tensor(obj, dtype, like)
    tensors = [o for o in _flat(obj) if isinstance(o, torch.Tensor)]
    if tensors:
        dtype = dtype or _target(*tensors)[0]
        return torch.stack([_array(o, dtype, tensors) for o in obj])
    tdtype, device = _target(*like)
    kind = torch.tensor(obj).dtype
    return torch.tensor(obj, dtype=dtype or (tdtype if kind.is_floating_point else kind),
                        device=device)


def _unary(fn):
    def call(x):
        return fn(_tensor(x))
    return call


def _where(cond, x=None, y=None):
    if x is None and y is None:
        return torch.where(_tensor(cond))
    cond = _tensor(cond, like=(x, y))
    x = _tensor(x, like=(cond, y))
    y = _tensor(y, like=(cond, x))
    dtype = torch.promote_types(x.dtype, y.dtype)
    return torch.where(cond, x.to(dtype), y.to(dtype))


def _full(fill):
    def call(shape, dtype=None):
        dt, device = _target()
        return torch.full(tuple(shape) if isinstance(shape, (list, tuple)) else (shape,),
                          fill, dtype=dtype or dt, device=device)
    return call


def _stack(arrays, axis=0):
    parts = [_tensor(a, like=arrays) for a in arrays]
    return torch.stack(parts, dim=axis)


def _concatenate(arrays, axis=0):
    parts = [_tensor(a, like=arrays) for a in arrays]
    return torch.cat(parts, dim=axis)


def _norm(x, ord=None, axis=None, keepdims=False):
    return torch.linalg.norm(_tensor(x), ord=ord, dim=axis, keepdim=keepdims)


class JnpNamespace:
    """The ``jax.numpy`` names a dataset's ``force.py`` uses, on torch.

    ``where``, ``array``/``asarray``, ``zeros``, ``ones``, ``sin``, ``cos``,
    ``exp``, ``pi``, ``stack``, ``concatenate`` and ``linalg.norm``. Any
    other name raises an AttributeError that names it and ``source``.
    """

    _NAMES = {
        "where": _where,
        "array": _array,
        "asarray": _array,
        "zeros": _full(0.0),
        "ones": _full(1.0),
        "sin": _unary(torch.sin),
        "cos": _unary(torch.cos),
        "exp": _unary(torch.exp),
        "pi": math.pi,
        "stack": _stack,
        "concatenate": _concatenate,
        "linalg": types.SimpleNamespace(norm=_norm),
    }

    def __init__(self, source: str):
        self._source = source

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        try:
            return self._NAMES[name]
        except KeyError:
            raise AttributeError(
                f"jax.numpy.{name} (used by {self._source}) is not provided by the port's "
                f"jax.numpy namespace for force files; it provides "
                f"{', '.join(sorted(self._NAMES))}"
            ) from None


@contextlib.contextmanager
def _jax_bound_to(jnp: JnpNamespace):
    """``import jax`` / ``import jax.numpy`` resolve to ``jnp`` inside the
    block; ``sys.modules`` is restored on the way out."""
    names = ("jax", "jax.numpy")
    saved = {k: sys.modules[k] for k in names if k in sys.modules}
    fake = types.ModuleType("jax")
    fake.numpy = jnp
    sys.modules["jax"] = fake
    sys.modules["jax.numpy"] = jnp
    try:
        yield
    finally:
        for k in names:
            if k in saved:
                sys.modules[k] = saved[k]
            else:
                sys.modules.pop(k, None)


def load_force_fn(path: str) -> Callable:
    """``force_fn`` of the file at ``path``, run with ``jax.numpy`` bound to
    the port's namespace."""
    jnp = JnpNamespace(path)
    spec = importlib.util.spec_from_file_location("force_module", path)
    module = importlib.util.module_from_spec(spec)
    with _jax_bound_to(jnp):
        spec.loader.exec_module(module)
    return module.force_fn


def apply_force(force_fn: Callable, r: torch.Tensor) -> torch.Tensor:
    """``force_fn`` applied to every particle of ``r`` (..., dim): the
    per-particle function vmapped over the flattened positions on their
    device, reshaped back to (..., dim_out)."""
    flat = r.reshape(-1, r.shape[-1])
    token = _TARGET.set((r.dtype, r.device))
    try:
        out = torch.func.vmap(force_fn)(flat)
    finally:
        _TARGET.reset(token)
    out = out.to(device=r.device)
    return out.reshape(tuple(r.shape[:-1]) + tuple(out.shape[1:]))
