"""Minimal module system for the model code: dataclass modules with named,
nested parameter trees, in plain JAX.

It keeps the ``init``/``apply`` contract the rest of the package is written
against, and the parameter-tree layout checkpoints and the torch interop
rely on:

  * a module is a dataclass; ``name=`` (keyword-only) names it inside its
    parent, unnamed children are named ``<ClassName>_<n>``;
  * ``@compact`` methods create children inline, ``setup()`` assigns them as
    attributes (the attribute name is the child's name);
  * ``self.param(name, init_fn, *args)`` reads the ``params`` collection,
    creating the entry with ``init_fn(key, *args)`` under ``init``;
  * ``self.variable(collection, name, init_fn, *args)`` is a mutable
    non-parameter variable (BatchNorm's ``batch_stats``);
  * ``Module.init(key, *args, method=None, **kw)`` returns every collection
    as nested dicts; ``Module.apply(variables, *args, method=None,
    mutable=False, rngs=None, **kw)`` returns the output, or
    ``(output, updated_collections)`` when ``mutable`` names collections.

Layers (``Conv``, ``Dense``, ``Embed``, ``BatchNorm``, ``LayerNorm``,
``GroupNorm``, ``Dropout``) store ``kernel``/``bias``/``scale``/``embedding``
and ``batch_stats/{mean,var}`` under the same names and shapes as the
common JAX layer libraries, compute in ``dtype`` when it is given
(parameters stay float32), and take normalization statistics in float32.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import inspect
import threading
from typing import Any, Callable, Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
from jax import lax

initializers = jax.nn.initializers

_context = threading.local()


def _stack() -> list:
    if not hasattr(_context, "stack"):
        _context.stack = []
    return _context.stack


def _copy_dicts(tree):
    """Copy the dict structure (not the leaves) so updates never alias the
    caller's variables."""
    if isinstance(tree, dict):
        return {k: _copy_dicts(v) for k, v in tree.items()}
    return tree


class _Frame:
    """State shared by every module bound within one init/apply call."""

    def __init__(self, variables, rngs, mutable, initializing):
        self.variables = variables
        self.rngs = rngs
        self.mutable = mutable
        self.initializing = initializing
        self.rng_counters: dict = {}

    def is_mutable(self, collection: str) -> bool:
        if self.initializing or self.mutable is True:
            return True
        return collection in self.mutable

    def node(self, collection: str, path: Tuple[str, ...], create: bool):
        node = self.variables.get(collection)
        if node is None:
            if not create:
                return None
            node = self.variables[collection] = {}
        for part in path:
            child = node.get(part)
            if child is None:
                if not create:
                    return None
                child = node[part] = {}
            node = child
        return node


class Variable:
    """Handle to one entry of a non-parameter collection."""

    def __init__(self, frame: _Frame, collection: str, node: dict, name: str):
        self._frame, self._collection = frame, collection
        self._node, self._name = node, name

    @property
    def value(self):
        return self._node[self._name]

    @value.setter
    def value(self, v):
        if not self._frame.is_mutable(self._collection):
            raise ValueError(
                f"collection {self._collection!r} is immutable here; pass "
                f"mutable=[{self._collection!r}] to apply")
        self._node[self._name] = v


def _fold_in_path(key: jax.Array, data: Sequence) -> jax.Array:
    """Fold the module path and a per-module counter into ``key``: the
    first 4 bytes of the SHA-1 of the path names and the counter.  (The
    derivation the common JAX layer libraries use, so a seed gives the
    same initial parameters as there.)"""
    m = hashlib.sha1()
    for x in data:
        m.update(x.encode() if isinstance(x, str)
                 else x.to_bytes((x.bit_length() + 7) // 8, "big"))
    return jax.random.fold_in(
        key, jnp.uint32(int.from_bytes(m.digest()[:4], "big")))


def compact(fn: Callable) -> Callable:
    """Marks a method that creates submodules inline (documentation only:
    every public method may do so)."""
    return fn


def _wrap_method(fn: Callable) -> Callable:
    @functools.wraps(fn)
    def wrapped(self, *args, **kwargs):
        if self._frame is None:
            stack = _stack()
            if not stack:
                raise RuntimeError(
                    f"{type(self).__name__} is unbound: call it through "
                    f"init/apply or from inside a bound module")
            self = stack[-1]._bind_child(self)
        self._ensure_setup()
        stack = _stack()
        if not stack or stack[-1] is not self:
            # entered from outside: unnamed children are numbered afresh,
            # so a second call reuses the first call's parameters
            self._autoname = {}
        stack.append(self)
        try:
            return fn(self, *args, **kwargs)
        finally:
            stack.pop()

    return wrapped


class Module:
    """Base class; subclasses become dataclasses with a keyword-only
    ``name`` field."""

    _frame: Optional[_Frame] = None
    _path: Tuple[str, ...] = ()

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        annotations = cls.__dict__.get("__annotations__", {})
        if "name" not in annotations:
            cls.__annotations__ = {**annotations, "name": "Optional[str]"}
            cls.name = dataclasses.field(default=None, kw_only=True)
        for attr, value in list(cls.__dict__.items()):
            if (inspect.isfunction(value) and attr not in annotations
                    and attr != "setup"
                    and (attr == "__call__" or not attr.startswith("__"))):
                setattr(cls, attr, _wrap_method(value))
        dataclasses.dataclass(eq=False, repr=False)(cls)

    def __repr__(self) -> str:
        return f"{type(self).__name__}(name={self.name!r})"

    # -- binding ---------------------------------------------------------

    def _bound_copy(self, frame: _Frame, path: Tuple[str, ...]) -> "Module":
        clone = object.__new__(type(self))
        clone.__dict__.update(self.__dict__)
        clone._frame, clone._path = frame, path
        clone._children, clone._autoname = {}, {}
        clone._setup_done = False
        return clone

    def _bind_child(self, child: "Module") -> "Module":
        cached = self._children.get(id(child))
        if cached is not None and cached[0] is child:
            return cached[1]
        name = child.name
        if name is None:
            cls_name = type(child).__name__
            n = self._autoname.get(cls_name, 0)
            self._autoname[cls_name] = n + 1
            name = f"{cls_name}_{n}"
        bound = child._bound_copy(self._frame, self._path + (name,))
        self._children[id(child)] = (child, bound)
        return bound

    def _ensure_setup(self) -> None:
        if self._setup_done:
            return
        self._setup_done = True
        self.setup()
        for attr, value in list(self.__dict__.items()):
            if isinstance(value, Module) and value.name is None \
                    and not attr.startswith("_"):
                value.name = attr

    def setup(self) -> None:
        pass

    # -- variables -------------------------------------------------------

    def is_initializing(self) -> bool:
        return self._frame.initializing

    def param(self, name: str, init_fn: Callable, *init_args) -> jax.Array:
        frame = self._frame
        node = frame.node("params", self._path, create=frame.initializing)
        if node is not None and name in node:
            return node[name]
        if not frame.initializing:
            raise KeyError(
                f"parameter {'/'.join(self._path + (name,))} is missing")
        node[name] = init_fn(self.make_rng("params"), *init_args)
        return node[name]

    def variable(self, collection: str, name: str, init_fn: Callable,
                 *init_args) -> Variable:
        frame = self._frame
        create = frame.is_mutable(collection)
        node = frame.node(collection, self._path, create=create)
        if node is None or name not in node:
            if not create:
                raise KeyError(
                    f"variable {collection}/"
                    f"{'/'.join(self._path + (name,))} is missing")
            node[name] = init_fn(*init_args)
        return Variable(frame, collection, node, name)

    def make_rng(self, name: str) -> jax.Array:
        """A fresh key of stream ``name`` (``params`` under init), derived
        from this module's path and how many keys it has drawn so far."""
        frame = self._frame
        if name not in frame.rngs:
            raise ValueError(f"this call needs rngs={{{name!r}: key}}")
        n = frame.rng_counters.get((name, self._path), 0) + 1
        frame.rng_counters[(name, self._path)] = n
        return _fold_in_path(frame.rngs[name], self._path + (n,))

    # -- entry points ----------------------------------------------------

    def _run(self, frame: _Frame, method, args, kwargs):
        bound = self._bound_copy(frame, ())
        if method is None:
            method = type(self).__call__
        elif isinstance(method, str):
            method = getattr(type(self), method)
        return method(bound, *args, **kwargs)

    def init(self, rngs, *args, method=None, **kwargs) -> dict:
        if not isinstance(rngs, dict):
            rngs = {"params": rngs}
        frame = _Frame({}, rngs, True, initializing=True)
        self._run(frame, method, args, kwargs)
        return frame.variables

    def apply(self, variables: dict, *args, method=None,
              mutable: Union[bool, Sequence[str]] = False, rngs=None,
              **kwargs):
        if rngs is not None and not isinstance(rngs, dict):
            rngs = {"dropout": rngs}
        if mutable is not True and mutable is not False:
            mutable = (mutable,) if isinstance(mutable, str) else tuple(mutable)
        frame = _Frame(_copy_dicts(dict(variables)), rngs or {},
                       mutable or (), initializing=False)
        out = self._run(frame, method, args, kwargs)
        if mutable is False:
            return out
        cols = (frame.variables if mutable is True
                else {c: frame.variables.get(c, {}) for c in mutable})
        return out, cols


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def _promote(*args, dtype=None):
    dtype = dtype or jnp.result_type(*args)
    return [jnp.asarray(a, dtype) for a in args]


def _tuple(v, n: int) -> Tuple[int, ...]:
    return tuple(v) if isinstance(v, (tuple, list)) else (v,) * n


class Dense(Module):
    features: int
    use_bias: bool = True
    dtype: Optional[Any] = None
    kernel_init: Callable = initializers.lecun_normal()
    bias_init: Callable = initializers.zeros

    def __call__(self, x: jax.Array) -> jax.Array:
        kernel = self.param("kernel", self.kernel_init,
                            (x.shape[-1], self.features))
        bias = (self.param("bias", self.bias_init, (self.features,))
                if self.use_bias else None)
        x, kernel = _promote(x, kernel, dtype=self.dtype)
        y = lax.dot_general(x, kernel, (((x.ndim - 1,), (0,)), ((), ())))
        if bias is not None:
            y = y + bias.astype(y.dtype)
        return y


class Conv(Module):
    """N-D convolution on channels-last inputs with HWIO kernels."""

    features: int
    kernel_size: Sequence[int]
    strides: Union[int, Sequence[int]] = 1
    padding: Union[str, Sequence[Tuple[int, int]]] = "SAME"
    kernel_dilation: Union[int, Sequence[int]] = 1
    feature_group_count: int = 1
    use_bias: bool = True
    dtype: Optional[Any] = None
    kernel_init: Callable = initializers.lecun_normal()
    bias_init: Callable = initializers.zeros

    def __call__(self, x: jax.Array) -> jax.Array:
        ks = tuple(self.kernel_size)
        nd = len(ks)
        kernel = self.param(
            "kernel", self.kernel_init,
            ks + (x.shape[-1] // self.feature_group_count, self.features))
        bias = (self.param("bias", self.bias_init, (self.features,))
                if self.use_bias else None)
        x, kernel = _promote(x, kernel, dtype=self.dtype)
        padding = (self.padding if isinstance(self.padding, str)
                   else [tuple(p) for p in self.padding])
        spatial = "HWD"[:nd] if nd <= 3 else None
        y = lax.conv_general_dilated(
            x, kernel,
            window_strides=_tuple(self.strides, nd),
            padding=padding,
            rhs_dilation=_tuple(self.kernel_dilation, nd),
            dimension_numbers=("N" + spatial + "C", spatial + "IO",
                               "N" + spatial + "C"),
            feature_group_count=self.feature_group_count,
        )
        if bias is not None:
            y = y + bias.astype(y.dtype)
        return y


class Embed(Module):
    num_embeddings: int
    features: int
    dtype: Optional[Any] = None
    embedding_init: Callable = initializers.variance_scaling(
        1.0, "fan_in", "normal", out_axis=0)

    def __call__(self, ids: jax.Array) -> jax.Array:
        table = self.param("embedding", self.embedding_init,
                           (self.num_embeddings, self.features))
        if self.dtype is not None:
            table = table.astype(self.dtype)
        return jnp.take(table, ids, axis=0)


def _stats(x: jax.Array, axes, axis_name: Optional[str] = None):
    """Mean and biased variance in float32 (E[x^2] - E[x]^2, clamped)."""
    x = x.astype(jnp.promote_types(x.dtype, jnp.float32))
    mean = jnp.mean(x, axes)
    mean2 = jnp.mean(jnp.square(x), axes)
    if axis_name is not None:
        mean, mean2 = jnp.split(
            lax.pmean(jnp.concatenate([mean, mean2]), axis_name), 2)
    return mean, jnp.maximum(0.0, mean2 - jnp.square(mean))


def _normalize(module: Module, x, mean, var, epsilon, dtype):
    """(x - mean) * rsqrt(var + eps) * scale + bias over the last axis."""
    c = x.shape[-1]
    scale = module.param("scale", initializers.ones, (c,))
    bias = module.param("bias", initializers.zeros, (c,))
    y = (x - mean) * (lax.rsqrt(var + epsilon) * scale) + bias
    return y.astype(dtype or jnp.result_type(x, scale, bias))


class BatchNorm(Module):
    use_running_average: bool = False
    momentum: float = 0.99
    epsilon: float = 1e-5
    dtype: Optional[Any] = None
    axis_name: Optional[str] = None

    def __call__(self, x: jax.Array) -> jax.Array:
        c = x.shape[-1]
        ra_mean = self.variable("batch_stats", "mean",
                                lambda: jnp.zeros((c,), jnp.float32))
        ra_var = self.variable("batch_stats", "var",
                               lambda: jnp.ones((c,), jnp.float32))
        if self.use_running_average:
            mean, var = ra_mean.value, ra_var.value
        else:
            axes = tuple(range(x.ndim - 1))
            mean, var = _stats(
                x, axes,
                None if self.is_initializing() else self.axis_name)
            if not self.is_initializing():
                m = self.momentum
                ra_mean.value = m * ra_mean.value + (1 - m) * mean
                ra_var.value = m * ra_var.value + (1 - m) * var
        return _normalize(self, x, mean, var, self.epsilon, self.dtype)


class LayerNorm(Module):
    epsilon: float = 1e-6
    dtype: Optional[Any] = None

    def __call__(self, x: jax.Array) -> jax.Array:
        mean, var = _stats(x, (-1,))
        return _normalize(self, x, mean[..., None], var[..., None],
                          self.epsilon, self.dtype)


class GroupNorm(Module):
    num_groups: int = 32
    epsilon: float = 1e-6
    dtype: Optional[Any] = None

    def __call__(self, x: jax.Array) -> jax.Array:
        c, g = x.shape[-1], self.num_groups
        grouped = x.reshape(x.shape[:-1] + (g, c // g))
        axes = tuple(range(1, x.ndim - 1)) + (x.ndim,)
        mean, var = _stats(grouped, axes)
        bshape = (x.shape[0],) + (1,) * (x.ndim - 2) + (c,)
        mean = jnp.repeat(mean, c // g, axis=-1).reshape(bshape)
        var = jnp.repeat(var, c // g, axis=-1).reshape(bshape)
        return _normalize(self, x, mean, var, self.epsilon, self.dtype)


class Dropout(Module):
    rate: float
    deterministic: bool = False

    def __call__(self, x: jax.Array, rng: Optional[jax.Array] = None):
        if self.deterministic or self.rate == 0.0:
            return x
        if self.rate == 1.0:
            return jnp.zeros_like(x)
        if rng is None:
            rng = self.make_rng("dropout")
        keep = jax.random.bernoulli(rng, 1.0 - self.rate, x.shape)
        return jnp.where(keep, x / (1.0 - self.rate), jnp.zeros_like(x))


def _pool(x, init, op, window, strides, padding):
    strides = strides or window
    if not isinstance(padding, str):
        padding = ((0, 0),) + tuple(tuple(p) for p in padding) + ((0, 0),)
    return lax.reduce_window(x, init, op, (1,) + tuple(window) + (1,),
                             (1,) + tuple(strides) + (1,), padding)


def max_pool(x, window_shape, strides=None, padding="VALID"):
    return _pool(x, -jnp.inf, lax.max, window_shape, strides, padding)


def avg_pool(x, window_shape, strides=None, padding="VALID"):
    total = _pool(x, 0.0, lax.add, window_shape, strides, padding)
    size = 1
    for w in window_shape:
        size *= w
    return total / size
