"""Runtime shape and type checking for the kernel and model entry points.

Counterpart of ``stamp_tpu/utils/shapecheck.py``, with the JAX package's
annotation syntax (``Float[torch.Tensor, "b n three_dim"]``, ``Bool[...]``,
``X | Y``, ``X | None``) and its rules: a tensor argument annotated so must
be a tensor of that kind (floating point, or bool) with one named axis a
dimension, a name's size the same in every argument and in the return value
of the call, and a number that exact size.  A call that breaks one raises
``ShapeError`` (a ``TypeError``, as jaxtyping's) before the function runs,
so before any kernel launches.

The checker is the port's own: jaxtyping's ``jaxtyped`` imports jax where
jax is installed (it registers a traceback filter on first use), and jax is
installed on both machines the port runs on, which the port may not load.

In JAX the check runs while a jitted function traces, once for each new
signature.  PyTorch runs eagerly, so a check at every call would sit on the
extraction hot path (24 ``fused_qkv_mha`` calls a UNI2 batch):
``shapechecked`` checks a call whose signature — the shapes, dtypes and
devices of its tensors and the values of its other arguments — it has not
seen, and remembers the signatures that passed; a call that repeats one
runs unchecked.
"""

from __future__ import annotations

import functools
import inspect
from dataclasses import dataclass
from typing import Any, Callable, TypeVar

import torch

_F = TypeVar("_F", bound=Callable[..., Any])

#: checked calls since the process started (a repeated signature is not checked)
CHECKS = 0
#: signatures a function remembers; past this many it forgets them all
MAX_SIGNATURES = 4096


class ShapeError(TypeError):
    """A call whose tensors break its annotations."""


@dataclass(frozen=True)
class _Array:
    kind: str  # "Float" or "Bool"
    dims: tuple[str, ...]

    def __or__(self, other) -> _Union:
        return _Union((self, other))

    def __str__(self) -> str:
        return f'{self.kind}[Tensor, "{" ".join(self.dims)}"]'


@dataclass(frozen=True)
class _Union:
    options: tuple[_Array | None, ...]

    def __or__(self, other) -> _Union:
        return _Union((*self.options, other))

    def __str__(self) -> str:
        return " | ".join(str(o) for o in self.options)


class _Kind:
    """``Float`` / ``Bool``: ``Kind[torch.Tensor, "dims"]`` is an annotation."""

    def __init__(self, name: str, test: Callable[[torch.Tensor], bool]) -> None:
        self.name, self.test = name, test

    def __getitem__(self, item: tuple[type, str]) -> _Array:
        array_type, dims = item
        if array_type is not torch.Tensor:
            raise TypeError(f"{self.name}[...] annotates a torch.Tensor, not {array_type}")
        return _Array(self.name, tuple(dims.split()))


Float = _Kind("Float", torch.is_floating_point)
Bool = _Kind("Bool", lambda t: t.dtype == torch.bool)
_KINDS = {"Float": Float, "Bool": Bool}


def _mismatch(spec: _Array | _Union | None, value: Any, sizes: dict[str, int]) -> str | None:
    """Why ``value`` breaks ``spec`` with the sizes bound so far (None when
    it fits; then ``sizes`` holds its bindings too)."""
    if spec is None:
        return None if value is None else f"{type(value).__name__}, not None"
    if isinstance(spec, _Union):
        reasons = []
        for option in spec.options:
            trial = dict(sizes)
            reason = _mismatch(option, value, trial)
            if reason is None:
                sizes.update(trial)
                return None
            reasons.append(reason)
        return "; ".join(reasons)
    if not isinstance(value, torch.Tensor):
        return f"a {type(value).__name__}, not a tensor"
    if not _KINDS[spec.kind].test(value):
        return f"{value.dtype}, not {spec.kind}"
    if value.ndim != len(spec.dims):
        return f"shape {tuple(value.shape)}, not {len(spec.dims)} axes ({' '.join(spec.dims)})"
    for name, size in zip(spec.dims, value.shape):
        want = int(name) if name.isdigit() else sizes.setdefault(name, size)
        if size != want:
            return f"shape {tuple(value.shape)}: axis {name} is {size}, {want} elsewhere in the call"
    return None


def _signature(value: Any) -> Any:
    """What a call's check depends on, hashable: a tensor's shape, dtype and
    device; plain values as they are; other objects by their type."""
    if isinstance(value, torch.Tensor):
        return (value.shape, value.dtype, value.device)
    if isinstance(value, (tuple, list)):
        return (type(value), tuple(_signature(v) for v in value))
    if value is None or isinstance(value, (bool, int, float, str)):
        return (type(value), value)
    return type(value)


def _annotation(fn: Callable, annotation: Any) -> _Array | _Union | None:
    """An annotation's spec (a string one evaluated in ``fn``'s module), or
    None when it is not a ``Float`` / ``Bool`` one."""
    if isinstance(annotation, str):
        if "Float[" not in annotation and "Bool[" not in annotation:
            return None
        annotation = eval(annotation, fn.__globals__)  # noqa: S307 - the module's own source
    return annotation if isinstance(annotation, (_Array, _Union)) else None


def shapechecked(fn: _F) -> _F:
    """Enforce ``fn``'s ``Float`` / ``Bool`` annotations once per call
    signature."""
    signature = inspect.signature(fn)
    specs: dict[str, Any] = {}
    resolved: list[bool] = []
    passed: set = set()

    def check(bound: inspect.BoundArguments, sizes: dict[str, int]) -> None:
        for name, spec in specs.items():
            if name == "return" or name not in bound.arguments:
                continue
            reason = _mismatch(spec, bound.arguments[name], sizes)
            if reason is not None:
                raise ShapeError(f"{fn.__qualname__}: {name} must be {spec}, got {reason}")

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        global CHECKS
        key = (tuple(map(_signature, args)), tuple(sorted((k, _signature(v)) for k, v in kwargs.items())) if kwargs else ())
        if key in passed:
            return fn(*args, **kwargs)
        if not resolved:  # at the first call: the module is whole by then
            resolved.append(True)
            for name, param in signature.parameters.items():
                if (spec := _annotation(fn, param.annotation)) is not None:
                    specs[name] = spec
            if (spec := _annotation(fn, signature.return_annotation)) is not None:
                specs["return"] = spec
        CHECKS += 1
        bound = signature.bind(*args, **kwargs)
        sizes: dict[str, int] = {}
        check(bound, sizes)
        out = fn(*args, **kwargs)
        if "return" in specs and (reason := _mismatch(specs["return"], out, sizes)) is not None:
            raise ShapeError(f"{fn.__qualname__}: its result must be {specs['return']}, got {reason}")
        if len(passed) >= MAX_SIGNATURES:
            passed.clear()
        passed.add(key)
        return out

    return wrapper  # type: ignore[return-value]
