"""A minimal init/apply module system for the framework's small networks.

Modules are frozen dataclasses whose `forward(scope, *args)` creates or
reads parameters through a `Scope`. `init(key, *args)` runs the forward
once to create them and returns `{"params": tree}`; `apply(variables,
*args)` runs it on existing parameters. The parameter tree keeps the
layout flax.linen produces for the same architecture — child modules
named `<ClassName>_<i>` in call order unless named explicitly, `Dense`
leaves `{"kernel": (in, out), "bias": (out,)}` — so `models/surgery.py`,
checkpoints and every `model.init/apply` call site work unchanged.

Each parameter's initial value is drawn from the init key folded with a
hash of its path, so it does not depend on creation order.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Callable

import jax
import jax.numpy as jnp

lecun_normal = jax.nn.initializers.lecun_normal
zeros = jax.nn.initializers.zeros

# Dense layers run at JAX's default matmul precision
# (`jax_default_matmul_precision`). Unset, that is DEFAULT: TF32 tensor
# cores on the H100 for f32 operands, bf16 ones under
# compute_dtype='bfloat16' (the CPU computes full f32). The eigenpairs'
# accuracy comes from the Rayleigh-Ritz / LOBPCG polish at
# Precision.HIGHEST, not from the network's arithmetic. A reference run
# that needs the network in full f32 traces it inside
# `jax.default_matmul_precision("highest")`, which is part of jit's cache
# key.


class Scope:
    """Parameter namespace of one module instance (init or apply mode)."""

    def __init__(self, params: dict, key=None, rngs=None, path=()):
        self.params = params
        self.key = key          # init key; None in apply mode
        self.rngs = rngs or {}  # named apply-time keys, e.g. {"dropout": k}
        self.path = path
        self._counts: dict[str, int] = {}

    def _fold(self, key, name: str):
        h = zlib.crc32("/".join(self.path + (name,)).encode()) & 0x7FFFFFFF
        return jax.random.fold_in(key, h)

    def child(self, name: str) -> "Scope":
        sub = (self.params.setdefault(name, {}) if self.key is not None
               else self.params[name])
        return Scope(sub, self.key, self.rngs, self.path + (name,))

    def auto_name(self, prefix: str) -> str:
        i = self._counts.get(prefix, 0)
        self._counts[prefix] = i + 1
        return f"{prefix}_{i}"

    def param(self, name: str, init_fn: Callable, shape,
              dtype=jnp.float32):
        if self.key is not None and name not in self.params:
            self.params[name] = init_fn(self._fold(self.key, name), shape,
                                        dtype)
        return self.params[name]

    def make_rng(self, kind: str):
        if kind not in self.rngs:
            raise ValueError(f"apply(..., rngs={{'{kind}': key}}) is "
                             f"required for {'/'.join(self.path)}")
        return self._fold(self.rngs[kind], self.auto_name(kind))


@dataclasses.dataclass(frozen=True)
class Module:
    """Base class: subclasses define `forward(self, scope, *args)`."""

    def init(self, key, *args, **kwargs) -> dict:
        params: dict = {}
        self.forward(Scope(params, key=key), *args, **kwargs)
        return {"params": params}

    def apply(self, variables, *args, rngs=None, **kwargs):
        return self.forward(Scope(variables["params"], rngs=rngs),
                            *args, **kwargs)

    def __call__(self, scope: Scope, *args, name: str | None = None,
                 **kwargs):
        """Run as a child of `scope` (named `<ClassName>_<i>` by default)."""
        name = name or scope.auto_name(type(self).__name__)
        return self.forward(scope.child(name), *args, **kwargs)

    def forward(self, scope: Scope, *args, **kwargs):
        raise NotImplementedError


def dense(scope: Scope, x, features: int, name: str, dtype=None,
          kernel_init: Callable = lecun_normal(),
          bias_init: Callable = zeros):
    """x @ kernel + bias as the child `name` (flax `Dense` semantics:
    parameters stored f32; inputs and parameters cast to `dtype` when
    given, else promoted to their common type)."""
    s = scope.child(name)
    kernel = s.param("kernel", kernel_init, (x.shape[-1], features))
    bias = s.param("bias", bias_init, (features,))
    dt = dtype if dtype is not None else jnp.result_type(x, kernel)
    x, kernel, bias = x.astype(dt), kernel.astype(dt), bias.astype(dt)
    y = jax.lax.dot_general(x, kernel, (((x.ndim - 1,), (0,)), ((), ())))
    return y + bias


def dropout(scope: Scope, x, rate: float, deterministic: bool):
    """Inverted dropout; identity when deterministic or rate == 0."""
    if deterministic or rate == 0.0:
        return x
    keep = jax.random.bernoulli(scope.make_rng("dropout"), 1.0 - rate,
                                x.shape)
    return jnp.where(keep, x / (1.0 - rate), jnp.zeros_like(x))
