"""Planar complex arithmetic: the framework's complex number representation.

Every complex tensor is a ``CArray``: a pytree of two same-shape arrays
(re, im), float32 on the device (int16 for sc16 wire-format input).  All
hot-path math is spelled out as real mul/add, which is exactly what XLA
emits for complex64 anyway; the FFT itself runs on complex64
(``ops.fft.fft_xla``: cuFFT on the GPU).

The reference stores interleaved complex float (cuFloatComplex / complexF,
ShMemSymBuff.hpp:86-89); deinterleaving happens once at the host boundary
(``CArray.from_numpy``) or inside the native ring's copy-out.
"""

from __future__ import annotations

from typing import Any, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

RealLike = Union[int, float, jnp.ndarray]


@jax.tree_util.register_pytree_node_class
class CArray:
    """A complex tensor as planar (re, im) float32 components.

    Thin, immutable, jit-transparent (registered pytree).  Arithmetic
    implements the textbook complex formulas on the planar parts.
    """

    __slots__ = ("re", "im")

    def __init__(self, re, im):
        self.re = re
        self.im = im

    # -- pytree protocol ----------------------------------------------------
    def tree_flatten(self):
        return (self.re, self.im), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    # -- host boundary -------------------------------------------------------
    @classmethod
    def from_numpy(cls, x: np.ndarray) -> "CArray":
        """Split host complex64 into planar float32 (one host-side copy)."""
        x = np.asarray(x)
        if np.iscomplexobj(x):
            return cls(jnp.asarray(np.ascontiguousarray(x.real, dtype=np.float32)),
                       jnp.asarray(np.ascontiguousarray(x.imag, dtype=np.float32)))
        return cls(jnp.asarray(x, jnp.float32),
                   jnp.zeros(np.shape(x), jnp.float32))

    def to_numpy(self) -> np.ndarray:
        """Gather to host and re-interleave as complex64."""
        return (np.asarray(self.re) + 1j * np.asarray(self.im)).astype(np.complex64)

    # -- shape utilities ------------------------------------------------------
    @property
    def shape(self) -> Tuple[int, ...]:
        return self.re.shape

    @property
    def ndim(self) -> int:
        return self.re.ndim

    def reshape(self, *shape) -> "CArray":
        return CArray(self.re.reshape(*shape), self.im.reshape(*shape))

    def swapaxes(self, a: int, b: int) -> "CArray":
        return CArray(jnp.swapaxes(self.re, a, b), jnp.swapaxes(self.im, a, b))

    def __getitem__(self, idx) -> "CArray":
        return CArray(self.re[idx], self.im[idx])

    def roll(self, shift: int, axis: int = -1) -> "CArray":
        return CArray(jnp.roll(self.re, shift, axis), jnp.roll(self.im, shift, axis))

    # -- arithmetic -----------------------------------------------------------
    def __add__(self, o: "CArray") -> "CArray":
        return CArray(self.re + o.re, self.im + o.im)

    def __sub__(self, o: "CArray") -> "CArray":
        return CArray(self.re - o.re, self.im - o.im)

    def __mul__(self, o) -> "CArray":
        if isinstance(o, CArray):
            return CArray(self.re * o.re - self.im * o.im,
                          self.re * o.im + self.im * o.re)
        if isinstance(o, complex) or (hasattr(o, "dtype")
                                      and np.issubdtype(o.dtype, np.complexfloating)):
            raise TypeError(
                "complex scalar/array would silently break the planar float32 "
                "invariant; wrap it in a CArray (CArray.from_numpy / from_const)")
        return CArray(self.re * o, self.im * o)  # real scalar/array scale

    def __rmul__(self, o) -> "CArray":
        return self.__mul__(o)

    def conj(self) -> "CArray":
        return CArray(self.re, -self.im)

    def mul_conj(self, o: "CArray") -> "CArray":
        """self * conj(o) -- the MRC inner step, fused form."""
        return CArray(self.re * o.re + self.im * o.im,
                      self.im * o.re - self.re * o.im)

    def abs2(self) -> jnp.ndarray:
        """|z|^2 as a real float32 array."""
        return self.re * self.re + self.im * self.im

    def abs(self) -> jnp.ndarray:
        return jnp.sqrt(self.abs2())

    def div_real(self, d: jnp.ndarray) -> "CArray":
        inv = 1.0 / d
        return CArray(self.re * inv, self.im * inv)

    def __truediv__(self, o) -> "CArray":
        if isinstance(o, CArray):
            return cdiv(self, o)
        return self.div_real(o)

    def astype(self, dtype) -> "CArray":
        return CArray(self.re.astype(dtype), self.im.astype(dtype))


def czeros(shape, dtype=jnp.float32) -> CArray:
    return CArray(jnp.zeros(shape, dtype), jnp.zeros(shape, dtype))


def cones(shape, dtype=jnp.float32) -> CArray:
    return CArray(jnp.ones(shape, dtype), jnp.zeros(shape, dtype))


def cdiv(a: CArray, b: CArray) -> CArray:
    """a / b == a * conj(b) / |b|^2 -- matches divideOneRow (cpuLS.hpp:233-244)."""
    inv = 1.0 / b.abs2()
    return CArray((a.re * b.re + a.im * b.im) * inv,
                  (a.im * b.re - a.re * b.im) * inv)


def csum(a: CArray, axis, keepdims: bool = False) -> CArray:
    return CArray(jnp.sum(a.re, axis=axis, keepdims=keepdims),
                  jnp.sum(a.im, axis=axis, keepdims=keepdims))


def cmatmul(a: CArray, b: CArray, precision=jax.lax.Precision.HIGHEST) -> CArray:
    """Complex matmul as 4 real matmuls (3-mult Karatsuba not worth the
    extra adds at these sizes; XLA fuses the 4-matmul form cleanly)."""
    rr = jnp.matmul(a.re, b.re, precision=precision)
    ii = jnp.matmul(a.im, b.im, precision=precision)
    ri = jnp.matmul(a.re, b.im, precision=precision)
    ir = jnp.matmul(a.im, b.re, precision=precision)
    return CArray(rr - ii, ri + ir)


def ceinsum(spec: str, a: CArray, b: CArray,
            precision=jax.lax.Precision.HIGHEST) -> CArray:
    rr = jnp.einsum(spec, a.re, b.re, precision=precision)
    ii = jnp.einsum(spec, a.im, b.im, precision=precision)
    ri = jnp.einsum(spec, a.re, b.im, precision=precision)
    ir = jnp.einsum(spec, a.im, b.re, precision=precision)
    return CArray(rr - ii, ri + ir)


def cstack(parts: Sequence[CArray], axis: int = 0) -> CArray:
    return CArray(jnp.stack([p.re for p in parts], axis),
                  jnp.stack([p.im for p in parts], axis))


def cconcat(parts: Sequence[CArray], axis: int = 0) -> CArray:
    return CArray(jnp.concatenate([p.re for p in parts], axis),
                  jnp.concatenate([p.im for p in parts], axis))


def cwhere(mask: jnp.ndarray, a: CArray, b: CArray) -> CArray:
    if not isinstance(b, CArray):  # allow scalar zero
        b = CArray(jnp.zeros_like(a.re) + b, jnp.zeros_like(a.im) + b)
    return CArray(jnp.where(mask, a.re, b.re), jnp.where(mask, a.im, b.im))


def from_const(x: np.ndarray) -> CArray:
    """Embed a host complex constant (DFT matrix, pilot, twiddles) as planar
    jnp constants -- baked into the jitted program."""
    x = np.asarray(x)
    return CArray(jnp.asarray(np.ascontiguousarray(x.real), jnp.float32),
                  jnp.asarray(np.ascontiguousarray(x.imag), jnp.float32))
