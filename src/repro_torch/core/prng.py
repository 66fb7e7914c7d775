"""JAX's threefry-2x32 PRNG in PyTorch, bit for bit with ``jax.random``.

The reference samples with ``jax.random``: keys from ``PRNGKey`` and
``fold_in``, Gumbel noise from ``gumbel``, tokens from ``categorical``.
A sampled run of the port gives the reference's tokens only if it draws
the same noise, so this module copies those functions op for op, with
``jax_threefry_partitionable`` on (JAX's default):

* a key is two uint32 words ``(k0, k1)``; ``PRNGKey(seed)`` keeps the
  seed mod 2**32 in ``k1`` with ``k0 = 0`` (JAX with x64 off);
* ``threefry2x32`` is Threefry-2x32 with 20 rounds (rotations 13 / 15 /
  26 / 6 and 17 / 29 / 16 / 24, the key schedule's third word ``k0 ^ k1
  ^ 0x1BD11BDA``);
* ``fold_in(key, d) = threefry2x32(key, (0, uint32(d)))``;
* ``random_bits(key, w, shape)`` hashes the counters ``(0, i)``, ``i``
  the row-major flat index over ``shape``, and takes ``bits1 ^ bits2``
  (its low byte for 8 bits);
* ``uniform`` sets the mantissa from the top bits (``_uniform``:
  ``bits >> (nbits - nmant) | bits(1.0)``, minus 1, scaled and clamped);
  bf16 takes 8 random bits, as JAX does for ``nmant < 8``;
* ``gumbel`` is ``-log(-log(u))`` on ``uniform(tiny, 1)`` (mode "low"),
  each op in the draw's dtype, so that bf16 rounds at every op as XLA
  does;
* ``categorical`` is ``argmax(gumbel + logits)``, the first maximal
  index.

A key is an int64 tensor whose last dimension holds the two words, each
in ``[0, 2**32)``; leading dimensions batch keys.  The uint32 arithmetic
runs in int64, masked to 32 bits, with logical shifts (torch's uint32
has partial CUDA coverage).  Every function works on the device of its
inputs and is vectorised over the keys' leading dimensions, so deriving
a batch of keys from tensors on the card reads nothing back to the host
(and copies nothing to it from the host: constants are filled on the
device, so a queue of draws never waits for the card).

Bit-equality: the key words, the random bits and the uniforms equal
JAX's exactly.  bf16 Gumbel noise does too: its uniform takes 128
values, and each op rounds the same f32 log to bf16.  f32 Gumbel noise
differs from XLA:CPU's by an ulp or two where the two ``log``
implementations round apart, so f32 draws agree except at near-ties
(``tests/test_torch_sampling.py`` states the band).
"""
from __future__ import annotations

import math
import operator

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# per float dtype: (bits of the dtype, mantissa bits, bits of 1.0, the
# integer dtype its bits are viewed through)
_FLOAT_BITS = {torch.float32: (32, 23, 0x3F800000, torch.int32),
               torch.bfloat16: (16, 7, 0x3F80, torch.int16)}


def PRNGKey(seed, device=None) -> torch.Tensor:  # noqa: N802 (JAX's name)
    """``jax.random.PRNGKey(seed)`` with x64 off: ``(0, seed mod 2**32)``.
    ``seed`` is an integer in the int64 range (JAX raises OverflowError
    beyond it)."""
    seed = operator.index(seed)
    if not -(2 ** 63) <= seed < 2 ** 63:
        raise OverflowError(f"seed {seed} does not fit an int64")
    return torch.tensor([0, seed & _MASK], dtype=torch.int64, device=device)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 of the counter words ``(x0, x1)`` under the key
    words ``(k0, k1)``, all int64 tensors of uint32 values that
    broadcast together; returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` of every key with ``data``: a Python int in
    ``[0, 2**32)`` (JAX raises OverflowError outside it) or an integer
    tensor of any shape, bit-cast to uint32 as JAX casts a traced int32
    (so -1 folds in as 0xFFFFFFFF).  Keys ``(*K, 2)`` and data broadcast
    like ``keys[..., 0]`` and ``data``; the result is ``(*broadcast,
    2)``."""
    if isinstance(data, int):
        if not 0 <= data <= _MASK:
            raise OverflowError(
                f"Python integer {data} out of bounds for uint32")
        data = torch.full((), data, dtype=torch.int64, device=keys.device)
    if data.dtype.is_floating_point or data.dtype == torch.bool:
        raise TypeError(f"fold_in takes integer data, got {data.dtype}")
    d = data.to(device=keys.device, dtype=torch.int64) & _MASK
    y0, y1 = threefry2x32(keys[..., 0], keys[..., 1],
                          torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def random_bits(keys: torch.Tensor, bit_width: int, shape) -> torch.Tensor:
    """``jax.random.bits`` (partitionable threefry) of ``bit_width`` 8 or
    32 bits for each key: ``(*K, *shape)`` int64 values."""
    if bit_width not in (8, 32):
        raise ValueError(f"bit_width must be 8 or 32: {bit_width}")
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    if n > _MASK:
        raise ValueError(f"{n} draws need the counters' high word; "
                         "this port keeps it 0")
    lead = keys.shape[:-1]
    view = lead + (1,) * len(shape)
    k0, k1 = keys[..., 0].reshape(view), keys[..., 1].reshape(view)
    lo = torch.arange(n, dtype=torch.int64, device=keys.device).reshape(shape)
    b1, b2 = threefry2x32(k0, k1, torch.zeros_like(lo), lo)
    bits = b1 ^ b2
    return bits & 0xFF if bit_width == 8 else bits


def uniform(keys: torch.Tensor, shape, dtype=torch.float32, minval=0.0,
            maxval=1.0) -> torch.Tensor:
    """``jax.random.uniform`` (its ``_uniform``, op for op) for each key:
    ``(*K, *shape)`` in ``dtype``, float32 or bfloat16."""
    if dtype not in _FLOAT_BITS:
        raise TypeError(f"the draws take float32 or bfloat16, not {dtype}")
    nbits, nmant, one, int_dtype = _FLOAT_BITS[dtype]
    rng_bits = 8 if nmant < 8 else nbits
    bits = random_bits(keys, rng_bits, shape)
    fbits = (bits >> (rng_bits - nmant)) | one
    dev = keys.device
    floats = fbits.to(int_dtype).view(dtype) - torch.ones((), dtype=dtype,
                                                           device=dev)
    lo = torch.full((), minval, dtype=dtype, device=dev)
    hi = torch.full((), maxval, dtype=dtype, device=dev)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(keys: torch.Tensor, shape, dtype=torch.float32) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, dtype, mode="low")`` for each key:
    ``-log(-log(u))`` on ``uniform(tiny, 1)``, each op in ``dtype``."""
    u = uniform(keys, shape, dtype, torch.finfo(dtype).tiny, 1.0)
    return u.log().neg().log().neg()


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis of ``logits``, its
    noise in the logits' dtype (float32 or bfloat16); int64 indices of
    shape ``logits.shape[:-1]``.

    One key (shape ``(2,)``) draws noise over the whole of ``logits``, as
    one JAX call on a batch does (counters over the flat index); keys of
    shape ``(*logits.shape[:-1], 2)`` give each row its own key, as
    ``jax.vmap(jax.random.categorical)`` does (counters over the row)."""
    if keys.dim() == 1:
        noise = gumbel(keys, logits.shape, logits.dtype)
    elif keys.shape[:-1] == logits.shape[:-1]:
        noise = gumbel(keys, logits.shape[-1:], logits.dtype)
    else:
        raise ValueError(f"keys {tuple(keys.shape)} fit neither one draw "
                         f"nor one per row of logits {tuple(logits.shape)}")
    return torch.argmax(noise + logits, dim=-1)
