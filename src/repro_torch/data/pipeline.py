"""Deterministic synthetic LM data (counterpart of ``repro.data.pipeline``).

Batch k is a pure function of ``(seed, step)``: no iterator state to
checkpoint, and a run resumed at step k, by either package, draws the batch
the uninterrupted run drew.  The reference draws with ``jax.random``'s
threefry2x32 in its partitionable mode (``jax_threefry_partitionable``, on
by default since jax 0.5); the draws here are the same bits, computed with
numpy on the host and uploaded once a batch:

  * ``threefry2x32``: the 20-round block, key schedule and rotations of
    ``jax._src.prng._threefry2x32_lowering``;
  * ``prng_key`` (``PRNGKey``), ``fold_in`` and ``split`` (the fold-like
    split: counts are the 64-bit iota of the output shape, hi and lo words);
  * ``random_bits`` (32 bits: the two output words xor'd);
  * ``randint`` (two 32-bit draws from a split, reduced modulo the span in
    uint32 arithmetic) and ``uniform`` / ``bernoulli`` (the mantissa trick:
    ``(bits >> 9) | 0x3F800000`` read as f32, minus 1, compared with p).

Targets are a noisy "copy previous token + drift" sequence so a real LM can
overfit it measurably.  ``input_specs_for_shape`` gives a dry-run cell's
inputs as ``meta`` tensors (``launch/dryrun.py`` counts a step on them).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["DataConfig", "synthetic_batch", "input_specs_for_shape",
           "prng_key", "fold_in", "split", "random_bits", "randint",
           "uniform", "bernoulli", "threefry2x32"]

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234


# ---------------------------------------------------------------------------
# threefry2x32 and the key operations of jax.random, in numpy uint32
# ---------------------------------------------------------------------------

def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << _U32(r)) | (v >> _U32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray,
                 x1: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 block (20 rounds) of ``key`` (2,) uint32 over the
    count words ``x0``, ``x1`` (uint32, one shape): two uint32 arrays."""
    k0, k1 = _U32(key[0]), _U32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _U32(0x1BD11BDA))
    x = [np.asarray(x0, _U32) + ks[0], np.asarray(x1, _U32) + ks[1]]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + _U32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: (seed >> 32, seed's
    low word), the high word 0 for an int32 seed."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise OverflowError(f"seed {seed} is not a 32-bit integer")
    return np.array([0, seed & 0xFFFFFFFF], _U32)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in``: the block of the count pair (0, data)."""
    a, b = threefry2x32(key, np.zeros(1, _U32),
                        np.array([int(data) & 0xFFFFFFFF], _U32))
    return np.array([a[0], b[0]], _U32)


def _iota_2x32(shape) -> tuple[np.ndarray, np.ndarray]:
    """The 64-bit iota of ``shape`` as (hi, lo) uint32 words."""
    n = int(np.prod(shape, dtype=np.int64))
    idx = np.arange(n, dtype=np.uint64).reshape(shape)
    return (idx >> np.uint64(32)).astype(_U32), idx.astype(_U32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split`` (partitionable): (num, 2) uint32 keys."""
    a, b = threefry2x32(key, *_iota_2x32((num,)))
    return np.stack([a, b], axis=1)


def random_bits(key: np.ndarray, shape) -> np.ndarray:
    """32 random bits an element (partitionable): the block over the
    element's flat index, its two words xor'd."""
    a, b = threefry2x32(key, *_iota_2x32(tuple(shape)))
    return a ^ b


def randint(key: np.ndarray, shape, minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint`` into int32: two 32-bit draws reduced modulo the
    span, in the reference's uint32 arithmetic: its products wrap, so above
    a span of 2**16 the multiplier is 0 and only the second draw counts."""
    k1, k2 = split(key)
    hi, lo = random_bits(k1, shape), random_bits(k2, shape)
    span = _U32(maxval - minval) if maxval > minval else _U32(1)
    with np.errstate(over="ignore"):
        mult = _U32(2 ** 16) % span
        mult = (mult * mult) % span       # wraps: 0 when span > 2**16
        off = (hi % span) * mult + lo % span
    off = off % span
    return (np.int32(minval) + off.astype(np.int32)).astype(np.int32)


def uniform(key: np.ndarray, shape) -> np.ndarray:
    """``jax.random.uniform`` in f32 on [0, 1): 23 random mantissa bits."""
    bits = (random_bits(key, shape) >> _U32(9)) | _U32(0x3F800000)
    return bits.view(np.float32) - np.float32(1.0)


def bernoulli(key: np.ndarray, p: float, shape) -> np.ndarray:
    """``jax.random.bernoulli`` (mode "low"): uniform < p in f32."""
    return uniform(key, shape) < np.float32(p)


# ---------------------------------------------------------------------------
# the batches
# ---------------------------------------------------------------------------

def _batch_numpy(cfg: DataConfig, step: int) -> dict:
    """Batch at ``step`` as numpy: {"tokens", "labels"} (B, S) int32, the
    reference's bits.

    A Markov-ish stream: token_{t+1} = (token_t * 31 + drift_t) % V with
    occasional resets, labels = next token (causal LM shift)."""
    key = fold_in(prng_key(cfg.seed), step)
    b, s, v = cfg.global_batch, cfg.seq_len, cfg.vocab_size
    k1, k2, k3 = split(key, 3)
    start = randint(k1, (b, 1), 0, v)
    drift = randint(k2, (b, 1), 1, 7)
    pos = np.arange(s + 1, dtype=np.int32)[None, :]
    with np.errstate(over="ignore"):
        seq = (start + drift * pos * np.int32(31)) % np.int32(v)
    noise_mask = bernoulli(k3, 0.05, (b, s + 1))
    noise = randint(key, (b, s + 1), 0, v)
    seq = np.where(noise_mask, noise, seq).astype(np.int32)
    return {"tokens": seq[:, :-1], "labels": seq[:, 1:]}


def synthetic_batch(cfg: DataConfig, step: int, device="cuda") -> dict:
    """Batch at ``step``: {"tokens", "labels"} (B, S) int32 tensors on
    ``device`` (the card unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for k, a in _batch_numpy(cfg, step).items()}


def input_specs_for_shape(cfg_model, shape, *,
                          dtype=torch.bfloat16) -> dict:
    """``meta`` stand-ins for every model input of a given (arch, shape)
    cell: the dry-run contract (no allocation, no draws).

    train/prefill: full (B, S) token batch (or embeddings for stub
    frontends) + labels for train; decode: one token (B,) (the cell's
    decode state is built separately in ``launch/dryrun.py``)."""
    b, s = shape.global_batch, shape.seq_len

    def meta(size, dt):
        return torch.empty(size, dtype=dt, device="meta")

    specs: dict = {}
    if shape.kind in ("train", "prefill"):
        if cfg_model.frontend == "tokens":
            specs["tokens"] = meta((b, s), torch.int32)
        else:
            specs["embeds"] = meta((b, s, cfg_model.d_model), dtype)
        if cfg_model.num_cond_tokens:
            specs["cond"] = meta((b, cfg_model.num_cond_tokens,
                                  cfg_model.d_model), dtype)
        if shape.kind == "train":
            specs["labels"] = meta((b, s), torch.int32)
    else:  # decode: one new token against a seq_len-deep cache/state
        if cfg_model.frontend == "tokens":
            specs["token"] = meta((b,), torch.int32)
        else:
            specs["token"] = meta((b, 1, cfg_model.d_model), dtype)
    return specs
