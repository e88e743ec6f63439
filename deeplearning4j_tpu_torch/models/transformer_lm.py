"""The sampling half of ``deeplearning4j_tpu/models/transformer_lm.py``: what
the generation engine's recurrent backend imports from it.

- :class:`ContextWindowExceeded` and :func:`_validate_sampling`
  (``transformer_lm.py:210-234``);
- :func:`_filter_logits`, :func:`sample_next_device` and
  :func:`sample_next_rows` (``:266-344``): greedy, temperature, top-k and
  top-p as data, row by row, on the logits' device;
- :func:`prefill_bucket_lengths` (``:604-623``).

``TransformerLM`` itself (its blocks, KV-cache decode and flash attention)
comes with the TransformerLM slice (ROADMAP § A, slice 6).

Random draws. JAX's threefry key chain cannot be reproduced in torch, so a
key here is a counter-based generator of the port's own: an int64 pair
``(seed, counter)`` on the device (:func:`new_key`). A draw hashes (seed,
counter, index) to a uniform in (0, 1), takes its Gumbel transform and the
argmax of ``logits + gumbel`` (``jax.random.categorical``'s method), and
advances the counter by one. So the same seed gives the same tokens, a row
of :func:`sample_next_rows` draws exactly what :func:`sample_next_device`
draws for that row alone, and no draw depends on the other rows. The port's
sampled tokens are not JAX's; its greedy tokens are.
"""

from __future__ import annotations

from typing import Tuple

import torch


class ContextWindowExceeded(ValueError):
    """prompt_len + max_new would overflow the fixed ``max_length`` window.
    Typed so serving layers reject with a 4xx naming the limit; carries the
    numbers as attributes."""

    def __init__(self, prompt_len: int, max_new: int, max_length: int):
        self.prompt_len = int(prompt_len)
        self.max_new = int(max_new)
        self.max_length = int(max_length)
        super().__init__(
            f"prompt ({prompt_len}) + max_new ({max_new}) exceeds the "
            f"model's max_length context window ({max_length}); shorten "
            f"the prompt or reduce max_new")


def _validate_sampling(temperature: float, top_k: int, top_p: float) -> None:
    if (top_k or top_p) and temperature <= 0:
        raise ValueError("top_k/top_p sampling requires temperature > 0")
    if top_k < 0:
        raise ValueError(f"top_k must be >= 0, got {top_k}")
    if top_p and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")


def _col(v: torch.Tensor) -> torch.Tensor:
    """A scalar knob stays scalar; a (b,) knob broadcasts per row."""
    return v if v.dim() == 0 else v[:, None]


def _knob(v, dtype, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=dtype, device=device)


def _filter_logits(logits: torch.Tensor, temperature, top_k, top_p) -> torch.Tensor:
    """(b, V) f32 logits -> temperature-scaled, top-k- and nucleus-filtered
    logits (filtered entries -inf). The knobs are scalars or per-row (b,)
    tensors; every op is row-wise, so a row filtered among others equals the
    row filtered alone. The sorts are stable, as JAX's."""
    dev = logits.device
    temperature = _knob(temperature, torch.float32, dev)
    top_k = _knob(top_k, torch.int64, dev)
    top_p = _knob(top_p, torch.float32, dev)
    b, V = logits.shape
    neg_inf = torch.full((), float("-inf"), dtype=logits.dtype, device=dev)
    t = torch.where(temperature > 0, temperature, torch.ones_like(temperature))
    lg = logits / _col(t)
    # top-k: keep the k highest (active only for 0 < k < V)
    k_eff = torch.clamp(top_k, 1, V)
    use_k = (top_k > 0) & (top_k < V)
    sorted_asc = torch.sort(lg, dim=-1, stable=True).values
    kth = torch.gather(sorted_asc, -1, torch.broadcast_to(_col(V - k_eff), (b, 1)))
    lg = torch.where(_col(use_k) & (lg < kth), neg_inf, lg)
    # nucleus: the smallest prefix of descending-probability tokens reaching
    # top_p, keeping the token that crosses it
    use_p = (top_p > 0.0) & (top_p < 1.0)
    order = torch.argsort(-lg, dim=-1, stable=True)
    sl = torch.gather(lg, -1, order)
    p_sorted = torch.exp(sl - sl.amax(-1, keepdim=True))
    p_sorted = p_sorted / p_sorted.sum(-1, keepdim=True)
    cum = torch.cumsum(p_sorted, -1)
    cut = cum - p_sorted >= _col(top_p)
    sl = torch.where(_col(use_p) & cut, neg_inf, sl)
    return torch.empty_like(sl).scatter_(-1, order, sl)


# ---------------------------------------------------------------------------
# the counter-based generator
# ---------------------------------------------------------------------------
_M32 = 0xFFFFFFFF


def new_key(seed: int, device="cpu") -> torch.Tensor:
    """A generator key: int64 ``(seed mod 2^32, counter 0)``."""
    return torch.tensor([int(seed) & _M32, 0], dtype=torch.int64, device=device)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2^32`` for x in [0, 2^32) without int64 overflow."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + ((hi * (c & 0xFFFF)) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A bijective 32-bit integer hash (two multiply-xorshift rounds)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _gumbel(keys: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    """Gumbel noise of ``shape`` (b, V) from ``keys`` (b, 2): row r hashes
    (seed_r, counter_r, v) for v in range(V)."""
    b, n = shape
    idx = torch.arange(n, dtype=torch.int64, device=keys.device)[None, :]
    a = _mix32((keys[:, :1] ^ 0x2545F491) & _M32)
    a = _mix32(a ^ (keys[:, 1:2] & _M32))
    h = _mix32(a ^ idx)
    u = ((h >> 9).to(torch.float32) + 0.5) * (2.0 ** -23)  # (0, 1), exact in f32
    return -torch.log(-torch.log(u))


def _advance(keys: torch.Tensor) -> torch.Tensor:
    step = torch.zeros_like(keys)
    step[..., 1] = 1
    return keys + step


def _draw(filtered: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    return torch.argmax(filtered + _gumbel(keys, tuple(filtered.shape)), dim=-1)


def sample_next_device(logits, temperature, top_k, top_p, key
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(b, V) f32 logits -> ((b,) int32 next ids, advanced key): one key for
    the batch (row r draws at indices r*V .. r*V + V - 1). Greedy rows
    (temperature <= 0) take the argmax of the unfiltered logits; the key
    advances on every call, greedy or not."""
    lg = _filter_logits(logits, temperature, top_k, top_p)
    b, V = lg.shape
    g = _gumbel(key.reshape(1, 2), (1, b * V)).reshape(b, V)
    sampled = torch.argmax(lg + g, dim=-1)
    t = _knob(temperature, torch.float32, logits.device)
    nxt = torch.where(t <= 0, torch.argmax(logits, dim=-1), sampled)
    return nxt.to(torch.int32), _advance(key)


def sample_next_rows(logits, temperature, top_k, top_p, keys
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-row variant for the continuous-batching engine: per-row knobs
    (b,) and keys (b, 2) -> ((b,) int32 ids, advanced keys). Row s draws
    what :func:`sample_next_device` draws for ``logits[s:s+1]`` with
    ``keys[s]``."""
    lg = _filter_logits(logits, temperature, top_k, top_p)
    sampled = _draw(lg, keys)
    t = _knob(temperature, torch.float32, logits.device)
    nxt = torch.where(t <= 0, torch.argmax(logits, dim=-1), sampled)
    return nxt.to(torch.int32), _advance(keys)


def prefill_bucket_lengths(max_length: int, hint=None):
    """Ascending prompt-length buckets for prefill padding: ``hint`` (a
    model's ``serving_seq_buckets``) filtered to <= max_length, else powers
    of two from 8; the list always ends at ``max_length``."""
    max_length = int(max_length)
    if hint:
        bs = sorted({int(t) for t in hint if 0 < int(t) <= max_length})
    else:
        bs, b = [], 8
        while b < max_length:
            bs.append(b)
            b *= 2
    if not bs or bs[-1] != max_length:
        bs.append(max_length)
    return bs
