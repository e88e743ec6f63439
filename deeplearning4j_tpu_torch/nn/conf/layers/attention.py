"""Attention and transformer layers (eval forward).

Counterpart of ``deeplearning4j_tpu/nn/conf/layers/attention.py``. Layers
work on recurrent-format activations ``(b, T, d)``; attention on ``(b, h, T,
hd)``.

- :func:`_layer_norm` and :class:`LayerNormalization`: population variance,
  eps 1e-5.
- :func:`dense_attention` routes as the reference does
  (``attention.py:221-339``): to the flash-attention kernel
  (``nn/ops/flash_attention.py``) when :func:`_flash_attention_route`
  allows it, else to the query-blocked path for T >= 1024, else to the
  einsum path. The reference's kill switch and compile probe (the kernel
  registry) are ROADMAP § B0 and not ported: on CUDA tensors the route's
  conditions alone decide.
- The einsum and blocked paths repeat JAX's dtype flow: scores in the
  operands' dtype, the scale rounded to it (a Python float is weakly typed
  in JAX), the softmax as ``jax.nn.softmax`` writes it (its sum in f32 under
  bf16), ``p`` in the operands' dtype before ``p @ v``.
- :class:`SelfAttentionLayer`, :class:`TransformerBlock` and
  :class:`PositionalEmbeddingLayer` have the reference's fields, ``@class``
  names and params. Attention dropout and the train-mode forward come with
  the TransformerLM training slice and raise :class:`NotImplementedError`.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from deeplearning4j_tpu_torch.nn.conf import serde
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.layers.base import FeedForwardLayer, Layer
from deeplearning4j_tpu_torch.nn.ops.flash_attention import MAX_SEQ_LEN, flash_attention

_NEG_INF = -1e30
BLOCKED_ATTENTION_MIN_T = 1024

NO_TRAINING = ("attention dropout and the train-mode forward come with the "
               "TransformerLM training slice (ROADMAP § A, slice 6)")


def _layer_norm(x, gamma, beta, eps: float = 1e-5):
    mean = x.mean(-1, keepdim=True)
    var = x.var(-1, unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * gamma + beta


@serde.register
class LayerNormalization(Layer):
    """Per-feature layer norm over the last axis."""

    def __init__(self, eps: float = 1e-5, **kwargs):
        super().__init__(**kwargs)
        self.eps = float(eps)
        self.n_feat: Optional[int] = None

    def initialize(self, input_type):
        self.n_feat = input_type.size if input_type.kind in ("feedforward", "recurrent") \
            else input_type.channels

    def init_params(self, gen, input_type, dtype=torch.float32):
        return {"gamma": torch.ones((self.n_feat,), dtype=dtype),
                "beta": torch.zeros((self.n_feat,), dtype=dtype)}

    def apply(self, params, x, *, state=None, train=False, mask=None):
        return _layer_norm(x, params["gamma"], params["beta"], self.eps), state or {}


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _weak(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``: what a Python float becomes in a JAX
    op against an array of that dtype."""
    return float(torch.tensor(value, dtype=torch.float64).to(dtype))


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis, op for op: ``exp(x - max)`` in
    x's dtype, divided by its sum (taken in f32 and rounded to x's dtype, as
    ``jnp.sum`` does for bf16)."""
    u = torch.exp(x - x.amax(-1, keepdim=True))
    return u / u.float().sum(-1, keepdim=True).to(x.dtype)


def _flash_attention_route(q, k, causal, mask, dropout_rate, segment_ids=None,
                           device_type: Optional[str] = None) -> bool:
    """Whether :func:`dense_attention` runs the flash kernel: CUDA tensors
    (``device_type``, default q's), no padding mask and no attention
    dropout, equal q/kv lengths, T >= 128 with T % 128 == 0 and T <=
    MAX_SEQ_LEN (the reference's conditions, ``attention.py:221-249``).
    Segment ids ride along. ``causal`` is the kernel's flag, not a
    condition. Head dims and dtypes the kernel does not take are routed to
    it all the same, and its argument checks refuse them: on the card
    nothing falls back to the plain path."""
    if mask is not None or dropout_rate > 0.0:
        return False
    if (device_type or q.device.type) != "cuda":
        return False
    T = q.shape[2]
    return k.shape[2] == T and T >= 128 and T % 128 == 0 and T <= MAX_SEQ_LEN


def _masked(s, causal: bool, mask, segment_ids, q_pos=None):
    """``-1e30`` where the causal mask (query positions ``q_pos``, default
    0..), the (b, T) key padding mask or the segment ids exclude a key."""
    T = s.shape[-1]
    if causal:
        kpos = torch.arange(T, device=s.device)
        qp = kpos[:s.shape[-2]] if q_pos is None else q_pos
        s = torch.where(kpos[None, :] <= qp[:, None], s, _NEG_INF)
    if mask is not None:
        s = torch.where(mask[:, None, None, :] > 0, s, _NEG_INF)
    if segment_ids is not None:
        seg_q = segment_ids if q_pos is None else segment_ids[:, q_pos]
        s = torch.where(seg_q[:, None, :, None] == segment_ids[:, None, None, :], s, _NEG_INF)
    return s


def _scores(q, k, scale: float):
    return torch.matmul(q, k.transpose(-1, -2)) * _weak(scale, q.dtype)


def _blocked_attention(q, k, v, *, causal: bool, mask, scale: float, block_q: int,
                       segment_ids=None):
    """Dense attention one query block at a time: live scores (b, h,
    block_q, T) instead of (b, h, T, T) (the reference's XLA fallback for T
    >= BLOCKED_ATTENTION_MIN_T)."""
    T = q.shape[2]
    out = []
    for i in range(T // block_q):
        q_pos = torch.arange(i * block_q, (i + 1) * block_q, device=q.device)
        s = _masked(_scores(q[:, :, i * block_q:(i + 1) * block_q], k, scale),
                    causal, mask, segment_ids, q_pos)
        out.append(torch.matmul(_softmax(s).to(v.dtype), v))
    return torch.cat(out, dim=2)


def dense_attention(q, k, v, *, causal: bool, mask=None, dropout_rate: float = 0.0,
                    dropout_rng=None, segment_ids=None):
    """Softmax attention, q, k, v: (b, h, T, hd). ``mask``: a (b, T) key
    padding mask; ``segment_ids``: (b, T) ints for packed sequences (tokens
    attend within their own segment; composes with ``causal``). Runs the
    flash kernel where :func:`_flash_attention_route` allows, else the
    blocked path (T >= 1024), else the einsum path."""
    if dropout_rate > 0.0 and dropout_rng is not None:
        raise NotImplementedError(f"dense_attention: {NO_TRAINING}")
    T = q.shape[2]
    scale = 1.0 / math.sqrt(q.shape[-1])
    if segment_ids is not None:
        segment_ids = torch.as_tensor(segment_ids, device=q.device).to(torch.int32)
    if _flash_attention_route(q, k, causal, mask, dropout_rate, segment_ids):
        return flash_attention(q, k, v, causal=causal, sm_scale=scale,
                               segment_ids=segment_ids)
    if T >= BLOCKED_ATTENTION_MIN_T and dropout_rate == 0.0 and k.shape[2] == T:
        for bq in (512, 256, 128):
            if T % bq == 0:
                return _blocked_attention(q, k, v, causal=causal, mask=mask, scale=scale,
                                          block_q=bq, segment_ids=segment_ids)
    s = _masked(_scores(q, k, scale), causal, mask, segment_ids)
    return torch.matmul(_softmax(s), v)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
def _refuse_training(layer, train: bool) -> None:
    if train:
        raise NotImplementedError(f"{type(layer).__name__}: {NO_TRAINING}")


@serde.register
class SelfAttentionLayer(FeedForwardLayer):
    """Multi-head self-attention over (b, T, d); ``n_out`` (default
    ``n_in``) divisible by ``n_heads``; ``causal`` masks the future."""

    is_recurrent = True  # preserves (b, T) masks

    def __init__(self, n_heads: int = 4, causal: bool = False,
                 attention_dropout: float = 0.0, **kwargs):
        kwargs.setdefault("activation", "identity")
        super().__init__(**kwargs)
        self.n_heads = int(n_heads)
        self.causal = bool(causal)
        self.attention_dropout = float(attention_dropout)

    def initialize(self, input_type):
        super().initialize(input_type)
        if self.n_out is None:
            self.n_out = self.n_in
        if self.n_out % self.n_heads:
            raise ValueError(f"n_out {self.n_out} not divisible by n_heads {self.n_heads}")

    def get_output_type(self, input_type):
        return InputType.recurrent(self.n_out, input_type.timesteps)

    def init_params(self, gen, input_type, dtype=torch.float32):
        d, m = self.n_in, self.n_out
        return {"Wq": self._draw_weight(gen, (d, m), d, m, dtype),
                "Wk": self._draw_weight(gen, (d, m), d, m, dtype),
                "Wv": self._draw_weight(gen, (d, m), d, m, dtype),
                "Wo": self._draw_weight(gen, (m, m), m, m, dtype),
                "bo": torch.zeros((m,), dtype=dtype)}

    def _heads(self, x, W):
        b, T, _ = x.shape
        return (x @ W).reshape(b, T, self.n_heads, -1).transpose(1, 2)

    def apply(self, params, x, *, state=None, train=False, mask=None):
        _refuse_training(self, train)
        b, T, _ = x.shape
        q, k, v = (self._heads(x, params[n]) for n in ("Wq", "Wk", "Wv"))
        o = dense_attention(q, k, v, causal=self.causal, mask=mask)
        o = o.transpose(1, 2).reshape(b, T, self.n_out)
        y = o @ params["Wo"] + params["bo"]
        if mask is not None:
            y = y * mask[..., None]
        return y, state or {}


@serde.register
class TransformerBlock(FeedForwardLayer):
    """Pre-LN transformer block: x + MHA(LN(x)), then x + MLP(LN(x));
    ``mlp_ratio`` sets the FFN's hidden width."""

    is_recurrent = True

    def __init__(self, n_heads: int = 4, causal: bool = True, mlp_ratio: int = 4,
                 **kwargs):
        kwargs.setdefault("activation", "gelu")
        super().__init__(**kwargs)
        self.n_heads = int(n_heads)
        self.causal = bool(causal)
        self.mlp_ratio = int(mlp_ratio)

    def initialize(self, input_type):
        super().initialize(input_type)
        if self.n_out is None:
            self.n_out = self.n_in
        if self.n_out != self.n_in:
            raise ValueError("TransformerBlock requires nIn == nOut (residual)")
        if self.n_out % self.n_heads:
            raise ValueError(f"n_out {self.n_out} not divisible by n_heads {self.n_heads}")

    def get_output_type(self, input_type):
        return InputType.recurrent(self.n_out, input_type.timesteps)

    def init_params(self, gen, input_type, dtype=torch.float32):
        d = self.n_out
        h = d * self.mlp_ratio
        ones, zeros = (lambda n: torch.ones((n,), dtype=dtype)), \
            (lambda n: torch.zeros((n,), dtype=dtype))
        return {"ln1_g": ones(d), "ln1_b": zeros(d),
                "Wq": self._draw_weight(gen, (d, d), d, d, dtype),
                "Wk": self._draw_weight(gen, (d, d), d, d, dtype),
                "Wv": self._draw_weight(gen, (d, d), d, d, dtype),
                "Wo": self._draw_weight(gen, (d, d), d, d, dtype),
                "bo": zeros(d), "ln2_g": ones(d), "ln2_b": zeros(d),
                "W1": self._draw_weight(gen, (d, h), d, h, dtype), "b1": zeros(h),
                "W2": self._draw_weight(gen, (h, d), h, d, dtype), "b2": zeros(d)}

    def attention(self, params, x, mask=None):
        """The MHA sublayer on pre-normed input."""
        b, T, d = x.shape
        q, k, v = ((x @ params[n]).reshape(b, T, self.n_heads, -1).transpose(1, 2)
                   for n in ("Wq", "Wk", "Wv"))
        o = dense_attention(q, k, v, causal=self.causal, mask=mask)
        o = o.transpose(1, 2).reshape(b, T, d)
        return o @ params["Wo"] + params["bo"]

    def mlp(self, params, x):
        h = self.act_fn()(x @ params["W1"] + params["b1"])
        return h @ params["W2"] + params["b2"]

    def block_apply(self, params, x, mask=None):
        a_in = _layer_norm(x, params["ln1_g"], params["ln1_b"])
        x = x + self.attention(params, a_in, mask=mask)
        m_in = _layer_norm(x, params["ln2_g"], params["ln2_b"])
        return x + self.mlp(params, m_in)

    def apply(self, params, x, *, state=None, train=False, mask=None):
        _refuse_training(self, train)
        y = self.block_apply(params, x, mask=mask)
        if mask is not None:
            y = y * mask[..., None]
        return y, state or {}


@serde.register
class PositionalEmbeddingLayer(Layer):
    """Adds learned (default) or sinusoidal position encodings to (b, T, d);
    ``max_length`` bounds a learned table."""

    def __init__(self, max_length: int = 2048, mode: str = "learned", **kwargs):
        super().__init__(**kwargs)
        self.max_length = int(max_length)
        self.mode = mode
        self.n_feat: Optional[int] = None

    def initialize(self, input_type):
        self.n_feat = input_type.size

    def init_params(self, gen, input_type, dtype=torch.float32):
        if self.mode != "learned":
            return {}
        return {"pos": 0.02 * torch.randn((self.max_length, self.n_feat), generator=gen,
                                          dtype=torch.float32).to(dtype)}

    def apply(self, params, x, *, state=None, train=False, mask=None):
        T = x.shape[1]
        if self.mode == "learned":
            return x + params["pos"][:T][None], state or {}
        d = x.shape[-1]
        half = (d + 1) // 2  # ceil, so odd feature dims work; trimmed below
        pos = torch.arange(T, dtype=x.dtype, device=x.device)[:, None]
        dim = torch.arange(half, dtype=x.dtype, device=x.device)[None, :]
        angle = pos / torch.pow(torch.tensor(10000.0, dtype=x.dtype, device=x.device),
                                2 * dim / d)
        enc = torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)[:, :d]
        return x + enc[None], state or {}
