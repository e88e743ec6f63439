"""TransformerLM: a GPT-style causal language model, served and trained on
the card.

Counterpart of ``deeplearning4j_tpu/models/transformer_lm.py``, its
functions under the same names over the same nested-dict params (block
params stacked along a leading ``(n_layers,)`` axis):

- :class:`TransformerLMConfig` (``:37-83``), :func:`init_params`
  (``:86-123``, drawn from a ``torch.Generator`` seeded by ``cfg.seed``),
  :func:`block_apply` (``:145-207``, dense and ``fused_qkv``),
  :func:`init_decode_cache` (``:343-356``), :func:`prefill_cache` with
  ``length=`` (``:359-428``), :func:`decode_step` with a scalar or per-row
  ``pos`` (``:431-515``), :func:`forward` (``:626-660``), :func:`token_nll`
  (``:663-679``), :func:`lm_loss` with ``segment_ids`` (``:682-708``) and the
  :class:`TransformerLM` model (``:711-937``: ``init`` with the updater and
  its state, ``_make_step``, ``fit_batch``, ``logits``, ``output``,
  ``generate``, ``generate_cached``, ``perplexity``);
- the sampler (``:210-344``, ``:604-623``): greedy, temperature, top-k and
  top-p as data, row by row, on the logits' device.

Mixed precision follows JAX's: under ``compute_dtype="bfloat16"`` the
``W*``/``b*`` params and the head are cast to bf16, LayerNorm params stay
f32 and ``_ln`` computes in f32; the residual stream is bf16; decode
attention scores are f32 and ``p`` is cast to the slab's dtype before ``p @
v``; logits come back f32. Prefill and full forwards at T % 128 == 0 run the
flash-attention kernel through ``dense_attention``; decode attention reads
the whole slab with ``torch.matmul``, as the reference's is an XLA einsum.
The KV cache is written in place (JAX returns a new one): the functions
return the cache dict they were given, its tensors updated.

Training follows JAX's ``_make_step``: the loss and its gradients are taken
over the f32 master params (the bf16 cast happens inside the forward, under
autograd), then ``Adam.apply`` runs per leaf and the step returns ``p -
update``. Attention at T % 128 == 0 on the card runs the flash forward and
backward kernels (``nn/ops/flash_attention.py``); packed sequences pass
``segment_ids`` through ``lm_loss`` into every attention path.

Refused with typed errors naming ROADMAP: MoE (``n_experts > 0``),
``decode_steps`` (speculative decoding), and the tensor/expert-parallel
arguments of ``block_apply``.

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

import json
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch import activations as _act
from deeplearning4j_tpu_torch import resolve_device
from deeplearning4j_tpu_torch.models.zoo import ZooModel
from deeplearning4j_tpu_torch.nn.conf.layers.attention import (
    _layer_norm,
    _softmax,
    dense_attention,
)
from deeplearning4j_tpu_torch.updaters import Adam

NO_MOE = ("mixture-of-experts TransformerLMs (n_experts > 0) are not ported yet: "
          "nn/conf/layers/moe.py comes with a later TransformerLM slice (ROADMAP § A, "
          "slice 6)")
NO_SPEC = ("decode_steps (speculative verification) comes with speculative decoding "
           "(ROADMAP § A, slice 6)")
NO_PARALLEL = ("manual tensor/expert parallelism (tp_axis, expert_axis) comes with the "
               "model-parallel slice (ROADMAP § A, slice 7)")


class TransformerLMConfig:
    def __init__(self, vocab_size: int, d_model: int = 256, n_heads: int = 4,
                 n_layers: int = 4, mlp_ratio: int = 4, max_length: int = 512,
                 seed: int = 0, n_experts: int = 0, top_k: int = 2,
                 capacity_factor: float = 1.25, aux_loss_weight: float = 1e-2,
                 compute_dtype: Optional[str] = None, fused_qkv: bool = False):
        if d_model % n_heads:
            raise ValueError("d_model must be divisible by n_heads")
        self.vocab_size = int(vocab_size)
        self.d_model = int(d_model)
        self.n_heads = int(n_heads)
        self.n_layers = int(n_layers)
        self.mlp_ratio = int(mlp_ratio)
        self.max_length = int(max_length)
        self.seed = int(seed)
        # MoE (n_experts > 0) is carried as configuration only (NO_MOE)
        self.n_experts = int(n_experts)
        self.top_k = int(top_k)
        self.capacity_factor = float(capacity_factor)
        self.aux_loss_weight = float(aux_loss_weight)
        if compute_dtype not in (None, "float32", "bfloat16"):
            raise ValueError(
                f"compute_dtype must be None, 'float32' or 'bfloat16', got {compute_dtype!r}")
        self.compute_dtype = None if compute_dtype == "float32" else compute_dtype
        # Q, K, V as one (d, 3d) matmul per block: the same outputs, the
        # param layout unchanged
        self.fused_qkv = bool(fused_qkv)

    def to_dict(self):
        return dict(self.__dict__)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_dict(cls, d):
        return cls(**d)


def _check_dense(cfg: TransformerLMConfig) -> None:
    if cfg.n_experts > 0:
        raise NotImplementedError(NO_MOE)


def init_params(cfg: TransformerLMConfig, gen: Optional[torch.Generator] = None,
                dtype=torch.float32, device=None) -> Dict:
    """The stacked-parameter dict (block params lead with ``(n_layers,)``),
    drawn on the CPU from ``gen`` (default seeded by ``cfg.seed``) in the
    reference's order and scales, then placed on ``device``."""
    _check_dense(cfg)
    gen = gen if gen is not None else torch.Generator().manual_seed(cfg.seed)
    dev = torch.device("cpu") if device is None else torch.device(device)
    d, h = cfg.d_model, cfg.d_model * cfg.mlp_ratio
    L, V = cfg.n_layers, cfg.vocab_size

    def normal(shape, scale):
        w = torch.randn(shape, generator=gen, dtype=torch.float32).mul_(scale)
        return w.to(device=dev, dtype=dtype)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    embed = normal((V, d), 0.02)
    pos = normal((cfg.max_length, d), 0.02)
    blocks = {"ln1_g": ones(L, d), "ln1_b": zeros(L, d)}
    for name in ("Wq", "Wk", "Wv", "Wo"):
        blocks[name] = normal((L, d, d), 1.0 / math.sqrt(d))
    blocks.update({"bo": zeros(L, d), "ln2_g": ones(L, d), "ln2_b": zeros(L, d),
                   "W1": normal((L, d, h), 1.0 / math.sqrt(d)), "b1": zeros(L, h),
                   "W2": normal((L, h, d), 1.0 / math.sqrt(h)), "b2": zeros(L, d)})
    return {"embed": embed, "pos": pos, "blocks": blocks,
            "lnf_g": ones(d), "lnf_b": zeros(d),
            "head": normal((d, V), 1.0 / math.sqrt(d))}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _cdtype(cfg: TransformerLMConfig) -> Optional[torch.dtype]:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None


def _ln(x, g, b, cd):
    """LayerNorm with f32 statistics under mixed precision."""
    if cd is None:
        return _layer_norm(x, g, b)
    return _layer_norm(x.float(), g, b).to(cd)


def _cast_block(bp: Dict, cd) -> Dict:
    """The reference's cast: ``W*``/``b*`` params to the compute dtype (the
    LayerNorm params stay). A no-op on params cast already."""
    if cd is None:
        return bp
    return {k: (v.to(cd) if k[0] in ("W", "b") else v) for k, v in bp.items()}


def _layers(cfg: TransformerLMConfig, params: Dict) -> List[Dict]:
    """One param dict per block: views of the stacked ``blocks`` (by
    ``unbind``, whose backward stacks the layers' gradients once, where
    indexing layer by layer would add a zero-filled stack per layer), or the
    list that :func:`compute_params` made already."""
    blocks = params["blocks"]
    if isinstance(blocks, list):
        return blocks
    per_param = {k: v.unbind(0) for k, v in blocks.items()}
    return [{k: v[i] for k, v in per_param.items()} for i in range(cfg.n_layers)]


def _head(params: Dict, cd):
    return params["head"] if cd is None else params["head"].to(cd)


def compute_params(cfg: TransformerLMConfig, params: Dict) -> Dict:
    """``params`` as the forward functions use them: each block's dict split
    out, its ``W*``/``b*`` and the head cast to the compute dtype once (the
    functions then cast nothing per call)."""
    cd = _cdtype(cfg)
    return {**params, "blocks": [_cast_block(bp, cd) for bp in _layers(cfg, params)],
            "head": _head(params, cd)}


def _heads(x, W, hn: int):
    b, T, _ = x.shape
    return (x @ W).reshape(b, T, hn, -1).transpose(1, 2)


def block_apply(cfg: TransformerLMConfig, bp: Dict, x, attn_fn=None,
                tp_axis: Optional[str] = None, expert_axis: Optional[str] = None):
    """One pre-LN block on (b, T, d); ``bp`` holds one layer's params.
    ``attn_fn`` replaces :func:`dense_attention`."""
    if tp_axis is not None or expert_axis is not None:
        raise NotImplementedError(NO_PARALLEL)
    _check_dense(cfg)
    b, T, d = x.shape
    hn = cfg.n_heads
    cd = _cdtype(cfg)
    if cd is not None:
        x = x.to(cd)
        bp = _cast_block(bp, cd)
    a_in = _ln(x, bp["ln1_g"], bp["ln1_b"], cd)
    if cfg.fused_qkv:
        qkv = a_in @ torch.cat([bp["Wq"], bp["Wk"], bp["Wv"]], dim=-1)
        q, k, v = (t.reshape(b, T, hn, -1).transpose(1, 2) for t in qkv.split(d, dim=-1))
    else:
        q, k, v = (_heads(a_in, bp[n], hn) for n in ("Wq", "Wk", "Wv"))
    fn = attn_fn if attn_fn is not None else dense_attention
    o = fn(q, k, v, causal=True, mask=None)
    o = o.transpose(1, 2).reshape(b, T, d).to(x.dtype)
    x = x + o @ bp["Wo"] + bp["bo"]
    m_in = _ln(x, bp["ln2_g"], bp["ln2_b"], cd)
    h = _act.gelu(m_in @ bp["W1"] + bp["b1"])
    return x + h @ bp["W2"] + bp["b2"]


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


# ---------------------------------------------------------------------------
# KV-cache decoding
# ---------------------------------------------------------------------------
def init_decode_cache(cfg: TransformerLMConfig, batch: int, max_length: Optional[int] = None,
                      device=None) -> Dict:
    """Preallocated per-layer K/V buffers ``(L, batch, heads, max_length,
    head_dim)`` of the compute dtype (f32 without one) and a position 0.
    ``max_length`` overrides the slab's time extent (default
    ``cfg.max_length``)."""
    cd = _cdtype(cfg) or torch.float32
    hd = cfg.d_model // cfg.n_heads
    T = cfg.max_length if max_length is None else int(max_length)
    shape = (cfg.n_layers, int(batch), cfg.n_heads, T, hd)
    dev = torch.device("cpu") if device is None else torch.device(device)
    return {"k": torch.zeros(shape, dtype=cd, device=dev),
            "v": torch.zeros(shape, dtype=cd, device=dev), "pos": 0}


def _embed(params, ids, positions, cd):
    x = params["embed"][ids] + params["pos"][positions]
    return x if cd is None else x.to(cd)


def _final_logits(params, x, cd):
    x = _ln(x, params["lnf_g"], params["lnf_b"], cd)
    return (x @ _head(params, cd)).float()


def prefill_cache(cfg: TransformerLMConfig, params: Dict, cache: Dict, ids, length=None):
    """Batched prompt prefill: ids (b, Tp) into ``cache`` (its positions
    [0, Tp) of every layer written in place) -> (the logits at the last real
    position (b, V) f32, the cache with ``pos`` = Tp, or ``length``).

    ``length`` (an int or a 0-d tensor, <= Tp) marks the real prompt length
    of a right-padded prompt: causal attention makes the padding exact, as
    position i attends only to positions <= i; the pad positions' K/V are
    written, masked from every decode read (decode masks to <= pos) and
    overwritten as decoding advances."""
    _check_dense(cfg)
    cd = _cdtype(cfg)
    b, Tp = ids.shape
    hn, d = cfg.n_heads, cfg.d_model
    x = _embed(params, ids, slice(0, Tp), cd)
    for i, bp in enumerate(_layers(cfg, params)):
        bp = _cast_block(bp, cd)
        a_in = _ln(x, bp["ln1_g"], bp["ln1_b"], cd)
        q, k, v = (_heads(a_in, bp[n], hn) for n in ("Wq", "Wk", "Wv"))
        cache["k"][i, :, :, :Tp] = k
        cache["v"][i, :, :, :Tp] = v
        o = dense_attention(q, k, v, causal=True, mask=None)
        o = o.transpose(1, 2).reshape(b, Tp, d).to(x.dtype)
        x = x + o @ bp["Wo"] + bp["bo"]
        m_in = _ln(x, bp["ln2_g"], bp["ln2_b"], cd)
        x = x + _act.gelu(m_in @ bp["W1"] + bp["b1"]) @ bp["W2"] + bp["b2"]
    if length is None:
        x_last, pos_out = x[:, -1], Tp
    elif isinstance(length, torch.Tensor):
        pos_out = length
        x_last = x.index_select(1, (length.to(x.device).long() - 1).reshape(1))[:, 0]
    else:
        pos_out = int(length)
        x_last = x[:, pos_out - 1]
    return _final_logits(params, x_last, cd), {**cache, "pos": pos_out}


def decode_step(cfg: TransformerLMConfig, params: Dict, cache: Dict, ids_1):
    """One autoregressive step: ids_1 (b,) at position ``cache["pos"]`` ->
    (logits (b, V) f32, the cache with its K/V written in place and ``pos``
    advanced by 1). ``pos`` is an int (every row at one position, written at
    ``min(pos, T - 1)``) or a (b,) tensor (each slot its own position, each
    row written at its own clamped index). Attention reads the whole slab,
    masked to positions <= pos; every op is row-wise, so a row decoded among
    others computes what it computes alone (up to the library GEMM's choice
    of algorithm at another row count)."""
    _check_dense(cfg)
    cd = _cdtype(cfg)
    pos = cache["pos"]
    per_row = isinstance(pos, torch.Tensor) and pos.dim() == 1
    kc_all, vc_all = cache["k"], cache["v"]
    T = kc_all.shape[3]
    dev = kc_all.device
    last = params["pos"].shape[0] - 1
    if per_row:
        pos = pos.to(dev)
        x = _embed(params, ids_1, pos.clamp(0, last), cd)
        valid = torch.arange(T, device=dev)[None, :] <= pos[:, None]     # (b, T)
        valid = valid[:, None, :]
        rows = torch.arange(ids_1.shape[0], device=dev)
        wp = pos.clamp(0, T - 1)
    else:
        p_int = int(pos)
        x = _embed(params, ids_1, min(max(p_int, 0), last), cd)
        valid = (torch.arange(T, device=dev) <= p_int)[None, None, :]
    b = x.shape[0]
    hn, d = cfg.n_heads, cfg.d_model
    scale = 1.0 / math.sqrt(d // hn)
    for i, bp in enumerate(_layers(cfg, params)):
        bp = _cast_block(bp, cd)
        kc, vc = kc_all[i], vc_all[i]                                  # (b, hn, T, hd)
        a_in = _ln(x, bp["ln1_g"], bp["ln1_b"], cd)
        q, k, v = ((a_in @ bp[n]).reshape(b, hn, -1) for n in ("Wq", "Wk", "Wv"))
        if per_row:
            kc[rows, :, wp] = k.to(kc.dtype)
            vc[rows, :, wp] = v.to(vc.dtype)
        else:
            kc[:, :, min(max(p_int, 0), T - 1)] = k
            vc[:, :, min(max(p_int, 0), T - 1)] = v
        scores = torch.matmul(q[:, :, None, :], kc.transpose(-1, -2))[:, :, 0].float() * scale
        p = _softmax(torch.where(valid, scores, -1e30)).to(kc.dtype)
        o = torch.matmul(p[:, :, None, :], vc)[:, :, 0].reshape(b, d).to(x.dtype)
        x = x + o @ bp["Wo"] + bp["bo"]
        m_in = _ln(x, bp["ln2_g"], bp["ln2_b"], cd)
        x = x + _act.gelu(m_in @ bp["W1"] + bp["b1"]) @ bp["W2"] + bp["b2"]
    return _final_logits(params, x, cd), {**cache, "pos": cache["pos"] + 1}


def decode_steps(cfg: TransformerLMConfig, params: Dict, cache: Dict, ids_k):
    """K-column decode for speculative verification: not ported yet."""
    raise NotImplementedError(NO_SPEC)


def forward(cfg: TransformerLMConfig, params: Dict, ids, attn_fn=None, pos_offset: int = 0,
            cast_logits: bool = True):
    """ids (b, T) -> logits (b, T, V). ``attn_fn`` replaces
    :func:`dense_attention`; ``cast_logits=False`` keeps the logits in the
    compute dtype."""
    _check_dense(cfg)
    cd = _cdtype(cfg)
    x = _embed(params, ids, slice(pos_offset, pos_offset + ids.shape[1]), cd)
    for bp in _layers(cfg, params):
        x = block_apply(cfg, bp, x, attn_fn=attn_fn)
    x = _ln(x, params["lnf_g"], params["lnf_b"], cd)
    logits = x @ _head(params, cd)
    return logits.float() if cast_logits else logits


def token_nll(logits, targets):
    """Per-token next-token NLL as ``lse(logits) - logits[target]``; targets
    -1 are ignored. Returns (mean_nll, valid_count)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    tgt = targets.clamp_min(0).long()
    tgt_logit = torch.gather(lf, -1, tgt[..., None])[..., 0]
    valid = (targets >= 0).float()
    nll = (lse - tgt_logit) * valid
    count = valid.sum().clamp_min(1.0)
    return nll.sum() / count, count


def lm_loss(cfg: TransformerLMConfig, params, ids, targets, segment_ids=None):
    """Mean next-token cross-entropy; targets (b, T) ints, -1 ignored.
    ``segment_ids``: optional (b, T) ints for packed-sequence training (several
    documents per row): attention stays within each segment on every
    attention path; a boundary token's target should be -1, so that it does
    not predict into the next document."""
    attn_fn = None
    if segment_ids is not None:
        seg = torch.as_tensor(segment_ids, device=ids.device)

        def attn_fn(q, k, v, *, causal, mask=None):
            return dense_attention(q, k, v, causal=causal, mask=mask, segment_ids=seg)

    logits = forward(cfg, params, ids, attn_fn=attn_fn, cast_logits=False)
    return token_nll(logits, targets)[0]


def _named_leaves(tree: Dict, prefix: Tuple[str, ...] = ()):
    """(path, tensor) for every tensor of a nested dict, in insertion order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _at(tree: Dict, path: Tuple[str, ...]):
    for k in path:
        tree = tree[k]
    return tree


def _nest(items) -> Dict:
    """The nested dict of (path, value) pairs."""
    out: Dict = {}
    for path, v in items:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def value_and_grad(loss_fn, params: Dict) -> Tuple[torch.Tensor, Dict]:
    """``(loss_fn(params), its gradient)`` over every tensor of the nested
    dict ``params``, the gradient in the same layout (``jax.value_and_grad``
    of a loss over a params pytree). ``params`` are not changed; the loss
    comes back detached."""
    named = [(path, p.detach().requires_grad_()) for path, p in _named_leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(_nest(named))
        grads = torch.autograd.grad(loss, [p for _, p in named])
    return loss.detach(), _nest((path, g) for (path, _), g in zip(named, grads))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
class TransformerLM(ZooModel):
    """The zoo wrapper: ``init`` on a device (default the CUDA card),
    ``fit_batch`` (one Adam step, default ``Adam(3e-4)``; ``updater=`` to
    the constructor overrides it), ``logits``/``output`` (token ids (b, T) ->
    f32 logits (b, T, V)), ``generate`` (a host loop of full forwards),
    ``generate_cached`` (KV-cache decoding) and ``perplexity``. ``params_``
    are f32 master params, ``opt_state_`` the updater's slots in the same
    nested layout (per leaf ``{"m", "v"}``); :meth:`compute_params` casts the
    params for the compute dtype once and keeps the cast while every param
    tensor is the same object at the same version."""

    name = "transformerlm"

    #: prompt-length buckets for KV-cache prefill (filtered to the
    #: instance's max_length at use; see ``prefill_bucket_lengths``)
    serving_seq_buckets = (16, 32, 64, 128, 256, 512)

    def __init__(self, vocab_size: int = 1000, d_model: int = 256, n_heads: int = 4,
                 n_layers: int = 4, mlp_ratio: int = 4, max_length: int = 512,
                 seed: int = 123, n_experts: int = 0, top_k: int = 2,
                 capacity_factor: float = 1.25, aux_loss_weight: float = 1e-2,
                 compute_dtype: Optional[str] = None, fused_qkv: bool = False, **kwargs):
        super().__init__(num_classes=vocab_size, seed=seed, **kwargs)
        self.cfg = TransformerLMConfig(
            vocab_size, d_model, n_heads, n_layers, mlp_ratio, max_length, seed=seed,
            n_experts=n_experts, top_k=top_k, capacity_factor=capacity_factor,
            aux_loss_weight=aux_loss_weight, compute_dtype=compute_dtype,
            fused_qkv=fused_qkv)
        self.params_: Optional[Dict] = None
        self.opt_state_: Optional[Dict] = None
        #: no layer running state (the serving engine reads this attribute)
        self.state_ = None
        self.device: Optional[torch.device] = None
        self.updater = None
        self.iteration = 0
        self.score_: Optional[float] = None
        #: ([(leaf, its _version)], the cast params) of the last compute_params()
        self._compute_cache: Optional[Tuple[List[Tuple[torch.Tensor, int]], Dict]] = None

    def init(self, device=None) -> "TransformerLM":
        """Seeded params (``cfg.seed``) on ``device`` (default the CUDA card),
        zero updater slots and iteration 0."""
        self.device = resolve_device(device)
        self.params_ = init_params(self.cfg, device=self.device)
        self.updater = self.kwargs.get("updater", Adam(3e-4))
        self.opt_state_ = None
        self._ensure_opt_state()
        self.iteration, self.score_ = 0, None
        return self

    def _ensure_opt_state(self) -> Dict:
        """The updater slots, made (zeros) where none exist yet."""
        if self.opt_state_ is None:
            self.opt_state_ = _nest((path, self.updater.init_state(t))
                                    for path, t in _named_leaves(self.params_))
        return self.opt_state_

    def compute_params(self, params: Optional[Dict] = None) -> Dict:
        """``params`` (default ``params_``) as :func:`compute_params` gives
        them; for ``params_`` the result is kept until a tensor of it is
        replaced or changed in place. The key holds the leaf tensors
        themselves (compared with ``is``) and their versions: an ``id`` alone
        can be reused by a new tensor once the old one is freed."""
        if params is not None:
            return compute_params(self.cfg, params)
        leaves = list(_leaves(self.params_))
        cached = self._compute_cache
        if cached is None or len(cached[0]) != len(leaves) or any(
                t is not held or t._version != version
                for t, (held, version) in zip(leaves, cached[0])):
            self._compute_cache = ([(t, t._version) for t in leaves],
                                   compute_params(self.cfg, self.params_))
        return self._compute_cache[1]

    def _ids(self, ids) -> torch.Tensor:
        """Token ids (numpy, a list or a tensor) as int64 on the model's device."""
        if isinstance(ids, torch.Tensor):
            return ids.to(device=self.device, dtype=torch.int64)
        return torch.as_tensor(np.asarray(ids), dtype=torch.int64).to(self.device)

    def _make_step(self, with_seg: bool = False):
        """``step(params, opt_state, ids, targets, t, seg=None) -> (params,
        opt_state, loss)``, JAX's contract: the loss and its gradients over
        the f32 master ``params`` (``seg`` is passed to :func:`lm_loss` when
        ``with_seg``), then per leaf ``(update, slots) = updater.apply(g,
        slots, t, t, 0)`` and ``p - update``. Returns new tensors; the inputs
        are not changed. ``loss`` is a 0-dim tensor on the params' device."""
        cfg, upd = self.cfg, self.updater

        def step(params, opt_state, ids, targets, t, seg=None):
            loss, grads = value_and_grad(
                lambda p: lm_loss(cfg, p, ids, targets, segment_ids=seg if with_seg else None),
                params)
            new_p, new_o = [], []
            with torch.no_grad():
                for path, p in _named_leaves(params):
                    update, slots = upd.apply(_at(grads, path), _at(opt_state, path), t, t, 0)
                    new_p.append((path, p - update))
                    new_o.append((path, slots))
            return _nest(new_p), _nest(new_o), loss

        return step

    def fit_batch(self, ids, targets, segment_ids=None) -> float:
        """One train step on token ids (b, T) and targets (b, T) (-1 =
        ignore); ``segment_ids`` (b, T) ints enable packed-sequence training
        (see :func:`lm_loss`). Returns the loss before the update (also
        ``score_``)."""
        if self.params_ is None:
            raise ValueError("init() the model (or load params) first")
        step = self._make_step(with_seg=segment_ids is not None)
        self.iteration += 1
        args = [self.params_, self._ensure_opt_state(), self._ids(ids), self._ids(targets),
                self.iteration]
        if segment_ids is not None:
            args.append(self._ids(segment_ids).to(torch.int32))
        self.params_, self.opt_state_, loss = step(*args)
        self._compute_cache = None  # the old cast and the old params are freed now
        self.score_ = float(loss)
        return self.score_

    def logits(self, ids) -> np.ndarray:
        with torch.inference_mode():
            return forward(self.cfg, self.compute_params(), self._ids(ids)).cpu().numpy()

    def output(self, x, mask=None) -> np.ndarray:
        """Token ids (b, T) -> f32 logits (b, T, V)."""
        return self.logits(np.asarray(x).astype(np.int64))

    # -- the serving engine's surface for a model without ``_forward`` -------
    def conf_json(self) -> str:
        """The architecture key the engine compares on reload."""
        return self.cfg.to_json()

    def serving_rows(self, x) -> np.ndarray:
        """A request as int64 token ids: (b, T) integral values in [0,
        vocab), 1 <= T <= max_length; a ValueError otherwise."""
        x = np.asarray(x)
        cfg = self.cfg
        if x.ndim != 2 or not 1 <= x.shape[1] <= cfg.max_length:
            raise ValueError(f"input of shape {tuple(x.shape)}; the model takes (batch, time) "
                             f"token ids with 1 <= time <= {cfg.max_length}")
        ids = x.astype(np.int64)
        if x.size and (np.any(ids != x) or ids.min() < 0 or ids.max() >= cfg.vocab_size):
            raise ValueError(f"token ids must be integers in [0, {cfg.vocab_size})")
        return ids

    def serving_forward(self, params: Dict, ids: torch.Tensor) -> torch.Tensor:
        """f32 logits (b, T, V) of token ids (b, T) under ``params`` as
        :meth:`compute_params` gives them (an engine's snapshot)."""
        return forward(self.cfg, params, ids)

    def num_params(self) -> int:
        return sum(int(t.numel()) for t in _leaves(self.params_))

    def generate(self, prompt_ids, max_new: int = 20, temperature: float = 0.0, rng=None,
                 top_k: int = 0, top_p: float = 0.0) -> np.ndarray:
        """Continuation by a host loop of full forwards over the growing
        prefix, windowed to the last ``max_length`` tokens. ``rng``: a key of
        :func:`new_key` (default seed 0)."""
        ids = np.asarray(prompt_ids, np.int64)
        if ids.ndim == 1:
            ids = ids[None]
        _validate_sampling(temperature, top_k, top_p)
        key = (rng if rng is not None else new_key(0)).to(self.device)
        for _ in range(max_new):
            window = ids[:, -self.cfg.max_length:]
            with torch.inference_mode():
                logits = forward(self.cfg, self.compute_params(), self._ids(window))[:, -1]
                nxt, key = sample_next_device(logits, temperature, top_k, top_p, key)
            ids = np.concatenate([ids, nxt.cpu().numpy().astype(np.int64)[:, None]], axis=1)
        return ids.astype(np.int32)

    def prefill_buckets(self):
        """The prompt-length buckets prefill pads to."""
        return prefill_bucket_lengths(self.cfg.max_length, self.serving_seq_buckets)

    def generate_cached(self, prompt_ids, max_new: int = 20, temperature: float = 0.0,
                        rng=None, top_k: int = 0, top_p: float = 0.0) -> np.ndarray:
        """KV-cache decoding: the prompt, right-padded to its bucket,
        prefills the per-layer K/V slab; each new token is one
        :func:`decode_step`; sampling runs on the device and the tokens come
        back once at the end. Raises :class:`ContextWindowExceeded` when
        prompt_len + max_new > max_length."""
        ids = np.asarray(prompt_ids, np.int64)
        if ids.ndim == 1:
            ids = ids[None]
        if ids.shape[1] + max_new > self.cfg.max_length:
            raise ContextWindowExceeded(ids.shape[1], max_new, self.cfg.max_length)
        _validate_sampling(temperature, top_k, top_p)
        if max_new <= 0:
            return ids.astype(np.int32)
        key = (rng if rng is not None else new_key(0)).to(self.device)
        b, tp = ids.shape
        tb = next(t for t in self.prefill_buckets() if t >= tp)
        padded = np.zeros((b, tb), np.int64)
        padded[:, :tp] = ids
        with torch.inference_mode():
            params = self.compute_params()
            cache = init_decode_cache(self.cfg, b, device=self.device)
            logits, cache = prefill_cache(self.cfg, params, cache, self._ids(padded), length=tp)
            tok, key = sample_next_device(logits, temperature, top_k, top_p, key)
            toks = [tok]
            for _ in range(max_new - 1):
                logits, cache = decode_step(self.cfg, params, cache, tok.long())
                tok, key = sample_next_device(logits, temperature, top_k, top_p, key)
                toks.append(tok)
            gen = torch.stack(toks, dim=1).cpu().numpy()
        return np.concatenate([ids, gen.astype(np.int64)], axis=1).astype(np.int32)

    def perplexity(self, ids, targets) -> float:
        """exp(mean next-token NLL) over valid targets (-1 = ignore), under the
        current params (read through :meth:`compute_params`)."""
        with torch.inference_mode():
            nll = lm_loss(self.cfg, self.compute_params(), self._ids(ids), self._ids(targets))
        return float(np.exp(float(nll)))
