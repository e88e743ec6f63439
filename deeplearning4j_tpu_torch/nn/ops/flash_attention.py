"""Flash attention, forward: a hand-written CUDA kernel for Hopper beside its
plain PyTorch version.

Counterpart of ``deeplearning4j_tpu/nn/ops/flash_attention.py``. For q, k, v
of shape ``(b, h, T, hd)``, equal lengths::

    s   = q k^T * scale                          (f32; -1e30 where masked)
    o   = softmax(s) v                           (p rounded to v's dtype first)
    lse = logsumexp(s)                           (f32, (b*h, T))

with an optional causal mask and packed-sequence segment ids (a query
attends only to keys of its own segment; composes with ``causal``).

- :func:`flash_attention_plain` is the plain version: the reference
  kernel's arithmetic written whole (f32 scores, ``-1e30`` masking, row max
  and sum, ``p`` rounded to ``v``'s dtype before ``p @ v`` as
  ``flash_attention.py:107`` does, one division, ``lse = m + log(max(l,
  1e-30))``). The CPU path and the tests use it.
- :func:`flash_attention_fwd` takes the plain version for a CPU tensor and
  for a CUDA tensor launches the kernel (``csrc/flash_attention.cu``, which
  replaces the reference's ``_fwd_kernel``) or raises: there is no fallback
  and no probe (the availability registry is ROADMAP § B0). Each launch adds
  one to ``launch_counts["flash_attention_fwd"]`` (``launch.py``). q, k and v
  may be strided views with a unit-stride head dimension (the model's head
  split is a transpose); ``o`` comes back as a ``(b, h, T, hd)`` view of a
  ``(b, T, h, hd)`` buffer, so merging the heads after it copies nothing.
- :func:`flash_attention` is the reference's public function: the same
  validation and messages (``:380-419``).
- The backward kernels (``_dq_kernel``, ``_dkv_kernel``) come with the
  TransformerLM training slice: a CUDA call that would record a gradient
  raises :class:`NotImplementedError`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from deeplearning4j_tpu_torch.nn.ops.launch import (  # noqa: F401  (counters re-exported)
    KernelLibrary,
    launch,
    launch_counts,
    ptrs,
    reset_launch_counts,
)

OP = "flash_attention_fwd"

_LANE = 128
#: the reference's cap on T (it kept K and V of a head resident in VMEM)
MAX_SEQ_LEN = 4096
#: the largest head dim the kernel takes
MAX_HEAD_DIM = 128
_NEG_INF = -1e30
_DTYPES = (torch.float32, torch.bfloat16)

WIDER = ("other dtypes and head dims over 128 wait for a wider kernel (ROADMAP § A, "
         "flash attention)")

NO_BACKWARD = ("the flash-attention backward kernels (_dq_kernel, _dkv_kernel) come "
               "with the TransformerLM training slice (ROADMAP § A, slice 6); run "
               "the forward under torch.no_grad() or inference_mode()")


# ---------------------------------------------------------------------------
# plain version (the CPU path, and the oracle the kernel is held to)
# ---------------------------------------------------------------------------
def masked_scores(q, k, causal: bool, scale: float,
                  segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(b, h, T, T) f32 scores ``q k^T * scale``, ``-1e30`` where the causal
    mask or the segment ids exclude a key."""
    T = q.shape[2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        tri = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
        s = torch.where(tri, s, _NEG_INF)
    if segment_ids is not None:
        same = segment_ids[:, None, :, None] == segment_ids[:, None, None, :]
        s = torch.where(same, s, _NEG_INF)
    return s


def flash_attention_plain(q, k, v, causal: bool, scale: float,
                          segment_ids: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain torch -> ``(o (b, h, T, hd) of q's
    dtype, lse (b*h, T) f32)``."""
    b, h, T, _ = q.shape
    s = masked_scores(q, k, causal, scale, segment_ids)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l_safe = p.sum(-1, keepdim=True).clamp_min(1e-30)
    # p rounded to v's dtype, products summed in f32 (the reference's
    # preferred_element_type=f32 dot)
    pv = torch.matmul(p.to(v.dtype).float(), v.float())
    o = (pv / l_safe).to(q.dtype)
    lse = (m + torch.log(l_safe)).reshape(b * h, T)
    return o, lse


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------
_LIB = KernelLibrary("flash_attention", {"dl4j_flash_fwd": (6, 18, 1)},
                     "dl4j_flash_tile", tile_keys="mnd")

_I32_MAX = 2 ** 31 - 1


def _strides(name: str, t: torch.Tensor) -> Tuple[int, int, int]:
    """(batch, head, time) element strides of a (b, h, T, hd) operand whose
    head dim is unit-stride; every offset must fit the kernel's int32."""
    if t.stride(3) != 1 and t.shape[3] > 1:
        raise ValueError(f"{OP}: {name} needs a unit-stride head dim (strides "
                         f"{t.stride()}); use .contiguous()")
    span = sum((n - 1) * abs(st) for n, st in zip(t.shape, t.stride()))
    if span > _I32_MAX:
        raise ValueError(f"{OP}: {name} spans {span} elements, over the kernel's "
                         "int32 offsets")
    return t.stride(0), t.stride(1), t.stride(2)


def _kernel(q, k, v, causal: bool, scale: float, seg: Optional[torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    if q.dim() != 4:
        raise ValueError(f"{OP}: q must be (b, h, T, hd), got {tuple(q.shape)}")
    b, h, T, hd = q.shape
    if q.dtype not in _DTYPES:
        raise TypeError(f"{OP}: the kernel takes f32 or bf16, got {q.dtype}; {WIDER}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{OP}: {name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{OP}: {name} must be {q.dtype}, got {t.dtype}")
        if tuple(t.shape) != tuple(q.shape):
            raise ValueError(f"{OP}: {name} must have shape {tuple(q.shape)}, "
                             f"got {tuple(t.shape)}")
    bm = 64
    if T == 0 or T % bm or not 1 <= hd <= MAX_HEAD_DIM or b * h > 65535:
        raise ValueError(f"{OP}: the kernel takes T a positive multiple of {bm}, "
                         f"1 <= hd <= {MAX_HEAD_DIM} and b*h <= 65535, got "
                         f"{tuple(q.shape)}; {WIDER}")
    if seg is not None:
        if seg.device != q.device or seg.dtype != torch.int32 or \
                tuple(seg.shape) != (b, T) or not seg.is_contiguous():
            raise ValueError(f"{OP}: segment ids must be a contiguous int32 (b, T)="
                             f"({b}, {T}) tensor on {q.device}, got {seg.dtype} "
                             f"{tuple(seg.shape)} on {seg.device}")
    strides = [s for name, t in (("q", q), ("k", k), ("v", v))
               for s in _strides(name, t)]
    # o as a (b, h, T, hd) view of a (b, T, h, hd) buffer
    o = torch.empty((b, T, h, hd), dtype=q.dtype, device=q.device).permute(0, 2, 1, 3)
    lse = torch.empty((b * h, T), dtype=torch.float32, device=q.device)
    lib = _LIB.get()
    if _LIB.tile["m"] != bm:
        raise RuntimeError(f"{OP}: the kernel's row block is {_LIB.tile['m']}, not {bm}")
    with torch.cuda.device(q.device):
        launch(lib.dl4j_flash_fwd, OP,
               (*ptrs(q, k, v), 0 if seg is None else seg.data_ptr(), *ptrs(o, lse),
                b, h, T, hd, int(causal), int(q.dtype == torch.bfloat16), *strides,
                o.stride(0), o.stride(1), o.stride(2), float(scale)))
    return o, lse


def flash_attention_fwd(q, k, v, causal: bool, scale: float,
                        segment_ids: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse)``: the kernel's entry (the reference's ``_fwd_impl``). A CPU
    ``q`` takes the plain version; a CUDA ``q`` the kernel (f32 or bf16
    q/k/v of one shape, ``T % 64 == 0``, ``hd <= 128``, int32 segment ids),
    or it raises. Forward only."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, scale, segment_ids)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(f"{OP}: {NO_BACKWARD}")
    return _kernel(q, k, v, causal, scale, segment_ids)


def flash_attention(q, k, v, *, causal: bool = False, sm_scale: Optional[float] = None,
                    segment_ids=None) -> torch.Tensor:
    """O(T)-memory attention. q, k, v: (b, h, T, head_dim) with equal q/kv
    lengths, T a multiple of 128 and <= MAX_SEQ_LEN. ``segment_ids``: an
    optional (b, T) int array for packed sequences (a token attends only to
    keys with the same id; composes with ``causal``)."""
    b, h, T, hd = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"q/k/v shapes must match exactly (got q={tuple(q.shape)}, "
            f"k={tuple(k.shape)}, v={tuple(v.shape)}); cross-attention / differing kv "
            "lengths are not supported by this kernel — use dense_attention")
    if T % _LANE or T > MAX_SEQ_LEN:
        raise ValueError(
            f"T={T} must be a multiple of {_LANE} and <= {MAX_SEQ_LEN} "
            "(longer sequences: use ring attention / dense)")
    scale = float(sm_scale) if sm_scale is not None else hd ** -0.5
    seg = None
    if segment_ids is not None:
        seg = torch.as_tensor(segment_ids, device=q.device)
        if tuple(seg.shape) != (b, T):
            raise ValueError(
                f"segment_ids must be (b, T)=({b}, {T}), got {tuple(seg.shape)}")
        seg = seg.to(torch.int32).contiguous()
    return flash_attention_fwd(q, k, v, causal, scale, seg)[0]
