"""Flash attention, forward and backward: hand-written CUDA kernels for
Hopper beside their plain PyTorch versions.

Counterpart of ``deeplearning4j_tpu/nn/ops/flash_attention.py``. For q, k, v
of shape ``(b, h, T, hd)``, equal lengths::

    s   = q k^T * scale                          (f32; -1e30 where masked)
    o   = softmax(s) v                           (p rounded to v's dtype first)
    lse = logsumexp(s)                           (f32, (b*h, T))

with an optional causal mask and packed-sequence segment ids (a query
attends only to keys of its own segment; composes with ``causal``). The
backward (the reference's ``_bwd_impl``, FlashAttention-2 style) recomputes
``p = exp(s - lse)`` from the forward's ``lse``::

    D  = rowsum(dO * O)                          (f32, both widened)
    dv = p~^T dO,  dp = dO v^T,  ds = p (dp - D) scale
    dq = ds~ k,    dk = ds~^T q                  (~: rounded to the operand dtype)

every product summed in f32.

- :func:`flash_attention_plain` and :func:`flash_attention_bwd_plain` (made of
  :func:`flash_attention_dq_plain` and :func:`flash_attention_dkv_plain`,
  which split the work as the two backward kernels do) are the plain
  versions: the reference kernels' arithmetic written whole. The CPU path
  and the tests use them.
- :func:`flash_attention_fwd`, :func:`flash_attention_dq` and
  :func:`flash_attention_dkv` take the plain version for a CPU tensor and
  for a CUDA tensor launch their kernel (``csrc/flash_attention.cu``, which
  replaces the reference's ``_fwd_kernel``; ``csrc/flash_attention_bwd.cu``,
  which replaces ``_dq_kernel`` and ``_dkv_kernel``) or raise: there is no
  fallback and no probe (the availability registry is ROADMAP § B0).
  The bf16 forward, dq and dkv kernels are Hopper designs (TMA tile loads
  on mbarriers, wgmma, scores and accumulators in registers): an operand
  their TMA loads cannot read (:func:`tma_ready`) is first copied into a
  padded buffer (:func:`padded_operand`, a layout copy for the same kernel).
  :func:`flash_attention_bwd` is the reference's ``_bwd_impl``: ``D`` by
  :func:`row_dot`, then the two. Each launch adds one to
  ``launch_counts`` under ``flash_attention_fwd``, ``flash_attention_dq`` or
  ``flash_attention_dkv`` (``launch.py``). q, k, v and dO may be strided
  views with a unit-stride head dimension (the model's head split is a
  transpose); ``o``, dq, dk and dv come back as ``(b, h, T, hd)`` views of
  ``(b, T, h, hd)`` buffers, so merging the heads after them copies nothing.
- Gradients: where grad mode is on and q, k or v requires grad,
  :func:`flash_attention_fwd` runs through :class:`FlashAttention` (the
  reference's custom VJP ``_flash``/``_flash_seg``), which saves ``q, k, v,
  o, lse`` and the segment ids and calls :func:`flash_attention_bwd` in the
  backward; segment ids and ``lse`` get no gradient. Under ``no_grad`` or
  ``inference_mode`` nothing is saved and no backward kernel launches.
- :func:`flash_attention` is the reference's public function: the same
  validation and messages (``:380-419``).
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
OP_DQ = "flash_attention_dq"
OP_DKV = "flash_attention_dkv"

_LANE = 128
#: the reference's cap on T (it kept K and V of a head resident in VMEM)
MAX_SEQ_LEN = 4096
#: the largest head dim the kernels take
MAX_HEAD_DIM = 128
_NEG_INF = -1e30
_DTYPES = (torch.float32, torch.bfloat16)

WIDER = ("other dtypes and head dims over 128 wait for a wider kernel (ROADMAP § A, "
         "flash attention)")


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and the oracles the kernels are held to)
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
    """The forward kernel's function in plain torch -> ``(o (b, h, T, hd) of
    q's dtype, lse (b*h, T) f32)``."""
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


def _probs(q, k, lse, causal, scale, segment_ids):
    """``p = exp(s - lse)`` (b, h, T, T) f32, ``s`` recomputed as the
    forward computes it."""
    b, h, T, _ = q.shape
    s = masked_scores(q, k, causal, scale, segment_ids)
    return torch.exp(s - lse.reshape(b, h, T, 1))


def row_dot(o, do) -> torch.Tensor:
    """``D = rowsum(dO * O)``, (b*h, T) f32 from both operands widened (the
    reference's XLA reduction outside its kernels, ``:271-273``)."""
    b, h, T, _ = o.shape
    return (do.float() * o.float()).sum(-1).reshape(b * h, T)


def flash_attention_dq_plain(q, k, v, lse, do, dcap, causal: bool, scale: float,
                             segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The ``_dq_kernel``'s function: ``dq = ds~ k`` with ``ds = p (dO v^T -
    D) scale`` rounded to k's dtype; dq in q's dtype. ``dcap``: ``D``."""
    b, h, T, _ = q.shape
    p = _probs(q, k, lse, causal, scale, segment_ids)
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = p * (dp - dcap.reshape(b, h, T, 1)) * scale
    return torch.matmul(ds.to(k.dtype).float(), k.float()).to(q.dtype)


def flash_attention_dkv_plain(q, k, v, lse, do, dcap, causal: bool, scale: float,
                              segment_ids: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``_dkv_kernel``'s function: ``dv = p~^T dO`` (p rounded to dO's
    dtype) and ``dk = ds~^T q`` (ds rounded to q's dtype), in k's and v's
    dtypes."""
    b, h, T, _ = q.shape
    p = _probs(q, k, lse, causal, scale, segment_ids)
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = p * (dp - dcap.reshape(b, h, T, 1)) * scale
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal: bool, scale: float,
                              segment_ids: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' function in plain torch -> ``(dq, dk, dv)`` in
    q's, k's and v's dtypes (the reference's ``_bwd_impl``)."""
    dcap = row_dot(o, do)
    dq = flash_attention_dq_plain(q, k, v, lse, do, dcap, causal, scale, segment_ids)
    dk, dv = flash_attention_dkv_plain(q, k, v, lse, do, dcap, causal, scale, segment_ids)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------
_LIB = KernelLibrary("flash_attention", {"dl4j_flash_fwd": (6, 21, 1)},
                     "dl4j_flash_tile", tile_keys="mnd")
_BWD_LIB = KernelLibrary("flash_attention_bwd", {"dl4j_flash_bwd_dq": (8, 25, 1),
                                                 "dl4j_flash_bwd_dkv": (9, 28, 1)},
                         "dl4j_flash_bwd_tile", tile_keys="mnd")
#: query rows per block of the forward (T must be a multiple: the reference's
#: own rule), and the backward's T rule
_FWD_BLOCK = 128
_BWD_BLOCK = 64
_I32_MAX = 2 ** 31 - 1
#: TMA reads 16-byte aligned bases and strides (8 bf16)
_TMA_ALIGN = 16


def _strides(op: str, name: str, t: torch.Tensor) -> Tuple[int, int, int]:
    """(batch, head, time) element strides of a (b, h, T, hd) operand whose
    head dim is unit-stride; every offset must fit the kernel's int32."""
    shape, st = t.shape, t.stride()
    if st[3] != 1 and shape[3] > 1:
        raise ValueError(f"{op}: {name} needs a unit-stride head dim (strides "
                         f"{st}); use .contiguous()")
    span = ((shape[0] - 1) * abs(st[0]) + (shape[1] - 1) * abs(st[1])
            + (shape[2] - 1) * abs(st[2]) + (shape[3] - 1) * abs(st[3]))
    if span > _I32_MAX:
        raise ValueError(f"{op}: {name} spans {span} elements, over the kernel's "
                         "int32 offsets")
    return st[0], st[1], st[2]


def tma_ready(t: torch.Tensor) -> bool:
    """Whether the bf16 kernels' TMA loads can read a (b, h, T, hd) operand
    as it is: a 16-byte aligned base, a unit-stride head dim, and the batch,
    head and time strides of every dimension longer than 1 positive
    multiples of 16 bytes. A ragged hd (20) in a dense layout, a stride-0
    (expanded) or misaligned view is not."""
    shape, st = t.shape, t.stride()
    if t.data_ptr() % _TMA_ALIGN or (st[3] != 1 and shape[3] > 1):
        return False
    step = _TMA_ALIGN // t.element_size()
    for i in range(3):
        if shape[i] != 1 and (st[i] <= 0 or st[i] % step):
            return False
    return True


def padded_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` copied into a contiguous (b, h, T, hd8) buffer, hd8 = hd rounded
    up to a multiple of 8, zero past hd: the layout copy that lets the same
    kernel read an operand that is not :func:`tma_ready`."""
    b, h, T, hd = t.shape
    out = torch.zeros((b, h, T, -(-hd // 8) * 8), dtype=t.dtype, device=t.device)
    out[..., :hd].copy_(t)
    return out


def aligned_vector(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """lse, D or segment ids as the kernels' bulk copies read them: a
    16-byte aligned base (a copy if not)."""
    if t is None or t.data_ptr() % _TMA_ALIGN == 0:
        return t
    return t.clone()


def _check_operands(op: str, q, k, v, seg: Optional[torch.Tensor], extra=(),
                    block: int = _BWD_BLOCK) -> None:
    """What every flash kernel takes: f32 or bf16 q, k, v (and ``extra``
    tensors, (name, tensor) pairs) of one shape, dtype and device, T a
    positive multiple of ``block`` (128 in the forward, 64 in the backward),
    1 <= hd <= 128, b*h <= 65535, unit-stride head dims (int32 offsets),
    contiguous int32 (b, T) segment ids."""
    if q.dim() != 4:
        raise ValueError(f"{op}: q must be (b, h, T, hd), got {tuple(q.shape)}")
    b, h, T, hd = q.shape
    if q.dtype not in _DTYPES:
        raise TypeError(f"{op}: the kernel takes f32 or bf16, got {q.dtype}; {WIDER}")
    for name, t in (("k", k), ("v", v), *extra):
        if t.device != q.device:
            raise ValueError(f"{op}: {name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{op}: {name} must be {q.dtype}, got {t.dtype}")
        if tuple(t.shape) != tuple(q.shape):
            raise ValueError(f"{op}: {name} must have shape {tuple(q.shape)}, "
                             f"got {tuple(t.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v), *extra):
        _strides(op, name, t)
    if T == 0 or T % block or not 1 <= hd <= MAX_HEAD_DIM or b * h > 65535:
        raise ValueError(f"{op}: the kernel takes T a positive multiple of {block}, "
                         f"1 <= hd <= {MAX_HEAD_DIM} and b*h <= 65535, got "
                         f"{tuple(q.shape)}; {WIDER}")
    if seg is not None:
        if seg.device != q.device or seg.dtype != torch.int32 or \
                tuple(seg.shape) != (b, T) or not seg.is_contiguous():
            raise ValueError(f"{op}: segment ids must be a contiguous int32 (b, T)="
                             f"({b}, {T}) tensor on {q.device}, got {seg.dtype} "
                             f"{tuple(seg.shape)} on {seg.device}")


def _heads_buffer(q) -> torch.Tensor:
    """An empty (b, h, T, hd) view of a (b, T, h, hd) buffer of q's dtype."""
    b, h, T, hd = q.shape
    return q.new_empty_strided((b, h, T, hd), (T * h * hd, hd, h * hd, 1))


def _out_strides(t) -> Tuple[int, int, int]:
    return t.stride(0), t.stride(1), t.stride(2)


def _load(lib: KernelLibrary, op: str, block: int):
    handle = lib.get()
    if lib.tile["m"] != block:
        raise RuntimeError(f"{op}: the kernel's row block is {lib.tile['m']}, not {block}")
    return handle


def _kernel_operands(ts):
    """The operands as the kernel reads them -> (tensors, their (batch,
    head, time) strides flattened, their last dims). bf16: an operand that
    is not :func:`tma_ready` is replaced by its :func:`padded_operand`
    (:func:`_check_operands` has held every dtype to a unit-stride head
    dim)."""
    if ts[0].dtype == torch.bfloat16:
        ts = [t if tma_ready(t) else padded_operand(t) for t in ts]
    return ts, [x for t in ts for x in t.stride()[:3]], [t.shape[3] for t in ts]


def _kernel(q, k, v, causal: bool, scale: float, seg: Optional[torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    _check_operands(OP, q, k, v, seg, block=_FWD_BLOCK)
    b, h, T, hd = q.shape
    o = _heads_buffer(q)
    lse = q.new_empty((b * h, T), dtype=torch.float32)
    (q, k, v), strides, dims = _kernel_operands([q, k, v])
    seg = aligned_vector(seg)
    lib = _load(_LIB, OP, _FWD_BLOCK)
    with torch.cuda.device(q.device):
        launch(lib.dl4j_flash_fwd, OP,
               (*ptrs(q, k, v), 0 if seg is None else seg.data_ptr(), *ptrs(o, lse),
                b, h, T, hd, int(causal), int(q.dtype == torch.bfloat16), *strides,
                *_out_strides(o), *dims, float(scale)))
    return o, lse


def _bwd_args(op, q, k, v, lse, do, dcap, seg):
    """Checks of a backward kernel's operands -> dO with a unit-stride head
    dim. Autograd may hand over an expanded or strided gradient: the kernels
    read dO through its strides, so only a head dim that is not unit-stride
    is copied."""
    if do.dim() == 4 and do.stride(3) != 1 and do.shape[3] > 1:
        do = do.contiguous()
    _check_operands(op, q, k, v, seg, (("dO", do),))
    b, h, T, _ = q.shape
    for name, t in (("lse", lse), ("D", dcap)):
        if t.dtype != torch.float32 or tuple(t.shape) != (b * h, T) or \
                not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{op}: {name} must be a contiguous f32 (b*h, T)=({b * h}, {T}) "
                             f"tensor on {q.device}, got {t.dtype} {tuple(t.shape)}")
    return do


def flash_attention_dq(q, k, v, lse, do, dcap, causal: bool, scale: float,
                       segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dq (the reference's ``_dq_kernel``; ``dcap``: ``D``, (b*h, T) f32). A
    CPU ``q`` takes :func:`flash_attention_dq_plain`; a CUDA ``q`` the
    kernel, or it raises."""
    if q.device.type == "cpu":
        return flash_attention_dq_plain(q, k, v, lse, do, dcap, causal, scale, segment_ids)
    do = _bwd_args(OP_DQ, q, k, v, lse, do, dcap, segment_ids)
    b, h, T, hd = q.shape
    dq = _heads_buffer(q)
    (q, k, v, do), ins, dims = _kernel_operands([q, k, v, do])
    lse, dcap, seg = (aligned_vector(t) for t in (lse, dcap, segment_ids))
    lib = _load(_BWD_LIB, OP_DQ, _BWD_BLOCK)
    with torch.cuda.device(q.device):
        launch(lib.dl4j_flash_bwd_dq, OP_DQ,
               (*ptrs(q, k, v, do, lse, dcap), 0 if seg is None else seg.data_ptr(),
                dq.data_ptr(), b, h, T, hd, int(causal), int(q.dtype == torch.bfloat16), *ins,
                *_out_strides(dq), *dims, float(scale)))
    return dq


def flash_attention_dkv(q, k, v, lse, do, dcap, causal: bool, scale: float,
                        segment_ids: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) (the reference's ``_dkv_kernel``). A CPU ``q`` takes
    :func:`flash_attention_dkv_plain`; a CUDA ``q`` the kernel, or it
    raises."""
    if q.device.type == "cpu":
        return flash_attention_dkv_plain(q, k, v, lse, do, dcap, causal, scale, segment_ids)
    do = _bwd_args(OP_DKV, q, k, v, lse, do, dcap, segment_ids)
    b, h, T, hd = q.shape
    dk, dv = _heads_buffer(k), _heads_buffer(v)
    (q, k, v, do), ins, dims = _kernel_operands([q, k, v, do])
    lse, dcap, seg = (aligned_vector(t) for t in (lse, dcap, segment_ids))
    lib = _load(_BWD_LIB, OP_DKV, _BWD_BLOCK)
    with torch.cuda.device(q.device):
        launch(lib.dl4j_flash_bwd_dkv, OP_DKV,
               (*ptrs(q, k, v, do, lse, dcap), 0 if seg is None else seg.data_ptr(),
                *ptrs(dk, dv), b, h, T, hd, int(causal), int(q.dtype == torch.bfloat16), *ins,
                *_out_strides(dk), *_out_strides(dv), *dims, float(scale)))
    return dk, dv


def _forward(q, k, v, causal, scale, segment_ids):
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, scale, segment_ids)
    return _kernel(q, k, v, causal, scale, segment_ids)


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool, scale: float,
                        segment_ids: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` from the forward's ``o`` and ``lse`` and the gradient
    ``do`` of ``o`` (the reference's ``_bwd_impl``): ``D`` by
    :func:`row_dot`, then :func:`flash_attention_dq` and
    :func:`flash_attention_dkv` (the plain versions for a CPU ``q``; on
    CUDA the kernels, at the forward's limits, ``do`` of q's dtype and
    shape with any batch/head/time strides, or it raises)."""
    if tuple(o.shape) != tuple(q.shape) or tuple(do.shape) != tuple(q.shape):
        raise ValueError(f"{OP_DQ}: o and dO must have q's shape {tuple(q.shape)}, got "
                         f"{tuple(o.shape)} and {tuple(do.shape)}")
    dcap = row_dot(o, do).contiguous()
    dq = flash_attention_dq(q, k, v, lse, do, dcap, causal, scale, segment_ids)
    dk, dv = flash_attention_dkv(q, k, v, lse, do, dcap, causal, scale, segment_ids)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """The reference's custom VJP (``_flash``/``_flash_seg``): the forward
    kernel (the plain version on the CPU) saving ``q, k, v, o, lse`` and the
    segment ids; the backward kernels in the backward. ``lse`` and the
    segment ids get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, seg, causal, scale):
        o, lse = _forward(q, k, v, causal, scale, seg)
        ctx.save_for_backward(q, k, v, o, lse, seg)
        ctx.causal, ctx.scale = causal, scale
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse, seg = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, ctx.causal, ctx.scale, seg)
        return dq, dk, dv, None, None, None


def flash_attention_fwd(q, k, v, causal: bool, scale: float,
                        segment_ids: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse)``: the forward kernel's entry (the reference's
    ``_fwd_impl``). A CPU ``q`` takes the plain version; a CUDA ``q`` the
    kernel (f32 or bf16 q/k/v of one shape, ``T % 128 == 0``, ``hd <= 128``,
    int32 segment ids), or it raises. Where a gradient is recorded it runs
    through :class:`FlashAttention`, so ``o`` carries one."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, segment_ids, causal, scale)
    return _forward(q, k, v, causal, scale, segment_ids)


def flash_attention(q, k, v, *, causal: bool = False, sm_scale: Optional[float] = None,
                    segment_ids=None) -> torch.Tensor:
    """O(T)-memory attention. q, k, v: (b, h, T, head_dim) with equal q/kv
    lengths, T a multiple of 128 and <= MAX_SEQ_LEN. Differentiable (the
    backward kernels under :class:`FlashAttention`). ``segment_ids``: an
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
