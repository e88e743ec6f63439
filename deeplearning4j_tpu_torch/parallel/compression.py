"""Threshold-encoded gradient compression: the message format of the
shared-training master.

Counterpart of ``deeplearning4j_tpu/parallel/compression.py`` (reference
``EncodingHandler.java:133-176``, ``EncodedGradientsAccumulator.java``):
elements with ``|g| >= threshold`` travel as (index, sign·threshold) pairs
in a message of fixed capacity (the largest magnitudes when more qualify);
what is not sent stays in a residual that joins the next round, so a
gradient is delayed, never dropped. Plain torch on the tensors' device, no
kernel: the reference is jitted XLA with no ``pallas_call``. Nothing here
syncs the host, except :class:`EncodingHandler`'s adaptation, which reads
the count as the reference's does, so a captured CUDA graph can hold an
encode and a decode.

The bits are the reference's:

- selection: ``jax.lax.top_k`` lists the slots by descending score and,
  among equal scores, ascending index. ``torch.topk`` leaves the order of
  ties open, so :func:`_top_k` sorts the scores stably and takes the first
  k;
- decode: every rank's message is scattered in rank order (indices are
  unique within a message), which is the order of the reference's
  ``.at[].add`` over the gathered (n, K) messages, so reruns agree bit for
  bit (``index_add_`` on CUDA adds with atomics, in no fixed order, where
  one call holds an index twice);
- the bitmap packs 16 two-bit codes to a 32-bit lane, as the reference's
  ``uint32`` lanes; the lanes are packed in int64 (torch lacks ``uint32``
  shifts on some versions) and stored as int32 with the same bits.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class EncodedUpdate(NamedTuple):
    """A fixed-size message: ``indices`` (K,) int32, -1 for an empty slot;
    ``values`` (K,) f32 (±threshold, 0 in an empty slot); ``count`` ()
    int32, the used slots."""

    indices: torch.Tensor
    values: torch.Tensor
    count: torch.Tensor


def _as_threshold(threshold, like: torch.Tensor) -> torch.Tensor:
    if isinstance(threshold, torch.Tensor):
        return threshold.to(device=like.device, dtype=torch.float32)
    return torch.full((), float(threshold), dtype=torch.float32, device=like.device)


def _top_k(score: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k(score, k)`` of a 1-D tensor: (values, indices int64),
    descending, ties by ascending index, which a stable descending sort
    keeps. On the H100 the whole sort takes less device time than
    ``torch.topk`` of unique int64 (score, index) keys, or than its k-th
    score with the ties filled by a cumsum (``scripts/torch_parallel_times.py
    --encoder``, PERF.md § 5)."""
    values, idx = torch.sort(score, descending=True, stable=True)
    return values[:k], idx[:k]


def threshold_encode(grad: torch.Tensor, threshold, capacity: int
                     ) -> Tuple[EncodedUpdate, torch.Tensor]:
    """Encode ``|g| >= threshold`` into a message of ``capacity`` slots;
    returns (message, residual). A sent element carries sign·threshold; the
    rest of it (its excess over the threshold) and every element not sent
    stay in the residual, of ``grad``'s shape."""
    flat = grad.reshape(-1)
    if not 0 < capacity <= flat.numel():
        raise ValueError(f"capacity {capacity} must be in [1, {flat.numel()}], the "
                         "gradient's size (the reference's top_k needs k <= n)")
    thr = _as_threshold(threshold, flat)
    mag = flat.abs()
    score = torch.where(mag >= thr, mag, torch.full_like(mag, -1.0))
    top_vals, top_idx = _top_k(score, int(capacity))
    valid = top_vals > 0
    send = torch.where(valid, torch.sign(flat[top_idx]) * thr,
                       torch.zeros((), dtype=torch.float32, device=flat.device))
    residual = flat.clone()
    residual.index_put_((top_idx,), flat[top_idx] - send)
    msg = EncodedUpdate(torch.where(valid, top_idx, -1).to(torch.int32),
                        send.to(torch.float32), valid.sum().to(torch.int32))
    return msg, residual.view(grad.shape)


def _scatter_add(out: torch.Tensor, msg_indices: torch.Tensor,
                 msg_values: torch.Tensor) -> None:
    """Add one message into ``out`` (n + 1,): empty slots go to the last
    element, which the caller drops. Indices are unique in a message."""
    n = out.numel() - 1
    idx = torch.where(msg_indices >= 0, msg_indices.to(torch.int64), n)
    out.index_add_(0, idx, msg_values.to(out.dtype))


def threshold_decode(msg: EncodedUpdate, size: int) -> torch.Tensor:
    """A message as a dense (size,) f32 vector."""
    out = torch.zeros(size + 1, dtype=torch.float32, device=msg.values.device)
    _scatter_add(out, msg.indices, msg.values)
    return out[:size]


def gather_and_decode(msg: EncodedUpdate, like: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's message (``mesh.all_gather``, one collective for the
    indices and one for the values), added into a dense tensor of
    ``like``'s shape in rank order: the same sum on every rank. A
    collective: every rank calls it."""
    idx = mesh.all_gather(msg.indices.reshape(1, -1))
    val = mesh.all_gather(msg.values.reshape(1, -1))
    out = torch.zeros(like.numel() + 1, dtype=torch.float32, device=like.device)
    for r in range(idx.shape[0]):
        _scatter_add(out, idx[r], val[r])
    return out[:-1].view(like.shape)


_SHIFTS = tuple(2 * j for j in range(16))


def bitmap_encode(grad: torch.Tensor, threshold) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dense form: a 2-bit code per element (0 skip, 1 +threshold, 2
    -threshold), 16 to a 32-bit lane. Returns (lanes (ceil(n/16),) int32
    holding the reference's uint32 bits, residual of ``grad``'s shape)."""
    flat = grad.reshape(-1)
    thr = _as_threshold(threshold, flat)
    code = torch.where(flat >= thr, 1, torch.where(flat <= -thr, 2, 0)).to(torch.int64)
    pad = (-code.numel()) % 16
    lanes = torch.cat([code, code.new_zeros(pad)]).view(-1, 16)
    shifts = torch.tensor(_SHIFTS, dtype=torch.int64, device=flat.device)
    packed = (lanes << shifts).sum(1)
    packed = torch.where(packed >= 2 ** 31, packed - 2 ** 32, packed).to(torch.int32)
    residual = flat - _decode_codes(code, thr)
    return packed, residual.view(grad.shape)


def _decode_codes(code: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros((), dtype=torch.float32, device=code.device)
    return torch.where(code == 1, thr, torch.where(code == 2, -thr, zero))


def bitmap_decode(packed: torch.Tensor, threshold, size: int) -> torch.Tensor:
    """Lanes of :func:`bitmap_encode` as a dense (size,) f32 vector."""
    thr = _as_threshold(threshold, packed)
    shifts = torch.tensor(_SHIFTS, dtype=torch.int64, device=packed.device)
    lanes = (packed.to(torch.int64) & 0xFFFFFFFF)[:, None] >> shifts[None, :]
    return _decode_codes((lanes & 0x3).reshape(-1)[:size], thr)


class EncodingHandler:
    """The residual and the adaptive threshold around the encoder (reference
    ``EncodingHandler`` + ``EncodedGradientsAccumulator``): one a trainer;
    :meth:`encode_update` returns the message to send and keeps the
    residual; the threshold moves by ``adapt_rate`` toward
    ``target_utilization`` of the capacity (up when the message is full,
    down when it is under the target)."""

    def __init__(self, size: int, threshold: float = 1e-3, capacity: int = 4096,
                 target_utilization: float = 0.75, adapt_rate: float = 1.2,
                 min_threshold: float = 1e-6, device=None):
        self.size = int(size)
        self.threshold = float(threshold)
        self.capacity = min(int(capacity), self.size)  # top-k needs k <= n
        self.target = float(target_utilization)
        self.adapt = float(adapt_rate)
        self.min_threshold = float(min_threshold)
        self.residual = torch.zeros(self.size, dtype=torch.float32, device=device)
        self.last_utilization = 0.0

    def encode_update(self, grad: torch.Tensor) -> EncodedUpdate:
        work = self.residual + grad.reshape(-1)
        msg, self.residual = threshold_encode(work, self.threshold, self.capacity)
        used = float(msg.count) / self.capacity
        self.last_utilization = used
        if used >= 0.999:
            self.threshold *= self.adapt
        elif used < self.target:
            self.threshold = max(self.threshold / self.adapt, self.min_threshold)
        return msg

    def apply_update(self, params_flat: torch.Tensor, msg: EncodedUpdate) -> torch.Tensor:
        return params_flat + threshold_decode(msg, self.size)


def make_compressed_allreduce(mesh, capacity: int = 4096):
    """The compressed exchange over the ranks of ``mesh``: each rank
    threshold-encodes its own gradient plus residual, the messages are
    gathered (8·capacity bytes a rank instead of 4·n) and every rank adds
    them all in rank order.

    Returns ``fn(grad, residual, threshold) -> (summed, new_residual)``:
    ``grad`` and ``residual`` are this rank's (size,) rows (the reference's
    function takes the (n_ranks, size) global arrays of one program);
    ``summed`` (size,), the same on every rank, is the sum of the sent
    updates (divide by the rank count for the mean). A collective."""
    def fn(grad, residual, threshold):
        work = residual + grad
        msg, new_residual = threshold_encode(work, threshold, min(capacity, work.numel()))
        return gather_and_decode(msg, work, mesh), new_residual

    return fn
