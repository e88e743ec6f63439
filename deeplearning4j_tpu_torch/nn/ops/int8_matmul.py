"""Int8 weight-only serving matmul with per-output-channel scales: a
hand-written CUDA kernel for Hopper beside its plain PyTorch version.

Counterpart of ``deeplearning4j_tpu/nn/ops/int8_matmul.py``::

    q[:, j] = clip(rint(W[:, j] / s_j), -127, 127),   s_j = max|W[:, j]| / 127
    y       = (x @ float(q)) * s        (the scale applied after the sum)

The quantizer runs once per serving snapshot on the host (numpy, the
reference's code, so ``q`` and ``s`` are bit-equal to JAX's). An
``InferenceEngine(int8_serving=True)`` rewrites the eligible layers' param
dicts from ``{"W"}`` to ``{"W_q8", "W_scale"}`` (:func:`quantize_model_params`);
the layers' forward goes through :func:`serving_matmul`, which takes the
int8 route when it finds those keys.

Dispatch: :func:`int8_matmul` takes the plain version
(:func:`int8_matmul_plain`) for a CPU tensor, and for a CUDA tensor launches
the kernel (``csrc/int8_matmul.cu``, which replaces the reference's
``_int8_kernel``) or raises: there is no fallback, and no probe. Each launch
adds one to ``launch_counts["int8_matmul"]`` (``launch.py``).

The kernel keeps f32 exact on the tensor cores: an f32 ``x`` is split into
three bf16 planes (:func:`x_planes_plain` is the split's plain version, which
the kernel's pre-pass mirrors), each product of a plane and ``q`` is exact
in f32, and the three passes are summed in f32. The host side here plans
the depth split (:func:`int8_split`) and how ``q`` reaches the kernel's
stages (:func:`q_route`).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.ops.launch import (
    KernelLibrary,
    check_kernel_args,
    launch,
    ptrs,
    sm_count,
)

#: params-dict key suffixes of a quantized weight (serving snapshots only)
Q_SUFFIX = "_q8"
SCALE_SUFFIX = "_scale"

OP = "int8_matmul"


# ---------------------------------------------------------------------------
# quantization (host side, once per serving snapshot)
# ---------------------------------------------------------------------------
def quantize_int8(w) -> Tuple[np.ndarray, np.ndarray]:
    """(K, N) float weights -> (int8 (K, N), f32 per-output-channel scale
    (N,)). Symmetric round-to-nearest (half to even, ``np.rint``); an
    all-zero channel gets a tiny scale so it dequantizes to exact zeros."""
    if isinstance(w, torch.Tensor):
        w = w.detach().float().cpu().numpy()
    w = np.asarray(w, np.float32)
    amax = np.max(np.abs(w), axis=0)
    scale = np.maximum(amax / 127.0, 1e-12).astype(np.float32)
    q = np.clip(np.rint(w / scale), -127, 127).astype(np.int8)
    return q, scale


# ---------------------------------------------------------------------------
# plain version (the CPU path, and the oracle the kernel is held to)
# ---------------------------------------------------------------------------
def int8_matmul_plain(x: torch.Tensor, q: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """The reference's ``int8_matmul_reference``: ``(x @ q.to(x.dtype)) *
    scale.to(x.dtype)``, in ``x.dtype`` (TF32 is off package-wide)."""
    return (x @ q.to(x.dtype)) * scale.to(x.dtype)


def x_planes_plain(x: torch.Tensor) -> torch.Tensor:
    """The bf16 planes the kernel multiplies ``q`` by, ``(P, B, K)``: for
    an f32 ``x`` (P = 3) hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi
    - mid), each rounded to nearest (the subtractions are exact in f32, and
    hi + mid + lo is x within 2^-24 |x|); a bf16 ``x`` is its own plane.
    The kernel's pre-pass computes the same bits (``csrc/int8_matmul.cu``
    ``int8_planes_kernel``); this version serves the tests."""
    if x.dtype == torch.bfloat16:
        return x.unsqueeze(0)
    x = x.to(torch.float32)
    hi = x.to(torch.bfloat16)
    r1 = x - hi.float()
    mid = r1.to(torch.bfloat16)
    lo = (r1 - mid.float()).to(torch.bfloat16)
    return torch.stack([hi, mid, lo])


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------
_LIB = KernelLibrary("int8_matmul", {"dl4j_int8_matmul": (6, 7)},
                     "dl4j_int8_matmul_tile", tile_keys="rnk")

_X_DTYPES = (torch.float32, torch.bfloat16)

#: the depth split: at least MIN_STAGES stages a chunk (one per consumer
#: warpgroup of a block), unless K is shallower
MIN_STAGES = 2

#: how the kernel's producer brings q into a stage
ROUTE_TMA, ROUTE_WORDS, ROUTE_BYTES = 0, 1, 2


def int8_split(k: int, n: int, sms: int, cols: int, depth: int) -> Tuple[int, int]:
    """``(chunk, splits)``: the kernel splits the depth ``k`` into ``splits``
    chunks of ``chunk`` (whole stages of ``depth``, at least ``MIN_STAGES``
    of them unless ``k`` is shallower), one grid row each, so that the
    column tiles of ``cols`` times the chunks make about one wave of blocks
    (one block per SM) and never more. It depends on ``k``, ``n`` and the SM
    count only, never on the rows: a row's summation order is the same in
    every batch bucket."""
    col_tiles = -(-n // cols)
    stages = -(-k // depth)
    splits = max(1, min(-(-stages // MIN_STAGES), sms // col_tiles))
    chunk = -(-stages // splits) * depth
    return chunk, -(-k // chunk)


def q_route(n: int, address: int) -> int:
    """How ``q`` (``n`` columns, first byte at ``address``) reaches the
    kernel's stages: by TMA when its rows start on 16-byte boundaries
    (``ROUTE_TMA``), else by 4-byte ``cp.async`` when they start on 4-byte
    ones (``ROUTE_WORDS``), else byte by byte (``ROUTE_BYTES``)."""
    if n % 16 == 0 and address % 16 == 0:
        return ROUTE_TMA
    if n % 4 == 0 and address % 4 == 0:
        return ROUTE_WORDS
    return ROUTE_BYTES


def _kernel(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    if x.dim() != 2 or q.dim() != 2:
        raise ValueError(f"{OP}: x must be (B, K) and q (K, N), got "
                         f"{tuple(x.shape)} and {tuple(q.shape)}")
    if x.dtype not in _X_DTYPES:
        raise TypeError(f"{OP}: the kernel takes f32 or bf16 x, got {x.dtype}")
    b, k = x.shape
    n = q.shape[1]
    if not scale.is_floating_point():
        raise TypeError(f"{OP}: scale must be a float tensor, got {scale.dtype}")
    # the kernel applies the scale in f32: a bf16 scale widens exactly
    scale32 = scale.to(torch.float32).contiguous()
    check_kernel_args(OP, x, (("x", x, x.dtype, (b, k)),
                              ("q", q, torch.int8, (k, n)),
                              ("scale", scale32, torch.float32, (n,))))
    if b == 0 or n == 0:
        return torch.empty((b, n), dtype=x.dtype, device=x.device)
    if k == 0:
        return torch.zeros((b, n), dtype=x.dtype, device=x.device)
    lib = _LIB.get()
    chunk, splits = int8_split(k, n, sm_count(x.device.index or 0), _LIB.tile["n"],
                               _LIB.tile["k"])
    bf16 = x.dtype == torch.bfloat16
    with torch.cuda.device(x.device):
        planes = torch.empty((1 if bf16 else 3, b, -(-k // 8) * 8), dtype=torch.bfloat16,
                             device=x.device)
        partial = torch.empty((splits, b, n), dtype=torch.float32, device=x.device)
        y = torch.empty((b, n), dtype=x.dtype, device=x.device)
        launch(lib.dl4j_int8_matmul, OP,
               (*ptrs(x, q, scale32, planes, partial, y), b, k, n, chunk, splits, int(bf16),
                q_route(n, q.data_ptr())))
    return y


def int8_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``x (B, K) · q (K, N)`` int8 with per-channel ``scale (N,)``, in
    ``x.dtype``. Serving only (no gradient: quantized weights are never
    trained through). A CPU ``x`` takes the plain version; a CUDA ``x``
    the kernel (f32 or bf16 ``x``, contiguous), or it raises."""
    if x.device.type == "cpu":
        return int8_matmul_plain(x, q, scale)
    return _kernel(x, q, scale)


def serving_matmul(params: Dict[str, torch.Tensor], x: torch.Tensor,
                   name: str = "W") -> torch.Tensor:
    """``x @ params[name]``, or the int8 route when ``params`` carries the
    quantized form (``{name}_q8``/``{name}_scale``). The f32 route promotes
    as JAX does (a bf16 ``x`` against f32 params computes in f32). Takes
    rank-2 ``(B, K)`` and rank-3 ``(B, T, K)`` activations (per-timestep
    heads)."""
    q = params.get(name + Q_SUFFIX)
    if q is None:
        w = params[name]
        dt = torch.promote_types(x.dtype, w.dtype)
        return x.to(dt) @ w.to(dt)
    scale = params[name + SCALE_SUFFIX]
    if x.dim() == 2:
        return int8_matmul(x, q, scale)
    lead = tuple(x.shape[:-1])
    y = int8_matmul(x.reshape(-1, x.shape[-1]).contiguous(), q, scale)
    return y.reshape(lead + (q.shape[1],))


# ---------------------------------------------------------------------------
# model-level quantization (engine snapshot build)
# ---------------------------------------------------------------------------
def quantizable_layer(layer) -> bool:
    """Layers whose ``W`` routes through :func:`serving_matmul`: the dense
    and output heads, the per-timestep ``RnnOutputLayer`` included. The
    recurrent gate matrices stay float (the fused LSTM cell owns them)."""
    from deeplearning4j_tpu_torch.nn.conf.layers.core import (
        BaseOutputLayer,
        DenseLayer,
    )
    from deeplearning4j_tpu_torch.nn.conf.layers.recurrent import RnnOutputLayer

    return isinstance(layer, (DenseLayer, BaseOutputLayer, RnnOutputLayer))


def quantize_layer_params(params: Dict[str, torch.Tensor],
                          name: str = "W") -> Dict[str, torch.Tensor]:
    """One layer's param dict with ``name`` replaced by its quantized form
    (on the weight's device). The same dict when it is absent or not 2-D."""
    w = params.get(name)
    if w is None or w.dim() != 2:
        return params
    q, s = quantize_int8(w)
    out = {k: v for k, v in params.items() if k != name}
    out[name + Q_SUFFIX] = torch.from_numpy(q).to(w.device)
    out[name + SCALE_SUFFIX] = torch.from_numpy(s).to(w.device)
    return out


def quantize_model_params(model) -> Tuple[List[Dict[str, torch.Tensor]], dict]:
    """A copy of ``model.params_`` (a MultiLayerNetwork's list of dicts)
    with every eligible layer's ``W`` quantized, and the reference's byte
    report. The model itself is untouched: a serving-snapshot transform,
    not a training mutation."""
    new_params = []
    fp32_bytes = int8_bytes = n_q = 0
    for layer, p in zip(model.layers, model.params_):
        if quantizable_layer(layer) and "W" in p:
            w = p["W"]
            qp = quantize_layer_params(p)
            if "W" + Q_SUFFIX in qp:
                n_q += 1
                fp32_bytes += w.numel() * w.element_size()
                int8_bytes += w.numel() + w.shape[1] * 4
                new_params.append(qp)
                continue
        new_params.append(p)
    return new_params, {
        "layers_quantized": n_q,
        "weight_bytes_fp32": fp32_bytes,
        "weight_bytes_int8": int8_bytes,
        "bytes_saved": fp32_bytes - int8_bytes,
    }
