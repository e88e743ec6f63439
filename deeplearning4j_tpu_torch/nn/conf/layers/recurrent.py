"""Recurrent layers: the LSTM family, SimpleRnn, Bidirectional and the
sequence wrappers, and the per-timestep output heads.

Counterpart of ``deeplearning4j_tpu/nn/conf/layers/recurrent.py`` (the eval
forward, with masks and carries). Layout at the API is the reference's:
``(batch, time, size)``; gates packed [i, f, o, g] in ``Wx (nIn, 4 nOut)``,
``Wh (nOut, 4 nOut)``, ``b (4 nOut,)``; GravesLSTM adds the peepholes
``pI``/``pF``/``pO``; Bidirectional holds its two copies under
``"fwd"``/``"bwd"``.

- The time loop is a Python loop over :meth:`LSTM._step` (the reference's
  ``lax.scan``); T == 1, the generation engine's decode shape, is one direct
  step (:func:`_masked_scan`).
- Masks: at a masked step the carry is held with the reference's
  ``m*new + (1-m)*old`` and the output is zeroed.
- A tanh/sigmoid LSTM or GravesLSTM step goes through
  ``nn/ops/fused_lstm.py``: the plain cell for CPU tensors, the CUDA kernel
  for CUDA tensors. Other activations run the layer's own step.
- Matmuls promote as JAX does (:func:`fused_lstm._mm`): under
  ``compute_dtype`` a bf16 ``x`` meets f32 carries and computes in f32.
- The heads' ``compute_score`` is the per-example loss over every time
  step, the label mask broadcast over the outputs as ``mask[..., None]``.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from deeplearning4j_tpu_torch import activations as _act
from deeplearning4j_tpu_torch import losses as _losses
from deeplearning4j_tpu_torch.nn.conf import serde
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.layers.base import FeedForwardLayer, Layer, LayerWrapper
from deeplearning4j_tpu_torch.nn.conf.layers.core import _affine
from deeplearning4j_tpu_torch.nn.ops.fused_lstm import _mm

def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of a carry: a tensor or a tuple of tensors."""
    if isinstance(tree, (tuple, list)):
        return tuple(tree_map(fn, *leaves) for leaves in zip(tree, *rest))
    return fn(tree, *rest)


class BaseRecurrentLayer(FeedForwardLayer):
    is_recurrent = True

    def initialize(self, input_type: InputType) -> None:
        if input_type.kind != "recurrent":
            raise ValueError(f"{type(self).__name__} needs recurrent input, got {input_type}")
        if self.n_in is None:
            self.n_in = input_type.size

    def get_output_type(self, input_type):
        return InputType.recurrent(self.n_out, input_type.timesteps)

    def init_carry(self, batch: int, dtype=torch.float32, device="cpu") -> Any:
        raise NotImplementedError

    def apply_with_carry(self, params, x, carry, *, mask=None, train=False, rng=None):
        raise NotImplementedError

    def apply(self, params, x, *, state=None, train=False, rng=None, mask=None):
        carry = self.init_carry(x.shape[0], x.dtype, x.device)
        y, _ = self.apply_with_carry(params, x, carry, mask=mask, train=train, rng=rng)
        return y, state or {}


def _masked_scan(step_fn, carry0, x, mask):
    """The time loop with carry-hold and output-zero masking.

    ``x`` (b, T, d); ``mask`` (b, T) or None; ``step_fn(carry, x_t) ->
    (new_carry, y_t)``. Returns ``(ys (b, T, n), carry)``. T == 1 is one
    direct step, as in the reference."""
    def hold(new, old, m_t):
        return tree_map(lambda a, b: m_t * a + (1.0 - m_t) * b, new, old)

    if x.shape[1] == 1:
        new_carry, y_t = step_fn(carry0, x[:, 0].contiguous())
        if mask is not None:
            m_t = mask[:, 0][..., None]  # (b, 1)
            new_carry = hold(new_carry, carry0, m_t)
            y_t = y_t * m_t
        return y_t[:, None, :], new_carry

    carry, ys = carry0, []
    xt = x.transpose(0, 1).contiguous()  # time-major: each step's rows contiguous
    for t in range(x.shape[1]):
        new_carry, y_t = step_fn(carry, xt[t])
        if mask is not None:
            m_t = mask[:, t][..., None]
            new_carry = hold(new_carry, carry, m_t)
            y_t = y_t * m_t
        carry = new_carry
        ys.append(y_t)
    return torch.stack(ys, dim=1), carry


@serde.register
class LSTM(BaseRecurrentLayer):
    """Standard LSTM, no peepholes. Gates [i, f, o, g]; the forget block of
    ``b`` starts at ``forget_gate_bias_init``."""

    def __init__(self, forget_gate_bias_init: float = 1.0,
                 gate_activation: str = "sigmoid", **kwargs):
        super().__init__(**kwargs)
        self.forget_gate_bias_init = float(forget_gate_bias_init)
        self.gate_activation = gate_activation
        if self.activation is None:
            self.activation = "tanh"

    def inherit_defaults(self, defaults):
        act_was_unset = self.activation is None
        super().inherit_defaults(defaults)
        if act_was_unset:
            self.activation = "tanh"

    def init_params(self, gen, input_type, dtype=torch.float32):
        n_out = self.n_out
        b = torch.zeros((4 * n_out,), dtype=dtype)
        b[n_out:2 * n_out] = self.forget_gate_bias_init
        return {
            "Wx": self._draw_weight(gen, (self.n_in, 4 * n_out), self.n_in, n_out, dtype),
            "Wh": self._draw_weight(gen, (n_out, 4 * n_out), n_out, n_out, dtype),
            "b": b,
        }

    def init_carry(self, batch, dtype=torch.float32, device="cpu"):
        return (torch.zeros((batch, self.n_out), dtype=dtype, device=device),
                torch.zeros((batch, self.n_out), dtype=dtype, device=device))

    def _fused_cell(self):
        from deeplearning4j_tpu_torch.nn.ops import fused_lstm

        return fused_lstm.cell_for(self)

    def _step(self, params, carry, x_t):
        h, c = carry
        cell = self._fused_cell()
        if cell is not None:
            h_new, c_new = cell(x_t, h, c, params["Wx"], params["Wh"], params["b"])
            return (h_new, c_new), h_new
        act = _act.get(self.activation)
        gate = _act.get(self.gate_activation)
        z = _mm(x_t, params["Wx"]) + _mm(h, params["Wh"]) + params["b"]
        n = self.n_out
        i = gate(z[:, :n])
        f = gate(z[:, n:2 * n])
        o = gate(z[:, 2 * n:3 * n])
        g = act(z[:, 3 * n:])
        c_new = f * c + i * g
        h_new = o * act(c_new)
        return (h_new, c_new), h_new

    def apply_with_carry(self, params, x, carry, *, mask=None, train=False, rng=None):
        return _masked_scan(lambda c, xt: self._step(params, c, xt), carry, x, mask)


@serde.register
class GravesLSTM(LSTM):
    """LSTM with peephole connections: i and f see c_{t-1}, o sees c_t."""

    def init_params(self, gen, input_type, dtype=torch.float32):
        p = super().init_params(gen, input_type, dtype)
        for k in ("pI", "pF", "pO"):
            p[k] = torch.zeros((self.n_out,), dtype=dtype)
        return p

    def _step(self, params, carry, x_t):
        h, c = carry
        cell = self._fused_cell()
        if cell is not None:
            h_new, c_new = cell(x_t, h, c, params["Wx"], params["Wh"], params["b"],
                                params["pI"], params["pF"], params["pO"])
            return (h_new, c_new), h_new
        act = _act.get(self.activation)
        gate = _act.get(self.gate_activation)
        z = _mm(x_t, params["Wx"]) + _mm(h, params["Wh"]) + params["b"]
        n = self.n_out
        i = gate(z[:, :n] + params["pI"] * c)
        f = gate(z[:, n:2 * n] + params["pF"] * c)
        g = act(z[:, 3 * n:])
        c_new = f * c + i * g
        o = gate(z[:, 2 * n:3 * n] + params["pO"] * c_new)
        h_new = o * act(c_new)
        return (h_new, c_new), h_new


@serde.register
class SimpleRnn(BaseRecurrentLayer):
    """Elman RNN: h_t = act(x_t Wx + h_{t-1} Wh + b)."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        if self.activation is None:
            self.activation = "tanh"

    def inherit_defaults(self, defaults):
        act_was_unset = self.activation is None
        super().inherit_defaults(defaults)
        if act_was_unset:
            self.activation = "tanh"

    def init_params(self, gen, input_type, dtype=torch.float32):
        return {
            "Wx": self._draw_weight(gen, (self.n_in, self.n_out), self.n_in, self.n_out, dtype),
            "Wh": self._draw_weight(gen, (self.n_out, self.n_out), self.n_out, self.n_out,
                                    dtype),
            "b": self._bias((self.n_out,), dtype),
        }

    def init_carry(self, batch, dtype=torch.float32, device="cpu"):
        return torch.zeros((batch, self.n_out), dtype=dtype, device=device)

    def _step(self, params, carry, x_t):
        act = _act.get(self.activation)
        h_new = act(_mm(x_t, params["Wx"]) + _mm(carry, params["Wh"]) + params["b"])
        return h_new, h_new

    def apply_with_carry(self, params, x, carry, *, mask=None, train=False, rng=None):
        return _masked_scan(lambda c, xt: self._step(params, c, xt), carry, x, mask)


@serde.register
class Bidirectional(LayerWrapper):
    """Runs the wrapped recurrent layer forward and on the time-reversed
    sequence; modes concat | add | mul | ave."""

    is_recurrent = True

    def __init__(self, layer: Optional[BaseRecurrentLayer] = None, mode: str = "concat",
                 **kwargs):
        super().__init__(**kwargs)
        self.layer = layer
        self.mode = mode.lower()

    @property
    def n_out(self):
        return self.layer.n_out * (2 if self.mode == "concat" else 1)

    def get_output_type(self, input_type):
        inner = self.layer.get_output_type(input_type)
        size = inner.size * 2 if self.mode == "concat" else inner.size
        return InputType.recurrent(size, input_type.timesteps)

    def init_params(self, gen, input_type, dtype=torch.float32):
        return {"fwd": self.layer.init_params(gen, input_type, dtype),
                "bwd": self.layer.init_params(gen, input_type, dtype)}

    def apply(self, params, x, *, state=None, train=False, rng=None, mask=None):
        b = x.shape[0]
        carry_f = self.layer.init_carry(b, x.dtype, x.device)
        carry_b = self.layer.init_carry(b, x.dtype, x.device)
        y_f, _ = self.layer.apply_with_carry(params["fwd"], x, carry_f, mask=mask, train=train,
                                             rng=rng)
        mask_rev = None if mask is None else torch.flip(mask, dims=(1,))
        y_b, _ = self.layer.apply_with_carry(params["bwd"], torch.flip(x, dims=(1,)), carry_b,
                                             mask=mask_rev, train=train, rng=rng)
        y_b = torch.flip(y_b, dims=(1,))
        if self.mode == "concat":
            return torch.cat([y_f, y_b], dim=-1), state or {}
        if self.mode == "add":
            return y_f + y_b, state or {}
        if self.mode == "mul":
            return y_f * y_b, state or {}
        if self.mode in ("ave", "average"):
            return 0.5 * (y_f + y_b), state or {}
        raise ValueError(f"Unknown Bidirectional mode {self.mode}")


@serde.register
class GravesBidirectionalLSTM(Bidirectional):
    """The legacy configuration: Bidirectional(GravesLSTM, concat)."""

    def __init__(self, n_out: Optional[int] = None, n_in: Optional[int] = None,
                 activation: Optional[str] = None, **kwargs):
        inner = GravesLSTM(n_out=n_out, n_in=n_in, activation=activation)
        super().__init__(layer=inner, mode="concat", **kwargs)


@serde.register
class LastTimeStep(LayerWrapper):
    """Wraps a recurrent layer and emits its last (unmasked) step."""

    def __init__(self, layer: Optional[Layer] = None, **kwargs):
        super().__init__(**kwargs)
        self.layer = layer

    def get_output_type(self, input_type):
        return InputType.feed_forward(self.layer.get_output_type(input_type).size)

    def init_params(self, gen, input_type, dtype=torch.float32):
        return self.layer.init_params(gen, input_type, dtype)

    def apply(self, params, x, *, state=None, train=False, rng=None, mask=None):
        y, st = self.layer.apply(params, x, state=state, train=train, rng=rng, mask=mask)
        if mask is None:
            return y[:, -1, :], st
        # the last unmasked index of each example
        idx = torch.clamp(mask.sum(dim=1).to(torch.int64) - 1, min=0)
        return y[torch.arange(y.shape[0], device=y.device), idx, :], st


@serde.register
class MaskZeroLayer(LayerWrapper):
    """Sets the inputs of masked timesteps to ``masking_value`` before the
    wrapped layer."""

    def __init__(self, layer: Optional[Layer] = None, masking_value: float = 0.0, **kwargs):
        super().__init__(**kwargs)
        self.layer = layer
        self.masking_value = float(masking_value)

    def get_output_type(self, input_type):
        return self.layer.get_output_type(input_type)

    def init_params(self, gen, input_type, dtype=torch.float32):
        return self.layer.init_params(gen, input_type, dtype)

    def apply(self, params, x, *, state=None, train=False, rng=None, mask=None):
        if mask is not None:
            fill = torch.tensor(self.masking_value, dtype=x.dtype, device=x.device)
            x = torch.where(mask[..., None] > 0, x, fill)
        return self.layer.apply(params, x, state=state, train=train, rng=rng, mask=mask)


@serde.register
class RnnOutputLayer(FeedForwardLayer):
    """Per-timestep dense head: ``act(x W + b)``, zero at masked steps. The
    product goes through ``serving_matmul`` (int8 heads in int8 serving
    snapshots)."""

    is_output_layer = True

    def __init__(self, loss: str = "mcxent", **kwargs):
        super().__init__(**kwargs)
        self.loss = loss

    def get_output_type(self, input_type):
        return InputType.recurrent(self.n_out, input_type.timesteps)

    def init_params(self, gen, input_type, dtype=torch.float32):
        return {"W": self._draw_weight(gen, (self.n_in, self.n_out), self.n_in, self.n_out,
                                       dtype),
                "b": self._bias((self.n_out,), dtype)}

    def apply(self, params, x, *, state=None, train=False, rng=None, mask=None):
        y = self.act_fn()(_affine(params, x))
        if mask is not None:
            y = y * mask[..., None]
        return y, state or {}

    def compute_score(self, params, x, labels, mask=None):
        """Per-example loss of the (b, T, nOut) pre-activations; masked
        steps contribute nothing."""
        m = None if mask is None else mask[..., None]
        return _losses.get(self.loss)(labels, _affine(params, x), self.activation, m)


@serde.register
class RnnLossLayer(Layer):
    """Parameter-free per-timestep loss head: ``act(x)``, zero at masked
    steps."""

    is_output_layer = True

    def __init__(self, loss: str = "mcxent", activation: str = "identity", **kwargs):
        super().__init__(**kwargs)
        self.loss = loss
        self.activation = activation

    def apply(self, params, x, *, state=None, train=False, rng=None, mask=None):
        y = _act.get(self.activation)(x)
        if mask is not None:
            y = y * mask[..., None]
        return y, state or {}

    def compute_score(self, params, x, labels, mask=None):
        """Per-example loss of the input taken as the pre-activation."""
        m = None if mask is None else mask[..., None]
        return _losses.get(self.loss)(labels, x, self.activation, m)
