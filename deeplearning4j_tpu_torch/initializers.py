"""Weight initialization schemes, drawn from a ``torch.Generator``.

Counterpart of ``deeplearning4j_tpu/initializers.py``, with the same scheme
names, fan-in/fan-out semantics and :class:`Distribution` configs. The draws
differ from JAX's (threefry keys there, a seeded ``torch.Generator`` on the
CPU here), so weights move between the packages through
:mod:`deeplearning4j_tpu_torch.interop`, never by seed; the schemes agree in
their distributions (and exactly where they are deterministic: ``zero``,
``ones``, ``identity``, a constant distribution).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from deeplearning4j_tpu_torch.nn.conf.serde import TaggedConf


class Distribution(TaggedConf):
    """The reference's ``{"@type": "distribution", "kind": ..., ...}`` config
    for ``WeightInit.DISTRIBUTION``: normal (gaussian), uniform, constant,
    lognormal, truncated_normal (±2 std) and orthogonal."""

    def __init__(self, kind: str, **kwargs):
        super().__init__({"@type": "distribution", "kind": kind.lower(), **kwargs})

    @property
    def kind(self) -> str:
        return self["kind"]

    @property
    def kwargs(self) -> dict:
        return {k: v for k, v in self.items() if k not in ("@type", "kind")}

    def to_dict(self) -> dict:
        """The reference's ``to_dict``: ``kind`` and the parameters."""
        return {"kind": self.kind, **self.kwargs}

    @staticmethod
    def from_dict(d: dict) -> "Distribution":
        d = {k: v for k, v in d.items() if k != "@type"}
        return Distribution(d.pop("kind"), **d)

    def sample(self, gen: torch.Generator, shape: Sequence[int],
               dtype=torch.float32) -> torch.Tensor:
        k, p, shape = self.kind, self.kwargs, tuple(shape)
        if k in ("normal", "gaussian"):
            w = p.get("mean", 0.0) + p.get("std", 1.0) * _normal(gen, shape)
        elif k == "uniform":
            w = _uniform(gen, shape, p.get("lower", -1.0), p.get("upper", 1.0))
        elif k == "constant":
            w = torch.full(shape, p.get("value", 0.0), dtype=torch.float32)
        elif k == "lognormal":
            w = torch.exp(p.get("mean", 0.0) + p.get("std", 1.0) * _normal(gen, shape))
        elif k == "truncated_normal":
            w = p.get("mean", 0.0) + p.get("std", 1.0) * _truncated_normal(gen, shape)
        elif k == "orthogonal":
            w = _orthogonal(gen, shape, gain=p.get("gain", 1.0))
        else:
            raise ValueError(f"Unknown distribution kind '{k}'")
        return w.to(dtype)


def as_distribution(conf) -> Optional[Distribution]:
    """A ``distribution`` config as a :class:`Distribution` (a dict read
    from JSON becomes one; None stays None)."""
    if conf is None or isinstance(conf, Distribution):
        return conf
    d = Distribution.__new__(Distribution)
    dict.__init__(d, conf)
    return d


def _is_distribution(conf) -> bool:
    return isinstance(conf, dict) and conf.get("@type") == "distribution"


def _normal(gen, shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32)


def _uniform(gen, shape, lo: float, hi: float) -> torch.Tensor:
    return torch.rand(shape, generator=gen, dtype=torch.float32) * (hi - lo) + lo


def _truncated_normal(gen, shape, lo: float = -2.0, hi: float = 2.0) -> torch.Tensor:
    """N(0, 1) truncated to [lo, hi], by the inverse CDF (in f64)."""
    cdf = lambda x: 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))  # noqa: E731
    u = torch.rand(shape, generator=gen, dtype=torch.float64)
    p = cdf(lo) + u * (cdf(hi) - cdf(lo))
    x = math.sqrt(2.0) * torch.erfinv(2.0 * p - 1.0)
    return torch.clamp(x, lo, hi).to(torch.float32)


def _orthogonal(gen, shape, gain: float = 1.0) -> torch.Tensor:
    if len(shape) < 2:
        raise ValueError("orthogonal init needs >=2 dims")
    rows, cols = shape[0], int(math.prod(shape[1:]))
    n = max(rows, cols)
    q, r = torch.linalg.qr(_normal(gen, (n, n)))
    q = q * torch.sign(torch.diagonal(r))
    return gain * q[:rows, :cols].reshape(shape)


#: scheme -> (draw, scale from (fan_in, fan_out, shape)): a normal draw's
#: std, or a uniform draw's limit
_NORMAL, _UNIFORM = "normal", "uniform"
_SCHEMES = {
    "xavier": (_NORMAL, lambda fi, fo, s: math.sqrt(2.0 / (fi + fo))),
    "xavier_uniform": (_UNIFORM, lambda fi, fo, s: math.sqrt(6.0 / (fi + fo))),
    "xavier_fan_in": (_NORMAL, lambda fi, fo, s: math.sqrt(1.0 / fi)),
    "xavier_legacy": (_NORMAL, lambda fi, fo, s: math.sqrt(
        1.0 / (s[0] * s[1])) if len(s) >= 2 else math.sqrt(1.0 / s[0])),
    "relu": (_NORMAL, lambda fi, fo, s: math.sqrt(2.0 / fi)),
    "relu_uniform": (_UNIFORM, lambda fi, fo, s: math.sqrt(6.0 / fi)),
    "lecun_normal": (_NORMAL, lambda fi, fo, s: math.sqrt(1.0 / fi)),
    "lecun_uniform": (_UNIFORM, lambda fi, fo, s: math.sqrt(3.0 / fi)),
    "sigmoid_uniform": (_UNIFORM, lambda fi, fo, s: 4.0 * math.sqrt(6.0 / (fi + fo))),
    "uniform": (_UNIFORM, lambda fi, fo, s: 1.0 / math.sqrt(fi)),
    "normal": (_NORMAL, lambda fi, fo, s: 1.0 / math.sqrt(fi)),
    "var_scaling_normal_fan_in": (_NORMAL, lambda fi, fo, s: math.sqrt(1.0 / fi)),
    "var_scaling_normal_fan_out": (_NORMAL, lambda fi, fo, s: math.sqrt(1.0 / fo)),
    "var_scaling_normal_fan_avg": (_NORMAL, lambda fi, fo, s: math.sqrt(2.0 / (fi + fo))),
    "var_scaling_uniform_fan_in": (_UNIFORM, lambda fi, fo, s: math.sqrt(3.0 / fi)),
    "var_scaling_uniform_fan_out": (_UNIFORM, lambda fi, fo, s: math.sqrt(3.0 / fo)),
    "var_scaling_uniform_fan_avg": (_UNIFORM, lambda fi, fo, s: math.sqrt(6.0 / (fi + fo))),
}
#: the reference also takes each two-word scheme without its underscores
_ALIASES = {k.replace("_", ""): k for k in _SCHEMES if "_" in k}


def init_weights(gen: torch.Generator, shape: Sequence[int], fan_in: float,
                 fan_out: float, scheme="xavier", distribution=None,
                 dtype=torch.float32) -> torch.Tensor:
    """Draw a weight tensor on the CPU by the named scheme (the reference's
    ``WeightInitUtil.initWeights``): e.g. ``xavier`` N(0, 2/(fanIn+fanOut)),
    ``xavier_uniform`` U(±sqrt(6/(fanIn+fanOut))), ``relu`` N(0, 2/fanIn),
    ``lecun_uniform`` U(±sqrt(3/fanIn)), ``zero``/``ones``/``identity``,
    ``orthogonal``, ``distribution`` (draws from ``distribution``); a
    :class:`Distribution` (or its dict) as the scheme draws from itself."""
    shape = tuple(shape)
    if _is_distribution(scheme):
        return as_distribution(scheme).sample(gen, shape, dtype)
    s = str(scheme).lower()
    fan_in, fan_out = max(float(fan_in), 1.0), max(float(fan_out), 1.0)
    if s == "distribution":
        if distribution is None:
            raise ValueError("WeightInit 'distribution' requires a Distribution")
        return as_distribution(distribution).sample(gen, shape, dtype)
    if s == "zero":
        return torch.zeros(shape, dtype=dtype)
    if s == "ones":
        return torch.ones(shape, dtype=dtype)
    if s == "identity":
        if len(shape) == 2 and shape[0] == shape[1]:
            return torch.eye(shape[0], dtype=dtype)
        raise ValueError("identity init requires a square 2-d shape")
    if s == "orthogonal":
        return _orthogonal(gen, shape).to(dtype)
    s = _ALIASES.get(s, s)
    if s not in _SCHEMES:
        raise ValueError(f"Unknown weight init scheme '{scheme}'")
    draw, scale = _SCHEMES[s]
    a = scale(fan_in, fan_out, shape)
    if draw == _NORMAL:
        w = _normal(gen, shape).mul_(a)
    else:
        w = _uniform(gen, shape, -a, a)
    return w.to(dtype)
