"""Variational autoencoder pretrain layer and its reconstruction
distributions.

Counterpart of ``deeplearning4j_tpu/nn/conf/layers/variational.py``, with
the same ``@class`` names, fields and parameter names. The encoder MLP maps
x to the mean and log-variance of q(z|x); in a network the layer's output is
that mean. Pretraining minimizes -ELBO = KL(q(z|x) || N(0, I)) - E_q[log
p(x|z)], the expectation over ``num_samples`` reparameterized draws z = mean
+ exp(logvar / 2) * eps, each decoded by the decoder MLP into the
parameters of the reconstruction distribution p(x|z).

The draws come from a noise source (``nn/conf/dropouts.NoiseSource``; the
networks' ``pretrain_layer`` hands each step the layer's stream): eps of
sample ``s`` from its child stream ``s``, a distribution's sample from the
stream it is given (a composite's part ``i`` from child ``i``). A
``FedNoise`` hands out given draws instead, in the order they are asked
for. Without a source the methods draw from a fixed one (seed 0, position
0), as the reference falls back to a fixed key; the two draw different
numbers.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch

from deeplearning4j_tpu_torch import activations as _act
from deeplearning4j_tpu_torch import losses as _losses
from deeplearning4j_tpu_torch.nn.conf import serde
from deeplearning4j_tpu_torch.nn.conf.dropouts import NoiseSource
from deeplearning4j_tpu_torch.nn.conf.layers.base import FeedForwardLayer

_LOG2PI = math.log(2.0 * math.pi)


def _source(rng):
    """``rng``, or the fixed source of a call given none."""
    return NoiseSource(0, 0) if rng is None else rng


class ReconstructionDistribution:
    """p(x|z): the decoder emits ``params_per_feature`` parameters a feature."""

    params_per_feature = 1

    def log_probability(self, x, dist_params) -> torch.Tensor:
        """Per-example log p(x|z); dist_params (b, n_in*params_per_feature)."""
        raise NotImplementedError

    def mean(self, dist_params) -> torch.Tensor:
        raise NotImplementedError

    def sample(self, rng, dist_params) -> torch.Tensor:
        raise NotImplementedError

    def to_dict(self):
        return serde.generic_to_dict(self)

    @classmethod
    def from_dict(cls, d):
        return serde.generic_from_dict(serde.lookup(d.get("@class", cls.__name__)), d)


@serde.register
class BernoulliReconstructionDistribution(ReconstructionDistribution):
    """The decoder emits logits; the probability is ``activation`` of them
    (sigmoid: the log-likelihood computed stably from the logits)."""

    def __init__(self, activation: str = "sigmoid"):
        self.activation = activation

    def log_probability(self, x, dist_params):
        logits = dist_params
        if self.activation == "sigmoid":
            ll = (-torch.clamp(logits, min=0) + logits * x
                  - torch.log1p(torch.exp(-logits.abs())))
        else:
            p = torch.clamp(_act.get(self.activation)(logits), 1e-7, 1 - 1e-7)
            ll = x * torch.log(p) + (1 - x) * torch.log1p(-p)
        return ll.sum(dim=-1)

    def mean(self, dist_params):
        return _act.get(self.activation)(dist_params)

    def sample(self, rng, dist_params):
        p = self.mean(dist_params)
        return _source(rng).bernoulli(p, p.shape, p.device).to(p.dtype)


@serde.register
class GaussianReconstructionDistribution(ReconstructionDistribution):
    """The decoder emits [mean | log-variance], two parameters a feature;
    ``activation`` applies to the mean."""

    params_per_feature = 2

    def __init__(self, activation: str = "identity"):
        self.activation = activation

    def _split(self, dist_params):
        n = dist_params.shape[-1] // 2
        return _act.get(self.activation)(dist_params[..., :n]), dist_params[..., n:]

    def log_probability(self, x, dist_params):
        mean, log_var = self._split(dist_params)
        return (-0.5 * (_LOG2PI + log_var + (x - mean) ** 2 / torch.exp(log_var))).sum(dim=-1)

    def mean(self, dist_params):
        return self._split(dist_params)[0]

    def sample(self, rng, dist_params):
        mean, log_var = self._split(dist_params)
        eps = _source(rng).normal(mean.shape, mean.dtype, mean.device)
        return mean + torch.exp(0.5 * log_var) * eps


@serde.register
class ExponentialReconstructionDistribution(ReconstructionDistribution):
    """The decoder emits gamma = log(lambda) (``activation`` applied)."""

    def __init__(self, activation: str = "identity"):
        self.activation = activation

    def log_probability(self, x, dist_params):
        gamma = _act.get(self.activation)(dist_params)
        return (gamma - torch.exp(gamma) * x).sum(dim=-1)

    def mean(self, dist_params):
        return torch.exp(-_act.get(self.activation)(dist_params))

    def sample(self, rng, dist_params):
        lam = 1.0 / self.mean(dist_params)
        # uniform on [1e-7, 1): the reference's minval, so the log is finite
        u = _source(rng).uniform(dist_params.shape, dist_params.device).to(dist_params.dtype)
        u = torch.clamp(u * (1.0 - 1e-7) + 1e-7, min=1e-7)
        return -torch.log(u) / lam


@serde.register
class LossFunctionWrapper(ReconstructionDistribution):
    """A loss as -log p(x|z) (not a probability): its mean is ``activation``
    of the decoder's output, and so is its sample."""

    def __init__(self, loss: str = "mse", activation: str = "identity"):
        self.loss = loss
        self.activation = activation

    def log_probability(self, x, dist_params):
        return -_losses.get(self.loss)(x, dist_params, self.activation)

    def mean(self, dist_params):
        return _act.get(self.activation)(dist_params)

    def sample(self, rng, dist_params):
        return self.mean(dist_params)


@serde.register
class CompositeReconstructionDistribution(ReconstructionDistribution):
    """Distributions over consecutive feature ranges: ``parts`` is a list of
    (n_features, distribution)."""

    def __init__(self, parts: Optional[List] = None):
        self.parts = list(parts or [])

    def add(self, n_features: int, dist: ReconstructionDistribution):
        self.parts.append((int(n_features), dist))
        return self

    @property
    def params_per_feature(self):
        raise AttributeError("Composite: use total_params()")

    def total_params(self) -> int:
        return sum(n * d.params_per_feature for n, d in self.parts)

    def _slices(self):
        """(feature offset, n, param offset, params, distribution) a part."""
        x_off = p_off = 0
        for n, d in self.parts:
            n_p = n * d.params_per_feature
            yield x_off, n, p_off, n_p, d
            x_off += n
            p_off += n_p

    def log_probability(self, x, dist_params):
        total = 0.0
        for x_off, n, p_off, n_p, d in self._slices():
            total = total + d.log_probability(x[..., x_off:x_off + n],
                                              dist_params[..., p_off:p_off + n_p])
        return total

    def mean(self, dist_params):
        return torch.cat([d.mean(dist_params[..., p_off:p_off + n_p])
                          for _, _, p_off, n_p, d in self._slices()], dim=-1)

    def sample(self, rng, dist_params):
        rng = _source(rng)
        return torch.cat([d.sample(rng.child(i), dist_params[..., p_off:p_off + n_p])
                          for i, (_, _, p_off, n_p, d) in enumerate(self._slices())], dim=-1)

    def to_dict(self):
        return {"@class": "CompositeReconstructionDistribution",
                "parts": [[n, serde.encode(d)] for n, d in self.parts]}

    @classmethod
    def from_dict(cls, d):
        return cls([(n, serde.decode(e)) for n, e in d.get("parts", [])])


@serde.register
class VariationalAutoencoder(FeedForwardLayer):
    """Encoder MLP (``encoder_layer_sizes``, the layer's ``activation``) ->
    mean (``pzx_activation``) and log-variance of q(z|x), ``n_out`` latent
    units; decoder MLP (``decoder_layer_sizes``) -> the parameters of
    ``reconstruction_distribution``. In a network: the mean of q(z|x)."""

    is_pretrain_layer = True

    def __init__(self, encoder_layer_sizes: Sequence[int] = (100,),
                 decoder_layer_sizes: Sequence[int] = (100,),
                 reconstruction_distribution: Optional[ReconstructionDistribution] = None,
                 pzx_activation: str = "identity", num_samples: int = 1, **kwargs):
        super().__init__(**kwargs)
        self.encoder_layer_sizes = [int(s) for s in encoder_layer_sizes]
        self.decoder_layer_sizes = [int(s) for s in decoder_layer_sizes]
        self.reconstruction_distribution = (
            reconstruction_distribution if reconstruction_distribution is not None
            else GaussianReconstructionDistribution("identity"))
        self.pzx_activation = pzx_activation
        self.num_samples = int(num_samples)

    def _dist_param_count(self) -> int:
        d = self.reconstruction_distribution
        if isinstance(d, CompositeReconstructionDistribution):
            return d.total_params()
        return self.n_in * d.params_per_feature

    def init_params(self, gen, input_type, dtype=torch.float32):
        sizes_e = [self.n_in] + self.encoder_layer_sizes
        sizes_d = [self.n_out] + self.decoder_layer_sizes
        p = {}

        def dense(w, b, fi, fo):
            p[w] = self._draw_weight(gen, (fi, fo), fi, fo, dtype)
            p[b] = self._bias((fo,), dtype)

        for i in range(len(self.encoder_layer_sizes)):
            dense(f"eW{i}", f"eb{i}", sizes_e[i], sizes_e[i + 1])
        dense("pZXMeanW", "pZXMeanb", sizes_e[-1], self.n_out)
        dense("pZXLogStd2W", "pZXLogStd2b", sizes_e[-1], self.n_out)
        for i in range(len(self.decoder_layer_sizes)):
            dense(f"dW{i}", f"db{i}", sizes_d[i], sizes_d[i + 1])
        dense("pXZW", "pXZb", sizes_d[-1], self._dist_param_count())
        return p

    def encode_mean_logvar(self, params, x) -> Tuple[torch.Tensor, torch.Tensor]:
        """The mean and log-variance of q(z|x)."""
        act = self.act_fn()
        h = x
        for i in range(len(self.encoder_layer_sizes)):
            h = act(h @ params[f"eW{i}"] + params[f"eb{i}"])
        mean = _act.get(self.pzx_activation)(h @ params["pZXMeanW"] + params["pZXMeanb"])
        return mean, h @ params["pZXLogStd2W"] + params["pZXLogStd2b"]

    def decode(self, params, z) -> torch.Tensor:
        """z -> the parameters of p(x|z)."""
        act = self.act_fn()
        h = z
        for i in range(len(self.decoder_layer_sizes)):
            h = act(h @ params[f"dW{i}"] + params[f"db{i}"])
        return h @ params["pXZW"] + params["pXZb"]

    def apply(self, params, x, *, state=None, train=False, rng=None, mask=None):
        return self.encode_mean_logvar(params, x)[0], state or {}

    def _draws(self, params, x, num_samples, rng):
        """(mean, log_var, [(eps, z) a sample]): sample ``s``'s eps from the
        child stream ``s`` of ``rng``."""
        mean, log_var = self.encode_mean_logvar(params, x)
        rng = _source(rng)
        std = torch.exp(0.5 * log_var)
        out = []
        for s in range(num_samples):
            eps = rng.child(s).normal(mean.shape, mean.dtype, mean.device)
            out.append((eps, mean + std * eps))
        return mean, log_var, out

    def pretrain_loss(self, params, x, rng=None) -> torch.Tensor:
        """-ELBO, the batch mean: KL(q(z|x) || N(0, I)) less the mean over
        ``num_samples`` draws of log p(x|z)."""
        mean, log_var, draws = self._draws(params, x, self.num_samples, rng)
        kl = 0.5 * (torch.exp(log_var) + mean ** 2 - 1.0 - log_var).sum(dim=-1)
        recon = 0.0
        for _, z in draws:
            recon = recon + self.reconstruction_distribution.log_probability(
                x, self.decode(params, z))
        return (kl - recon / self.num_samples).mean()

    def reconstruct(self, params, x) -> torch.Tensor:
        """The mean of p(x|z) at z = the mean of q(z|x)."""
        mean, _ = self.encode_mean_logvar(params, torch.as_tensor(x))
        return self.reconstruction_distribution.mean(self.decode(params, mean))

    def reconstruction_log_probability(self, params, x, num_samples: int = 1,
                                       rng=None) -> torch.Tensor:
        """Each example's importance-sampled estimate of log p(x) over
        ``num_samples`` draws from q(z|x)."""
        x = torch.as_tensor(x)
        _, log_var, draws = self._draws(params, x, num_samples, rng)
        lls = []
        for eps, z in draws:
            log_pxz = self.reconstruction_distribution.log_probability(x, self.decode(params, z))
            log_pz = -0.5 * (z ** 2 + _LOG2PI).sum(dim=-1)
            log_qzx = -0.5 * (eps ** 2 + _LOG2PI + log_var).sum(dim=-1)
            lls.append(log_pxz + log_pz - log_qzx)
        return torch.logsumexp(torch.stack(lls), dim=0) - math.log(num_samples)

    def generate_at_mean_given_z(self, params, z) -> torch.Tensor:
        """The mean of p(x|z)."""
        return self.reconstruction_distribution.mean(self.decode(params, torch.as_tensor(z)))

    def generate_random_given_z(self, params, z, rng=None) -> torch.Tensor:
        """A sample of p(x|z), drawn from ``rng``."""
        return self.reconstruction_distribution.sample(rng, self.decode(params,
                                                                        torch.as_tensor(z)))

    def has_loss_function(self) -> bool:
        return isinstance(self.reconstruction_distribution, LossFunctionWrapper)
