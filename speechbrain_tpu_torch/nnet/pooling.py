"""Statistics pooling over time.

Counterpart of ``speechbrain_tpu/nnet/pooling.py`` (``StatisticsPooling``,
the x-vector's pooling, with both of its statistics).  The CRDNN inlines its max pooling, as the JAX
module does; ``Pooling1d``, ``Pooling2d`` and the other pools are not
ported.
"""

import torch

__all__ = ["StatisticsPooling"]


class StatisticsPooling(torch.nn.Module):
    """(B, T, C) -> (B, 1, 2C): the mean and the std over each row's
    first ``n = round(lengths * T)`` frames (half to even, as
    ``jnp.round``; all T without lengths), concatenated.

    The std is Bessel-corrected, ``sqrt(max(ss, 1e-20) / max(n - 1,
    1))`` (the floor keeps the gradient finite on a constant row, such
    as a padded batch's dummy row), and ``eps`` is added to it.  With a
    ``generator``, the mean gets the JAX module's noise: a normal draw
    min-max normalized over the batch, scaled into [eps, 9 eps]
    (``add_noise``).

    Example
    -------
    >>> StatisticsPooling()(torch.ones(2, 10, 4)).shape
    torch.Size([2, 1, 8])
    >>> x = torch.tensor([[[1.0], [3.0], [100.0]]])
    >>> StatisticsPooling(eps=0.0)(x, torch.tensor([0.6])).tolist()
    [[[2.0, 1.4142135381698608]]]
    """

    def __init__(self, eps=1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x, lengths=None, generator=None):
        """x (B, T, C), lengths (B,) relative or None."""
        tiny = 1e-20
        if lengths is None:
            mean = x.mean(1)
            var = ((x - mean[:, None, :]) ** 2).sum(1) / max(x.shape[1] - 1, 1)
            std = torch.sqrt(var.clamp(min=tiny))
        else:
            T = x.shape[1]
            n = torch.round(lengths.to(x.dtype) * T)
            mask = (torch.arange(T, device=x.device)[None, :]
                    < n[:, None]).to(x.dtype)[..., None]
            mean = (x * mask).sum(1) / n.clamp(min=1.0)[:, None]
            ss = ((x - mean[:, None, :]) ** 2 * mask).sum(1)
            std = torch.sqrt(ss.clamp(min=tiny)
                             / (n - 1.0).clamp(min=1.0)[:, None])
        if generator is not None:
            mean = self.add_noise(mean, torch.randn(
                mean.shape, generator=generator, device=mean.device,
                dtype=mean.dtype))
        return torch.cat([mean, std + self.eps], -1)[:, None, :]

    def add_noise(self, mean, gnoise):
        """``mean`` plus the normal draw ``gnoise`` (its shape) min-max
        normalized over all of it and mapped to [eps, 9 eps]."""
        g = gnoise - gnoise.min()
        g = g / g.max().clamp(min=1e-20)
        return mean + self.eps * ((1 - 9) * g + 9)
