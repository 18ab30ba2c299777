"""Vector quantisers (wav2vec 2.0 targets).

Counterpart of ``speechbrain_tpu/nnet/quantisers.py``
(``GumbelVectorQuantizer``).  The Gumbel noise comes from the caller's
``torch.Generator`` (the Brain's), or is handed in as its uniform draw.
"""

import torch

from .linear import Linear

__all__ = ["GumbelVectorQuantizer"]


class GumbelVectorQuantizer(torch.nn.Module):
    """Gumbel-softmax product quantiser: ``groups`` codebooks of
    ``num_vars`` entries of ``vq_dim / groups``, chosen from the logits of a
    ``Linear`` to ``groups x num_vars``.

    In training mode the codeword is the argmax of
    ``softmax((logits + g) / temp)`` with Gumbel noise ``g = -log(-log(u +
    1e-20) + 1e-20)`` (``u`` uniform on [0, 1)), passed straight through
    (the forward is the one-hot, the gradient the soft one's); in eval mode
    the argmax of the logits.  ``prob_perplexity`` is the perplexity of the
    noiseless softmax averaged over the frames, summed over the groups.
    ``temp`` defaults to ``temp_tuple[0]``: nothing anneals it (the JAX
    module neither).  The logits, the noise, the softmaxes and the codeword
    sums run in float32 (float64 on float64 inputs).

    ``codebook`` is (1, groups x num_vars, vq_dim / groups), as in JAX;
    ``weight_proj`` is the JAX ``Dense_0``.

    Example
    -------
    >>> vq = GumbelVectorQuantizer(16, num_vars=8, groups=2, vq_dim=16)
    >>> out = vq(torch.ones(2, 5, 16), generator=torch.Generator())
    >>> out["x"].shape, out["num_vars"]
    (torch.Size([2, 5, 16]), 16)
    """

    def __init__(self, input_dim, num_vars=320, temp_tuple=(2.0, 0.5, 0.999995),
                 groups=2, vq_dim=256):
        super().__init__()
        self.num_vars, self.groups = num_vars, groups
        self.temp_tuple = tuple(temp_tuple)
        self.var_dim = vq_dim // groups
        self.codebook = torch.nn.Parameter(
            torch.rand(1, groups * num_vars, self.var_dim))
        self.weight_proj = Linear(input_dim, groups * num_vars)

    def forward(self, x, temp=None, generator=None, uniform=None):
        """x (B, T, input_dim).  In training mode the noise's uniform draw
        is ``uniform`` ((B T groups, num_vars), in the logits' dtype) when
        given, else drawn from ``generator``.  Returns ``{"x": (B, T,
        vq_dim), "prob_perplexity", "num_vars", "temp"}``."""
        B, T, _ = x.shape
        G, V = self.groups, self.num_vars
        if temp is None:
            temp = self.temp_tuple[0]
        logits = self.weight_proj(x).reshape(B * T * G, V)
        if logits.dtype != torch.float64:
            logits = logits.float()
        if self.training:
            if uniform is None:
                uniform = torch.rand(logits.shape, generator=generator,
                                     device=x.device, dtype=logits.dtype)
            gumbels = -torch.log(-torch.log(uniform + 1e-20) + 1e-20)
            y_soft = torch.softmax((logits + gumbels) / temp, -1)
            y_hard = torch.nn.functional.one_hot(y_soft.argmax(-1), V)
            probs = (y_hard.to(y_soft.dtype) - y_soft).detach() + y_soft
        else:
            probs = torch.nn.functional.one_hot(logits.argmax(-1), V).to(
                logits.dtype)
        avg_probs = torch.softmax(logits.reshape(B * T, G, V), -1).mean(0)
        prob_perplexity = torch.exp(
            -(avg_probs * torch.log(avg_probs + 1e-7)).sum(-1)).sum()
        codebook = self.codebook.to(probs.dtype).reshape(G, V, self.var_dim)
        quantized = torch.einsum("ngv,gvd->ngd", probs.reshape(B * T, G, V),
                                 codebook)
        return {"x": quantized.reshape(B, T, G * self.var_dim),
                "prob_perplexity": prob_perplexity, "num_vars": G * V,
                "temp": temp}
