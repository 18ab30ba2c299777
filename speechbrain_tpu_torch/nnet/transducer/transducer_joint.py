"""Transducer joint network (sum and concat joiners).

Counterpart of ``speechbrain_tpu/nnet/transducer/transducer_joint.py``
(``Transducer_joint``): encoder frames (B, T, H1) and prediction-network
states (B, U, H2) are joined over the lattice into (B, T, U, H) and put
through tanh, relu or leaky_relu; ``concat`` adds a Linear to
``joint_dim`` (the Flax ``Dense_0``; ``input_size`` = H1 + H2 here,
since torch layers are not lazily sized).
"""

import torch
import torch.nn.functional as F

from ..linear import Linear

__all__ = ["Transducer_joint"]

_ACTIVATIONS = {"tanh": torch.tanh, "relu": F.relu, "leaky_relu": F.leaky_relu}


class Transducer_joint(torch.nn.Module):
    """Join encoder and prediction-network states.

    ``joint="sum"``: broadcast add (the widths must match); ``"concat"``:
    concatenate, then Linear(``input_size`` -> ``joint_dim``).  Inputs of
    3 dims are broadcast over the lattice; 4-dim ones are taken as they
    are (B, T, 1, H) and (B, 1, U, H).  A bfloat16 and a float32 input
    promote to float32, as in JAX.

    Example
    -------
    >>> joiner = Transducer_joint("concat", joint_dim=8, input_size=10)
    >>> joiner(torch.ones(2, 5, 4), torch.ones(2, 3, 6)).shape
    torch.Size([2, 5, 3, 8])
    >>> Transducer_joint()(torch.ones(1, 2, 4), torch.ones(1, 3, 4)).shape
    torch.Size([1, 2, 3, 4])
    """

    def __init__(self, joint="sum", joint_dim=512, nonlinearity="tanh",
                 input_size=None):
        super().__init__()
        if joint not in ("sum", "concat"):
            raise ValueError(f"Unknown joint {joint}")
        if nonlinearity not in _ACTIVATIONS:
            raise ValueError(f"Unknown nonlinearity {nonlinearity}")
        self.joint = joint
        self.nonlinearity = nonlinearity
        if joint == "concat":
            if input_size is None:
                raise ValueError("the concat joiner needs input_size")
            self.linear = Linear(input_size, joint_dim)

    def forward(self, input_TN, input_PN):
        """input_TN: encoder (B, T, H1); input_PN: predictions (B, U, H2)."""
        act = _ACTIVATIONS[self.nonlinearity]
        if input_TN.dim() == 3 and input_PN.dim() == 3:
            enc, pred = input_TN[:, :, None, :], input_PN[:, None, :, :]
        else:
            enc, pred = input_TN, input_PN
        if self.joint == "sum":
            if enc.shape[-1] != pred.shape[-1]:
                raise ValueError("sum joiner needs matching feature dims")
            return act(enc + pred)
        T, U = enc.shape[1], pred.shape[2]
        dtype = torch.promote_types(enc.dtype, pred.dtype)
        joined = torch.cat([
            enc.expand(-1, -1, U, -1).to(dtype),
            pred.expand(-1, T, -1, -1).to(dtype),
        ], -1)
        return act(self.linear(joined))
