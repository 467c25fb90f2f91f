"""LSTM primitives (JAX counterpart: ops/lstm.py): a unidirectional LSTM
over a sequence and its bidirectional pair.

The JAX package scans its own cell; here each direction is one
``nn.LSTM`` (one cuDNN call on the card).  The semantics are JAX's: the
gate order is i, f, g, o; both biases are kept (``b_ih`` and ``b_hh``, as
torch's layers keep them); h and c start at zero; and a reverse scan runs
from the last position to the first with each output at its own input
position, as ``lax.scan(reverse=True)`` places it.
"""

from __future__ import annotations

import torch
from torch import nn


def lstm_scan(x: torch.Tensor, lstm: nn.LSTM, reverse: bool = False) -> torch.Tensor:
    """Run a one-layer, unidirectional, batch-first ``lstm`` over x [B, T, I]
    -> hidden states [B, T, H]; with ``reverse`` from position T-1 down to 0,
    output t being the state after reading positions T-1..t."""
    if reverse:
        return lstm(x.flip(1))[0].flip(1)
    return lstm(x)[0]


def bilstm(x: torch.Tensor, fwd: nn.LSTM, bwd: nn.LSTM) -> torch.Tensor:
    """The forward and the reverse scan side by side: [B, T, 2H], the
    layout of ``nn.LSTM(bidirectional=True)``."""
    return torch.cat([lstm_scan(x, fwd), lstm_scan(x, bwd, reverse=True)], dim=-1)

