"""The recurrent U-Net bottleneck of SuperSloMo-R: a bidirectional ConvLSTM /
ConvGRU over the window sequence, NCHW.

The same function as the JAX package's ``models/bottleneck.py``: two
independent ``num_layers``-deep stacks, one over the windows in order
(``forward_net``) and one in reverse (``reverse_net``); layer L of a direction
consumes that direction's layer L-1 outputs. The reverse stack emits each
output at its window's position, and its final state is the one after window
0. Under ``merge="concat"`` each direction has ``hidden // 2`` channels and
the outputs are concatenated (forward first); under ``"sum"`` each has
``hidden`` and they are added.

The state of a stack's layer is named ``{fwd,rev}_l{L}``: ``(h, c)`` for the
LSTM, ``(h,)`` for the GRU, each (B, hidden per direction, h, w). With no
state given it starts at zeros in the input's dtype (the compute dtype); a
given state starts both stacks, the reverse one too, as in the JAX package.

The time loop is a Python loop over the windows. The gate convolutions are
``layers.Conv2d`` (cuDNN on the card) and the cells' pointwise math is plain
PyTorch: the JAX package computes both with XLA, outside any Pallas kernel.
A cell's convs compute in its input's dtype (the compute dtype), whatever
the dtype of its parameters (float32 master weights in bf16 training): a
flax ``Conv(dtype=...)`` casts its input and kernel so.
Submodule names are those the JAX package's checkpoint converter reads:
``{forward,reverse}_net.cell_list.{L}.conv`` (the gates) and, for the GRU,
``.conv_can`` (the candidate).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from superslomo_tpu_torch.config import cell_gate_order
from superslomo_tpu_torch.models.layers import Conv2d

Carry = Tuple[torch.Tensor, ...]


def _conv(in_channels: int, out_channels: int, kernel: int) -> Conv2d:
    return Conv2d(in_channels, out_channels, kernel, padding=kernel // 2, bias=True)


class ConvLSTMCell(nn.Module):
    """Peephole-free ConvLSTM cell. One ``kernel``x``kernel`` conv on
    ``cat([x, h])`` gives 4 blocks of ``hidden`` channels, in the order
    ``gate_order`` names (a permutation of "ifog": input, forget, output,
    candidate); ``c = f*c + i*g``, ``h = o*tanh(c)``. The conv computes in
    ``x``'s dtype."""

    def __init__(self, in_channels: int, hidden: int, kernel: int = 3, gate_order: str = "ifog"):
        super().__init__()
        self.hidden = hidden
        self.gate_order = cell_gate_order("CLSTM", gate_order)
        self.conv = _conv(in_channels + hidden, 4 * hidden, kernel)

    def zero_carry(self, x: torch.Tensor) -> Carry:
        h = x.new_zeros((x.shape[0], self.hidden) + tuple(x.shape[2:]))
        return h, torch.zeros_like(h)

    def forward(self, x: torch.Tensor, carry: Carry) -> Tuple[Carry, torch.Tensor]:
        h, c = carry
        z = self.conv(torch.cat([x, h.to(x.dtype)], dim=1))
        gates = dict(zip(self.gate_order, z.chunk(4, dim=1)))
        i, f, o = (torch.sigmoid(gates[k]) for k in "ifo")
        g = torch.tanh(gates["g"])
        c = f * c + i * g
        h = o * torch.tanh(c)
        return (h, c), h


class ConvGRUCell(nn.Module):
    """ConvGRU cell. A ``gates`` conv on ``cat([x, h])`` gives the update z
    and reset r blocks in ``gate_order`` ("zr" or "rz"; "ifog" means "zr",
    ``config.cell_gate_order``); a ``candidate`` conv
    on ``cat([x, r*h])`` gives n = tanh(...); ``h = (1-z)*h + z*n``. Both
    convs compute in ``x``'s dtype."""

    def __init__(self, in_channels: int, hidden: int, kernel: int = 3, gate_order: str = "zr"):
        super().__init__()
        self.hidden = hidden
        self.gate_order = cell_gate_order("CGRU", gate_order)
        self.conv = _conv(in_channels + hidden, 2 * hidden, kernel)
        self.conv_can = _conv(in_channels + hidden, hidden, kernel)

    def zero_carry(self, x: torch.Tensor) -> Carry:
        return (x.new_zeros((x.shape[0], self.hidden) + tuple(x.shape[2:])),)

    def forward(self, x: torch.Tensor, carry: Carry) -> Tuple[Carry, torch.Tensor]:
        (h,) = carry
        blocks = dict(zip(self.gate_order, self.conv(torch.cat([x, h.to(x.dtype)], dim=1)).chunk(2, dim=1)))
        z, r = torch.sigmoid(blocks["z"]), torch.sigmoid(blocks["r"])
        n = torch.tanh(self.conv_can(torch.cat([x, (r * h).to(x.dtype)], dim=1)))
        h = (1.0 - z) * h + z * n
        return (h,), h


class _Stack(nn.Module):
    """``num_layers`` cells of one direction (``cell_list``)."""

    def __init__(self, cells):
        super().__init__()
        self.cell_list = nn.ModuleList(cells)


class BiConvRNN(nn.Module):
    """Bidirectional multi-layer ConvLSTM / ConvGRU over a window sequence.

    ``forward(x (B, T, C, h, w), carry_in=None)`` returns ``(out (B, T,
    hidden, h, w), carry)``, ``carry`` a dict ``{fwd,rev}_l{L}`` → the
    layer's state after its last window.

    :param cell: "CLSTM" or "CGRU".
    :param merge: "concat" (``hidden // 2`` a direction, concatenated) or
        "sum" (``hidden`` a direction, added), in any case.
    :param gate_order: ``[TPU] CLSTM_GATE_ORDER`` in any case; each cell
        reads it through ``config.cell_gate_order``.
    """

    def __init__(self, in_channels: int, hidden: int, num_layers: int = 2, cell: str = "CLSTM",
                 merge: str = "concat", gate_order: str = "ifog", kernel: int = 3):
        super().__init__()
        merge = merge.lower()
        if merge not in ("concat", "sum"):
            raise ValueError(f"merge must be 'concat' or 'sum', got {merge!r}")
        cells = {"CLSTM": ConvLSTMCell, "CGRU": ConvGRUCell}
        if cell not in cells:
            raise ValueError(f"unknown recurrent cell {cell!r}")
        make = lambda cin, hid: cells[cell](cin, hid, kernel, gate_order)  # noqa: E731
        self.merge = merge
        per_dir = hidden // 2 if merge == "concat" else hidden
        widths = [in_channels] + [per_dir] * (num_layers - 1)
        self.forward_net = _Stack([make(cin, per_dir) for cin in widths])
        self.reverse_net = _Stack([make(cin, per_dir) for cin in widths])

    def forward(self, x: torch.Tensor, carry_in: Optional[Dict[str, Carry]] = None):
        T = x.shape[1]
        seqs, carry_out = [], {}
        for direction, stack, order in (("fwd", self.forward_net, range(T)),
                                        ("rev", self.reverse_net, range(T - 1, -1, -1))):
            ys = [x[:, t] for t in range(T)]
            for layer, cell in enumerate(stack.cell_list):
                name = f"{direction}_l{layer}"
                carry = carry_in.get(name) if carry_in else None
                if carry is None:
                    carry = cell.zero_carry(ys[0])
                outs = [None] * T
                for t in order:  # the reverse stack writes each output at its own window
                    carry, outs[t] = cell(ys[t], carry)
                carry_out[name] = carry
                ys = outs
            seqs.append(torch.stack(ys, dim=1))
        fwd, rev = seqs
        out = torch.cat([fwd, rev], dim=2) if self.merge == "concat" else fwd + rev
        return out, carry_out
