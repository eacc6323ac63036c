"""The shared 6-level Super SloMo U-Net (stages 1 and 2), NCHW.

The plain reference topology: an encoder of 5 conv-pair blocks (channels
32/64/128/256/512, kernels 7/5/3/3/3) with a 2x2 average pool before each
block after the first, a bottleneck at 1/32 resolution (the CONV pair, or
the bidirectional ConvLSTM / ConvGRU of SuperSloMo-R over the window
sequence, models/bottleneck.py), a decoder of
5 "bilinear 2x upsample + conv pair" blocks with skip concats, a fuse conv at
full resolution and a linear 3x3 head. The cross-stage skip is a channel
concat: stage 1 emits its bottleneck output and stage 2 takes it beside its
own at ``conv7a`` (1024 channels).

The JAX package runs the same function through TPU layout rewrites
(space-to-depth polyphase convs, folded upsample+conv, prepared weights);
those are exact rewrites for the TPU's matrix unit and are not ported.
Submodule names follow the reference state dict (``conv1a.0.weight``,
``conv6.0.0.weight``, ``conv6.forward_net.cell_list.0.conv.weight``,
``final_conv.weight``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from superslomo_tpu_torch.models.bottleneck import BiConvRNN
from superslomo_tpu_torch.models.layers import conv_lrelu, final_conv
from superslomo_tpu_torch.ops import avg_pool_2x2, upsample_2x_bilinear

# (name, in_channels, out_channels, kernel) of every conv block before conv6
_ENCODER = (
    ("conv1a", None, 32, 7), ("conv1b", 32, 32, 7),
    ("conv2a", 32, 64, 5), ("conv2b", 64, 64, 5),
    ("conv3a", 64, 128, 3), ("conv3b", 128, 128, 3),
    ("conv4a", 128, 256, 3), ("conv4b", 256, 256, 3),
    ("conv5a", 256, 512, 3), ("conv5b", 512, 512, 3),
)
# decoder blocks after conv7: (name_a, name_b, in_channels of a, out_channels)
_DECODER = (
    ("conv8a", "conv8b", 1024, 256),
    ("conv9a", "conv9b", 512, 128),
    ("conv10a", "conv10b", 256, 64),
    ("conv11a", "conv11b", 128, 32),
)


class UNet(nn.Module):
    """One Super SloMo U-Net stage.

    ``forward(x (N, in_channels, H, W), cross_encoding=None, n_windows=1,
    rnn_carry=None)`` returns ``(out (N, out_channels, H, W), encoding,
    carry)``; ``encoding`` is the (N, 512, H/32, W/32) bottleneck output when
    ``emit_encoding``, else None. A recurrent bottleneck sees the batch as
    (N / n_windows, n_windows) window sequences, sample-major, starts from
    ``rnn_carry`` (zeros when None) and returns its new state as ``carry``;
    the CONV bottleneck returns None there. H and W must be divisible by 32.

    :param bottleneck: "CONV", "CLSTM" or "CGRU".
    :param clstm_merge, clstm_gate_order: the recurrent layout
        (``[TPU] CLSTM_MERGE`` / ``CLSTM_GATE_ORDER``), in any case.
    """

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        bottleneck: str = "CONV",
        emit_encoding: bool = False,
        accept_encoding: bool = False,
        clstm_merge: str = "CONCAT",
        clstm_gate_order: str = "IFOG",
    ):
        super().__init__()
        self.emit_encoding = emit_encoding
        self.accept_encoding = accept_encoding
        self.recurrent = bottleneck in ("CLSTM", "CGRU")
        for name, cin, cout, k in _ENCODER:
            self.add_module(name, conv_lrelu(in_channels if cin is None else cin, cout, k))
        if bottleneck == "CONV":
            self.conv6 = nn.Sequential(conv_lrelu(512, 512, 3), conv_lrelu(512, 512, 3))
        elif self.recurrent:
            self.conv6 = BiConvRNN(512, 512, num_layers=2, cell=bottleneck, merge=clstm_merge,
                                   gate_order=clstm_gate_order)
        else:
            raise ValueError(f"unknown bottleneck {bottleneck!r}")
        self.conv7a = conv_lrelu(1024 if accept_encoding else 512, 512, 3)
        self.conv7b = conv_lrelu(512, 512, 3)
        for na, nb, cin, cout in _DECODER:
            self.add_module(na, conv_lrelu(cin, cout, 3))
            self.add_module(nb, conv_lrelu(cout, cout, 3))
        self.fuse_conv = conv_lrelu(64, 32, 3)
        self.final_conv = final_conv(32, out_channels)

    def forward(self, x: torch.Tensor, cross_encoding: Optional[torch.Tensor] = None, n_windows: int = 1,
                rnn_carry: Optional[dict] = None):
        N, H, W = x.shape[0], x.shape[-2], x.shape[-1]
        if H % 32 or W % 32:
            raise ValueError(f"H, W must be /32-divisible, got {H}x{W}")
        if N % n_windows:
            raise ValueError(f"a batch of {N} is no whole number of {n_windows}-window sequences")
        skips = []
        h = x
        for i in range(0, len(_ENCODER), 2):
            if i:
                h = avg_pool_2x2(h)
            h = getattr(self, _ENCODER[i + 1][0])(getattr(self, _ENCODER[i][0])(h))
            skips.append(h)  # conv1b .. conv5b
        h = avg_pool_2x2(h)
        carry = None
        if self.recurrent:  # (B·T, 512, h, w) ↔ (B, T, 512, h, w) around the recurrence
            seq, carry = self.conv6(h.reshape((N // n_windows, n_windows) + h.shape[1:]), rnn_carry)
            h = seq.reshape((N,) + seq.shape[2:]).contiguous(memory_format=torch.channels_last)
        else:
            h = self.conv6(h)
        encoding = h if self.emit_encoding else None

        if self.accept_encoding:
            if cross_encoding is None:
                raise ValueError("this stage was built with accept_encoding=True")
            h = torch.cat([h, cross_encoding.to(h.dtype)], dim=1)
        h = self.conv7b(self.conv7a(upsample_2x_bilinear(h)))
        for (na, nb, _, _), skip in zip(_DECODER, reversed(skips[1:])):
            h = torch.cat([h, skip], dim=1)
            h = getattr(self, nb)(getattr(self, na)(upsample_2x_bilinear(h)))
        h = self.fuse_conv(torch.cat([h, skips[0]], dim=1))
        return self.final_conv(h), encoding, carry
