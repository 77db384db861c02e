"""DSIFN, the deeply supervised image fusion network, on NCHW tensors
(counterpart of stcd_tpu/models/dsifn.py:34-164, ``define_G("IFNet")``).
One VGG16 base runs on the 2N-batched pair; five decode branches fuse the
bi-temporal taps from 1/16 resolution up, each with channel and spatial
attention; the head has one channel whatever ``n_class`` is. The state_dict
names are the reference's: the shared base is registered as both ``t1_base``
and ``t2_base`` (one module, as the reference passes the same base twice), and
``o1_conv1`` .. ``o5_conv4``, ``sa1`` .. ``sa5``, ``bn_sa1`` .. ``bn_sa5``,
``ca2`` .. ``ca5``, ``trans_conv1`` .. ``trans_conv4``. The reference's unused
``ca1``, ``bn_ca1`` and ``bn_ca2`` are not built.
"""

from __future__ import annotations

import torch
from torch import nn

from stcd_tpu_torch.encoders.vgg import VGG16Features
from stcd_tpu_torch.layers.norm import BatchNorm
from stcd_tpu_torch.layers.stochastic import Dropout


class ChannelAttention(nn.Module):
    """sigmoid(fc2(relu(fc1(avg))) + fc2(relu(fc1(max)))), ratio 8."""

    def __init__(self, in_channels: int, ratio: int = 8, device=None):
        super().__init__()
        self.fc1 = nn.Conv2d(in_channels, in_channels // ratio, 1, bias=False, device=device)
        self.fc2 = nn.Conv2d(in_channels // ratio, in_channels, 1, bias=False, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        avg = x.mean((2, 3), keepdim=True)
        mx = x.amax((2, 3), keepdim=True)
        return torch.sigmoid(self.fc2(torch.relu(self.fc1(avg)))
                             + self.fc2(torch.relu(self.fc1(mx))))


class SpatialAttention(nn.Module):
    """sigmoid(conv7x7([mean_c, max_c])), no bias."""

    def __init__(self, device=None):
        super().__init__()
        self.conv1 = nn.Conv2d(2, 1, 7, padding=3, bias=False, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.cat([x.mean(1, keepdim=True), x.amax(1, keepdim=True)], dim=1)
        return torch.sigmoid(self.conv1(h))


def conv2d_bn(cin: int, cout: int, device=None) -> nn.Sequential:
    """Conv3x3 -> PReLU -> BN -> Dropout(0.6) (indices .0 .1 .2 .3)."""
    return nn.Sequential(nn.Conv2d(cin, cout, 3, padding=1, device=device),
                         nn.PReLU(1, 0.25, device=device), BatchNorm(cout, device=device),
                         Dropout(0.6))


# per branch: the widths of its convs; its 1-channel head follows them
_BRANCH_CONVS = {1: (512, 512), 2: (512, 256, 256), 3: (256, 128, 128), 4: (128, 64, 64),
                 5: (64, 32, 16)}
_TAP_CHANNELS = (64, 128, 256, 512, 512)


class DSIFN(nn.Module):
    """``forward(t1, t2) -> (N, 1, H, W)`` change logits; with ``return_aux``
    also the four deep-supervision sigmoids of branches 1-4."""

    def __init__(self, return_aux: bool = False, device=None):
        super().__init__()
        self.return_aux = return_aux
        self.t1_base = VGG16Features(device=device)
        self.t2_base = self.t1_base
        cin = 2 * _TAP_CHANNELS[4]
        for k, widths in _BRANCH_CONVS.items():
            if k > 1:  # the previous branch's upsampled output and both taps
                cin += 2 * _TAP_CHANNELS[5 - k]
                setattr(self, f"ca{k}", ChannelAttention(cin, device=device))
            for j, w in enumerate(widths):
                setattr(self, f"o{k}_conv{j + 1}", conv2d_bn(cin, w, device=device))
                cin = w
            setattr(self, f"sa{k}", SpatialAttention(device=device))
            setattr(self, f"bn_sa{k}", BatchNorm(cin, device=device))
            setattr(self, f"o{k}_conv{len(widths) + 1}", nn.Conv2d(cin, 1, 1, device=device))
            if k < 5:
                setattr(self, f"trans_conv{k}", nn.ConvTranspose2d(cin, cin, 2, stride=2,
                                                                   device=device))

    def forward(self, t1: torch.Tensor, t2: torch.Tensor):
        n = t1.shape[0]
        taps = self.t1_base(torch.cat([t1, t2], dim=0))
        aux = []
        for k, widths in _BRANCH_CONVS.items():
            level = 5 - k
            parts = [taps[level][:n], taps[level][n:]]
            if k == 1:
                x = torch.cat(parts, dim=1)
            else:
                x = torch.cat([x] + parts, dim=1)
                x = getattr(self, f"ca{k}")(x) * x
            for j in range(len(widths)):
                x = getattr(self, f"o{k}_conv{j + 1}")(x)
            x = getattr(self, f"sa{k}")(x) * x
            x = getattr(self, f"bn_sa{k}")(x)
            head = getattr(self, f"o{k}_conv{len(widths) + 1}")(x)
            if k == 5:
                return (head, aux) if self.return_aux else head
            aux.append(torch.sigmoid(head))
            x = getattr(self, f"trans_conv{k}")(x)
