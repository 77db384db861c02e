"""SNUNet-CD, the Siamese nested U-Net, with and without ECAM, on NCHW tensors
(counterpart of stcd_tpu/models/snunet.py:28-193). The state_dict names are
the reference's (``conv0_0.conv1`` .. ``conv0_4``, ``Up1_0.up`` .. ``Up1_3.up``,
``ca``, ``ca1``, ``final1`` .. ``final4``, ``conv_final``). The Siamese
columns run once on the 2N-batched pair, as in the JAX model.
"""

from __future__ import annotations

import torch
from torch import nn

from stcd_tpu_torch.layers.modules import max_pool
from stcd_tpu_torch.layers.norm import BatchNorm


class ConvBlockNested(nn.Module):
    """conv1 -> bn1 -> ReLU -> conv2 -> bn2, plus the first conv's pre-BN
    output, then ReLU (stcd_tpu/models/snunet.py:28-45)."""

    def __init__(self, in_ch: int, mid_ch: int, out_ch: int, device=None):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, mid_ch, 3, padding=1, device=device)
        self.bn1 = BatchNorm(mid_ch, device=device)
        self.conv2 = nn.Conv2d(mid_ch, out_ch, 3, padding=1, device=device)
        self.bn2 = BatchNorm(out_ch, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x = self.conv1(x)
        x = self.bn2(self.conv2(torch.relu(self.bn1(x))))
        return torch.relu(x + identity)


class Up(nn.Module):
    """``up`` = ConvTranspose2d(k=2, s=2), an exact 2x upsample
    (stcd_tpu/models/snunet.py:76-91). ``mode="d2s"`` computes the same
    function from the same parameters as one product and a depth-to-space
    interleave (``_D2SUp``, :48-73): out[b, o, 2i+u, 2j+v] =
    sum_c x[b, c, i, j] W[c, o, u, v] + bias[o]."""

    def __init__(self, ch: int, mode: str = "convtranspose", device=None):
        super().__init__()
        if mode not in ("convtranspose", "d2s"):
            raise ValueError(f"Up mode {mode!r}: 'convtranspose' or 'd2s'")
        self.mode = mode
        self.up = nn.ConvTranspose2d(ch, ch, 2, stride=2, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "convtranspose":
            return self.up(x)
        b, _, h, w = x.shape
        y = torch.einsum("bchw,couv->bohuwv", x, self.up.weight.to(x.dtype))
        y = y.reshape(b, -1, 2 * h, 2 * w)
        return y + self.up.bias.to(x.dtype).reshape(1, -1, 1, 1)


class ChannelAttention(nn.Module):
    """sigmoid(fc2(relu(fc1(avg))) + fc2(relu(fc1(max)))) over the pooled
    channels; 1x1 convs without bias (stcd_tpu/models/snunet.py:94-109)."""

    def __init__(self, in_channels: int, ratio: int = 16, device=None):
        super().__init__()
        self.fc1 = nn.Conv2d(in_channels, in_channels // ratio, 1, bias=False, device=device)
        self.fc2 = nn.Conv2d(in_channels // ratio, in_channels, 1, bias=False, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        avg = x.mean((2, 3), keepdim=True)
        mx = x.amax((2, 3), keepdim=True)
        return torch.sigmoid(self.fc2(torch.relu(self.fc1(avg)))
                             + self.fc2(torch.relu(self.fc1(mx))))


# the nested nodes: name -> (level, number of same-level inputs before the upsample)
_NODES = {"conv0_1": (0, 2), "conv1_1": (1, 2), "conv0_2": (0, 3), "conv2_1": (2, 2),
          "conv1_2": (1, 3), "conv0_3": (0, 4), "conv3_1": (3, 2), "conv2_2": (2, 3),
          "conv1_3": (1, 4), "conv0_4": (0, 5)}
_UPS = ("Up1_0", "Up2_0", "Up1_1", "Up3_0", "Up2_1", "Up1_2", "Up4_0", "Up3_1", "Up2_2",
        "Up1_3")


def _build_body(model: nn.Module, in_ch: int, n1: int, up_mode: str, device) -> None:
    """The Siamese columns and the nested nodes, as top-level modules of
    ``model`` under the reference's names."""
    f = [n1 * 2 ** i for i in range(5)]
    model.conv0_0 = ConvBlockNested(in_ch, f[0], f[0], device=device)
    for i in range(1, 5):
        setattr(model, f"conv{i}_0", ConvBlockNested(f[i - 1], f[i], f[i], device=device))
    for name, (lvl, same) in _NODES.items():
        setattr(model, name, ConvBlockNested(f[lvl] * same + f[lvl + 1], f[lvl], f[lvl],
                                             device=device))
    for name in _UPS:
        setattr(model, name, Up(f[int(name[2])], up_mode, device=device))


def _run_body(m: nn.Module, xa: torch.Tensor, xb: torch.Tensor):
    """x0_1 .. x0_4 of the nested body (stcd_tpu/models/snunet.py:112-155)."""
    n = xa.shape[0]
    x0_0 = m.conv0_0(torch.cat([xa, xb], dim=0))
    x1_0 = m.conv1_0(max_pool(x0_0))
    x2_0 = m.conv2_0(max_pool(x1_0))
    x3_0 = m.conv3_0(max_pool(x2_0))
    x0_0A, x0_0B = x0_0[:n], x0_0[n:]
    x1_0A, x1_0B = x1_0[:n], x1_0[n:]
    x2_0A, x2_0B = x2_0[:n], x2_0[n:]
    x3_0A, x3_0B = x3_0[:n], x3_0[n:]
    x4_0B = m.conv4_0(max_pool(x3_0B))  # the reference needs x4_0 of B only

    def cat(*xs):
        return torch.cat(xs, dim=1)

    x0_1 = m.conv0_1(cat(x0_0A, x0_0B, m.Up1_0(x1_0B)))
    x1_1 = m.conv1_1(cat(x1_0A, x1_0B, m.Up2_0(x2_0B)))
    x0_2 = m.conv0_2(cat(x0_0A, x0_0B, x0_1, m.Up1_1(x1_1)))
    x2_1 = m.conv2_1(cat(x2_0A, x2_0B, m.Up3_0(x3_0B)))
    x1_2 = m.conv1_2(cat(x1_0A, x1_0B, x1_1, m.Up2_1(x2_1)))
    x0_3 = m.conv0_3(cat(x0_0A, x0_0B, x0_1, x0_2, m.Up1_2(x1_2)))
    x3_1 = m.conv3_1(cat(x3_0A, x3_0B, m.Up4_0(x4_0B)))
    x2_2 = m.conv2_2(cat(x2_0A, x2_0B, x2_1, m.Up3_1(x3_1)))
    x1_3 = m.conv1_3(cat(x1_0A, x1_0B, x1_1, x1_2, m.Up2_2(x2_2)))
    x0_4 = m.conv0_4(cat(x0_0A, x0_0B, x0_1, x0_2, x0_3, m.Up1_3(x1_3)))
    return x0_1, x0_2, x0_3, x0_4


class SNUNetECAM(nn.Module):
    """SNUNet-CD with the ensemble channel attention head
    (stcd_tpu/models/snunet.py:158-176); ``define_G("SNUNet")``."""

    def __init__(self, in_ch: int = 3, out_ch: int = 1, n1: int = 32,
                 up_mode: str = "convtranspose", device=None):
        super().__init__()
        _build_body(self, in_ch, n1, up_mode, device)
        self.ca = ChannelAttention(n1 * 4, ratio=16, device=device)
        self.ca1 = ChannelAttention(n1, ratio=16 // 4, device=device)
        self.conv_final = nn.Conv2d(n1 * 4, out_ch, 1, device=device)

    def forward(self, xa: torch.Tensor, xb: torch.Tensor) -> torch.Tensor:
        x0_1, x0_2, x0_3, x0_4 = _run_body(self, xa, xb)
        out = torch.cat([x0_1, x0_2, x0_3, x0_4], dim=1)
        ca1 = self.ca1(x0_1 + x0_2 + x0_3 + x0_4)
        ca = self.ca(out)
        return self.conv_final(ca * (out + ca1.repeat(1, 4, 1, 1)))


class SiamNestedUNetConc(nn.Module):
    """SNUNet-CD without attention: four side heads and a 1x1 fuse
    (stcd_tpu/models/snunet.py:179-193)."""

    def __init__(self, in_ch: int = 3, out_ch: int = 1, n1: int = 32,
                 up_mode: str = "convtranspose", device=None):
        super().__init__()
        _build_body(self, in_ch, n1, up_mode, device)
        for i in range(1, 5):
            setattr(self, f"final{i}", nn.Conv2d(n1, out_ch, 1, device=device))
        self.conv_final = nn.Conv2d(out_ch * 4, out_ch, 1, device=device)

    def forward(self, xa: torch.Tensor, xb: torch.Tensor) -> torch.Tensor:
        xs = _run_body(self, xa, xb)
        outs = [getattr(self, f"final{i + 1}")(x) for i, x in enumerate(xs)]
        return self.conv_final(torch.cat(outs, dim=1))
