"""Caser and NextItNet: convolutions over the embedded item sequence.

Port of `oovrec_tpu/models/sequential/convs.py:18-118`. The convolutions
are flax's `nn.Conv` written as products, their kernels kept in flax's
layout as raw leaves (`Conv`): no cuDNN call, whose weight-gradient
algorithms need not be deterministic and which a CUDA-graph capture may
switch, so a graphed step equals an eager one bit for bit.
  * Caser: the (B, L, D) image under `hconv_<h>` (kernel (h, D, 1, n_h)),
    each the windows of h rows times the kernel, relu, then the max over
    the windows; `v_conv` (kernel (L, 1, 1, n_v)) sums over the L rows,
    and its (D, n_v) output is flattened d-major, as flax's NHWC output
    is, before `fc`; then the user's row and `out`.
  * NextItNet: `block_<i>` residual blocks, each LayerNorm → relu → a
    causal conv of dilation d (left padding (k − 1)·d) → LayerNorm → relu
    → a causal conv of dilation 2d; the children carry the compact names
    `LayerNorm_0`, `Conv_0`, `LayerNorm_1`, `Conv_1`; then `final` and
    the state at length − 1.
"""

from __future__ import annotations

import torch
from torch import nn

from oovrec_tpu_torch.models.base import register_model
from oovrec_tpu_torch.models.context import dense
from oovrec_tpu_torch.models.layers import Dropout, LayerNorm, _lecun_normal_
from oovrec_tpu_torch.models.sequential.base import SequentialRecommender, gather_last
from oovrec_tpu_torch.ops.embed_grad import gather_rows


class Conv(nn.Module):
    """A flax `nn.Conv`'s parameters: `kernel` in flax's layout (the
    window's axes, then in, then out) at lecun-normal scale, and a zero
    `bias`. The callers contract it themselves."""

    def __init__(self, kernel_shape, device=None, generator=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(kernel_shape, device=device))
        fan_in = 1
        for n in kernel_shape[:-1]:
            fan_in *= int(n)
        _lecun_normal_(self.kernel, fan_in, generator)
        self.bias = nn.Parameter(torch.zeros(kernel_shape[-1], device=device))


def windows(x: torch.Tensor, size: int, step: int, length: int) -> torch.Tensor:
    """(B, T, C) → (B, length, size·C): at t, x[t], x[t + step], ... side
    by side (the order of a flax kernel's window axis, then its input)."""
    return torch.cat([x[:, j * step: j * step + length] for j in range(size)], dim=-1)


@register_model
class Caser(SequentialRecommender):
    # the loss reads only split columns (+ a sampled negative): device-epoch OK
    supports_device_epoch = True

    def __init__(self, *args, n_h: int = 16, n_v: int = 4, dropout_prob: float = 0.4,
                 heights: tuple = (2, 3, 4), **kwargs):
        super().__init__(*args, **kwargs)
        D, L = self.embedding_size, self.max_seq_length
        self.user_embedding = self._embed_table(self.n_users)
        self.item_embedding = self._embed_table(self.n_items)
        self.heights = tuple(int(h) for h in heights)
        for h in self.heights:
            self.add_module(f"hconv_{h}", Conv((h, D, 1, n_h), self.device, self.generator))
        self.v_conv = Conv((L, 1, 1, n_v), self.device, self.generator)
        self.fc = dense(self, n_h * len(self.heights) + n_v * D, D)
        self.out = dense(self, 2 * D, D)
        self.drop = Dropout(dropout_prob)

    def seq_output(self, batch, train: bool = False):
        seq, _ = self._sequence(batch)
        E = gather_rows(self.item_embedding.weight, seq)  # (B, L, D)
        B, L, D = E.shape
        outs = []
        for h in self.heights:
            conv = getattr(self, f"hconv_{h}")
            c = windows(E, h, 1, L - h + 1) @ conv.kernel.reshape(h * D, -1) + conv.bias
            outs.append(torch.relu(c).amax(dim=1))  # (B, n_h)
        v = torch.einsum("bld,lc->bdc", E, self.v_conv.kernel[:, 0, 0]) + self.v_conv.bias
        outs.append(v.reshape(B, -1))
        z = self.drop(torch.cat(outs, dim=1), train)
        z = torch.relu(self.fc(z))
        u = gather_rows(self.user_embedding.weight, batch[self.uid_field])
        return self.out(torch.cat([z, u], dim=1))


class DilatedBlock(nn.Module):
    """x + conv₂(relu(LN₁(conv₁(relu(LN₀(x)))))), the convs causal with
    dilations d and 2d."""

    def __init__(self, channels: int, dilation: int, kernel: int = 3, device=None,
                 generator=None):
        super().__init__()
        self.dilation, self.kernel = int(dilation), int(kernel)
        self.LayerNorm_0 = LayerNorm(channels, device=device)
        self.Conv_0 = Conv((kernel, channels, channels), device, generator)
        self.LayerNorm_1 = LayerNorm(channels, device=device)
        self.Conv_1 = Conv((kernel, channels, channels), device, generator)

    def _causal(self, conv: Conv, x: torch.Tensor, dilation: int) -> torch.Tensor:
        k, c_in, _ = conv.kernel.shape
        L = x.shape[1]
        xp = nn.functional.pad(x, (0, 0, (k - 1) * dilation, 0))
        return windows(xp, k, dilation, L) @ conv.kernel.reshape(k * c_in, -1) + conv.bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self._causal(self.Conv_0, torch.relu(self.LayerNorm_0(x)), self.dilation)
        h = self._causal(self.Conv_1, torch.relu(self.LayerNorm_1(h)), 2 * self.dilation)
        return x + h


@register_model
class NextItNet(SequentialRecommender):
    # the loss reads only split columns (+ a sampled negative): device-epoch OK
    supports_device_epoch = True

    def __init__(self, *args, block_dilations: tuple = (1, 4), kernel_size: int = 3, **kwargs):
        super().__init__(*args, **kwargs)
        D = self.embedding_size
        self.item_embedding = self._embed_table(self.n_items)
        self.blocks = []
        for i, d in enumerate(block_dilations):
            blk = DilatedBlock(D, d, kernel_size, device=self.device, generator=self.generator)
            self.add_module(f"block_{i}", blk)
            self.blocks.append(blk)
        self.final = dense(self, D, D)

    def seq_output(self, batch, train: bool = False):
        seq, lengths = self._sequence(batch)
        x = gather_rows(self.item_embedding.weight, seq)
        for blk in self.blocks:
            x = blk(x)
        return gather_last(self.final(x), lengths)
