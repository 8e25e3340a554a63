"""Shared model layers.

Port of `oovrec_tpu/models/layers.py:13-62`: the activation lookup, the
Dropout → Dense → (BatchNorm) → activation stacks of `MLPLayers` and
`masked_mean_pool`. Each Dense is an `nn.Linear` named `Dense_<j>` and each
batch norm a `BatchNorm` named `BatchNorm_<j>`, as in the flax tree, so the
weight bridge (`utils/jax_params.py`) maps names one to one.

Two flax layers the context and sequential zoos call, written out so
that their parameters are flax's (flax 0.12):
  * `MultiHeadDotProductAttention`: `query` / `key` / `value` projections
    with a kernel (in, H, hd) and a bias (H, hd), `out` with a kernel
    (H, hd, out) and a bias (out) (`DenseGeneral`, raw leaves the bridge
    passes through); the query scaled by 1/√hd, masked logits at the
    dtype's finite minimum, the softmax over the keys, and in train mode
    flax's weight dropout (the context zoo's call sites pass
    `deterministic=True`; SASRec's and BERT4Rec's blocks train it).
    `torch.nn.MultiheadAttention` packs its projections and lays out its
    heads otherwise;
  * `GRUCell`: the six Denses `ir`, `iz`, `in` (with a bias), `hr`, `hz`
    (without) and `hn` (with), r = σ(ir(x) + hr(h)), z = σ(iz(x) + hz(h)),
    n = tanh(in(x) + r·hn(h)), h' = (1 − z)·n + z·h; called as
    `(carry, inputs)`. `torch.nn.GRUCell` has two more biases, which
    would train. `gru_scan` runs it over a sequence, as `nn.scan` does.
The sequential models' pieces: flax's `LayerNorm` (epsilon 1e-6, the fast
variance), `gelu` (the tanh form, `jax.nn.gelu`'s default) and the JAX
SASRec's pre-LN `TransformerBlock`.
`Dropout` is flax's `nn.Dropout` for a model's own dropout outside
`MLPLayers`: each call draws a new mask.

`BatchNorm` is flax's `nn.BatchNorm` (flax 0.12), not
`torch.nn.BatchNorm1d`: running averages as `ra = 0.99·ra + 0.01·batch`,
the biased batch variance `mean(x²) − mean(x)²` clipped at 0, statistics
in f32 whatever the compute dtype, epsilon 1e-5, parameters `scale` /
`bias` and running buffers `mean` / `var` (flax's `batch_stats`). Every
row of the batch counts in its statistics, the padded rows of a last
batch included, as the JAX package's fixed-shape batches count them. Under
the mesh (`parallel/train_step.py:data_scope`) the statistics are
the global batch's: the sums of x and x² all-reduced over the data group.

Dropout draws its masks from an explicit `torch.Generator` that the
trainer owns and seeds (`set_dropout_generator`), never from the global
RNG; in train mode without one it raises. A model's other train-mode
draws (DIEN's negatives) take the same generator through `RandomDraws`. The masks cannot match
`jax.random`'s, so parity with the JAX package holds at dropout 0.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from oovrec_tpu_torch.models.init import xavier_normal_
from oovrec_tpu_torch.parallel.train_step import all_reduce_grad, data_group
from oovrec_tpu_torch.utils.precision import compute_dtype


def activation_fn(name: Optional[str]):
    if name is None or name == "none":
        return lambda x: x
    return {
        "sigmoid": torch.sigmoid,
        "tanh": torch.tanh,
        "relu": torch.relu,
        "gelu": nn.functional.gelu,
        "leakyrelu": nn.functional.leaky_relu,
        "softmax": lambda x: torch.softmax(x, dim=-1),
    }.get(name.lower(), torch.relu)


class BatchNorm(nn.Module):
    """flax's `nn.BatchNorm` over the last axis of a (B, features) input:
    train mode normalises with the batch's statistics and moves the
    running ones (under `torch.no_grad()`), eval mode uses the running
    ones. The statistics and the normalisation run in f32; the output
    takes the input's dtype."""

    def __init__(self, features: int, momentum: float = 0.99, epsilon: float = 1e-5,
                 device=None):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        xf = x.float()
        group = data_group() if train else None
        if group is not None:
            # under the mesh: the global batch's moments, the sums of x and
            # x² all-reduced over the data group inside autograd
            n = xf.shape[0] * dist.get_world_size(group)
            sums = all_reduce_grad(torch.stack([xf.sum(dim=0), (xf * xf).sum(dim=0)]), group)
            mean = sums[0] / n
            var = torch.maximum(sums[1] / n - mean * mean, torch.zeros_like(mean))
        elif train:
            mean = xf.mean(dim=0)
            # jnp.maximum's gradient at a tie: half to each side
            var = torch.maximum((xf * xf).mean(dim=0) - mean * mean, torch.zeros_like(mean))
        if train:
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        y = (xf - mean) * (torch.rsqrt(var + self.epsilon) * self.scale) + self.bias
        return y.to(x.dtype)


def _dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
             shape=None) -> torch.Tensor:
    """Keep each element with probability 1 − `rate`, scaled by 1 / (1 −
    `rate`), the mask drawn from `generator` (at `shape`, broadcast over
    x, where given)."""
    if generator is None:
        raise RuntimeError(
            "dropout in train mode draws from an explicit generator: call "
            "set_dropout_generator(model, generator) first")
    keep = 1.0 - rate
    mask = x.new_empty(x.shape if shape is None else shape).bernoulli_(keep, generator=generator)
    return x * mask / keep


class Dropout(nn.Module):
    """flax's `nn.Dropout(rate)`, called with `train`: identity in eval
    mode or at rate 0. `shape` draws one mask of that shape, broadcast over
    the input (flax's attention dropout shares its mask over batch and
    heads)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor, train: bool, shape=None) -> torch.Tensor:
        if not train or self.rate == 0:
            return x
        return _dropout(x, self.rate, self.generator, shape)


class LayerNorm(nn.Module):
    """flax's `nn.LayerNorm()` over the last axis: the mean and the fast
    variance mean(x²) − mean(x)² clipped at 0, epsilon 1e-6 (torch's
    default is 1e-5), parameters `scale` and `bias`."""

    def __init__(self, features: int, epsilon: float = 1e-6, device=None):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=-1, keepdim=True)
        var = torch.maximum((x * x).mean(dim=-1, keepdim=True) - mean * mean,
                            torch.zeros_like(mean))
        return (x - mean) * (torch.rsqrt(var + self.epsilon) * self.scale) + self.bias


def gelu(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.gelu`'s default, the tanh approximation (torch's default is
    the exact erf form)."""
    return nn.functional.gelu(x, approximate="tanh")


class MLPLayers(nn.Module):
    """Dropout → Dense → (BatchNorm) → activation stacks (`layers.py:33-95`
    of the reference).

    `layers` lists every width including the input width; the activation
    (and the batch norm, `use_bn`) follow every Dense, the last one
    included, exactly like the reference's module list. Dense layers
    compute in the precision policy (`utils/precision.py`) and the output
    is f32. Dropout keeps each input with probability 1 - `dropout` and
    scales it by 1 / (1 - `dropout`) when `train` (the module's mode
    unless given), drawing from `self.generator`; the batch norms follow
    the same `train`.
    """

    def __init__(
        self,
        layers: Sequence[int],
        dropout: float = 0.0,
        activation: str = "relu",
        use_bn: bool = False,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.act = activation_fn(activation)
        self.dropout = float(dropout)
        self.generator: Optional[torch.Generator] = None
        self.dense = []
        self.bn = []
        for j, (n_in, n_out) in enumerate(zip(layers[:-1], layers[1:])):
            lin = nn.Linear(n_in, n_out, device=device)
            xavier_normal_(lin.weight, generator)
            nn.init.zeros_(lin.bias)
            self.add_module(f"Dense_{j}", lin)
            self.dense.append(lin)
            if use_bn:
                bn = BatchNorm(n_out, device=device)
                self.add_module(f"BatchNorm_{j}", bn)
                self.bn.append(bn)

    def _drop(self, x: torch.Tensor) -> torch.Tensor:
        return _dropout(x, self.dropout, self.generator)

    def forward(self, x: torch.Tensor, train: Optional[bool] = None) -> torch.Tensor:
        train = self.training if train is None else train
        dt = compute_dtype()
        for j, lin in enumerate(self.dense):
            if train and self.dropout > 0:
                x = self._drop(x)
            x = nn.functional.linear(x.to(dt), lin.weight.to(dt), lin.bias.to(dt))
            if self.bn:
                x = self.bn[j](x, train)
            x = self.act(x)
        return x.float()


def _lecun_normal_(weight: torch.Tensor, fan_in: int, generator=None) -> torch.Tensor:
    """N(0, 1/fan_in), the scale of flax's default `lecun_normal` kernels
    (the draws cannot match `jax.random`'s; parity goes through the
    bridge)."""
    with torch.no_grad():
        return weight.normal_(0.0, fan_in ** -0.5, generator=generator)


class DenseGeneral(nn.Module):
    """flax's `nn.DenseGeneral` as `MultiHeadDotProductAttention` uses it:
    x contracted over its last `contract` axes with the first ones of
    `kernel`, plus `bias`. The kernel keeps flax's layout (a raw leaf)."""

    def __init__(self, kernel_shape, bias_shape, contract: int = 1, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.contract = contract
        self.kernel = nn.Parameter(torch.empty(kernel_shape, device=device))
        fan_in = 1
        for n in kernel_shape[:contract]:
            fan_in *= int(n)
        _lecun_normal_(self.kernel, fan_in, generator)
        self.bias = nn.Parameter(torch.zeros(bias_shape, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tensordot(x, self.kernel, dims=self.contract) + self.bias


class MultiHeadDotProductAttention(nn.Module):
    """flax's `nn.MultiHeadDotProductAttention(num_heads, qkv_features,
    dropout_rate)` over (B, L, in) inputs; `out` maps back to
    `out_features` (flax's default: the query's last dim). `mask` (bool,
    broadcast to (B, H, Lq, Lk)) sets the logits it excludes to the
    dtype's finite minimum, as flax does (`attention.py:139-140`): a query
    with every key masked gets uniform weights, not the NaN of −inf. In
    train mode the weights take flax's dropout, one keep mask of shape
    (1, 1, Lq, Lk) shared over batch and heads."""

    def __init__(self, in_features: int, num_heads: int, qkv_features: int,
                 out_features: Optional[int] = None, dropout_rate: float = 0.0, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if qkv_features % num_heads:
            raise ValueError(f"qkv_features {qkv_features} is not a multiple of "
                             f"num_heads {num_heads}")
        h, hd = num_heads, qkv_features // num_heads
        out = in_features if out_features is None else out_features
        for name in ("query", "key", "value"):
            self.add_module(name, DenseGeneral((in_features, h, hd), (h, hd), 1,
                                               device, generator))
        self.out = DenseGeneral((h, hd, out), (out,), 2, device, generator)
        self.head_dim = hd
        self.dropout = Dropout(dropout_rate)

    def forward(self, inputs_q: torch.Tensor, inputs_kv: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None, train: bool = False) -> torch.Tensor:
        kv = inputs_q if inputs_kv is None else inputs_kv
        q = self.query(inputs_q) / self.head_dim ** 0.5  # (B, Lq, H, hd)
        k, v = self.key(kv), self.value(kv)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if mask is not None:
            logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
        w = torch.softmax(logits, dim=-1)
        w = self.dropout(w, train, shape=(1, 1) + tuple(w.shape[-2:]))
        return self.out(torch.einsum("bhqk,bkhd->bqhd", w, v))


class TransformerBlock(nn.Module):
    """The pre-LN block of the JAX package's SASRec and BERT4Rec
    (`models/sequential/sasrec.py:18-41`): x + Dropout(Attention(LN(x))),
    then x + Dropout(Dense(gelu(Dense(LN(x))))). The hidden dropout rate
    is the attention's too (the JAX block passes it; `attn_dropout_prob`
    is read nowhere). Children carry flax's compact names, so the bridge
    maps `block_<i>` one to one."""

    def __init__(self, n_heads: int, hidden_size: int, inner_size: int, dropout: float,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(hidden_size, device=device)
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(
            hidden_size, n_heads, hidden_size, dropout_rate=dropout, device=device,
            generator=generator)
        self.LayerNorm_1 = LayerNorm(hidden_size, device=device)
        for j, (n_in, n_out) in enumerate(((hidden_size, inner_size),
                                           (inner_size, hidden_size))):
            lin = nn.Linear(n_in, n_out, device=device)
            xavier_normal_(lin.weight, generator)
            nn.init.zeros_(lin.bias)
            self.add_module(f"Dense_{j}", lin)
        self.drop_attn = Dropout(dropout)
        self.drop_ffn = Dropout(dropout)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, train: bool) -> torch.Tensor:
        h = self.LayerNorm_0(x)
        h = self.MultiHeadDotProductAttention_0(h, h, mask=mask, train=train)
        x = x + self.drop_attn(h, train)
        h = self.Dense_1(gelu(self.Dense_0(self.LayerNorm_1(x))))
        return x + self.drop_ffn(h, train)


class GRUCell(nn.Module):
    """flax's `nn.GRUCell(features)`: `(carry (N, features), inputs (N,
    in)) → (h', h')`. Input kernels at flax's lecun-normal scale, recurrent
    kernels orthogonal, biases zero."""

    def __init__(self, in_features: int, features: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.features = features
        for name, n_in, bias in (("ir", in_features, True), ("iz", in_features, True),
                                 ("in", in_features, True), ("hr", features, False),
                                 ("hz", features, False), ("hn", features, True)):
            lin = nn.Linear(n_in, features, bias=bias, device=device)
            if name.startswith("i"):
                _lecun_normal_(lin.weight, n_in, generator)
            else:
                with torch.no_grad():
                    nn.init.orthogonal_(lin.weight, generator=generator)
            if bias:
                nn.init.zeros_(lin.bias)
            self.add_module(name, lin)

    def gates(self, xr: torch.Tensor, xz: torch.Tensor, xn: torch.Tensor,
              h: torch.Tensor) -> torch.Tensor:
        """The new carry from the input projections (`ir`, `iz`, `in` of
        the inputs) and the carry `h`."""
        r = torch.sigmoid(xr + self.hr(h))
        z = torch.sigmoid(xz + self.hz(h))
        n = torch.tanh(xn + r * self.hn(h))
        return (1.0 - z) * n + z * h

    def forward(self, carry: torch.Tensor, inputs: torch.Tensor):
        new_h = self.gates(self.ir(inputs), self.iz(inputs), getattr(self, "in")(inputs), carry)
        return new_h, new_h


def gru_scan(cell: "GRUCell", x: torch.Tensor, carry: torch.Tensor):
    """flax's `nn.scan(GRUCell)` over axis 1 of x (B, L, in) from `carry`
    (B, features): → (the last carry, the states (B, L, features)). The
    input projections of all L positions are one product each; the
    recurrent ones run a step at a time. The projections are split by
    `unbind`, whose backward stacks the L gradients once: a slice
    `xr[:, t]` would zero-fill and add a whole (B, L, features) gradient
    for each t."""
    steps = zip(cell.ir(x).unbind(1), cell.iz(x).unbind(1), getattr(cell, "in")(x).unbind(1))
    h, states = carry, []
    for xr, xz, xn in steps:
        h = cell.gates(xr, xz, xn, h)
        states.append(h)
    return h, torch.stack(states, dim=1)


def masked_mean_pool(emb: torch.Tensor, mask: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """(B, L, D) × (B, L) → (B, D): the reference's token_seq mean mode
    (`abstract_recommender.py:553-566`)."""
    m = mask.to(emb.dtype)[..., None]
    return (emb * m).sum(dim=1) / (mask.to(emb.dtype).sum(dim=1, keepdim=True) + eps)


def _draw_generator(generator: Optional[torch.Generator]) -> torch.Generator:
    if generator is None:
        raise RuntimeError(
            "a train-mode draw takes an explicit generator: call "
            "set_dropout_generator(model, generator) first")
    return generator


class RandomDraws(nn.Module):
    """A model's own random draws in train mode (DIEN's negatives, S3Rec's
    masks, negatives and segment starts, the autoencoders' ε and keep
    masks), from the trainer's dropout generator, as flax draws them from
    the `dropout` stream: a CUDA-graph capture registers that generator
    alone."""

    def __init__(self):
        super().__init__()
        self.generator: Optional[torch.Generator] = None

    def randint(self, low: int, high: int, shape, device) -> torch.Tensor:
        return torch.randint(low, high, tuple(shape), generator=_draw_generator(self.generator),
                             device=device)

    def rand(self, shape, device) -> torch.Tensor:
        """Uniform [0, 1) floats."""
        return torch.rand(tuple(shape), generator=_draw_generator(self.generator), device=device)

    def normal(self, shape, device) -> torch.Tensor:
        """Standard normal floats (`jax.random.normal`)."""
        return torch.randn(tuple(shape), generator=_draw_generator(self.generator), device=device)

    def keep(self, p: float, shape, device) -> torch.Tensor:
        """A float 0/1 mask, 1 with probability `p` (`jax.random.bernoulli`)."""
        mask = torch.empty(tuple(shape), device=device)
        return mask.bernoulli_(p, generator=_draw_generator(self.generator))

    def dropout(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        """flax's `nn.Dropout(rate)` in train mode, its keep mask drawn by
        `keep`: x at rate 0, zeros at rate 1."""
        if rate == 0.0:
            return x
        if rate == 1.0:
            return torch.zeros_like(x)
        return x * self.keep(1.0 - rate, x.shape, x.device) / (1.0 - rate)

    def below(self, high: torch.Tensor) -> torch.Tensor:
        """One int64 draw in [0, high) for each entry of the int tensor
        `high` (≥ 1), as ⌊u · high⌋ on the device: `torch.randint` takes
        no tensor bound, and reading `high` on the host would break a
        capture."""
        u = self.rand(high.shape, high.device)
        return torch.minimum((u * high).long(), high.long() - 1)


def set_dropout_generator(module: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Give every `MLPLayers`, `Dropout` and `RandomDraws` under `module`
    the generator their dropout masks and draws come from."""
    for m in module.modules():
        if isinstance(m, (MLPLayers, Dropout, RandomDraws)):
            m.generator = generator
