"""The frozen operation and byte counts equal the hand figures of PERF.md."""

import torch

from benchmark.harness import manifest, peaks
from benchmark.roofline import kernels

H100 = "NVIDIA H100 80GB HBM3"


def test_cin_forward_stack_at_8192_rows():
    layers = kernels.cin_layers(8192, 7, 10, [100, 100, 100], direct=False)
    assert [l[1] for l in layers] == [7, 50, 50]
    flops, _ = kernels.cin_forward(layers)
    assert flops == 12_271_616_000  # 12.27 GFLOP
    assert kernels.cin_backward(layers)[0] == 3 * flops


def test_kernel_1_is_2_b_n_d():
    flops, nbytes = kernels.topk_launch(256, 1_000_000, 64, 10)
    assert flops == 2 * 256 * 1_000_000 * 64
    p = peaks.peaks(H100)
    assert flops / p["f32_flops"] > nbytes / p["bytes_per_s"]  # bound by operations
    assert abs(flops / p["f32_flops"] * 1e3 - 0.489) < 0.001


def test_bpr_dense_adam_bytes():
    cfg = manifest.config("bpr-d64-1m")
    mod = manifest.roofline("bpr-d64-1m")
    _, _, n_params = mod._sizes(cfg)
    assert n_params == 64_025_600
    assert abs(kernels.adam_dense(n_params) / 3.35e12 * 1e3 - 0.459) < 0.001


def test_xdeepfm_params_match_the_port():
    from benchmark.harness import models

    cfg = manifest.config("xdeepfm-ml1m")
    cfg["corpus"]["schema"]["token_dims"][:2] = [300, 200]
    model = models.adapter(cfg).build(torch.device("cpu"))
    n = sum(p.numel() for p in model.parameters())
    assert manifest.roofline("xdeepfm-ml1m").n_params(cfg) == n


def test_gathers_backward_counts_written_rows():
    ids = torch.tensor([3, 3, 5, 7, 7, 7])
    live = torch.tensor([True, True, True, False, True, True])
    # more rows than ids: the distinct live rows are written
    assert kernels.gather_backward(ids, live, 100, 4) == 6 * (8 + 1 + 16) + 16 * 3
    # a table no larger than the ids: the one-block sort writes it whole
    assert kernels.gather_backward(ids, live, 4, 4) == 6 * (8 + 1 + 16) + 16 * 4
