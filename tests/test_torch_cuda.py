"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; every test asks the ``cuda_device`` fixture, which skips
where there is no card. The file imports neither JAX nor the JAX package, so
it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from gptqmodel_tpu_torch import GPTQModel
from gptqmodel_tpu_torch.models import transformer
from gptqmodel_tpu_torch.ops import _build, registry
from gptqmodel_tpu_torch.ops.gptq_solve import (
    gptq_block_inner,
    gptq_block_inner_plain,
    gptq_whole_solve,
    gptq_whole_solve_plain,
)
from gptqmodel_tpu_torch.ops.pack import pack_qweight
from gptqmodel_tpu_torch.ops.qlinear import qlinear_forward_torch
from gptqmodel_tpu_torch.ops.qmatmul import (
    H100_SMS,
    qmatmul,
    qmatmul_asym,
    qmatmul_asym_plain,
    qmatmul_fused,
    qmatmul_fused_plain,
    qmatmul_plain,
    qmatmul_planes,
    qmatmul_planes_asym,
    qmatmul_planes_asym_plain,
    qmatmul_planes_plain,
    qmm,
    qmm_plain,
)
from gptqmodel_tpu_torch.ops import qmoe
from gptqmodel_tpu_torch.ops.qmlp import qmlp, qmlp_plain
from gptqmodel_tpu_torch.ops.registry import post_init_module
from gptqmodel_tpu_torch.quantization.gptq import gptq_solve_core, hessian_inverse
from gptqmodel_tpu_torch.quantization.quantizer import _minmax, _params_from_range
from gptqmodel_tpu_torch.utils.testing import (
    random_quant_linear,
    write_random_gptq_checkpoint,
    write_random_qwen3_moe_checkpoint,
)

pytestmark = pytest.mark.cuda

TINY_LLAMA = {
    "model_type": "llama", "vocab_size": 1024, "hidden_size": 512,
    "intermediate_size": 1024, "num_hidden_layers": 2, "num_attention_heads": 4,
    "num_key_value_heads": 2, "rms_norm_eps": 1e-5, "rope_theta": 500000.0,
    "max_position_embeddings": 2048, "tie_word_embeddings": False, "hidden_act": "silu",
}
TINY_QWEN3_MOE = {
    "model_type": "qwen3_moe", "vocab_size": 1024, "hidden_size": 512,
    "intermediate_size": 1024, "moe_intermediate_size": 256, "num_hidden_layers": 2,
    "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 128, "num_experts": 16,
    "num_experts_per_tok": 4, "norm_topk_prob": True, "rms_norm_eps": 1e-6,
    "rope_theta": 1e6, "tie_word_embeddings": False, "hidden_act": "silu",
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: a CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    return torch.device("cuda")


def _rel(y, ref):
    return float((y.float() - ref.float()).norm() / ref.float().norm())


def _x(rng, M, K, dev):
    return torch.from_numpy(rng.standard_normal((M, K), dtype=np.float32)).to(dev).to(
        torch.bfloat16)


# M = 1 and 5 take one 16-row tile, 40 four of them, 100 the 32 x 32 tiles
# (N = 384) or four row tiles (N = 392, not a multiple of 32)
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("M,N", [(1, 384), (5, 384), (40, 384), (100, 384), (100, 392)])
def test_qmatmul_kernel_matches_plain(cuda_device, bits, M, N):
    """Both sum exact bf16 x code products in f32 and round once to bf16; only
    the order of the f32 sums differs: 1e-3 relative in norm."""
    rng = np.random.default_rng(bits * 1000 + M + N)
    K = 1024
    p = post_init_module(random_quant_linear(rng, K, N, bits, device=cuda_device))
    x = _x(rng, M, K, cuda_device)
    kw = dict(bits=bits, group_size=128, zero_const=p.zero_const)
    before = _build.LAUNCHES["qmatmul"]
    y = qmatmul(x, p.qweight, p.scales, **kw)
    ref = qmatmul_plain(x, p.qweight, p.scales, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["qmatmul"] == before + 1
    assert y.dtype == torch.bfloat16 and y.shape == (M, N)
    assert _rel(y, ref) <= 1e-3


def test_qmatmul_exact_inputs_give_equal_outputs(cuda_device):
    """Small integer activations and power-of-two scales: every product and
    every partial sum is exact in f32, so kernel and plain version agree bit
    for bit."""
    rng = np.random.default_rng(7)
    K, N = 512, 256
    p = post_init_module(random_quant_linear(rng, K, N, 4, device=cuda_device))
    p.scales = torch.from_numpy(2.0 ** rng.integers(-7, -4, p.scales.shape)).to(
        cuda_device).to(torch.float16)
    x = torch.from_numpy(rng.integers(-4, 5, (8, K)).astype(np.float32)).to(
        cuda_device).to(torch.bfloat16)
    kw = dict(bits=4, group_size=128, zero_const=p.zero_const)
    assert torch.equal(qmatmul(x, p.qweight, p.scales, **kw),
                       qmatmul_plain(x, p.qweight, p.scales, **kw))


@pytest.mark.parametrize("M", [8, 1024])
def test_qmatmul_same_result_every_run(cuda_device, M):
    rng = np.random.default_rng(3)
    p = post_init_module(random_quant_linear(rng, 4096, 256, 4, device=cuda_device))
    x = _x(rng, M, 4096, cuda_device)
    ys = [qmatmul(x, p.qweight, p.scales, bits=4, group_size=128, zero_const=p.zero_const)
          for _ in range(3)]
    assert all(torch.equal(ys[0], y) for y in ys[1:])


def test_qmatmul_refuses_what_it_does_not_take(cuda_device):
    """No plain fallback on the card: an operand outside the contract raises."""
    rng = np.random.default_rng(5)
    p = post_init_module(random_quant_linear(rng, 256, 128, 4, device=cuda_device))
    x = _x(rng, 4, 256, cuda_device)
    with pytest.raises(TypeError):
        qmatmul(x.float(), p.qweight, p.scales, bits=4, group_size=128, zero_const=8.0)
    with pytest.raises(ValueError):
        qmatmul(x, p.qweight, p.scales, bits=4, group_size=128, zero_const=-1.0)


# K3: M = 1 one row tile, 8 the decode size, 64 four row tiles, 1024 the
# 32 x 32 tiles; g = -1 is one group over all of K
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("M", [1, 8, 64, 1024])
@pytest.mark.parametrize("g", [128, 256, -1])
def test_qmatmul_asym_kernel_matches_plain(cuda_device, bits, M, g):
    """Per-group zeros read from the v2 qzeros words: exact products and
    z*s, f32 sums in another order, one rounding to bf16: 1e-3 relative, and
    the same bits on every run."""
    rng = np.random.default_rng(bits * 1000 + M + g)
    K, N = 1024, 384
    p = post_init_module(random_quant_linear(rng, K, N, bits, g if g > 0 else K,
                                             device=cuda_device, sym=False))
    assert p.zero_const < 0
    x = _x(rng, M, K, cuda_device)
    args, kw = (x, p.qweight, p.scales, p.qzeros), dict(bits=bits, group_size=g)
    before = _build.LAUNCHES["qmatmul_asym"]
    y = qmatmul_asym(*args, **kw)
    ref = qmatmul_asym_plain(*args, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["qmatmul_asym"] == before + 1
    assert y.dtype == torch.bfloat16 and y.shape == (M, N)
    assert _rel(y, ref) <= 1e-3
    assert all(torch.equal(y, qmatmul_asym(*args, **kw)) for _ in range(2))


def test_qmatmul_asym_exact_inputs_give_equal_outputs(cuda_device):
    """Integer activations and power-of-two scales: every product, z*s and
    partial sum is exact, so kernel and plain version agree bit for bit."""
    rng = np.random.default_rng(17)
    K, N = 512, 256
    p = post_init_module(random_quant_linear(rng, K, N, 4, device=cuda_device, sym=False))
    p.scales = torch.from_numpy(2.0 ** rng.integers(-7, -4, p.scales.shape)).to(
        cuda_device).to(torch.float16)
    x = torch.from_numpy(rng.integers(-4, 5, (8, K)).astype(np.float32)).to(
        cuda_device).to(torch.bfloat16)
    args, kw = (x, p.qweight, p.scales, p.qzeros), dict(bits=4, group_size=128)
    assert torch.equal(qmatmul_asym(*args, **kw), qmatmul_asym_plain(*args, **kw))


def test_qmatmul_asym_refuses_what_it_does_not_take(cuda_device):
    """No plain fallback on the card: f32 rows, groups of 64, qzeros of the
    wrong shape and CPU zeros raise."""
    rng = np.random.default_rng(15)
    p = post_init_module(random_quant_linear(rng, 256, 128, 4, device=cuda_device, sym=False))
    x = _x(rng, 4, 256, cuda_device)
    kw = dict(bits=4, group_size=128)
    with pytest.raises(TypeError):
        qmatmul_asym(x.float(), p.qweight, p.scales, p.qzeros, **kw)
    with pytest.raises(ValueError):
        qmatmul_asym(x, p.qweight, p.scales, p.qzeros, bits=4, group_size=64)
    with pytest.raises(ValueError):
        qmatmul_asym(x, p.qweight, p.scales, p.qzeros[:, :-1].contiguous(), **kw)
    with pytest.raises(ValueError):
        qmatmul_asym(x, p.qweight, p.scales, p.qzeros.cpu(), **kw)


# ------------------------------------------------------------------- K6, K7

def _pow2_scales(rng, p, dev):
    return torch.from_numpy(2.0 ** rng.integers(-7, -4, p.scales.shape)).to(dev).to(
        torch.float16)


def _int_x(rng, M, K, dev):
    return torch.from_numpy(rng.integers(-4, 5, (M, K)).astype(np.float32)).to(dev).to(
        torch.bfloat16)


# K = 960 splits into 4-word steps unevenly between the 4 warps and is off
# the decode kernel's contract; M = 1 and 40 take the four-row-tile kernel,
# 256 the 32 x 32 tiles; g = 16 and 32 put two groups in one mma step at 2
# bits
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("M", [1, 40, 256])
@pytest.mark.parametrize("g,sym", [(32, True), (64, False), (16, False), (32, False)])
def test_qmm_kernel_matches_plain(cuda_device, bits, M, g, sym):
    """K6: each weight dequantized to ``bf16(bf16(c - z) * bf16(s))`` in both,
    exact products, f32 sums in another order, one rounding to bf16: 1e-3
    relative, and the same bits on every run."""
    rng = np.random.default_rng(bits * 1000 + M + g + sym)
    K, N = 960, 384
    p = post_init_module(random_quant_linear(rng, K, N, bits, g, device=cuda_device, sym=sym))
    assert (p.zero_const >= 0) == sym and registry.kernel_route(p) == "K6"
    x = _x(rng, M, K, cuda_device)
    args, kw = (x, p.qweight, p.scales, p.qzeros), dict(bits=bits, group_size=g,
                                                         zero_const=p.zero_const)
    before = _build.LAUNCHES["qmm"]
    y = qmm(*args, **kw)
    ref = qmm_plain(*args, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["qmm"] == before + 1
    assert y.dtype == torch.bfloat16 and y.shape == (M, N)
    assert _rel(y, ref) <= 1e-3
    assert all(torch.equal(y, qmm(*args, **kw)) for _ in range(2))


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("sym", [True, False])
def test_qmm_exact_inputs_give_equal_outputs(cuda_device, bits, sym):
    """Integer activations and power-of-two scales: every weight, product and
    partial sum is exact, so kernel and plain version agree bit for bit; a
    scale or zero of the wrong group or column would not."""
    rng = np.random.default_rng(27 + bits)
    K, N = 512, 256
    p = post_init_module(random_quant_linear(rng, K, N, bits, 32, device=cuda_device, sym=sym))
    p.scales = _pow2_scales(rng, p, cuda_device)
    x = _int_x(rng, 8, K, cuda_device)
    args, kw = (x, p.qweight, p.scales, p.qzeros), dict(bits=bits, group_size=32,
                                                         zero_const=p.zero_const)
    assert torch.equal(qmm(*args, **kw), qmm_plain(*args, **kw))


def test_qmm_refuses_what_it_does_not_take(cuda_device):
    """No plain fallback on the card: f32 rows, qzeros of the wrong shape, CPU
    operands and a group that splits a word (2 bits, g = 8) raise."""
    rng = np.random.default_rng(25)
    p = post_init_module(random_quant_linear(rng, 256, 128, 4, 32, device=cuda_device,
                                             sym=False))
    x = _x(rng, 4, 256, cuda_device)
    kw = dict(bits=4, group_size=32, zero_const=p.zero_const)
    with pytest.raises(TypeError):
        qmm(x.float(), p.qweight, p.scales, p.qzeros, **kw)
    with pytest.raises(ValueError):
        qmm(x, p.qweight, p.scales, p.qzeros[:, :-1].contiguous(), **kw)
    with pytest.raises(ValueError):
        qmm(x, p.qweight, p.scales.cpu(), p.qzeros, **kw)
    p2 = post_init_module(random_quant_linear(rng, 256, 128, 2, 16, device=cuda_device))
    with pytest.raises(ValueError, match="does not take"):
        qmm(x, p2.qweight, p2.scales, p2.qzeros, bits=2, group_size=8,
            zero_const=p2.zero_const)


@pytest.mark.parametrize("M,launched", [(1, "qmm"), (256, "qmm"), (300, "reference")])
def test_group32_module_routes_by_rows(cuda_device, M, launched):
    """A group-32 module runs K6 up to 256 rows and the counted
    dequantize-then-matmul reference above; both near the reference."""
    rng = np.random.default_rng(31 + M)
    p = post_init_module(random_quant_linear(rng, 1024, 384, 4, 32, device=cuda_device))
    x = _x(rng, M, 1024, cuda_device)
    _build.reset_counts()
    y = registry.qlinear_forward(p, x)
    assert _build.LAUNCHES == dict.fromkeys(_build.LAUNCHES, 0) | {launched: 1}
    assert _rel(y, qlinear_forward_torch(p, x)) <= 1e-3


# K6 at M <= 16 on the decode kernel: every group its route takes at 2, 4
# and 8 bits (16, 32, 64; 8 where it holds whole words), K = 896 (7 chunks,
# a cluster of 7 blocks, one chunk each), N = 384 (6 column tiles)
K6_DECODE_GROUPS = [(b, g) for b in (2, 4, 8) for g in (16, 32, 64)] + [(4, 8), (8, 8)]


@functools.lru_cache(maxsize=None)
def _k6_decode_module(bits, g, sym):
    rng = np.random.default_rng([60, bits, g, int(sym)])
    p = post_init_module(random_quant_linear(rng, 896, 384, bits, g, device="cuda", sym=sym))
    assert registry.kernel_route(p) == "K6" and (p.zero_const >= 0) == sym
    return p


def _k6_args(p):
    return (p.qweight, p.scales, p.qzeros), dict(bits=p.bits, group_size=p.group_size,
                                                 zero_const=p.zero_const)


def _kernel_names(fn):
    """The kernels the profiler saw in one call of ``fn`` (a session that
    lost every record is run again, three at most)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        if names:
            return names
    return []


@pytest.mark.parametrize("sym", [True, False])
@pytest.mark.parametrize("bits,g", K6_DECODE_GROUPS)
@pytest.mark.parametrize("M", [1, 8, 16])
def test_qmm_decode_kernel_matches_plain(cuda_device, M, bits, g, sym):
    """K6 at M <= 16 on the decode kernel: the same bf16 weights as
    ``qmm_plain``, exact products, f32 sums in another order, one rounding
    to bf16: 1e-3 relative, one counted launch a call, and the same bits on
    two more runs."""
    p = _k6_decode_module(bits, g, sym)
    x = _x(np.random.default_rng([M, bits, g]), M, p.in_features, cuda_device)
    args, kw = _k6_args(p)
    before = _build.LAUNCHES["qmm"]
    y = qmm(x, *args, **kw)
    ref = qmm_plain(x, *args, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["qmm"] == before + 1
    assert y.dtype == torch.bfloat16 and y.shape == (M, p.out_features)
    assert _rel(y, ref) <= 1e-3
    assert all(torch.equal(y, qmm(x, *args, **kw)) for _ in range(2))


@pytest.mark.parametrize("sym", [True, False])
@pytest.mark.parametrize("bits,g", [(2, 16), (4, 8), (4, 32), (8, 8), (8, 64)])
@pytest.mark.parametrize("M", [1, 9, 16])
def test_qmm_decode_exact_inputs_give_equal_outputs(cuda_device, M, bits, g, sym):
    """Integer activations and power-of-two scales: every weight, product
    and sum is exact, so the decode kernel and ``qmm_plain`` agree bit for
    bit; a scale or zero of the wrong group, chunk or column would not."""
    rng = np.random.default_rng([61, M, bits, g])
    p = dataclasses.replace(_k6_decode_module(bits, g, sym))
    p.scales = _pow2_scales(rng, p, cuda_device)
    args, kw = _k6_args(p)
    x = _int_x(rng, M, p.in_features, cuda_device)
    assert torch.equal(qmm(x, *args, **kw), qmm_plain(x, *args, **kw))


def test_qmm_decode_refuses_a_split_or_pointers_it_does_not_take(cuda_device, monkeypatch):
    """K6's C entry refuses a cluster split past its 7 chunks; a module built
    from an unaligned view of its weights or scales raises at M <= 16."""
    from gptqmodel_tpu_torch.ops import qmatmul as qmatmul_mod

    p = _k6_decode_module(4, 32, False)
    args, kw = _k6_args(p)
    x = _x(np.random.default_rng(62), 8, p.in_features, cuda_device)
    plan = qmatmul_mod.decode_plan
    for split in (8, 9):
        monkeypatch.setattr(qmatmul_mod, "decode_plan",
                            lambda *a, s=split: dataclasses.replace(plan(*a), split=s))
        with pytest.raises(ValueError, match="unsupported"):
            qmm(x, *args, **kw)
    monkeypatch.undo()
    for view in (dataclasses.replace(p, qweight=_unaligned(p.qweight)),
                 dataclasses.replace(p, scales=_unaligned(p.scales))):
        with pytest.raises(ValueError, match="aligned"):
            qmm(x, *_k6_args(view)[0], **kw)


# (M, K, g) -> the kernel K6's plan names: the decode kernel's DequantFirst
# instantiation, or the register tile for a group that does not divide 128,
# K not a whole number of chunks, or more than 16 rows
K6_ROUTES = {"decode_m1": (1, 896, 32, "qmm_decode_kernel<"),
             "decode_m16_g64": (16, 4096, 64, "qmm_decode_kernel<"),
             "tile_k960": (8, 960, 32, "qmm_kernel<"), "tile_g48": (8, 960, 48, "qmm_kernel<"),
             "tile_m40": (40, 896, 32, "qmm_kernel<")}


@pytest.mark.parametrize("case", list(K6_ROUTES))
def test_qmm_runs_the_kernel_its_plan_names(cuda_device, case):
    M, K, g, kernel = K6_ROUTES[case]
    rng = np.random.default_rng([63, M, K, g])
    p = post_init_module(random_quant_linear(rng, K, 256, 4, g, device=cuda_device, sym=False))
    args, kw = _k6_args(p)
    x = _x(rng, M, K, cuda_device)
    names = _kernel_names(lambda: qmm(x, *args, **kw))
    assert names and all(kernel in n for n in names), names
    assert all("DequantFirst" in n for n in names) == kernel.startswith("qmm_decode")
    assert _rel(qmm(x, *args, **kw), qmm_plain(x, *args, **kw)) <= 1e-3


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("M,N", [(1, 384), (5, 384), (40, 384), (100, 384), (100, 392)])
def test_qmatmul_fused_kernel_matches_plain(cuda_device, bits, M, N):
    """K7: ``x * bf16(c * s)`` summed, one zero correction per group; the
    same weights and exact products in both, f32 sums in another order:
    1e-3 relative, and the same bits on every run."""
    rng = np.random.default_rng(bits * 100 + M + N)
    K = 1024
    p = post_init_module(random_quant_linear(rng, K, N, bits, device=cuda_device))
    x = _x(rng, M, K, cuda_device)
    kw = dict(bits=bits, group_size=128, zero_const=p.zero_const)
    before = _build.LAUNCHES["qmatmul_fused"]
    y = qmatmul_fused(x, p.qweight, p.scales, **kw)
    ref = qmatmul_fused_plain(x, p.qweight, p.scales, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["qmatmul_fused"] == before + 1
    assert y.dtype == torch.bfloat16 and y.shape == (M, N)
    assert _rel(y, ref) <= 1e-3
    assert all(torch.equal(y, qmatmul_fused(x, p.qweight, p.scales, **kw)) for _ in range(2))


def test_qmatmul_fused_exact_inputs_give_equal_outputs(cuda_device):
    rng = np.random.default_rng(37)
    p = post_init_module(random_quant_linear(rng, 512, 256, 4, device=cuda_device))
    p.scales = _pow2_scales(rng, p, cuda_device)
    x = _int_x(rng, 8, 512, cuda_device)
    kw = dict(bits=4, group_size=128, zero_const=p.zero_const)
    assert torch.equal(qmatmul_fused(x, p.qweight, p.scales, **kw),
                       qmatmul_fused_plain(x, p.qweight, p.scales, **kw))


def test_qmatmul_fused_refuses_what_it_does_not_take(cuda_device):
    """f32 rows, groups of 64, per-group zeros and CPU scales raise."""
    rng = np.random.default_rng(35)
    p = post_init_module(random_quant_linear(rng, 256, 128, 4, device=cuda_device))
    x = _x(rng, 4, 256, cuda_device)
    kw = dict(bits=4, group_size=128, zero_const=p.zero_const)
    with pytest.raises(TypeError):
        qmatmul_fused(x.float(), p.qweight, p.scales, **kw)
    with pytest.raises(ValueError):
        qmatmul_fused(x, p.qweight, p.scales, bits=4, group_size=64, zero_const=8.0)
    with pytest.raises(ValueError):
        qmatmul_fused(x, p.qweight, p.scales, bits=4, group_size=128, zero_const=-1.0)
    with pytest.raises(ValueError):
        qmatmul_fused(x, p.qweight, p.scales.cpu(), **kw)


# ------------------------------------------- K1, K3 and K7 at decode (M <= 16)

# (K, N, g): 7 groups over a ragged last column tile (N = 200, or 208 for
# 2-bit K3, whose zeros rows need N % 16 == 0), one group, and Llama-3-8B's
# qkv and down; M = 1..8 one n-tile of tokens, 9 and 16 two
DECODE_SHAPES = {"seven_groups_ragged": (896, 200, 128), "one_group": (128, 384, 128),
                 "qkv": (4096, 6144, 128), "down": (14336, 4096, 128)}
DECODE_MS = [1, 2, 7, 8, 9, 16]


@functools.lru_cache(maxsize=None)
def _decode_module(kernel, bits, shape):
    K, N, g = DECODE_SHAPES[shape]
    sym = kernel != "qmatmul_asym"
    N += 8 if N * bits % 32 else 0
    rng = np.random.default_rng([bits, K, N, int(sym)])
    return post_init_module(random_quant_linear(rng, K, N, bits, g, device="cuda", sym=sym))


def _decode_fns(kernel, p):
    if kernel == "qmatmul_asym":
        args, kw = (p.qweight, p.scales, p.qzeros), dict(bits=p.bits, group_size=p.group_size)
        return (lambda x: qmatmul_asym(x, *args, **kw),
                lambda x: qmatmul_asym_plain(x, *args, **kw))
    args = (p.qweight, p.scales)
    kw = dict(bits=p.bits, group_size=p.group_size, zero_const=p.zero_const)
    run, plain = ((qmatmul_fused, qmatmul_fused_plain) if kernel == "qmatmul_fused"
                  else (qmatmul, qmatmul_plain))
    return lambda x: run(x, *args, **kw), lambda x: plain(x, *args, **kw)


DECODE_KERNELS = ["qmatmul_asym", "qmatmul_fused", "qmatmul"]


@pytest.mark.parametrize("shape", list(DECODE_SHAPES))
@pytest.mark.parametrize("M", DECODE_MS)
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("kernel", DECODE_KERNELS)
def test_decode_kernel_matches_plain(cuda_device, kernel, bits, M, shape):
    """K1, K3 and K7 at M <= 16 run the decode kernel (cluster split along
    K, shared-memory ring): exact products, f32 sums in another order, one
    rounding to bf16: 1e-3 relative, and the same bits on every run."""
    p = _decode_module(kernel, bits, shape)
    x = _x(np.random.default_rng([M, bits]), M, p.in_features, cuda_device)
    run, plain = _decode_fns(kernel, p)
    before = _build.LAUNCHES[kernel]
    y = run(x)
    ref = plain(x)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[kernel] == before + 1
    assert y.dtype == torch.bfloat16 and y.shape == (M, p.out_features)
    assert _rel(y, ref) <= 1e-3
    assert torch.equal(y, run(x))


@pytest.mark.parametrize("M", [1, 9, 16])
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("kernel", DECODE_KERNELS)
def test_decode_kernel_exact_inputs_give_equal_outputs(cuda_device, kernel, bits, M):
    """Integer activations and power-of-two scales over 7 groups and a
    ragged column tile: every product and sum is exact, so the decode
    kernel and the plain version agree bit for bit."""
    rng = np.random.default_rng([41, bits, M])
    p = dataclasses.replace(_decode_module(kernel, bits, "seven_groups_ragged"))
    p.scales = _pow2_scales(rng, p, cuda_device)
    run, plain = _decode_fns(kernel, p)
    x = _int_x(rng, M, p.in_features, cuda_device)
    assert torch.equal(run(x), plain(x))


def _unaligned(t):
    """A copy of ``t`` that starts 4 bytes past a 16-byte boundary."""
    shifted = torch.empty(t.numel() + 4 // t.element_size(), dtype=t.dtype, device=t.device)
    out = shifted[4 // t.element_size():].view_as(t)
    out.copy_(t)
    return out


def test_decode_kernel_refuses_a_split_or_pointers_it_does_not_take(cuda_device, monkeypatch):
    """K3's, K1's and K2's C entries refuse a cluster split outside
    1 .. min(8, K / g) (K2: of either pass); an unaligned weight or scale
    pointer raises before the launch."""
    from gptqmodel_tpu_torch.ops import qmatmul as qmatmul_mod

    x = _x(np.random.default_rng(43), 8, 896, cuda_device)
    gu, down = _mlp(np.random.default_rng(44), 896, 384, 4, cuda_device)  # 7 and 3 groups
    mlp = lambda x, gu=gu: qmlp(x, gu.qweight, gu.scales, down.qweight, down.scales, bits=4,
                                group_size=128, zc_gu=gu.zero_const, zc_d=down.zero_const)
    runs = [_decode_fns(kernel, _decode_module(kernel, 4, "seven_groups_ragged"))[0]
            for kernel in ("qmatmul_asym", "qmatmul")] + [mlp]
    plan = qmatmul_mod.decode_plan
    for split in (0, 4, 8, 9):  # 7 groups (K2's down: 3, so 4 too)
        monkeypatch.setattr(qmatmul_mod, "decode_plan",
                            lambda *a, s=split: dataclasses.replace(plan(*a), split=s))
        for run in runs if split != 4 else runs[2:]:
            with pytest.raises(ValueError, match="unsupported"):
                run(x)
    monkeypatch.undo()
    p = _decode_module("qmatmul_asym", 4, "seven_groups_ragged")
    with pytest.raises(ValueError, match="aligned"):
        qmatmul_asym(x, p.qweight, _unaligned(p.scales), p.qzeros, bits=4, group_size=128)
    p = _decode_module("qmatmul", 4, "seven_groups_ragged")
    for qweight, scales in ((_unaligned(p.qweight), p.scales), (p.qweight, _unaligned(p.scales))):
        with pytest.raises(ValueError, match="aligned"):
            qmatmul(x, qweight, scales, bits=4, group_size=128, zero_const=p.zero_const)
    with pytest.raises(ValueError, match="aligned"):
        mlp(x, dataclasses.replace(gu, scales=_unaligned(gu.scales)))


def test_group32_facade_runs_k6(cuda_device, tmp_path, monkeypatch):
    """load -> optimize -> generate of a group-32 checkpoint: the prefill of
    300 rows on the counted reference route, every decode step's four
    projections per layer on K6, no K1, K2 or K3; the logits of decode-sized
    forwards near the plain path's."""
    write_random_gptq_checkpoint(tmp_path, TINY_LLAMA, seed=3, group_size=32)
    model = GPTQModel.load(tmp_path).optimize()
    L, B, T, new = 2, 3, 100, 5
    ids = np.random.default_rng(4).integers(0, 1024, (B, T))
    _build.reset_counts()
    tokens = model.generate(ids, max_new_tokens=new)
    assert tokens.shape == (B, new) and ((tokens >= 0) & (tokens < 1024)).all()
    assert _build.LAUNCHES == dict.fromkeys(_build.LAUNCHES, 0) | {
        "reference": 4 * L, "qmm": 4 * L * (new - 1)}
    ids_t = torch.as_tensor(ids[:, :8], device=cuda_device)  # 24 rows: K6
    with torch.inference_mode():
        got = transformer.forward_logits(model.spec, model.params, ids_t, torch.bfloat16)
        monkeypatch.setattr(registry, "qmm", qmm_plain)
        ref = transformer.forward_logits(model.spec, model.params, ids_t, torch.bfloat16)
    assert torch.isfinite(got).all()
    assert _rel(got, ref) <= 1e-2


def test_rt_fused_facade_runs_k7(cuda_device, tmp_path, monkeypatch):
    """Under ``GPTQ_TPU_RT_FUSED=1`` the llama path runs K7 where it ran K1:
    4 per layer in the prefill, 2 per layer and K2 once per layer in each
    decode step; the logits near the plain path's."""
    write_random_gptq_checkpoint(tmp_path, TINY_LLAMA, seed=5)
    monkeypatch.setenv("GPTQ_TPU_RT_FUSED", "1")
    model = GPTQModel.load(tmp_path).optimize()
    L, B, T, new = 2, 3, 32, 5
    ids = np.random.default_rng(6).integers(0, 1024, (B, T))
    _build.reset_counts()
    tokens = model.generate(ids, max_new_tokens=new)
    assert tokens.shape == (B, new)
    assert _build.LAUNCHES == dict.fromkeys(_build.LAUNCHES, 0) | {
        "qmatmul_fused": 4 * L + 2 * L * (new - 1), "qmlp": L * (new - 1)}
    ids_t = torch.as_tensor(ids, device=cuda_device)
    with torch.inference_mode():
        got = transformer.forward_logits(model.spec, model.params, ids_t, torch.bfloat16)
        monkeypatch.setattr(registry, "qmatmul_fused", qmatmul_fused_plain)
        ref = transformer.forward_logits(model.spec, model.params, ids_t, torch.bfloat16)
    assert torch.isfinite(got).all()
    assert _rel(got, ref) <= 1e-2


@pytest.mark.parametrize("sym,kernel", [(True, "qmatmul"), (False, "qmatmul_asym")])
@pytest.mark.parametrize("M", [1, 300])
def test_act_order_module_runs_its_kernel(cuda_device, sym, kernel, M):
    """A balanced act-order module, its rows permuted at post-init on the
    card: K1 (symmetric) or K3 after the x-column gather, at decode and
    prefill sizes, against the dequantize-then-matmul reference on the
    module as loaded (bf16 weights there): 1e-2 relative."""
    rng = np.random.default_rng(21 + M)
    K, N = 1024, 256
    loaded = random_quant_linear(rng, K, N, 4, device=cuda_device, sym=sym,
                                 perm=rng.permutation(K))
    p = post_init_module(loaded)
    assert p.act_perm is not None and p.act_perm.device.type == "cuda"
    x = _x(rng, M, K, cuda_device)
    _build.reset_counts()
    y = registry.qlinear_forward(p, x)
    assert _build.LAUNCHES == dict.fromkeys(_build.LAUNCHES, 0) | {kernel: 1}
    ref = qlinear_forward_torch(loaded, x)
    assert _rel(y, ref) <= 1e-2


def test_asym_act_order_facade_runs_k3(cuda_device, tmp_path, monkeypatch):
    """load -> optimize -> generate of a checkpoint written with
    ``sym=False, desc_act=True``: K3 four times per layer (fused qkv, o,
    fused gate_up, down) in the prefill and in every decode step, no K1 or
    K2; the logits near the plain path's."""
    write_random_gptq_checkpoint(tmp_path, TINY_LLAMA, seed=1, sym=False, desc_act=True)
    model = GPTQModel.load(tmp_path).optimize()
    L, B, T, new = 2, 3, 32, 5
    ids = np.random.default_rng(2).integers(0, 1024, (B, T))
    _build.reset_counts()
    tokens = model.generate(ids, max_new_tokens=new)
    assert tokens.shape == (B, new) and ((tokens >= 0) & (tokens < 1024)).all()
    assert _build.LAUNCHES == dict.fromkeys(_build.LAUNCHES, 0) | {"qmatmul_asym": 4 * L * new}
    ids_t = torch.as_tensor(ids, device=cuda_device)
    with torch.inference_mode():
        got = transformer.forward_logits(model.spec, model.params, ids_t, torch.bfloat16)
        monkeypatch.setattr(registry, "qmatmul_asym", qmatmul_asym_plain)
        ref = transformer.forward_logits(model.spec, model.params, ids_t, torch.bfloat16)
    assert torch.isfinite(got).all()
    assert _rel(got, ref) <= 1e-2


def _mlp(rng, D, F, bits, dev):
    from gptqmodel_tpu_torch.models.optimize import _concat_quant

    gate, up = (post_init_module(random_quant_linear(rng, D, F, bits, device=dev))
                for _ in range(2))
    down = post_init_module(random_quant_linear(rng, F, D, bits, device=dev))
    return _concat_quant([gate, up]), down


# K2 on a small MLP, Llama-3-8B's, and a narrow one whose 12 gate/up tiles
# leave most of the card idle: M <= 16 on the decode kernel (1..8 one n-tile
# of tokens, 9 and 16 two), 40 and 64 on the register tiles
QMLP_SHAPES = {"small": (512, 1024), "llama3_8b": (4096, 14336), "narrow": (1024, 384)}


@functools.lru_cache(maxsize=None)
def _qmlp_modules(bits, shape):
    D, F = QMLP_SHAPES[shape]
    return _mlp(np.random.default_rng([bits, D, F]), D, F, bits, torch.device("cuda"))


@pytest.mark.parametrize("shape", list(QMLP_SHAPES))
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("M", [1, 8, 9, 16, 40, 64])
def test_qmlp_kernel_matches_plain(cuda_device, bits, M, shape):
    """g and u in f32, inner rounded to bf16 in both; f32 summation order can
    flip a rounding of inner: 2e-3 relative in norm, one launch, and the same
    bits on two more runs."""
    D, F = QMLP_SHAPES[shape]
    gu, down = _qmlp_modules(bits, shape)
    x = _x(np.random.default_rng(bits * 100 + M), M, D, cuda_device)
    args = (x, gu.qweight, gu.scales, down.qweight, down.scales)
    kw = dict(bits=bits, group_size=128, zc_gu=gu.zero_const, zc_d=down.zero_const)
    before = _build.LAUNCHES["qmlp"]
    y = qmlp(*args, **kw)
    ref = qmlp_plain(*args, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["qmlp"] == before + 1
    assert y.dtype == torch.bfloat16 and y.shape == (M, D)
    assert _rel(y, ref) <= 2e-3
    assert all(torch.equal(y, qmlp(*args, **kw)) for _ in range(2))


def test_facade_runs_the_kernels(cuda_device, tmp_path, monkeypatch):
    """load -> optimize -> generate on the default device: the launch counts of
    one prefill and of the decode steps, and logits near the plain path's."""
    write_random_gptq_checkpoint(tmp_path, TINY_LLAMA, seed=1)
    model = GPTQModel.load(tmp_path).optimize()
    assert model.device.type == "cuda"
    L, B, T, new = 2, 3, 32, 5  # a prefill of 96 rows runs the MLP unfused
    ids = np.random.default_rng(2).integers(0, 1024, (B, T))
    _build.reset_counts()
    tokens = model.generate(ids, max_new_tokens=new)
    assert tokens.shape == (B, new) and ((tokens >= 0) & (tokens < 1024)).all()
    steps = new - 1
    assert _build.LAUNCHES == dict.fromkeys(_build.LAUNCHES, 0) | {
        "qmatmul": 4 * L + 2 * L * steps, "qmlp": L * steps}

    ids_t = torch.as_tensor(ids, device=cuda_device)
    with torch.inference_mode():
        got = transformer.forward_logits(model.spec, model.params, ids_t, torch.bfloat16)
        monkeypatch.setattr(registry, "qmatmul", qmatmul_plain)
        monkeypatch.setattr(registry, "qmlp", qmlp_plain)
        ref = transformer.forward_logits(model.spec, model.params, ids_t, torch.bfloat16)
    assert torch.isfinite(got).all()
    # bf16 activations: one-ulp flips of rounded products carried through 2 layers
    assert _rel(got, ref) <= 1e-2


def _solve_case(seed, out_f, in_f, dev, rows=2048):
    """W ~ N(0, 0.02) and the inverse factor of a Hessian of seeded
    activations, as the quantize loop builds them."""
    rng = np.random.default_rng(seed)
    W = torch.from_numpy(rng.standard_normal((out_f, in_f), dtype=np.float32) * 0.02).to(dev)
    X = torch.from_numpy(rng.standard_normal((rows, in_f), dtype=np.float32)).to(dev)
    U, _ = hessian_inverse((2.0 / rows) * (X.T @ X), 0.01)
    return W, U


# the JAX package's tolerances for its K8 against the XLA scan
# (tests/test_pallas_gptq.py): only the trailing product's f32 sums differ
# shapes at the edges of K8's tiling beside the two first ones: one row, one
# 32-row tile plus one and a part pass of 384 columns, rows that are no
# multiple of 32 and a single block (no trailing update)
@pytest.mark.parametrize("out_f,in_f", [(72, 512), (4096, 4096), (1, 256), (33, 640),
                                        (100, 128)])
@pytest.mark.parametrize("group_size,sym", [(128, True), (64, False), (16, True), (-1, True),
                                            (128, False), (16, False), (-1, False)])
def test_gptq_whole_solve_matches_plain(cuda_device, out_f, in_f, group_size, sym):
    W, U = _solve_case(out_f + group_size, out_f, in_f, cuda_device)
    g = in_f if group_size == -1 else group_size
    SP = ZP = None
    if group_size == -1:  # per channel: static tables, as gptq_solve_core makes them
        s, z = _params_from_range(*_minmax(W, sym), 15, sym)
        SP, ZP = (t[:, None].expand(out_f, in_f).contiguous() for t in (s, z))
    kw = dict(maxq=15, group_size=g, sym=sym)
    before = _build.LAUNCHES["gptq_whole_solve"]
    Q, Dq, L, s_out, z_out = gptq_whole_solve(W, U, SP, ZP, **kw)
    Q2 = gptq_whole_solve(W, U, SP, ZP, **kw)[0]
    rQ, rDq, rL, rs, rz = gptq_whole_solve_plain(W, U, SP, ZP, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["gptq_whole_solve"] == before + 2
    assert torch.equal(Q, Q2)  # no atomics: the same codes every run
    assert float((Q != rQ).float().mean()) < 2e-3
    torch.testing.assert_close(Dq, rDq, rtol=1e-4, atol=2e-4)
    assert abs(float(L.sum() / rL.sum()) - 1) < 1e-3
    if SP is None:
        torch.testing.assert_close(s_out, rs, rtol=1e-5, atol=0)
        torch.testing.assert_close(z_out, rz, rtol=0, atol=0)


# K8 holds each row to the same float32 sequence wherever it sits in the
# 32-row tiles (csrc/gptq_solve.cu, "The invariant"): a few rows solved alone
# equal the same rows of a wider solve. Down's 112 blocks at a small row count
# are held this way: the plain version's other trailing sum order moves more
# than 2e-3 of so few rows' codes, for this kernel and its parent alike.
@pytest.mark.parametrize("out_f,in_f", [(1, 14336), (8, 14336), (33, 640), (100, 128)])
@pytest.mark.parametrize("group_size,sym", [(128, True), (64, False), (16, True), (-1, True)])
def test_gptq_whole_solve_rows_match_a_wider_solve(cuda_device, out_f, in_f, group_size,
                                                   sym):
    W, U = _solve_case(out_f + group_size + 7, out_f + 64, in_f, cuda_device)
    g = in_f if group_size == -1 else group_size
    kw = dict(maxq=15, group_size=g, sym=sym)
    tables = [None, None]
    if group_size == -1:
        s, z = _params_from_range(*_minmax(W, sym), 15, sym)
        tables = [t[:, None].expand(W.shape[0], in_f).contiguous() for t in (s, z)]
    wide = gptq_whole_solve(W, U, *tables, **kw)
    few = gptq_whole_solve(W[:out_f].contiguous(), U,
                           *[None if t is None else t[:out_f].contiguous() for t in tables],
                           **kw)
    torch.cuda.synchronize()
    for a, b in zip(few[:3], wide[:3]):  # Q, Dq, L
        assert torch.equal(a, b[:out_f])
    if group_size != -1:
        for a, b in zip(few[3:], wide[3:]):  # scales and zeros, [groups, out]
            assert torch.equal(a, b[:, :out_f])


@pytest.mark.parametrize("out_f", [40, 28672, 1, 33, 100, 4096])
def test_gptq_block_inner_matches_plain(cuda_device, out_f):
    """The column loop rounds and orders as the plain version does: equal."""
    W, U = _solve_case(out_f, out_f, 128, cuda_device)
    s, z = _params_from_range(*_minmax(W, True), 15, True)
    S, Z = (t[:, None].expand(out_f, 128).contiguous() for t in (s, z))
    before = _build.LAUNCHES["gptq_block_inner"]
    got = gptq_block_inner(W, U, S, Z, maxq=15)
    ref = gptq_block_inner_plain(W, U, S, Z, maxq=15)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["gptq_block_inner"] == before + 1
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_gptq_solve_routes_on_the_card(cuda_device, monkeypatch):
    """K8 by default, K9 per block with GPTQ_TPU_SOLVER=pallas; any other
    value, or a group outside K8's contract, raises: no plain path."""
    W, U = _solve_case(9, 64, 512, cuda_device)
    kw = dict(bits=4, group_size=128, sym=True)
    _build.reset_counts()
    mega = gptq_solve_core(W, U, **kw)
    assert _build.LAUNCHES["gptq_whole_solve"] == 1
    monkeypatch.setenv("GPTQ_TPU_SOLVER", "pallas")
    blocks = gptq_solve_core(W, U, **kw)
    assert _build.LAUNCHES["gptq_block_inner"] == 4
    assert float((mega["Q"] != blocks["Q"]).float().mean()) < 2e-3
    monkeypatch.setenv("GPTQ_TPU_SOLVER", "xla")
    with pytest.raises(ValueError):
        gptq_solve_core(W, U, **kw)
    monkeypatch.delenv("GPTQ_TPU_SOLVER")
    with pytest.raises(NotImplementedError):
        gptq_solve_core(W, U, bits=4, group_size=256, sym=True)


# --------------------------------------------------------------- K10-K13

def _stacks(rng, E, D, F, bits, dev, group_size=128):
    """A fused gate|up stack and a down stack of E random experts."""
    mods = {n: [post_init_module(random_quant_linear(rng, i, o, bits, group_size, device=dev))
                for _ in range(E)]
            for n, (i, o) in (("gate", (D, F)), ("up", (D, F)), ("down", (F, D)))}
    st = {n: qmoe.stack_packed_experts(m) for n, m in mods.items()}
    return qmoe.fuse_gate_up(st["gate"], st["up"]), st["down"]


def _routes(rng, N, E, k, dev):
    logits = torch.from_numpy(rng.standard_normal((N, E), dtype=np.float32)).to(dev)
    top_w, top_i = transformer._topk(torch.softmax(logits, -1), k)
    return top_w / top_w.sum(-1, keepdim=True), top_i


@pytest.mark.parametrize("N,E", [(16, 32), (1024, 128), (8, 5000)])
def test_topk_breaks_ties_to_the_lower_index(cuda_device, N, E):
    """``_topk`` on the card keeps ``lax.top_k``'s order, equal values in
    index order, and equals ``_topk`` on the CPU and numpy's stable argsort,
    with router-width rows and one row wide enough for another sort."""
    rng = np.random.default_rng(N + E)
    x = rng.standard_normal((N, E)).astype(np.float32)
    x[:, 5] = x[:, 1]
    x[:, 9] = x[:, 1]
    x[:, E - 1] = x[:, 1]
    x[:3] = 0.25  # whole rows of ties
    order = np.argsort(-x, axis=-1, kind="stable")
    for k in (2, 8):
        v, i = transformer._topk(torch.from_numpy(x).to(cuda_device), k)
        cv, ci = transformer._topk(torch.from_numpy(x), k)
        np.testing.assert_array_equal(i.cpu().numpy(), order[:, :k])
        np.testing.assert_array_equal(i.cpu().numpy(), ci.numpy())
        np.testing.assert_array_equal(v.cpu().numpy(), cv.numpy())


def _bm(M):
    return 8 if M <= 128 else (16 if M <= 1024 else 32)


def _e2e(x, top_w, top_i, gu, down, bm, fn=qmoe.qmoe_mlp_e2e):
    N, k = top_i.shape
    E = gu.qweight.shape[0]
    ids, counts, row_pos = qmoe.plan_rows(top_i.reshape(-1), E, bm,
                                          qmoe.slot_bound(N * k, E, bm))
    ops = qmoe.e2e_operands(row_pos.reshape(N, k), top_w, counts, bm)
    return fn(x, ids, *ops, gu.qweight, gu.scales, down.qweight, down.scales, bits=gu.bits,
              G_gu=gu.G, G_d=down.G, F=gu.out_features // 2, bm=bm, zc_gu=gu.zero_const,
              zc_d=down.zero_const, rt_gu=gu.rt, rt_d=down.rt)


# (N, k, bm): decode at 8 rows a slot (N = 1 and 8), the same rows at 16, 40
# tokens at 24 and 300 at 32: one n-tile of the ring per 8 rows of a slot
E2E_CASES = [(1, 8, 8), (8, 8, 8), (8, 8, 16), (40, 4, 24), (300, 4, 32)]
# (rt_gu, rt_d): every pair of contracts K10's C entry takes
E2E_CONTRACTS = [(True, True), (False, False), (True, False), (False, True)]


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("rt", E2E_CONTRACTS)
@pytest.mark.parametrize("N,k,bm", E2E_CASES)
def test_qmoe_e2e_kernel_matches_plain(cuda_device, bits, rt, N, k, bm):
    """K10 against its plain version: the same exact products in both
    contracts, f32 sums in another order, inner rounded to bf16 in both:
    2e-3 relative in norm. Two runs give the same bits."""
    rng = np.random.default_rng([bits, N, k, bm, *rt])
    E, D, F = 16, 512, 256
    gu, down = _stacks(rng, E, D, F, bits, cuda_device)
    gu, down = dataclasses.replace(gu, rt=rt[0]), dataclasses.replace(down, rt=rt[1])
    x = _x(rng, N, D, cuda_device)
    top_w, top_i = _routes(rng, N, E, k, cuda_device)
    before = _build.LAUNCHES["qmoe_e2e"]
    y = _e2e(x, top_w, top_i, gu, down, bm)
    ref = _e2e(x, top_w, top_i, gu, down, bm, qmoe.qmoe_mlp_e2e_plain)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["qmoe_e2e"] == before + 1
    assert y.dtype == torch.bfloat16 and y.shape == (N, D)
    assert _rel(y, ref) <= 2e-3
    assert torch.equal(y, _e2e(x, top_w, top_i, gu, down, bm))


# routes that the slot plan meets at its edges: one token with one route (a
# slot of one row and bm - 1 padding rows, tok -1 and w 0), every token on
# one expert (whole slots, the last one part-filled), and the stack's last
# expert beside others
EDGE_ROUTES = {"one_row_slot": lambda rng, E: np.array([[3]]),
               "one_expert": lambda rng, E: np.full((40, 1), 5),
               "last_expert": lambda rng, E: np.stack(
                   [np.full(12, E - 1), rng.integers(0, E - 1, 12)], 1)}


@pytest.mark.parametrize("bm", [8, 32])
@pytest.mark.parametrize("rt", [True, False])
@pytest.mark.parametrize("case", list(EDGE_ROUTES))
def test_qmoe_e2e_edge_routes_match_plain(cuda_device, case, rt, bm):
    rng = np.random.default_rng([bm, int(rt), len(case)])
    E, D, F = 16, 512, 256
    gu, down = _stacks(rng, E, D, F, 4, cuda_device)
    gu, down = dataclasses.replace(gu, rt=rt), dataclasses.replace(down, rt=rt)
    top_i = torch.from_numpy(EDGE_ROUTES[case](rng, E)).to(cuda_device)
    N, k = top_i.shape
    top_w = torch.full((N, k), 1.0 / k, device=cuda_device)
    x = _x(rng, N, D, cuda_device)
    y = _e2e(x, top_w, top_i, gu, down, bm)
    ref = _e2e(x, top_w, top_i, gu, down, bm, qmoe.qmoe_mlp_e2e_plain)
    assert torch.isfinite(y).all() and _rel(y, ref) <= 2e-3
    assert torch.equal(y, _e2e(x, top_w, top_i, gu, down, bm))


def _stack_of(codes, scales, bits, zc):
    """A stack from integer codes [E, K, N] and float32 scales [E, G, N]
    (the groups padded to 8, bf16), symmetric, ic contract."""
    E, K, N = codes.shape
    G = scales.shape[1]
    qw = torch.stack([pack_qweight(torch.from_numpy(c.astype(np.int32)), bits) for c in codes])
    sc = torch.zeros((E, max(8, G), N), dtype=torch.float32)
    sc[:, :G] = torch.from_numpy(scales)
    return qmoe.StackedQuantExperts(qweight=qw, scales=sc.to(torch.bfloat16), bits=bits, G=G,
                                    zero_const=float(zc), in_features=K, out_features=N)


@pytest.mark.parametrize("bm", [8, 32])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_qmoe_e2e_ic_dequantizes_to_bf16_of_q_minus_zc_times_s(cuda_device, bits, bm):
    """The ic contract on the ring is K6's dequantization, bf16(bf16(c - zc)
    * s): for bf16 scales it is bf16((q - zc) * s) bit for bit. Each token's
    x is one-hot, so gate|up read one weight row; gate codes above zc and
    scales of 20-40 make silu(g) = g in f32; up codes are zc but in one
    column, so inner is one-hot and y is one product of two bf16 values. No
    sum rounds, and the float32 output must equal the formula's bits."""
    rng = np.random.default_rng([bits, bm, 77])
    E, D, F, N = 4, 256, 128, 6
    zc, maxq = 2 ** (bits - 1), 2 ** bits - 1
    qg = rng.integers(zc + 1, maxq + 1, (E, D, F))
    qu = np.full((E, D, F), zc)
    f0 = rng.integers(0, F, E)
    others = np.array([c for c in range(maxq + 1) if c != zc])
    qu[np.arange(E), :, f0] = rng.choice(others, (E, D))
    qd = rng.integers(0, maxq + 1, (E, F, D))
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16).float().numpy()
    sg, su = bf(rng.uniform(20, 40, (E, D // 128, F))), bf(rng.uniform(0.5, 2, (E, D // 128, F)))
    sd = bf(rng.uniform(0.01, 0.1, (E, 1, D)))
    gu = _stack_of(np.concatenate([qg, qu], 2), np.concatenate([sg, su], 2), bits, zc)
    down = _stack_of(qd, sd, bits, zc)
    gu, down = (dataclasses.replace(s, qweight=s.qweight.to(cuda_device),
                                    scales=s.scales.to(cuda_device)) for s in (gu, down))
    e, kk = rng.integers(0, E, N), rng.choice(D, N, replace=False)
    x = torch.zeros((N, D), dtype=torch.bfloat16, device=cuda_device)
    x[torch.arange(N), torch.from_numpy(kk)] = 1.0
    top_i = torch.from_numpy(e[:, None]).to(cuda_device)
    top_w = torch.ones((N, 1), device=cuda_device)
    ids, counts, row_pos = qmoe.plan_rows(top_i.reshape(-1), E, bm, qmoe.slot_bound(N, E, bm))
    ops = qmoe.e2e_operands(row_pos.reshape(N, 1), top_w, counts, bm)
    y = qmoe.qmoe_mlp_e2e(x, ids, *ops, gu.qweight, gu.scales, down.qweight, down.scales,
                          bits=bits, G_gu=gu.G, G_d=down.G, F=F, bm=bm, zc_gu=zc, zc_d=zc,
                          rt_gu=False, rt_d=False, out_dtype=torch.float32)
    rnd = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).float()
    g = rnd((qg[e, kk, f0[e]] - zc) * sg[e, kk // 128, f0[e]])
    u = rnd((qu[e, kk, f0[e]] - zc) * su[e, kk // 128, f0[e]])
    inner = rnd((g * u).numpy())
    w_d = rnd((qd[e, f0[e], :] - zc) * sd[e, 0, :])
    assert (g >= 20).all()
    assert torch.equal(y.cpu(), inner[:, None] * w_d)


def _kernel_names(run, calls: int = 4) -> set:
    """The CUDA kernels the profiler saw in ``calls`` calls of ``run``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
    return {e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


@pytest.mark.parametrize("rt", [True, False])
@pytest.mark.parametrize("N,bm", [(8, 8), (300, 32)])
def test_qmoe_e2e_runs_only_the_ring_and_the_combine(cuda_device, rt, N, bm):
    """By the profiler's kernel names, a K10 call runs its gate|up pass and
    its down pass on the decode ring (``qmm_decode_kernel`` with
    ``MoeGateUp`` and ``MoeDown``) and the combine, and nothing else."""
    rng = np.random.default_rng([N, bm, int(rt)])
    E, D, F, k = 16, 512, 256, 8
    gu, down = _stacks(rng, E, D, F, 4, cuda_device)
    gu, down = dataclasses.replace(gu, rt=rt), dataclasses.replace(down, rt=rt)
    x = _x(rng, N, D, cuda_device)
    top_w, top_i = _routes(rng, N, E, k, cuda_device)
    ids, counts, row_pos = qmoe.plan_rows(top_i.reshape(-1), E, bm,
                                          qmoe.slot_bound(N * k, E, bm))
    ops = qmoe.e2e_operands(row_pos.reshape(N, k), top_w, counts, bm)
    run = lambda: qmoe.qmoe_mlp_e2e(
        x, ids, *ops, gu.qweight, gu.scales, down.qweight, down.scales, bits=4, G_gu=gu.G,
        G_d=down.G, F=F, bm=bm, zc_gu=gu.zero_const, zc_d=down.zero_const, rt_gu=rt, rt_d=rt)
    run()
    names = _kernel_names(run)
    ring = lambda z: [n for n in names if "qmm_decode_kernel<" in n and z in n]
    assert len(ring("MoeGateUp")) == len(ring("MoeDown")) == 1
    assert [n for n in names if "qmoe_combine_kernel" in n]
    assert len(names) == 3, names


def test_qmoe_e2e_refuses_a_split_or_pointers_it_does_not_take(cuda_device, monkeypatch):
    """K10's C entry refuses a cluster split outside 1 .. min(8, K / g) of
    either pass (down: F = 256 is 2 groups); an unaligned qweight or scales
    raises before the launch."""
    rng = np.random.default_rng(45)
    E, D, F, N, k = 16, 512, 256, 8, 8
    gu, down = _stacks(rng, E, D, F, 4, cuda_device)
    x = _x(rng, N, D, cuda_device)
    top_w, top_i = _routes(rng, N, E, k, cuda_device)
    plan = qmoe.e2e_plan
    for split in (0, 3, 9):
        monkeypatch.setattr(qmoe, "e2e_plan",
                            lambda *a, s=split: dataclasses.replace(plan(*a), split=s))
        with pytest.raises(ValueError, match="unsupported"):
            _e2e(x, top_w, top_i, gu, down, 8)
    monkeypatch.undo()
    for bad in (dataclasses.replace(gu, qweight=_unaligned(gu.qweight)),
                dataclasses.replace(gu, scales=_unaligned(gu.scales))):
        with pytest.raises(ValueError, match="aligned"):
            _e2e(x, top_w, top_i, bad, down, 8)
    with pytest.raises(ValueError, match="aligned"):
        _e2e(x, top_w, top_i, gu, dataclasses.replace(down, scales=_unaligned(down.scales)), 8)


def test_qmoe_e2e_rows_do_not_depend_on_bm(cuda_device):
    """bm is a tiling choice: 8, 16 and 32 rows per slot give the same bits."""
    rng = np.random.default_rng(21)
    E, D, F, N, k = 16, 512, 256, 40, 4
    gu, down = _stacks(rng, E, D, F, 4, cuda_device)
    x = _x(rng, N, D, cuda_device)
    top_w, top_i = _routes(rng, N, E, k, cuda_device)
    ys = [_e2e(x, top_w, top_i, gu, down, bm) for bm in (8, 16, 32)]
    assert all(torch.equal(ys[0], y) for y in ys[1:])


def _sorted_case(rng, N, k, E, D, dev, bm=8):
    top_w, top_i = _routes(rng, N, E, k, dev)
    flat = top_i.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    S = qmoe.slot_bound(N * k, E, bm)
    ids, counts, pos = qmoe.plan_slots(flat[order], E, bm, S)
    xs = torch.zeros((S * bm, D), dtype=torch.bfloat16, device=dev)
    xs[pos.long()] = _x(rng, N, D, dev)[order // k]
    return xs, ids, counts


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("N", [1, 8, 128])
@pytest.mark.parametrize("bm", [8, 32])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_qmoe_slot_mlp_kernels_match_plain(cuda_device, bits, N, bm, out_dtype):
    """K11 and K12 against their plain version (ic contract, inner rounded to
    bf16: 2e-3 relative); K11 equals K12 bit for bit, every run; skipped
    slots and rows past the count are exactly 0 in an output whose memory
    held NaN (no memset); K11 skips the slots at or past a smaller n_used;
    the profiler sees only the decode ring's slot passes."""
    rng = np.random.default_rng(bits * 7 + N + (bm - 8))
    E, D, F, k = 16, 512, 256, 8
    gu, down = _stacks(rng, E, D, F, bits, cuda_device)
    xs, ids, counts = _sorted_case(rng, N, k, E, D, cuda_device, bm)
    used = int((counts > 0).sum())
    n_used = torch.tensor([used], dtype=torch.int32, device=cuda_device)
    w = (gu.qweight, gu.scales, down.qweight, down.scales)
    kw = dict(bits=bits, G_gu=gu.G, G_d=down.G, F=F, bm=bm, zc_gu=gu.zero_const,
              zc_d=down.zero_const, out_dtype=out_dtype)
    dyn = lambda n: qmoe.qmoe_mlp_matmul_dyn(xs, ids, counts, n, *w, **kw)
    grid = lambda: qmoe.qmoe_mlp_matmul(xs, ids, counts, *w, **kw)
    # the caching allocator hands the outputs memory that held NaN
    torch.full((4 * xs.shape[0], D), float("nan"), device=cuda_device)
    _build.reset_counts()
    y_dyn, y_grid = dyn(n_used), grid()
    ref = qmoe.qmoe_mlp_matmul_plain(xs, ids, counts, *w, **kw)
    torch.cuda.synchronize()
    assert (_build.LAUNCHES["qmoe_mlp_dyn"], _build.LAUNCHES["qmoe_mlp"]) == (1, 1)
    assert y_dyn.dtype == out_dtype and torch.equal(y_dyn, y_grid)
    assert torch.equal(y_dyn, dyn(n_used)) and torch.equal(y_grid, grid())
    assert _rel(y_dyn, ref) <= 2e-3
    rows = torch.arange(bm, device=cuda_device)[None, :] < counts[:, None]
    assert not y_dyn.reshape(-1, bm, D)[~rows].any()
    assert torch.isfinite(y_dyn).all()

    fewer = max(used - 2, 0)  # K11 at a smaller n_used: the slots past it 0
    y_few = dyn(torch.tensor([fewer], dtype=torch.int32, device=cuda_device))
    y_few, y_all = y_few.reshape(-1, bm, D), y_dyn.reshape(-1, bm, D)
    assert torch.equal(y_few[:fewer], y_all[:fewer]) and not y_few[fewer:].any()

    ring = lambda z: [n for n in names if "qmm_decode_kernel<" in n and z in n]
    for _ in range(3):  # CUPTI now and then loses a session's records
        names = _kernel_names(lambda: (dyn(n_used), grid()))
        if ring("MoeSlotGateUp") and ring("MoeSlotDown"):
            break
    assert len(ring("MoeSlotGateUp")) == len(ring("MoeSlotDown")) == 1
    assert len(names) == 2 and not [n for n in names if "qmoe_pass_kernel" in n], names


def test_qmoe_slot_mlp_refuses_a_split_or_pointers_it_does_not_take(cuda_device, monkeypatch):
    """K11's and K12's C entry refuses a cluster split outside 1 .. min(8, K
    / g) of either pass (down: F = 256 is 2 groups); an unaligned qweight or
    scales raises before the launch."""
    rng = np.random.default_rng(46)
    E, D, F, N, k = 16, 512, 256, 8, 8
    gu, down = _stacks(rng, E, D, F, 4, cuda_device)
    xs, ids, counts = _sorted_case(rng, N, k, E, D, cuda_device)
    kw = dict(bits=4, G_gu=gu.G, G_d=down.G, F=F, bm=8, zc_gu=gu.zero_const,
              zc_d=down.zero_const)
    run = lambda g, d: qmoe.qmoe_mlp_matmul(xs, ids, counts, g.qweight, g.scales, d.qweight,
                                            d.scales, **kw)
    plan = qmoe.e2e_plan
    for split in (0, 3, 9):
        monkeypatch.setattr(qmoe, "e2e_plan",
                            lambda *a, s=split: dataclasses.replace(plan(*a), split=s))
        with pytest.raises(ValueError, match="unsupported"):
            run(gu, down)
    monkeypatch.undo()
    for g, d in ((dataclasses.replace(gu, qweight=_unaligned(gu.qweight)), down),
                 (gu, dataclasses.replace(down, scales=_unaligned(down.scales)))):
        with pytest.raises(ValueError, match="aligned"):
            run(g, d)


def test_slot_mlp_matches_k10_ic_bit_for_bit(cuda_device):
    """Where the two launch plans agree (here one cluster block a pass), K11
    with its y kept in float32 and the model's combine equals K10 in the ic
    contract bit for bit: the same ring, split and bm give each row the same
    float32 sums, and both combines multiply by w and add in ascending slot
    order from 0 in float32."""
    rng = np.random.default_rng(19)
    E, D, F, N, k, bm = 16, 512, 256, 8, 8, 8
    gu, down = _stacks(rng, E, D, F, 4, cuda_device)
    gu, down = dataclasses.replace(gu, rt=False), dataclasses.replace(down, rt=False)
    x = _x(rng, N, D, cuda_device)
    top_w, top_i = _routes(rng, N, E, k, cuda_device)
    M = N * k
    S = qmoe.slot_bound(M, E, bm)
    for K, Nout in ((D, 2 * F), (F, D)):
        assert qmoe.e2e_plan(S, E, K, Nout, 128).split == qmoe.e2e_plan(
            M, E, K, Nout, 128).split
    y10 = _e2e(x, top_w, top_i, gu, down, bm)
    flat = top_i.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    ids, counts, pos = qmoe.plan_slots(flat[order], E, bm, S)
    xs = torch.zeros((S * bm, D), dtype=torch.bfloat16, device=cuda_device)
    xs[pos.long()] = x[order // k]
    y11 = qmoe.qmoe_mlp_forward_sorted(xs, ids, counts, gu, down, act="silu", bm=bm)
    w = top_w.reshape(-1)[order].to(torch.float32)
    out = transformer._combine_sorted(y11, pos, w, order, N, k).to(torch.bfloat16)
    assert torch.equal(out, y10)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("N,bm", [(8, 8), (128, 8), (128, 32)])
def test_qmoe_matmul_kernel_matches_plain(cuda_device, bits, N, bm):
    """K13 against its plain version: exact products, f32 sums in another
    order, one rounding: 1e-3 relative; padding rows 0."""
    rng = np.random.default_rng(bits * 3 + N + bm)
    E, D, F, k = 16, 512, 256, 8
    gu, _ = _stacks(rng, E, D, F, bits, cuda_device)
    xs, ids, counts = _sorted_case(rng, N, k, E, D, cuda_device, bm)
    kw = dict(bits=bits, G=gu.G, bm=bm, zero_const=gu.zero_const, out_dtype=torch.bfloat16)
    before = _build.LAUNCHES["qmoe_matmul"]
    y = qmoe.qmoe_matmul(xs, ids, counts, gu.qweight, gu.scales, **kw)
    ref = qmoe.qmoe_matmul_plain(xs, ids, counts, gu.qweight, gu.scales, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["qmoe_matmul"] == before + 1
    assert _rel(y, ref) <= 1e-3
    pad = torch.arange(bm, device=cuda_device)[None, :] >= counts[:, None]
    assert not y.reshape(-1, bm, y.shape[1])[pad].any()


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,bm", [(8, 8), (128, 8), (128, 32)])
def test_qmoe_matmul_down_equals_k12_bit_for_bit(cuda_device, N, bm, out_dtype):
    """K13 on K12's own inner (K12's scratch, here a buffer the test owns)
    is K12's down pass alone, with K12's plan: equal bits in f32 and bf16,
    and two runs of K13 give equal bits. F = 1024 gives the down pass 8
    groups, which the plan splits over a cluster."""
    rng = np.random.default_rng([N, bm, int(out_dtype == torch.float32)])
    E, D, F, k = 16, 512, 1024, 8
    gu, down = _stacks(rng, E, D, F, 4, cuda_device)
    xs, ids, counts = _sorted_case(rng, N, k, E, D, cuda_device, bm)
    S = ids.shape[0]
    assert qmoe.e2e_plan(S, E, F, D, 128, H100_SMS).split > 1
    inner = torch.zeros((S * bm, F), dtype=torch.bfloat16, device=cuda_device)
    y12 = qmoe._mlp_kernel("qmoe_mlp", xs, ids, counts, None, gu.qweight, gu.scales,
                           down.qweight, down.scales, bits=4, G_gu=gu.G, G_d=down.G, F=F,
                           bm=bm, zc_gu=gu.zero_const, zc_d=down.zero_const,
                           out_dtype=out_dtype, inner=inner)
    k13 = lambda: qmoe.qmoe_forward_sorted(inner, ids, counts, down, bm=bm, out_dtype=out_dtype)
    y13 = k13()
    torch.cuda.synchronize()
    assert y13.dtype == out_dtype and torch.isfinite(y13).all()
    assert torch.equal(y13, y12)
    assert torch.equal(y13, k13())


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("bm", [8, 32])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_qmoe_matmul_partial_column_tile(cuda_device, bits, bm, out_dtype):
    """N = 200 leaves a last 64-column tile of 8 columns: K13 matches its
    plain version to 1e-3, and the padding rows and skipped slots are 0 in
    an output whose memory held NaN (no memset)."""
    rng = np.random.default_rng([bits, bm, 200])
    E, K, N, k = 8, 512, 200, 4
    st = qmoe.stack_packed_experts(
        [post_init_module(random_quant_linear(rng, K, N, bits, 128, device=cuda_device))
         for _ in range(E)])
    xs, ids, counts = _sorted_case(rng, 40, k, E, K, cuda_device, bm)
    torch.full((4 * xs.shape[0], N), float("nan"), device=cuda_device)
    y = qmoe.qmoe_forward_sorted(xs, ids, counts, st, bm=bm, out_dtype=out_dtype)
    ref = qmoe.qmoe_matmul_plain(xs, ids, counts, st.qweight, st.scales, bits=bits, G=st.G,
                                 bm=bm, zero_const=st.zero_const, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert y.shape == (xs.shape[0], N) and torch.isfinite(y).all()
    assert _rel(y, ref) <= 1e-3
    pad = torch.arange(bm, device=cuda_device)[None, :] >= counts[:, None]
    assert not y.reshape(-1, bm, N)[pad].any()


@pytest.mark.parametrize("N,bm", [(8, 8), (300, 32)])
def test_qmoe_matmul_runs_only_the_ring(cuda_device, N, bm):
    """By the profiler's kernel names, K13 runs the decode ring's
    ``MoeSlotDown`` pass and nothing else: no ``qmoe_pass_kernel``."""
    rng = np.random.default_rng([N, bm, 13])
    E, D, F, k = 16, 512, 256, 8
    gu, _ = _stacks(rng, E, D, F, 4, cuda_device)
    xs, ids, counts = _sorted_case(rng, N, k, E, D, cuda_device, bm)
    run = lambda: qmoe.qmoe_forward_sorted(xs, ids, counts, gu, bm=bm)
    run()
    ring = lambda: [n for n in names if "qmm_decode_kernel<" in n and "MoeSlotDown" in n]
    for _ in range(3):  # CUPTI now and then loses a session's records
        names = _kernel_names(run)
        if ring():
            break
    assert len(ring()) == 1 and len(names) == 1, names
    assert not [n for n in names if "qmoe_pass_kernel" in n], names


def test_qmoe_matmul_refuses_a_split_or_pointers_it_does_not_take(cuda_device, monkeypatch):
    """K13's C entry refuses a cluster split outside 1 .. min(8, K / g)
    (K = 512: 4 groups) before any launch; an unaligned qweight or scales
    raises before the launch."""
    rng = np.random.default_rng(47)
    E, D, F, N, k = 16, 512, 256, 8, 8
    gu, _ = _stacks(rng, E, D, F, 4, cuda_device)
    xs, ids, counts = _sorted_case(rng, N, k, E, D, cuda_device)
    plan = qmoe.e2e_plan
    before = _build.LAUNCHES["qmoe_matmul"]
    for split in (0, 5, 9):
        monkeypatch.setattr(qmoe, "e2e_plan",
                            lambda *a, s=split: dataclasses.replace(plan(*a), split=s))
        with pytest.raises(ValueError, match="unsupported"):
            qmoe.qmoe_forward_sorted(xs, ids, counts, gu)
    monkeypatch.undo()
    assert _build.LAUNCHES["qmoe_matmul"] == before
    for bad in (dataclasses.replace(gu, qweight=_unaligned(gu.qweight)),
                dataclasses.replace(gu, scales=_unaligned(gu.scales))):
        with pytest.raises(ValueError, match="aligned"):
            qmoe.qmoe_forward_sorted(xs, ids, counts, bad)


def test_qmoe_kernels_refuse_what_they_do_not_take(cuda_device):
    """No plain fallback on the card: f32 rows and a stack of group size 64
    raise."""
    rng = np.random.default_rng(8)
    E, D, F, N, k = 4, 256, 128, 4, 2
    gu, down = _stacks(rng, E, D, F, 4, cuda_device)
    top_w, top_i = _routes(rng, N, E, k, cuda_device)
    with pytest.raises(ValueError):
        _e2e(_x(rng, N, D, cuda_device).float(), top_w, top_i, gu, down, 8)
    spec = transformer.ModelSpec(model_type="qwen3_moe", vocab_size=8, hidden_size=D,
                                 intermediate_size=F, num_layers=1, num_heads=2,
                                 num_kv_heads=2, head_dim=128, num_experts=E,
                                 num_experts_per_tok=k, moe_intermediate_size=F)
    gu64, down64 = _stacks(rng, E, D, F, 4, cuda_device, group_size=64)
    with pytest.raises(NotImplementedError, match="group size 64"):
        transformer._moe_ragged_apply_q(spec, {"gateup": gu64, "down": down64},
                                        _x(rng, N, D, cuda_device), top_w, top_i)


def test_moe_facade_runs_k1_and_k10(cuda_device, tmp_path, monkeypatch):
    """load -> optimize -> generate of a qwen3_moe checkpoint: K1 twice and K10
    once per layer in the prefill and in every decode step; the logits near
    the plain versions'."""
    write_random_qwen3_moe_checkpoint(tmp_path, TINY_QWEN3_MOE, seed=1, device=cuda_device)
    model = GPTQModel.load(tmp_path).optimize()
    L, B, T, new = 2, 3, 32, 5
    ids = np.random.default_rng(2).integers(0, 1024, (B, T))
    _build.reset_counts()
    tokens = model.generate(ids, max_new_tokens=new)
    assert tokens.shape == (B, new) and ((tokens >= 0) & (tokens < 1024)).all()
    assert _build.LAUNCHES == dict.fromkeys(_build.LAUNCHES, 0) | {
        "qmatmul": 2 * L * new, "qmoe_e2e": L * new}
    ids_t = torch.as_tensor(ids, device=cuda_device)
    with torch.inference_mode():
        got = transformer.forward_logits(model.spec, model.params, ids_t, torch.bfloat16)
        monkeypatch.setattr(registry, "qmatmul", qmatmul_plain)
        monkeypatch.setattr(qmoe, "qmoe_mlp_e2e", qmoe.qmoe_mlp_e2e_plain)
        ref = transformer.forward_logits(model.spec, model.params, ids_t, torch.bfloat16)
    assert torch.isfinite(got).all()
    assert _rel(got, ref) <= 1e-2


# ------------------------------------------------------------------- K4, K5

# the five layouts K4 and K5 read: 3-bit stitched, 3/5/6/7-bit planar
PLANE_LAYOUTS = [(3, False), (3, True), (5, True), (6, True), (7, True)]


def _planes_case(rng, bits, planar, sym, K, N, g, dev, perm=None):
    p = post_init_module(random_quant_linear(rng, K, N, bits, g, device=dev, sym=sym,
                                             perm=perm, planar=planar))
    assert p.planar == planar and (p.zero_const >= 0) == sym
    return p


def _planes_call(p, x, plain=False):
    kw = dict(bits=p.bits, group_size=p.group_size, planar=p.planar)
    if p.zero_const >= 0:
        fn = qmatmul_planes_plain if plain else qmatmul_planes
        return fn(x, p.qweight, p.scales, zero_const=p.zero_const, **kw)
    fn = qmatmul_planes_asym_plain if plain else qmatmul_planes_asym
    return fn(x, p.qweight, p.scales, p.qzeros, **kw)


# (K, N): ten groups that split unevenly between the register tile's 4 warps
# and over a cluster of 7 at decode; seven groups and a column tile of 32
# (N % 64 == 32) at decode
PLANES_SHAPES = {"ten_groups": (1280, 384), "seven_groups_ragged": (896, 352)}


@pytest.mark.parametrize("bits,planar", PLANE_LAYOUTS)
@pytest.mark.parametrize("sym", [True, False])
@pytest.mark.parametrize("M,shape", [(M, "ten_groups") for M in (1, 5, 8, 9, 16, 40, 300)]
                         + [(M, "seven_groups_ragged") for M in (1, 9, 16)])
def test_qmatmul_planes_kernels_match_plain(cuda_device, bits, planar, sym, M, shape):
    """K4 (one zero point) and K5 (zeros per group and column) against their
    plain versions: exact products and z*s, f32 sums in another order, one
    rounding to bf16: 1e-3 relative, and the same bits on every run. M <= 16
    runs the decode kernel (M = 1..8 one n-tile of tokens, 9 and 16 two); 40
    the register tile's four row tiles, 300 its 32 x 32 tiles."""
    K, N = PLANES_SHAPES[shape]
    rng = np.random.default_rng(bits * 100 + planar * 10 + sym + M if shape == "ten_groups"
                                else [bits, planar, sym, M, K])
    p = _planes_case(rng, bits, planar, sym, K, N, 128, cuda_device)
    x = _x(rng, M, K, cuda_device)
    name = "qmatmul_planes" if sym else "qmatmul_planes_asym"
    before = _build.LAUNCHES[name]
    y = _planes_call(p, x)
    ref = _planes_call(p, x, plain=True)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[name] == before + 1
    assert y.dtype == torch.bfloat16 and y.shape == (M, N)
    assert _rel(y, ref) <= 1e-3
    assert all(torch.equal(y, _planes_call(p, x)) for _ in range(2))


@pytest.mark.parametrize("bits,planar", PLANE_LAYOUTS)
@pytest.mark.parametrize("sym", [True, False])
@pytest.mark.parametrize("M", [1, 8, 9, 16, 40])
def test_qmatmul_planes_exact_inputs_give_equal_outputs(cuda_device, bits, planar, sym, M):
    """Integer activations and power-of-two scales: every product, z*s and
    partial sum is exact, so kernel and plain version agree bit for bit; a
    code or zero read from the wrong bits of its unit, or x from the wrong
    rows, would break that. Two groups of 256 rows; M <= 16 on the decode
    kernel, 40 on the register tile."""
    rng = np.random.default_rng(40 + bits + 10 * planar + sym if M == 8
                                else [40, bits, planar, sym, M])
    p = _planes_case(rng, bits, planar, sym, 512, 256, 256, cuda_device)
    p.scales = _pow2_scales(rng, p, cuda_device)
    x = _int_x(rng, M, 512, cuda_device)
    assert torch.equal(_planes_call(p, x), _planes_call(p, x, plain=True))


def test_qmatmul_planes_decode_refuses_a_split_or_pointers_it_does_not_take(cuda_device,
                                                                            monkeypatch):
    """K4's and K5's C entries refuse a cluster split outside 1 .. min(8,
    K / g) at M <= 16; an unaligned weight or scale pointer raises before the
    launch."""
    from gptqmodel_tpu_torch.ops import qmatmul as qmatmul_mod

    rng = np.random.default_rng(45)
    mods = [_planes_case(rng, 3, False, True, 896, 256, 128, cuda_device),  # 7 groups
            _planes_case(rng, 7, True, False, 896, 256, 128, cuda_device)]
    x = _x(rng, 8, 896, cuda_device)
    plan = qmatmul_mod.decode_plan
    for split in (0, 8, 9):
        monkeypatch.setattr(qmatmul_mod, "decode_plan",
                            lambda *a, s=split: dataclasses.replace(plan(*a), split=s))
        for p in mods:
            with pytest.raises(ValueError, match="unsupported"):
                _planes_call(p, x)
    monkeypatch.undo()
    for p in mods:
        for view in (dataclasses.replace(p, qweight=_unaligned(p.qweight)),
                     dataclasses.replace(p, scales=_unaligned(p.scales))):
            with pytest.raises(ValueError, match="aligned"):
                _planes_call(view, x)


@pytest.mark.parametrize("bits,planar", PLANE_LAYOUTS)
@pytest.mark.parametrize("sym", [True, False])
@pytest.mark.parametrize("M,kernel", [(1, "qmm_decode_kernel<"), (16, "qmm_decode_kernel<"),
                                      (40, "planes_kernel<")])
def test_qmatmul_planes_run_the_kernel_their_plan_names(cuda_device, bits, planar, sym, M,
                                                         kernel):
    """At M <= 16 the profiler sees only the decode kernel's ``Units``
    instantiation of the layout; above, only the register tile."""
    rng = np.random.default_rng([46, bits, planar, sym, M])
    p = _planes_case(rng, bits, planar, sym, 1024, 256, 128, cuda_device)
    x = _x(rng, M, 1024, cuda_device)
    names = _kernel_names(lambda: _planes_call(p, x))
    assert names and all(kernel in n for n in names), names
    if M <= 16:
        assert all("Units" in n for n in names), names


def test_qmatmul_planes_refuse_what_they_do_not_take(cuda_device):
    """No plain fallback on the card: f32 rows, groups of 64, N not a
    multiple of 32, 5-bit words said to be stitched, qzeros of the wrong
    shape and CPU zeros raise."""
    rng = np.random.default_rng(19)
    p = _planes_case(rng, 3, False, False, 256, 128, 128, cuda_device)
    x = _x(rng, 4, 256, cuda_device)
    kw = dict(bits=3, group_size=128, planar=False)
    with pytest.raises(TypeError):
        qmatmul_planes(x.float(), p.qweight, p.scales, zero_const=4.0, **kw)
    with pytest.raises(ValueError):
        qmatmul_planes(x, p.qweight, p.scales, zero_const=4.0, bits=3, group_size=64,
                       planar=False)
    with pytest.raises(ValueError):
        qmatmul_planes(x, p.qweight[:, :120].contiguous(), p.scales[:, :120].contiguous(),
                       zero_const=4.0, **kw)
    p5 = _planes_case(rng, 5, True, True, 256, 128, 128, cuda_device)
    with pytest.raises(ValueError, match="planar"):
        qmatmul_planes(x, p5.qweight, p5.scales, zero_const=16.0, bits=5, group_size=128,
                       planar=False)
    with pytest.raises(ValueError):
        qmatmul_planes_asym(x, p.qweight, p.scales, p.qzeros[:, :-1].contiguous(), **kw)
    with pytest.raises(ValueError):
        qmatmul_planes_asym(x, p.qweight, p.scales, p.qzeros.cpu(), **kw)


@pytest.mark.parametrize("bits,planar", [(3, False), (7, True)])
@pytest.mark.parametrize("sym,kernel", [(True, "qmatmul_planes"),
                                        (False, "qmatmul_planes_asym")])
def test_act_order_plane_module_runs_its_kernel(cuda_device, bits, planar, sym, kernel):
    """A balanced act-order 3-bit stitched or 7-bit planar module, its rows
    permuted at post-init on the card in its own layout: K4 or K5 after the
    x-column gather, against the dequantize-then-matmul reference on the
    module as loaded (bf16 weights there): 1e-2 relative."""
    rng = np.random.default_rng(23 + bits)
    K, N = 1024, 256
    loaded = random_quant_linear(rng, K, N, bits, device=cuda_device, sym=sym,
                                 perm=rng.permutation(K), planar=planar)
    p = post_init_module(loaded)
    assert p.act_perm is not None and p.act_perm.device.type == "cuda"
    x = _x(rng, 8, K, cuda_device)
    _build.reset_counts()
    y = registry.qlinear_forward(p, x)
    assert _build.LAUNCHES == dict.fromkeys(_build.LAUNCHES, 0) | {kernel: 1}
    assert _rel(y, qlinear_forward_torch(loaded, x)) <= 1e-2


@pytest.mark.parametrize("bits,fmt,sym", [(3, "gptq", True), (5, "gptq_p", False)])
def test_plane_facade_runs_k4_or_k5(cuda_device, tmp_path, monkeypatch, bits, fmt, sym):
    """load -> optimize -> generate of a 3-bit v1 or a 5-bit gptq_p
    checkpoint: K4 (symmetric) or K5 four times per layer in the prefill and
    in every decode step, nothing else; the logits near the plain path's."""
    write_random_gptq_checkpoint(tmp_path, TINY_LLAMA, seed=4, bits=bits, sym=sym, format=fmt)
    model = GPTQModel.load(tmp_path).optimize()
    L, B, T, new = 2, 3, 32, 5
    ids = np.random.default_rng(2).integers(0, 1024, (B, T))
    _build.reset_counts()
    tokens = model.generate(ids, max_new_tokens=new)
    assert tokens.shape == (B, new) and ((tokens >= 0) & (tokens < 1024)).all()
    name = "qmatmul_planes" if sym else "qmatmul_planes_asym"
    assert _build.LAUNCHES == dict.fromkeys(_build.LAUNCHES, 0) | {name: 4 * L * new}
    ids_t = torch.as_tensor(ids, device=cuda_device)
    with torch.inference_mode():
        got = transformer.forward_logits(model.spec, model.params, ids_t, torch.bfloat16)
        monkeypatch.setattr(registry, "qmatmul_planes", qmatmul_planes_plain)
        monkeypatch.setattr(registry, "qmatmul_planes_asym", qmatmul_planes_asym_plain)
        ref = transformer.forward_logits(model.spec, model.params, ids_t, torch.bfloat16)
    assert torch.isfinite(got).all()
    assert _rel(got, ref) <= 1e-2
