"""K1's and K7's plain versions and the port's quantized linear against the
JAX package.

The same seeded numpy codes, scales and activations go to both packages. The
JAX Pallas kernel runs in interpret mode, as the JAX tests run it on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptqmodel_tpu.ops import pallas_qmatmul
from gptqmodel_tpu.ops.qlinear import dequantize_weight as jdequant
from gptqmodel_tpu.ops.qlinear import make_quant_linear, qlinear_forward_xla
from gptqmodel_tpu.ops.registry import post_init_module as jpost
from gptqmodel_tpu_torch.convert import convert_quant_linear, to_torch
from gptqmodel_tpu_torch.ops import _build
from gptqmodel_tpu_torch.ops.qlinear import QuantLinear, dequantize_weight
from gptqmodel_tpu_torch.ops.qlinear import make_quant_linear as tmake
from gptqmodel_tpu_torch.ops.qmatmul import (
    qmatmul,
    qmatmul_fused,
    qmatmul_fused_plain,
    qmatmul_plain,
)
from gptqmodel_tpu_torch.ops.registry import (
    kernel_route,
    post_init_module,
    qlinear_forward,
)


def _module(rng, out_f, in_f, bits=4, g=128, pow2=False, sym=True, bf16_scales=False):
    """A JAX QuantLinear in the interchange layout (v1 zeros, fp16 scales;
    ``bf16_scales``: scales that are bf16 values, exact in fp16 too)."""
    Q = rng.integers(0, 2**bits, size=(out_f, in_f)).astype(np.int32)
    if sym:
        zeros = np.full((in_f // g, out_f), 2 ** (bits - 1), np.int32)
    else:
        zeros = rng.integers(0, 2**bits, size=(in_f // g, out_f)).astype(np.int32)
    if pow2:  # exact in fp16 and bf16: no scale rounding anywhere
        scales = 2.0 ** rng.integers(-6, -3, size=(in_f // g, out_f))
    else:
        scales = rng.uniform(0.005, 0.02, size=(in_f // g, out_f))
        if bf16_scales:
            scales = np.asarray(jnp.asarray(scales, jnp.bfloat16), np.float32)
    return make_quant_linear(Q=Q, scales=scales, zeros=zeros, g_idx=None, bias=None,
                             bits=bits, group_size=g, sym=sym, v1=True)


def _port(jm):
    """A JAX QuantLinear as the port's, on the CPU, prepared for its kernels."""
    return post_init_module(convert_quant_linear(jm, device="cpu"))


def _cpu(a):
    return to_torch(a, device="cpu")


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


@pytest.mark.parametrize("bits,v1,g_idx", [(2, True, False), (4, False, True),
                                           (8, True, False)])
def test_make_quant_linear_matches_jax(bits, v1, g_idx):
    """Packing is bit manipulation: the same arrays, bit for bit."""
    rng = np.random.default_rng(30 + bits)
    out_f, in_f = 64, 256
    kw = dict(Q=rng.integers(0, 2**bits, size=(out_f, in_f)).astype(np.int32),
              scales=rng.uniform(0.005, 0.02, size=(2, out_f)),
              zeros=rng.integers(0, 2**bits, size=(2, out_f)).astype(np.int32),
              g_idx=rng.integers(0, 2, size=in_f).astype(np.int32) if g_idx else None,
              bias=None, bits=bits, group_size=128, sym=False, v1=v1)
    ref = convert_quant_linear(make_quant_linear(**kw), device="cpu")
    got = tmake(**kw, device="cpu")
    for f in ("qweight", "qzeros", "scales", "g_idx"):
        a, b = getattr(got, f), getattr(ref, f)
        assert (a is None and b is None) or (a.dtype == b.dtype and torch.equal(a, b)), f
    assert (got.in_features, got.out_features, got.v1) == (in_f, out_f, v1)


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_dequantize_matches_jax(bits):
    jm = _module(np.random.default_rng(bits), 64, 256, bits=bits)
    tm = convert_quant_linear(jm, device="cpu")
    np.testing.assert_array_equal(dequantize_weight(tm).numpy(), np.asarray(jdequant(jm)))


@pytest.mark.parametrize("bits,pow2", [(4, True), (4, False), (2, True), (8, True)])
def test_qmatmul_plain_matches_jax_rt_sym_kernel(bits, pow2):
    """Against the TPU kernel K1 (interpret mode). With power-of-two scales
    both sides compute the same exact products and differ only in f32
    summation order before one bf16 rounding: within 1 bf16 ulp (2^-8
    relative) of the output. With random fp16 scales the TPU kernel rounds
    scales to bf16 (up to 2^-9 relative each) and the port does not, so the
    bound is 1e-2 relative in norm."""
    rng = np.random.default_rng(100 + bits)
    K, N, M = 1024, 256, 8
    jm = _module(rng, N, K, bits=bits, pow2=pow2)
    x = (rng.integers(-4, 5, size=(M, K)) if pow2
         else rng.standard_normal((M, K))).astype(np.float32)
    jrt = jpost(jm)
    assert jrt.rt_layout and jrt.zero_const == 2 ** (bits - 1)
    ref = pallas_qmatmul.qmatmul(
        jnp.asarray(x, jnp.bfloat16), jrt.qweight, jrt.scales, jrt.zvals,
        bits=bits, group_size=128, rt=True, rt_block_k=jrt.rt_block_k,
        zero_const=jrt.zero_const, interpret=True,
    )
    tm = _port(jm)
    got = qmatmul_plain(_cpu(x).to(torch.bfloat16), tm.qweight, tm.scales, bits=bits,
                        group_size=128, zero_const=tm.zero_const)
    assert got.dtype == torch.bfloat16
    ref32 = np.asarray(ref.astype(jnp.float32))
    got32 = got.float().numpy()
    if pow2:
        np.testing.assert_allclose(got32, ref32, rtol=2**-8, atol=1e-6 * np.abs(ref32).max())
    else:
        assert _rel(got32, ref32) < 1e-2


@pytest.fixture
def rt_fused(monkeypatch):
    """``GPTQ_TPU_RT_FUSED=1`` for both packages. The JAX ``qmatmul`` reads
    it when it traces, so its traces are dropped before and after."""
    monkeypatch.setenv("GPTQ_TPU_RT_FUSED", "1")
    jax.clear_caches()
    yield
    monkeypatch.delenv("GPTQ_TPU_RT_FUSED")
    jax.clear_caches()


def _jax_rt_sym(jm, x):
    """The JAX package's symmetric rt kernel on the module (K1, or K7 under
    ``GPTQ_TPU_RT_FUSED=1``), in interpret mode."""
    jrt = jpost(jm)
    assert jrt.rt_layout and jrt.zero_const >= 0
    y = pallas_qmatmul.qmatmul(
        jnp.asarray(x, jnp.bfloat16), jrt.qweight, jrt.scales, jrt.zvals, bits=jm.bits,
        group_size=jm.group_size, rt=True, rt_block_k=jrt.rt_block_k,
        zero_const=jrt.zero_const, interpret=True)
    return np.asarray(y.astype(jnp.float32))


@pytest.mark.parametrize("M", [1, 8])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_k7_plain_matches_jax_fused_kernel(rt_fused, bits, M):
    """Against ``_qmm_rt_sym_fused_kernel`` (interpret mode) on scales that
    are bf16 values, where the TPU kernel's rounding of the scales to bf16
    changes nothing: both sum ``x * bf16(c * s)`` and subtract ``X1 * (zc *
    s)`` in float32, in another order, before one bf16 rounding: 1e-3
    relative."""
    rng = np.random.default_rng(200 + bits)
    jm = _module(rng, 256, 1024, bits=bits, bf16_scales=True)
    x = rng.standard_normal((M, 1024)).astype(np.float32)
    ref = _jax_rt_sym(jm, x)
    tm = _port(jm)
    got = qmatmul_fused_plain(_cpu(x).to(torch.bfloat16), tm.qweight, tm.scales, bits=bits,
                              group_size=128, zero_const=tm.zero_const)
    assert got.dtype == torch.bfloat16
    assert _rel(got.float().numpy(), ref) <= 1e-3


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_k7_plain_equals_jax_fused_kernel_on_one_hot_rows(rt_fused, bits):
    """Power-of-two scales and one-hot rows of x: each output is one weight,
    ``bf16(c * s) - zc * s``, exact on both sides, so they agree bit for bit;
    a code, scale or group read at the wrong place breaks it."""
    rng = np.random.default_rng(210 + bits)
    jm = _module(rng, 256, 1024, bits=bits, pow2=True)
    x = np.zeros((8, 1024), np.float32)
    x[np.arange(8), rng.choice(1024, 8, replace=False)] = 1.0
    ref = _jax_rt_sym(jm, x)
    tm = _port(jm)
    got = qlinear_forward(tm, _cpu(x).to(torch.bfloat16))
    np.testing.assert_array_equal(got.float().numpy(), ref)


def test_k7_wrapper_takes_plain_version_on_cpu_only(rt_fused, monkeypatch):
    """Under ``GPTQ_TPU_RT_FUSED=1`` a K1 module's forward is K7: on the CPU
    exactly its plain version; off the CPU the wrapper asks for the kernel
    (refused here), refuses f32 activations, and counts no launch."""
    rng = np.random.default_rng(13)
    tm = _port(_module(rng, 128, 256))
    x = _cpu(rng.standard_normal((5, 256)).astype(np.float32)).to(torch.bfloat16)
    kw = dict(bits=4, group_size=128, zero_const=tm.zero_const)
    assert kernel_route(tm) == "K1"
    assert torch.equal(qlinear_forward(tm, x), qmatmul_fused_plain(x, tm.qweight, tm.scales, **kw))
    assert torch.equal(qmatmul_fused(x, tm.qweight, tm.scales, **kw),
                       qmatmul_fused_plain(x, tm.qweight, tm.scales, **kw))
    _refuse_build(monkeypatch)
    before = dict(_build.LAUNCHES)
    meta = tm.to("meta")
    with pytest.raises(RuntimeError, match="kernel library"):
        qlinear_forward(meta, x.to("meta"))
    with pytest.raises(TypeError, match="bf16"):
        qmatmul_fused(x.to("meta").float(), meta.qweight, meta.scales, **kw)
    with pytest.raises(ValueError, match="K7 does not take"):
        qmatmul_fused(x.to("meta"), meta.qweight, meta.scales, bits=4, group_size=64,
                      zero_const=tm.zero_const)
    assert _build.LAUNCHES == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qlinear_forward_matches_xla_reference(dtype):
    """The port's forward against ``qlinear_forward_xla``. In float32 both are
    exact products with f32 sums in another order: 1e-5 relative. In bf16
    the reference rounds each dequantized weight to bf16 (2^-9 relative) and
    the port does not: 1e-2 relative in norm."""
    rng = np.random.default_rng(7)
    jm = _module(rng, 384, 512)
    x = rng.standard_normal((2, 3, 512)).astype(np.float32)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    ref = np.asarray(qlinear_forward_xla(jm, jnp.asarray(x, jdt)).astype(jnp.float32))
    tm = _port(jm)
    assert kernel_route(tm) == "K1"
    got = qlinear_forward(tm, _cpu(x).to(tdt))
    assert got.shape == (2, 3, 384) and got.dtype == tdt
    assert _rel(got.float().numpy(), ref) < (1e-5 if dtype == "float32" else 1e-2)


def test_asymmetric_module_runs_reference_on_cpu():
    """Per-group zeros are outside K1's contract: the module runs K3, whose
    plain version on the CPU sums exact products in float32, as the
    dequantize-then-matmul XLA reference does, in another order: 1e-5."""
    rng = np.random.default_rng(8)
    jm = _module(rng, 128, 256, sym=False)
    tm = _port(jm)
    assert tm.zero_const < 0 and kernel_route(tm) == "K3"
    x = rng.standard_normal((4, 256)).astype(np.float32)
    ref = np.asarray(qlinear_forward_xla(jm, jnp.asarray(x)))
    np.testing.assert_allclose(qlinear_forward(tm, _cpu(x)).numpy(), ref,
                               rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def test_cpu_tensor_takes_plain_version():
    """The wrapper picks the plain version only because the tensor is on the
    CPU, and then gives exactly what the plain version gives."""
    rng = np.random.default_rng(9)
    tm = _port(_module(rng, 128, 256))
    x = _cpu(rng.standard_normal((5, 256)).astype(np.float32)).to(torch.bfloat16)
    kw = dict(bits=4, group_size=128, zero_const=tm.zero_const)
    assert torch.equal(qmatmul(x, tm.qweight, tm.scales, **kw),
                       qmatmul_plain(x, tm.qweight, tm.scales, **kw))


def test_post_init_converts_v1_zeros_and_finds_uniform_zero():
    jm = _module(np.random.default_rng(10), 64, 256, bits=4)
    tm = _port(jm)
    assert not tm.v1 and tm.zero_const == 8.0 and tm.scales.dtype == torch.float16
    np.testing.assert_array_equal(dequantize_weight(tm).numpy(), np.asarray(jdequant(jm)))


def _refuse_build(monkeypatch):
    def lib():
        raise RuntimeError("kernel library requested")

    monkeypatch.setattr(_build, "lib", lib)


def test_tensor_off_the_cpu_goes_to_the_kernel(monkeypatch):
    """A tensor that is not on the CPU (here on the meta device) never takes
    the plain version: the wrapper asks for the kernel library and raises
    when it cannot have it."""
    _refuse_build(monkeypatch)
    tm = _port(_module(np.random.default_rng(11), 128, 256))
    x = torch.empty((4, 256), dtype=torch.bfloat16, device="meta")
    before = _build.LAUNCHES["qmatmul"]
    with pytest.raises(RuntimeError, match="kernel library"):
        qmatmul(x, tm.qweight.to("meta"), tm.scales.to("meta"), bits=4, group_size=128,
                zero_const=tm.zero_const)
    with pytest.raises(RuntimeError, match="kernel library"):
        qlinear_forward(tm.to("meta"), x)
    assert _build.LAUNCHES["qmatmul"] == before  # a launch that failed is not counted
    with pytest.raises(TypeError, match="bf16"):
        qmatmul(x.float(), tm.qweight.to("meta"), tm.scales.to("meta"), bits=4,
                group_size=128, zero_const=tm.zero_const)


def _meta_module(bits, g, sym, K=256, N=128):
    """A prepared 3-bit module on the meta device: only its fields are read
    before the kernel is asked for."""
    G = K // g
    return QuantLinear(
        qweight=torch.empty((K * bits // 32, N), dtype=torch.int32, device="meta"),
        qzeros=torch.empty((G, N * bits // 32), dtype=torch.int32, device="meta"),
        scales=torch.empty((G, N), dtype=torch.float16, device="meta"), g_idx=None,
        bias=None, bits=bits, group_size=g, in_features=K, out_features=N, sym=sym,
        zero_const=2.0 ** (bits - 1) if sym else -1.0)


@pytest.mark.parametrize("sym,bits,g,act_order,kernel", [
    (False, 4, 128, False, "K3"), (True, 4, 128, True, "K1"), (False, 4, 128, True, "K3"),
    (True, 4, 32, False, "K6"), (False, 4, 32, False, "K6"),
    (True, 3, 128, False, "K4"), (False, 3, 128, False, "K5"),
])
def test_module_outside_k1_raises_off_the_cpu(monkeypatch, sym, bits, g, act_order, kernel):
    """Off the CPU each module takes the JAX registry's route. Asymmetric
    modules run K3, balanced act-order ones K1 or K3 after the gather,
    contiguous groups of 32 K6, symmetric or not, and 3-bit modules K4 (one
    zero point) or K5 (zeros per group): here they ask for the kernel
    library, which is refused, and count no launch."""
    _refuse_build(monkeypatch)
    if bits == 3:
        tm = _meta_module(bits, g, sym)
    else:
        rng = np.random.default_rng(12)
        g_idx = (np.arange(256) * 7 % 256 // g).astype(np.int32) if act_order else None
        jm = _module(rng, 128, 256, bits=bits, g=g, sym=sym)
        if g_idx is not None:
            jm.g_idx = g_idx
        tm = _port(jm).to("meta")
        assert (tm.act_perm is not None) == act_order
    x = torch.empty((4, 256), dtype=torch.bfloat16, device="meta")
    before = dict(_build.LAUNCHES)
    assert kernel_route(tm) == kernel
    with pytest.raises(RuntimeError, match="kernel library"):
        qlinear_forward(tm, x)
    assert _build.LAUNCHES == before
