"""K2's plain version and the port's fused-MLP routing against the JAX package.

The JAX fused-MLP kernel runs in interpret mode on the same seeded modules.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptqmodel_tpu.models.optimize import _concat_quant
from gptqmodel_tpu.models.optimize import enable_fused_mlp as jenable
from gptqmodel_tpu.models.spec import ModelSpec as JSpec
from gptqmodel_tpu.ops.pallas_qmlp import qmlp as jqmlp
from gptqmodel_tpu.ops.qlinear import make_quant_linear
from gptqmodel_tpu.ops.registry import post_init_module as jpost
from gptqmodel_tpu_torch.convert import convert_quant_linear, to_torch
from gptqmodel_tpu_torch.ops import _build
from gptqmodel_tpu_torch.models.optimize import enable_fused_mlp, fuse_projections
from gptqmodel_tpu_torch.models.spec import ModelSpec
from gptqmodel_tpu_torch.models.transformer import gated_mlp
from gptqmodel_tpu_torch.ops.qmlp import qmlp, qmlp_plain
from gptqmodel_tpu_torch.ops.registry import post_init_module, qmlp_forward


def _module(rng, out_f, in_f, pow2):
    Q = rng.integers(0, 16, size=(out_f, in_f)).astype(np.int32)
    zeros = np.full((in_f // 128, out_f), 8, np.int32)
    scales = (2.0 ** rng.integers(-6, -3, size=(in_f // 128, out_f)) if pow2
              else rng.uniform(0.005, 0.02, size=(in_f // 128, out_f)))
    return make_quant_linear(Q=Q, scales=scales, zeros=zeros, g_idx=None, bias=None,
                             bits=4, group_size=128, sym=True, v1=True)


def _port(jm):
    """A JAX QuantLinear as the port's, on the CPU, prepared for its kernels."""
    return post_init_module(convert_quant_linear(jm, device="cpu"))


def _cpu(a):
    return to_torch(a, device="cpu")


def _rel(a, b):
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


@pytest.mark.parametrize("pow2", [True, False])
def test_qmlp_plain_matches_jax_fused_mlp_kernel(pow2):
    """Against the TPU kernel K2 (interpret mode). Both keep g and u in f32
    and round inner to bf16; with power-of-two scales the remaining
    differences are f32 summation order, which can flip an inner bf16
    rounding: 1e-3 relative in norm. With random scales the TPU kernel
    rounds scales to bf16 and the port keeps fp16: 2e-2, the JAX test's
    bound against its own reference."""
    rng = np.random.default_rng(0 if pow2 else 1)
    D, F, M = 1024, 1024, 8
    gate, up, down = (_module(rng, F, D, pow2), _module(rng, F, D, pow2),
                      _module(rng, D, F, pow2))
    x = (rng.integers(-4, 5, size=(M, D)) if pow2
         else rng.standard_normal((M, D)) * 0.5).astype(np.float32)
    jgu, jd = jpost(_concat_quant([gate, up])), jpost(down)
    jd8 = jenable(  # re-packs down to the TPU kernel's 8-group tile
        JSpec(model_type="llama", vocab_size=8, hidden_size=D, intermediate_size=F,
              num_layers=1, num_heads=8, num_kv_heads=8, head_dim=128),
        {"model": {"layers": [{"mlp": {"gate_up_proj": jgu, "down_proj": jd}}]}},
    )["model"]["layers"][0]["mlp"]["down_proj"]
    ref = jqmlp(jnp.asarray(x, jnp.bfloat16), jgu.qweight, jgu.scales, jd8.qweight,
                jd8.scales, bits=4, group_size=128, kt_gu=jgu.rt_block_k,
                zc_gu=jgu.zero_const, zc_d=jd8.zero_const, act="silu", interpret=True)
    tgu = _port(_concat_quant([gate, up]))
    td = _port(down)
    got = qmlp_plain(_cpu(x).to(torch.bfloat16), tgu.qweight, tgu.scales, td.qweight,
                     td.scales, bits=4, group_size=128, zc_gu=tgu.zero_const,
                     zc_d=td.zero_const)
    assert got.dtype == torch.bfloat16 and got.shape == (M, D)
    assert _rel(got.float().numpy(), np.asarray(ref.astype(jnp.float32))) < (
        1e-3 if pow2 else 2e-2)


def test_fused_mlp_routing_and_contract():
    """``optimize`` marks the MLP; gated_mlp then runs K2's path at decode
    sizes and the two projections at prefill sizes (M > 64), both equal to
    the unfused MLP within bf16 rounding of inner (1e-2 relative)."""
    rng = np.random.default_rng(3)
    D, F = 256, 512
    mlp = {"gate_proj": _module(rng, F, D, False), "up_proj": _module(rng, F, D, False),
           "down_proj": _module(rng, D, F, False)}
    spec = ModelSpec(model_type="llama", vocab_size=8, hidden_size=D, intermediate_size=F,
                     num_layers=1, num_heads=2, num_kv_heads=2, head_dim=128)
    layer = {"self_attn": {}, "mlp": {k: _port(v) for k, v in mlp.items()}}
    params = {"model": {"layers": [layer]}}
    unfused = dict(layer["mlp"])
    enable_fused_mlp(spec, fuse_projections(spec, params))
    mp = layer["mlp"]
    assert mp["_fused"] and "gate_up_proj" in mp and "gate_proj" not in mp
    for rows in (8, 80):
        h = _cpu(rng.standard_normal((1, rows, D)).astype(np.float32)).to(torch.bfloat16)
        fused = qmlp_forward(mp["gate_up_proj"], mp["down_proj"], h, "silu")
        assert (fused is None) == (rows > 64)
        y, ref = gated_mlp(spec, mp, h), gated_mlp(spec, unfused, h)
        assert y.shape == (1, rows, D)
        assert _rel(y.float().numpy(), ref.float().numpy()) < 1e-2


def test_tensor_off_the_cpu_goes_to_the_kernel(monkeypatch):
    """A tensor that is not on the CPU (here on the meta device) never takes
    K2's plain version: the wrapper asks for the kernel library and raises
    when it cannot have it."""
    def lib():
        raise RuntimeError("kernel library requested")

    monkeypatch.setattr(_build, "lib", lib)
    rng = np.random.default_rng(4)
    D, F = 256, 512
    gu = _port(_concat_quant([_module(rng, F, D, True), _module(rng, F, D, True)])).to("meta")
    down = _port(_module(rng, D, F, True)).to("meta")
    x = torch.empty((8, D), dtype=torch.bfloat16, device="meta")
    with pytest.raises(RuntimeError, match="kernel library"):
        qmlp(x, gu.qweight, gu.scales, down.qweight, down.scales, bits=4, group_size=128,
             zc_gu=gu.zero_const, zc_d=down.zero_const)
    with pytest.raises(RuntimeError, match="kernel library"):
        qmlp_forward(gu, down, x[None], "silu")


@pytest.mark.parametrize("M", [1, 8, 16, 40])
def test_tensor_off_the_cpu_hands_the_kernel_both_plan_splits(monkeypatch, M):
    """Off the CPU (here on the meta device, with a stand-in library), K2's
    C entry gets the split of ``decode_plan(M, D, 2F, g)`` for gate/up and of
    ``decode_plan(M, F, D, g)`` for down at M <= 16, and 0 for both above."""
    from types import SimpleNamespace

    from gptqmodel_tpu_torch.ops import qmatmul as qmatmul_mod

    calls = []

    def gqt_qmlp(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(_build, "lib", lambda: SimpleNamespace(gqt_qmlp=gqt_qmlp))
    monkeypatch.setattr(qmatmul_mod, "_sm_count", lambda index: qmatmul_mod.H100_SMS)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: SimpleNamespace(cuda_stream=0))
    monkeypatch.setitem(_build.LAUNCHES, "qmlp", 0)
    rng = np.random.default_rng(5)
    D, F = 256, 512
    gu = _port(_concat_quant([_module(rng, F, D, True), _module(rng, F, D, True)])).to("meta")
    down = _port(_module(rng, D, F, True)).to("meta")
    x = torch.empty((M, D), dtype=torch.bfloat16, device="meta")
    y = qmlp(x, gu.qweight, gu.scales, down.qweight, down.scales, bits=4, group_size=128,
             zc_gu=gu.zero_const, zc_d=down.zero_const)
    assert y.shape == (M, D) and _build.LAUNCHES["qmlp"] == 1 and len(calls) == 1
    split_gu, split_d = calls[0][12:14]
    want = ((qmatmul_mod.decode_plan(M, D, 2 * F, 128).split,
             qmatmul_mod.decode_plan(M, F, D, 128).split) if M <= 16 else (0, 0))
    assert (split_gu, split_d) == want
    assert min(want) >= (1 if M <= 16 else 0)
