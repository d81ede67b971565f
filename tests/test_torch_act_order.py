"""Asymmetric and act-order modules in the port against the JAX package.

K3's plain version (the route of every module with a zero point per group)
against the JAX package's ``_qmm_rt_kernel`` in interpret mode and against
its XLA reference; the act-order preparation (``act_perm``), its reversal in
the dequantization and in the export, fusion; and whole tiny checkpoints
written with ``sym=False`` and ``desc_act=True``, served and quantized by
both packages. Inputs are numpy arrays from a seed; the JAX Pallas kernels
run in interpret mode, as the JAX tests run them on the CPU.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptqmodel_tpu.models.auto import GPTQModel as JGPTQModel
from gptqmodel_tpu.models.optimize import _can_fuse as jcan_fuse
from gptqmodel_tpu.models.transformer import forward_logits as jforward
from gptqmodel_tpu.models.writer import flatten_params as jflatten
from gptqmodel_tpu.ops import registry as jregistry
from gptqmodel_tpu.ops.qlinear import dequantize_weight as jdequant
from gptqmodel_tpu.ops.qlinear import make_quant_linear, qlinear_forward_xla
from gptqmodel_tpu_torch import GPTQModel, QuantizeConfig
from gptqmodel_tpu_torch.convert import convert_quant_linear, to_torch
from gptqmodel_tpu_torch.models.optimize import _can_fuse, _concat_quant
from gptqmodel_tpu_torch.models.safetensors_io import load_file
from gptqmodel_tpu_torch.models.transformer import forward_logits
from gptqmodel_tpu_torch.models.writer import flatten_params
from gptqmodel_tpu_torch.ops import _build
from gptqmodel_tpu_torch.ops.pack import unpack_qweight
from gptqmodel_tpu_torch.ops.qlinear import dequantize_weight
from gptqmodel_tpu_torch.ops.qmatmul import qmatmul_asym, qmatmul_asym_plain
from gptqmodel_tpu_torch.ops.registry import (
    kernel_route,
    mlp_fusable,
    post_init_module,
    post_init_params,
    qlinear_forward,
)
from gptqmodel_tpu_torch.utils.testing import (
    act_order_g_idx,
    write_random_fp_checkpoint,
    write_random_gptq_checkpoint,
)

TINY_LLAMA = {
    "model_type": "llama", "vocab_size": 512, "hidden_size": 256,
    "intermediate_size": 512, "num_hidden_layers": 2, "num_attention_heads": 8,
    "num_key_value_heads": 4, "rms_norm_eps": 1e-5, "rope_theta": 500000.0,
    "max_position_embeddings": 2048, "tie_word_embeddings": False, "hidden_act": "silu",
    "eos_token_id": 511,
}


def _jmodule(bits=4, g=128, in_f=1024, out_f=256, seed=0, sym=False, act_order=True,
             scales="fp16"):
    """A JAX QuantLinear in the interchange layout, as
    ``tests/test_desc_act_fast_path.py`` builds it. ``scales``: "pow2"
    (exact in every type), "bf16" (bf16 values, exact in fp16 too) or
    "fp16"."""
    rng = np.random.default_rng(seed)
    G = in_f // g
    codes = rng.integers(0, 2**bits, size=(out_f, in_f), dtype=np.int64)
    if scales == "pow2":
        s = 2.0 ** rng.integers(-7, -4, size=(G, out_f))
    else:
        s = rng.uniform(0.005, 0.05, size=(G, out_f))
        if scales == "bf16":
            s = np.asarray(jnp.asarray(s, jnp.bfloat16), np.float32)
    if sym:
        zeros = np.full((G, out_f), 2 ** (bits - 1), np.int64)
    else:
        zeros = rng.integers(0, 2**bits, size=(G, out_f), dtype=np.int64)
    g_idx = act_order_g_idx(rng.permutation(in_f), g) if act_order else None
    p = make_quant_linear(Q=codes, scales=s.astype(np.float16), zeros=zeros, g_idx=g_idx,
                          bias=None, bits=bits, group_size=g, sym=sym)
    assert (p.g_idx is not None) == act_order
    return p


def _port(jm):
    return post_init_module(convert_quant_linear(jm, device="cpu"))


def _jax_kernel(jm, x):
    """The JAX package's registry forward on its post-init module, the
    Pallas kernels in interpret mode."""
    jq = jregistry.post_init_module(jm)
    assert jq.rt_layout
    jregistry.set_backend("pallas_interpret")
    try:
        return np.asarray(jregistry.qlinear_forward(jq, x).astype(jnp.float32))
    finally:
        jregistry.set_backend("auto")


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("act_order", [False, True])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_k3_plain_equals_jax_kernel_on_pow2_inputs(bits, act_order):
    """Power-of-two scales and integer activations make every product and
    partial sum exact in float32 on both sides: the port's route (the gather,
    then K3's plain version) and the JAX ``_qmm_rt_kernel`` round the same
    value once to bf16."""
    jm = _jmodule(bits=bits, seed=5 + bits, act_order=act_order, scales="pow2")
    tm = _port(jm)
    assert kernel_route(tm) == "K3" and (tm.act_perm is not None) == act_order
    x = np.random.default_rng(2).integers(-4, 5, size=(4, 1024)).astype(np.float32)
    ref = _jax_kernel(jm, jnp.asarray(x, jnp.bfloat16))
    got = qlinear_forward(tm, to_torch(x, "cpu").to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("M", [1, 8])
@pytest.mark.parametrize("act_order", [False, True])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_k3_plain_matches_jax_kernel_on_bf16_scales(bits, act_order, M):
    """Scales that are bf16 values (exact in fp16 too) are the same numbers
    on both sides, where the TPU kernel rounds scales to bf16 and the port
    does not; only the order of the f32 sums differs before one bf16
    rounding: 1e-3 relative."""
    jm = _jmodule(bits=bits, seed=20 + bits, act_order=act_order, scales="bf16")
    x = np.random.default_rng(3).standard_normal((M, 1024)).astype(np.float32)
    ref = _jax_kernel(jm, jnp.asarray(x, jnp.bfloat16))
    got = qlinear_forward(_port(jm), to_torch(x, "cpu").to(torch.bfloat16))
    assert _rel(got.float().numpy(), ref) <= 1e-3


@pytest.mark.parametrize("act_order", [False, True])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_k3_route_matches_xla_reference(bits, act_order):
    """Against ``qlinear_forward_xla`` on the module as loaded (it reads
    ``g_idx`` itself), with ordinary fp16 scales: the reference dequantizes
    to bf16, the port sums exact products in f32. The JAX package holds its
    own kernel to the same 8e-3 (``test_desc_act_pallas_matches_xla``)."""
    jm = _jmodule(bits=bits, seed=40 + bits, act_order=act_order)
    x = np.random.default_rng(4).standard_normal((8, 1024)).astype(np.float32)
    ref = np.asarray(qlinear_forward_xla(jm, jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    got = qlinear_forward(_port(jm), to_torch(x, "cpu").to(torch.bfloat16))
    assert _rel(got.float().numpy(), ref) < 8e-3


def test_k3_wrapper_takes_plain_version_on_cpu_only(monkeypatch):
    """A CPU tensor gets exactly the plain version; a tensor off the CPU asks
    for the kernel (refused here) and counts no launch."""
    tm = _port(_jmodule(seed=50, act_order=False))
    x = to_torch(np.random.default_rng(5).standard_normal((3, 1024)), "cpu").to(torch.bfloat16)
    args = (tm.qweight, tm.scales, tm.qzeros)
    assert torch.equal(qmatmul_asym(x, *args, bits=4, group_size=128),
                       qmatmul_asym_plain(x, *args, bits=4, group_size=128))

    def lib():
        raise RuntimeError("kernel library requested")

    monkeypatch.setattr(_build, "lib", lib)
    before = _build.LAUNCHES["qmatmul_asym"]
    meta = [t.to("meta") for t in args]
    with pytest.raises(RuntimeError, match="kernel library"):
        qmatmul_asym(x.to("meta"), *meta, bits=4, group_size=128)
    with pytest.raises(TypeError, match="bf16"):
        qmatmul_asym(x.to("meta").float(), *meta, bits=4, group_size=128)
    with pytest.raises(ValueError, match="qzeros"):
        qmatmul_asym(x.to("meta"), meta[0], meta[1], meta[2][:, :-1], bits=4, group_size=128)
    assert _build.LAUNCHES["qmatmul_asym"] == before


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_post_init_builds_act_perm(bits):
    """The JAX package's permutation, and the rows stored in its order."""
    jm = _jmodule(bits=bits, seed=60 + bits, sym=True)
    tm = _port(jm)
    np.testing.assert_array_equal(tm.act_perm.numpy(), jregistry._act_order_perm(jm))
    assert tm.act_perm.dtype == torch.int32 and tm.g_idx is not None
    assert kernel_route(tm) == "K1" and not mlp_fusable(tm, tm)
    codes = unpack_qweight(convert_quant_linear(jm, device="cpu").qweight, bits)
    assert torch.equal(unpack_qweight(tm.qweight, bits), codes[tm.act_perm.long()])
    assert post_init_module(tm) is tm  # prepared once


def test_post_init_params_prepares_in_place():
    """The walk replaces each module in its dict or list, so the loaded rows
    of an act-order module are dropped as its permuted rows are made."""
    loaded = convert_quant_linear(_jmodule(seed=65), device="cpu")
    tree = {"layers": [{"proj": loaded}], "norm": torch.ones(4)}
    assert post_init_params(tree) is tree
    assert tree["layers"][0]["proj"] is not loaded
    assert tree["layers"][0]["proj"].act_perm is not None


@pytest.mark.parametrize("sym", [True, False])
def test_dequant_reverses_act_perm(sym):
    jm = _jmodule(seed=70, sym=sym)
    np.testing.assert_array_equal(dequantize_weight(_port(jm)).numpy(),
                                  np.asarray(jdequant(jm)))


@pytest.mark.parametrize("sym", [True, False])
def test_export_round_trip_is_byte_equal(sym):
    """The rows go back to the order they were loaded in, and ``act_perm``
    never reaches a file: the tensors equal the JAX writer's, byte for byte,
    before and after post-init."""
    jm = _jmodule(seed=80, sym=sym)
    before = flatten_params(convert_quant_linear(jm, device="cpu"), "m")
    after = flatten_params(_port(jm), "m")
    ref = jflatten(jm, "m", {}, v1_zeros=True, conv1d_suffixes=())
    assert set(before) == set(after) == set(ref) == {"m.qweight", "m.qzeros", "m.scales",
                                                     "m.g_idx"}
    for k in ref:
        assert torch.equal(after[k], before[k]), k
        np.testing.assert_array_equal(after[k].numpy(), np.asarray(ref[k]))


def test_fusion_shares_the_permutation():
    """q/k/v-style members with one ``g_idx`` fuse into one module with one
    ``act_perm``, whose forward is the members' side by side."""
    a = _jmodule(seed=90, out_f=128)
    b = _jmodule(seed=91, out_f=128)
    b.g_idx = np.asarray(a.g_idx).copy()
    qa, qb = _port(a), _port(b)
    assert _can_fuse([qa, qb]) and jcan_fuse([jregistry.post_init_module(m) for m in (a, b)])
    fused = _concat_quant([qa, qb])
    assert torch.equal(fused.act_perm, qa.act_perm) and kernel_route(fused) == "K3"
    x = to_torch(np.random.default_rng(6).standard_normal((8, 1024)).astype(np.float32), "cpu")
    np.testing.assert_allclose(qlinear_forward(fused, x).numpy(),
                               torch.cat([qlinear_forward(qa, x), qlinear_forward(qb, x)],
                                         dim=-1).numpy(), rtol=1e-6, atol=1e-6)


def test_mismatched_permutations_do_not_fuse():
    qa, qb = (_port(_jmodule(seed=s, out_f=128)) for s in (92, 93))
    assert not _can_fuse([qa, qb])
    assert not _can_fuse([qa, _port(_jmodule(seed=94, out_f=128, act_order=False))])


def test_ragged_g_idx_takes_the_reference_route(monkeypatch):
    """A g_idx whose groups are not all ``group_size`` wide keeps the
    dequantize-then-matmul reference on any device, as the JAX package keeps
    it on XLA: on meta tensors it neither asks for a kernel nor raises."""
    monkeypatch.setattr(_build, "lib", lambda: pytest.fail("kernel library requested"))
    rng = np.random.default_rng(15)
    g_idx = np.zeros(256, np.int32)
    g_idx[:64] = 1  # groups of 192 and 64
    jm = make_quant_linear(
        Q=rng.integers(0, 16, size=(128, 256)), scales=rng.uniform(0.005, 0.05, (2, 128)),
        zeros=rng.integers(0, 16, size=(2, 128)), g_idx=g_idx, bias=None, bits=4,
        group_size=128, sym=False)
    tm = _port(jm)
    assert tm.act_perm is None and kernel_route(tm) == "reference"
    assert jregistry.post_init_module(jm).act_perm is None
    before = dict(_build.LAUNCHES)
    y = qlinear_forward(tm.to("meta"), torch.empty((4, 256), dtype=torch.bfloat16,
                                                   device="meta"))
    assert y.shape == (4, 128) and _build.LAUNCHES == before
    x = rng.standard_normal((4, 256)).astype(np.float32)
    np.testing.assert_allclose(qlinear_forward(tm, to_torch(x, "cpu")).numpy(),
                               np.asarray(qlinear_forward_xla(jm, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)


def _teacher_forced_logits(jmodel, tmodel, ids, toks, jdtype, tdtype):
    forced = np.concatenate([ids, toks[:, :-1]], axis=1)
    jl = np.asarray(jforward(jmodel.spec, jmodel.params, jnp.asarray(forced), dtype=jdtype),
                    np.float32)[:, ids.shape[1] - 1:]
    tl = forward_logits(tmodel.spec, tmodel.params, torch.as_tensor(forced),
                        tdtype).float().numpy()[:, ids.shape[1] - 1:]
    return tl, jl


@pytest.mark.parametrize("sym", [False, True])
def test_act_order_checkpoint_serves_as_jax(tmp_path, sym):
    """A tiny checkpoint written with ``desc_act=True`` (and per-group zeros
    with ``sym=False``) loads in both packages. The port fuses q/k/v and
    gate/up, runs K3 (asymmetric) or K1 (symmetric) after the gather and
    keeps K2 off; the JAX facade on the CPU runs its XLA path. The greedy
    tokens are the same in float32 and in bf16. Teacher-forced on them, the
    logits agree within 1e-5 in float32, where both compute exact products.
    In bf16 the port's logits lie within 1e-2 of the JAX package's float32
    ones (6.2e-3 asymmetric, 4.8e-3 symmetric, measured). The JAX package's
    own bf16 logits round every dequantized weight to bf16, the port's do
    not: they lie 8.1e-3 and 6.4e-3 from its float32 ones, and the two bf16
    runs 1.04e-2 (asymmetric) and 7.2e-3 (symmetric) apart. So the bf16 legs
    agree within 1e-2 on the symmetric checkpoint and within 2e-2, the limit
    ``test_checkpoints_round_trip_between_packages`` holds for the same
    reason, on the asymmetric one."""
    write_random_gptq_checkpoint(tmp_path, TINY_LLAMA, seed=11, sym=sym, desc_act=True)
    assert json.loads((tmp_path / "quantize_config.json").read_text())["desc_act"]
    ids = np.random.default_rng(12).integers(0, 511, (2, 9))
    jmodel = JGPTQModel.load(tmp_path).optimize()
    tmodel = GPTQModel.load(tmp_path, device="cpu").optimize()
    lp = tmodel.params["model"]["layers"][0]
    assert "qkv_proj" in lp["self_attn"] and "gate_up_proj" in lp["mlp"]
    assert not lp["mlp"].get("_fused")
    routes = {kernel_route(m) for m in (*lp["self_attn"].values(), *lp["mlp"].values())
              if not isinstance(m, bool)}
    assert routes == {"K1" if sym else "K3"}
    assert all(m.act_perm is not None for m in lp["self_attn"].values())
    logits = {}
    for jdtype, tdtype, tol in ((jnp.float32, torch.float32, 1e-5),
                                (jnp.bfloat16, torch.bfloat16, 1e-2 if sym else 2e-2)):
        ref = np.asarray(jmodel.generate(ids, max_new_tokens=6, dtype=jdtype))
        np.testing.assert_array_equal(tmodel.generate(ids, max_new_tokens=6, dtype=tdtype),
                                      ref)
        tl, jl = _teacher_forced_logits(jmodel, tmodel, ids, ref, jdtype, tdtype)
        assert _rel(tl, jl) <= tol, tdtype
        logits[tdtype] = tl, jl
    assert _rel(logits[torch.bfloat16][0], logits[torch.float32][1]) <= 1e-2


def test_device_draw_shares_the_zero_and_g_idx_rule(tmp_path):
    """``write_random_gptq_checkpoint(device=...)`` draws codes and scales
    with torch and the zeros and ``g_idx`` with the numpy rule: the same
    act-order ``g_idx`` as the numpy draw, zero points in the middle half of
    the codes, one permutation shared by q/k/v and by gate/up, and the port
    serves it on K3."""
    write_random_gptq_checkpoint(tmp_path / "np", TINY_LLAMA, seed=3, sym=False, desc_act=True)
    write_random_gptq_checkpoint(tmp_path / "dev", TINY_LLAMA, seed=3, sym=False,
                                 desc_act=True, device="cpu")
    shards = [f for f in sorted((tmp_path / "np").glob("*.safetensors"))
              if any(k.endswith("g_idx") for k in load_file(f))]
    assert len(shards) == TINY_LLAMA["num_hidden_layers"]
    for f in shards:
        a, b = load_file(f), load_file(tmp_path / "dev" / f.name)
        assert sorted(a) == sorted(b)
        for k in (k for k in a if k.endswith("g_idx")):
            assert a[k].equal(b[k]), k
        pre = next(k for k in b if k.endswith("q_proj.g_idx"))[:-len("q_proj.g_idx")]
        assert b[pre + "k_proj.g_idx"].equal(b[pre + "q_proj.g_idx"])
        for k in (k for k in b if k.endswith("qzeros")):
            words = b[k].numpy().view(np.uint32)[..., None]
            z = ((words >> (4 * np.arange(8, dtype=np.uint32))) & 15) + 1
            assert z.min() >= 4 and z.max() < 12, k
    tmodel = GPTQModel.load(tmp_path / "dev", device="cpu").optimize()
    qkv = tmodel.params["model"]["layers"][0]["self_attn"]["qkv_proj"]
    assert kernel_route(qkv) == "K3" and qkv.act_perm is not None
    ids = np.random.default_rng(4).integers(0, 511, (2, 5))
    assert tmodel.generate(ids, max_new_tokens=2, dtype=torch.float32).shape == (2, 2)


def test_asym_act_order_quantize_save_load(tmp_path):
    """``QuantizeConfig(sym=False, desc_act=True)``: quantize a tiny
    checkpoint, save it; the JAX package reads back the same dequantized
    weights, and both serve the same greedy tokens in float32; the port's
    load, post-init and save again write the same bytes."""
    write_random_fp_checkpoint(tmp_path / "fp", TINY_LLAMA, seed=0)
    ids = np.random.default_rng(1).integers(0, 512, (8, 32))
    qm = GPTQModel.load(tmp_path / "fp", QuantizeConfig(sym=False, desc_act=True), device="cpu")
    qm.quantize(ids, batch_size=4)
    o = qm.params["model"]["layers"][0]["self_attn"]["o_proj"]
    assert o.act_perm is not None and kernel_route(o) == "K3"
    qm.save(tmp_path / "q1")
    tmodel = GPTQModel.load(tmp_path / "q1", device="cpu")
    tmodel.save(tmp_path / "q2")
    for f in sorted((tmp_path / "q1").glob("*.safetensors")):
        a, b = load_file(f), load_file(tmp_path / "q2" / f.name)
        assert list(a) == list(b)
        for k in a:
            assert a[k].contiguous().view(torch.uint8).equal(b[k].contiguous().view(torch.uint8)), k
    jmodel = JGPTQModel.load(tmp_path / "q1")
    for li in range(2):
        for k in ("self_attn", "mlp"):
            for name, tp in tmodel.params["model"]["layers"][li][k].items():
                jp = jmodel.params["model"]["layers"][li][k][name]
                assert jp.g_idx is not None
                np.testing.assert_array_equal(dequantize_weight(tp).numpy(),
                                              np.asarray(jdequant(jp)))
    prompt = ids[:2, :12]
    ref = np.asarray(jmodel.optimize().generate(prompt, max_new_tokens=6, dtype=jnp.float32))
    got = tmodel.optimize().generate(prompt, max_new_tokens=6, dtype=torch.float32)
    np.testing.assert_array_equal(got, ref)
