"""3, 5, 6 and 7-bit GPTQ in the port against the JAX package, on the CPU.

The 3-bit stitched layout and the planar gptq_p layout, packed byte for byte
as the JAX package packs them; K4's and K5's plain versions (the route of
every 3/5/6/7-bit module inside their contract) against the JAX package's
``_qmm_rtp_sym_kernel`` and ``_qmm_rtp_kernel`` in interpret mode; the
routes against the JAX registry's; whole tiny checkpoints loaded, served,
saved and quantized by both packages. Inputs are numpy arrays from a seed.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptqmodel_tpu.looper import quantize_loop as jquantize_loop
from gptqmodel_tpu.models.auto import GPTQModel as JGPTQModel
from gptqmodel_tpu.models.transformer import forward_logits as jforward
from gptqmodel_tpu.models.writer import flatten_params as jflatten
from gptqmodel_tpu.ops import pack as jpack
from gptqmodel_tpu.ops import registry as jregistry
from gptqmodel_tpu.ops.qlinear import dequantize_weight as jdequant
from gptqmodel_tpu.ops.qlinear import make_quant_linear as jmake_quant_linear
from gptqmodel_tpu.quantization.config import QuantizeConfig as JQuantizeConfig
from gptqmodel_tpu.quantization.gptq import gptq_quantize as jgptq_quantize
from gptqmodel_tpu_torch import GPTQModel, QuantizeConfig
from gptqmodel_tpu_torch.convert import convert_quant_linear, to_torch
from gptqmodel_tpu_torch.models.safetensors_io import load_file
from gptqmodel_tpu_torch.models.transformer import forward_logits
from gptqmodel_tpu_torch.models.writer import flatten_params
from gptqmodel_tpu_torch.ops import _build
from gptqmodel_tpu_torch.ops import pack as tpack
from gptqmodel_tpu_torch.ops.qlinear import dequantize_weight, make_quant_linear
from gptqmodel_tpu_torch.ops.qmatmul import (
    qmatmul_planes,
    qmatmul_planes_asym,
    qmatmul_planes_asym_plain,
    qmatmul_planes_plain,
    qmatmul_planes_supported,
)
from gptqmodel_tpu_torch.ops.registry import kernel_route, post_init_module, qlinear_forward
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
# (bits, planar): the five layouts K4 and K5 read
LAYOUTS = [(3, False), (3, True), (5, True), (6, True), (7, True)]
LAYOUT_IDS = ["3-stitched", "3-planar", "5-planar", "6-planar", "7-planar"]


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# ------------------------------------------------------------------ packing

@pytest.mark.parametrize("bits,planar", LAYOUTS, ids=LAYOUT_IDS)
def test_qweight_packs_as_jax(bits, planar):
    """Codes -> words byte-equal to ``gptqmodel_tpu.ops.pack``, and back."""
    rng = np.random.default_rng(bits + 10 * planar)
    codes = rng.integers(0, 2**bits, size=(256, 96)).astype(np.int32)
    ref = jpack.pack_qweight(codes, bits, planar=planar)
    got = tpack.pack_qweight(torch.from_numpy(codes), bits, planar=planar)
    assert got.dtype == torch.int32 and tuple(got.shape) == (256 * bits // 32, 96)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(tpack.unpack_qweight(got, bits, planar=planar).numpy(), codes)
    words = rng.integers(0, 2**32, size=ref.shape, dtype=np.uint32).view(np.int32)
    np.testing.assert_array_equal(
        tpack.unpack_qweight(torch.from_numpy(words), bits, planar=planar).numpy(),
        jpack.unpack_qweight(words, bits, planar=planar))


@pytest.mark.parametrize("bits,planar", LAYOUTS, ids=LAYOUT_IDS)
@pytest.mark.parametrize("v1", [False, True])
def test_qzeros_pack_as_jax(bits, planar, v1):
    """Zero points, v1 and v2 in the stitched layout, v2 in the planar one
    (planar zeros are never v1)."""
    rng = np.random.default_rng(20 + bits)
    zeros = rng.integers(0, 2**bits, size=(4, 64)).astype(np.int32)
    if v1 and planar:
        with pytest.raises(ValueError, match="v2"):
            tpack.pack_qzeros(torch.from_numpy(zeros), bits, v1=True, planar=True)
        return
    ref = jpack.pack_qzeros(zeros, bits, v1=v1, planar=planar)
    got = tpack.pack_qzeros(torch.from_numpy(zeros), bits, v1=v1, planar=planar)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        tpack.unpack_qzeros(got, bits, v1=v1, planar=planar).numpy(), zeros)
    if v1:
        np.testing.assert_array_equal(tpack.convert_qzeros_v1_to_v2(got, bits).numpy(),
                                      jpack.convert_qzeros_v1_to_v2(ref, bits))


def test_pack_factor_and_planar_only_widths():
    """3 bits pack 32 codes per 3-word unit; 5, 6 and 7 bits have only the
    planar layout, and ``make_quant_linear`` packs them planar regardless."""
    assert tpack.pack_factor(3) == jpack.pack_factor(3) == 32
    assert tpack.PLANAR_ONLY_BITS == jpack.PLANAR_ONLY_BITS
    with pytest.raises(NotImplementedError, match="planar"):
        tpack.pack_qweight(torch.zeros((32, 8), dtype=torch.int32), 5)
    rng = np.random.default_rng(3)
    Q = rng.integers(0, 32, (64, 256))
    kw = dict(Q=Q, scales=rng.uniform(0.01, 0.02, (2, 64)).astype(np.float16),
              zeros=np.full((2, 64), 16), g_idx=None, bias=None, bits=5, group_size=128)
    tm, jm = make_quant_linear(**kw, device="cpu"), jmake_quant_linear(**kw)
    assert tm.planar and jm.planar
    np.testing.assert_array_equal(tm.qweight.numpy(), jm.qweight)
    np.testing.assert_array_equal(tm.qzeros.numpy(), jm.qzeros)


# ----------------------------------------------- K4 and K5 against the JAX kernels

def _jmodule(bits, planar, sym, seed, scales, in_f=2048, out_f=256, g=128, act_order=False):
    """A JAX QuantLinear in the storage layout. ``scales``: "pow2" (exact in
    every type) or "bf16" (bf16 values, exact in fp16 too)."""
    rng = np.random.default_rng(seed)
    G = in_f // g
    codes = rng.integers(0, 2**bits, size=(out_f, in_f), dtype=np.int64)
    if scales == "pow2":
        s = 2.0 ** rng.integers(-7, -4, size=(G, out_f))
    else:
        s = np.asarray(jnp.asarray(rng.uniform(0.005, 0.05, (G, out_f)), jnp.bfloat16),
                       np.float32)
    zeros = (np.full((G, out_f), 2 ** (bits - 1), np.int64) if sym
             else rng.integers(0, 2**bits, size=(G, out_f), dtype=np.int64))
    g_idx = act_order_g_idx(rng.permutation(in_f), g) if act_order else None
    return jmake_quant_linear(Q=codes, scales=s.astype(np.float16), zeros=zeros, g_idx=g_idx,
                              bias=None, bits=bits, group_size=g, sym=sym, planar=planar)


def _port(jm):
    return post_init_module(convert_quant_linear(jm, device="cpu"))


def _jax_kernel(jm, x):
    """The JAX registry's forward on its post-init module: the plane-split
    rt layout and K4 or K5 in interpret mode."""
    jq = jregistry.post_init_module(jm)
    assert jq.rt_layout
    jregistry.set_backend("pallas_interpret")
    try:
        return np.asarray(jregistry.qlinear_forward(jq, x).astype(jnp.float32))
    finally:
        jregistry.set_backend("auto")


@pytest.mark.parametrize("bits,planar", LAYOUTS, ids=LAYOUT_IDS)
@pytest.mark.parametrize("sym", [True, False])
def test_plain_versions_equal_jax_kernels_on_pow2_inputs(bits, planar, sym):
    """Power-of-two scales and integer activations make every product and
    partial sum exact in float32 on both sides: K4's or K5's plain version,
    on the port's route, and the JAX kernel round the same value once to
    bf16 (atol 1e-6, as the JAX package holds its own kernels), at M = 1
    and 8. K = 2048, g = 128: the JAX kernels' tile rule asks K >= 16 g."""
    jm = _jmodule(bits, planar, sym, seed=bits + 10 * planar + 100 * sym, scales="pow2")
    tm = _port(jm)
    assert kernel_route(tm) == ("K4" if sym else "K5") and tm.planar == planar
    for M in (1, 8):
        x = np.random.default_rng(2 + M).integers(-4, 5, size=(M, 2048)).astype(np.float32)
        ref = _jax_kernel(jm, jnp.asarray(x, jnp.bfloat16))
        got = qlinear_forward(tm, to_torch(x, "cpu").to(torch.bfloat16))
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("bits,planar", LAYOUTS, ids=LAYOUT_IDS)
@pytest.mark.parametrize("sym", [True, False])
def test_plain_versions_match_jax_kernels_on_bf16_scales(bits, planar, sym):
    """Scales that are bf16 values are the same numbers on both sides (the
    TPU kernels round scales and zeros to bf16, the port does not); only the
    order of the float32 sums differs before one bf16 rounding: 1e-3
    relative, at M = 1 and 8."""
    jm = _jmodule(bits, planar, sym, seed=30 + bits + 10 * planar + 100 * sym, scales="bf16")
    tm = _port(jm)
    for M in (1, 8):
        x = np.random.default_rng(3 + M).standard_normal((M, 2048)).astype(np.float32)
        xb = jnp.asarray(x, jnp.bfloat16)
        ref = _jax_kernel(jm, xb)
        got = qlinear_forward(tm, to_torch(np.asarray(xb.astype(jnp.float32)), "cpu").to(
            torch.bfloat16))
        assert _rel(got.float().numpy(), ref) <= 1e-3, M


@pytest.mark.parametrize("bits,planar", [(3, False), (7, True)], ids=["3-stitched", "7-planar"])
@pytest.mark.parametrize("sym", [True, False])
def test_act_order_plane_module_matches_jax_kernel(bits, planar, sym):
    """A balanced act-order module: post-init permutes its rows into group
    order in its own layout (the JAX package's permutation), the forward
    gathers x's columns, then K4 or K5; the dequantization and the export put
    the rows back."""
    jm = _jmodule(bits, planar, sym, seed=60 + bits, scales="pow2", act_order=True)
    tm = _port(jm)
    np.testing.assert_array_equal(tm.act_perm.numpy(), jregistry._act_order_perm(jm))
    codes = tpack.unpack_qweight(convert_quant_linear(jm, device="cpu").qweight, bits,
                                 planar=planar)
    assert torch.equal(tpack.unpack_qweight(tm.qweight, bits, planar=planar),
                       codes[tm.act_perm.long()])
    x = np.random.default_rng(5).integers(-4, 5, size=(4, 2048)).astype(np.float32)
    ref = _jax_kernel(jm, jnp.asarray(x, jnp.bfloat16))
    got = qlinear_forward(tm, to_torch(x, "cpu").to(torch.bfloat16))
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(dequantize_weight(tm).numpy(), np.asarray(jdequant(jm)))
    flat, jflat = flatten_params(tm, "m"), jflatten(jm, "m", {}, v1_zeros=not planar,
                                                    conv1d_suffixes=())
    assert set(flat) == set(jflat)
    for k in jflat:
        np.testing.assert_array_equal(flat[k].numpy(), np.asarray(jflat[k]), err_msg=k)


def test_wrappers_take_plain_versions_on_cpu_only(monkeypatch):
    """A CPU tensor gets exactly the plain version; a tensor off the CPU asks
    for the kernel (refused here) and counts no launch; 5-bit words said to
    be stitched raise."""
    tm = _port(_jmodule(3, False, False, seed=70, scales="bf16", in_f=256))
    x = to_torch(np.random.default_rng(6).standard_normal((3, 256)), "cpu").to(torch.bfloat16)
    kw = dict(bits=3, group_size=128, planar=False)
    assert torch.equal(qmatmul_planes(x, tm.qweight, tm.scales, zero_const=4.0, **kw),
                       qmatmul_planes_plain(x, tm.qweight, tm.scales, zero_const=4.0, **kw))
    assert torch.equal(qmatmul_planes_asym(x, tm.qweight, tm.scales, tm.qzeros, **kw),
                       qmatmul_planes_asym_plain(x, tm.qweight, tm.scales, tm.qzeros, **kw))

    def lib():
        raise RuntimeError("kernel library requested")

    monkeypatch.setattr(_build, "lib", lib)
    before = dict(_build.LAUNCHES)
    meta = [t.to("meta") for t in (x, tm.qweight, tm.scales, tm.qzeros)]
    with pytest.raises(RuntimeError, match="kernel library"):
        qmatmul_planes(*meta[:3], zero_const=4.0, **kw)
    with pytest.raises(RuntimeError, match="kernel library"):
        qmatmul_planes_asym(*meta, **kw)
    with pytest.raises(TypeError, match="bf16"):
        qmatmul_planes_asym(meta[0].float(), *meta[1:], **kw)
    with pytest.raises(ValueError, match="qzeros"):
        qmatmul_planes_asym(*meta[:3], meta[3][:, :-1], **kw)
    t5 = _port(_jmodule(5, True, True, seed=71, scales="bf16", in_f=256)).to("meta")
    with pytest.raises(ValueError, match="planar"):
        qmatmul_planes(meta[0], t5.qweight, t5.scales, zero_const=16.0, bits=5,
                       group_size=128, planar=False)
    assert _build.LAUNCHES == before


# ------------------------------------------------------------------- routes

def _jax_takes_a_kernel(jm) -> bool:
    """Whether the JAX registry sends the module, after its post-init, to a
    Pallas kernel (it raises under ``set_backend("pallas")`` otherwise)."""
    jq = jregistry.post_init_module(jm)
    jregistry.set_backend("pallas")
    try:
        return jregistry.select_kernel(jq) == "pallas"
    except ValueError:
        return False
    finally:
        jregistry.set_backend("auto")


def _route_module(bits, planar, g, K, g_idx, sym=True, N=128):
    rng = np.random.default_rng(bits * 7 + K)
    G = K // (g if g > 0 else K)
    if g_idx == "act_order":
        gi = act_order_g_idx(rng.permutation(K), g)
    elif g_idx == "ragged":
        gi = np.zeros(K, np.int32)
        gi[: K // 4] = 1
        G = 2
    else:
        gi = None
    zeros = (np.full((G, N), 2 ** (bits - 1)) if sym else rng.integers(0, 2**bits, (G, N)))
    return jmake_quant_linear(
        Q=rng.integers(0, 2**bits, (N, K)), scales=rng.uniform(0.01, 0.02, (G, N)),
        zeros=zeros, g_idx=gi, bias=None, bits=bits, group_size=g, sym=sym, planar=planar)


# (bits, planar, g, K, g_idx, sym) -> the port's route; "tile" marks a module
# the JAX package keeps on XLA only for its TPU tile rule K % (16 g) == 0
ROUTE_CASES = [
    (3, False, 128, 2048, None, True, "K4"), (3, False, 128, 2048, None, False, "K5"),
    (3, True, 128, 2048, None, True, "K4"), (5, True, 128, 2048, None, False, "K5"),
    (6, True, 256, 4096, None, True, "K4"), (7, True, 128, 2048, None, False, "K5"),
    (3, False, 128, 2048, "act_order", True, "K4"),
    (7, True, 128, 2048, "act_order", False, "K5"),
    (3, False, 32, 2048, None, True, "reference"), (5, True, 64, 2048, None, True, "reference"),
    (3, False, -1, 2080, None, True, "reference"), (3, False, 128, 2048, "ragged", True,
                                                     "reference"),
    (6, True, 32, 2048, "act_order", True, "reference"),
    (4, True, 128, 2048, None, True, "reference"), (4, False, 128, 2048, None, True, "K1"),
    (3, False, 128, 256, None, True, "K4 tile"), (7, True, 128, 1024, None, False, "K5 tile"),
    (3, False, -1, 2048, None, True, "K4 tile"),
]


@pytest.mark.parametrize("bits,planar,g,K,g_idx,sym,route", ROUTE_CASES)
def test_routes_match_the_jax_registry(bits, planar, g, K, g_idx, sym, route):
    """The port's route against the JAX registry's choice on the same
    module: a kernel where the JAX package takes one (K4/K5 where it takes
    ``_qmm_rtp_sym_kernel``/``_qmm_rtp_kernel``, with the same uniform zero
    point), the counted reference route where it takes XLA. The one
    difference is documented (ROADMAP queue 3): the JAX kernels' tiles ask
    ``K % (16 g) == 0`` at these widths, the port's take any ``K % g == 0``,
    so a module that only the tile rule keeps on XLA runs K4 or K5 here."""
    jm = _route_module(bits, planar, g, K, g_idx, sym)
    tm = _port(jm)
    want, _, tile = route.partition(" ")
    assert kernel_route(tm) == want
    assert tm.zero_const == jregistry.post_init_module(jm).zero_const
    assert (tm.act_perm is not None) == (want != "reference" and g_idx is not None)
    jax_kernel = _jax_takes_a_kernel(jm)
    if tile:
        gg = g if g > 0 else K
        assert not jax_kernel and K % (16 * gg) != 0
    else:
        assert jax_kernel == (want != "reference")
    if g_idx != "ragged":  # a ragged g_idx is outside any kernel whatever its shapes
        assert qmatmul_planes_supported(bits, g, K, 128) == (want in ("K4", "K5"))


def test_every_module_has_a_route_off_the_cpu(monkeypatch):
    """No 3/5/6/7-bit module raises: on meta tensors a K4 module asks for
    the kernel (refused here) and a group-32 one takes the reference route,
    which counts a launch on a CUDA tensor only."""
    def lib():
        raise RuntimeError("kernel library requested")

    monkeypatch.setattr(_build, "lib", lib)
    before = dict(_build.LAUNCHES)
    k4 = _port(_route_module(3, False, 128, 256, None)).to("meta")
    with pytest.raises(RuntimeError, match="kernel library"):
        qlinear_forward(k4, torch.empty((2, 256), dtype=torch.bfloat16, device="meta"))
    ref = _port(_route_module(3, False, 32, 256, None)).to("meta")
    y = qlinear_forward(ref, torch.empty((2, 5, 256), dtype=torch.bfloat16, device="meta"))
    assert y.shape == (2, 5, 128) and _build.LAUNCHES == before


def test_convert_refuses_the_jax_rt_layout():
    """After the JAX post-init a 3-bit module holds the plane-split words of
    ``repack_rt_planes``, which are no storage layout: ``convert`` refuses
    it rather than pass them on."""
    jm = _jmodule(3, False, True, seed=80, scales="bf16")
    jq = jregistry.post_init_module(jm)
    assert jq.rt_layout and not np.array_equal(np.asarray(jq.qweight), jm.qweight)
    with pytest.raises(ValueError, match="post-init"):
        convert_quant_linear(jq, device="cpu")
    assert torch.equal(convert_quant_linear(jm, device="cpu").qweight,
                       torch.from_numpy(np.asarray(jm.qweight)))


# -------------------------------------------------------------- whole model

# name -> (bits, format, sym, desc_act, limit between the two packages' bf16
# logits). The JAX package's bf16 path rounds every dequantized weight to
# bf16, the port's kernels do not: measured, the JAX bf16 logits lie
# 3.6e-3, 7.7e-3, 9.3e-3 and 8.4e-3 from its float32 ones, the port's
# 3.5e-3, 5.8e-3, 6.2e-3 and 6.2e-3, and the two bf16 runs 4.6e-3, 9.2e-3,
# 1.03e-2 and 9.8e-3 apart. So the bf16 legs are held to 1e-2 where the JAX
# package's own bf16 error leaves room (3-bit symmetric, as
# ``tests/test_torch_act_order.py``) and to 2e-2, that file's limit for the
# same reason, elsewhere. The anchor in all is the JAX package's float32
# logits: the port's bf16 ones lie within 1e-2 of them, and, where the pair
# is held to 2e-2, no further from them than the JAX package's own bf16
# ones, so the wider limit covers the reference's rounding alone.
CHECKPOINTS = {
    "3bit-sym": (3, "gptq", True, False, 1e-2),
    "3bit-asym-act": (3, "gptq", False, True, 2e-2),
    "5bit-gptq_p-sym": (5, "gptq_p", True, False, 2e-2),
    "7bit-gptq_p-asym": (7, "gptq_p", False, False, 2e-2),
}


@pytest.fixture(scope="module", params=list(CHECKPOINTS))
def checkpoint(request, tmp_path_factory):
    bits, fmt, sym, act, tol = CHECKPOINTS[request.param]
    d = tmp_path_factory.mktemp(request.param)
    write_random_gptq_checkpoint(d, TINY_LLAMA, seed=11, bits=bits, sym=sym, desc_act=act,
                                 format=fmt)
    return d, bits, fmt, sym, act, tol


def test_checkpoint_serves_as_jax(checkpoint):
    """Loaded by both packages: the port fuses q/k/v and gate/up and runs K4
    (symmetric) or K5 after any act-order gather, K2 off; the JAX package's
    facade on the CPU runs its XLA path (its tile rule keeps these widths off
    its K4 and K5 anyway). The greedy tokens are the same in float32 and in
    bf16. Teacher-forced on them, the logits agree within 1e-5 in float32,
    the bf16 legs within the limits of ``CHECKPOINTS``, and the port's bf16
    logits lie within 1e-2 of the JAX package's float32 ones (and, where
    the pair is held to 2e-2, no further than the JAX bf16 ones). The JAX side
    of a gptq_p checkpoint is not fused: its ``_concat_quant`` drops
    ``planar`` (ROADMAP queue 3)."""
    d, bits, fmt, sym, act, tol = checkpoint
    assert json.loads((d / "quantize_config.json").read_text())["checkpoint_format"] == fmt
    ids = np.random.default_rng(12).integers(0, 511, (2, 9))
    jmodel = JGPTQModel.load(d)
    if fmt != "gptq_p":
        jmodel.optimize()
    tmodel = GPTQModel.load(d, device="cpu").optimize()
    lp = tmodel.params["model"]["layers"][0]
    assert "qkv_proj" in lp["self_attn"] and "gate_up_proj" in lp["mlp"]
    assert not lp["mlp"].get("_fused")
    mods = [m for m in (*lp["self_attn"].values(), *lp["mlp"].values())]
    assert {kernel_route(m) for m in mods} == {"K4" if sym else "K5"}
    assert all(m.planar == (fmt == "gptq_p") and (m.act_perm is not None) == act for m in mods)
    logits = {}
    for jdtype, tdtype, limit in ((jnp.float32, torch.float32, 1e-5),
                                  (jnp.bfloat16, torch.bfloat16, tol)):
        ref = np.asarray(jmodel.generate(ids, max_new_tokens=6, dtype=jdtype))
        np.testing.assert_array_equal(tmodel.generate(ids, max_new_tokens=6, dtype=tdtype),
                                      ref)
        forced = np.concatenate([ids, ref[:, :-1]], axis=1)
        jl = np.asarray(jforward(jmodel.spec, jmodel.params, jnp.asarray(forced), dtype=jdtype),
                        np.float32)[:, ids.shape[1] - 1:]
        tl = forward_logits(tmodel.spec, tmodel.params, torch.as_tensor(forced),
                            tdtype).float().numpy()[:, ids.shape[1] - 1:]
        assert _rel(tl, jl) <= limit, tdtype
        logits[tdtype] = tl, jl
    port_bf16, jax_bf16 = logits[torch.bfloat16]
    jax_f32 = logits[torch.float32][1]
    assert _rel(port_bf16, jax_f32) <= 1e-2
    if tol > 1e-2:
        assert _rel(port_bf16, jax_f32) <= _rel(jax_bf16, jax_f32)


def test_checkpoint_saves_as_it_was_written_and_as_jax_saves_it(checkpoint, tmp_path):
    """``load -> post_init -> save`` in the port gives back every tensor of
    the checkpoint byte for byte (act-order rows put back, planar words and
    v2 zeros as they are, 3-bit v1 zeros in the stitched layout), and the JAX
    writer's tensors for its own load of the same checkpoint."""
    d, bits, fmt, *_ = checkpoint
    tmodel = GPTQModel.load(d, device="cpu")
    tmodel.save(tmp_path / "port")
    JGPTQModel.load(d).save(tmp_path / "jax")
    saved_cfg = json.loads((tmp_path / "port" / "quantize_config.json").read_text())
    assert saved_cfg["checkpoint_format"] == fmt and saved_cfg["bits"] == bits
    src = {}
    for f in sorted(d.glob("*.safetensors")):
        src.update(load_file(f))
    for name in ("port", "jax"):
        got = {}
        for f in sorted((tmp_path / name).glob("*.safetensors")):
            got.update(load_file(f))
        assert set(got) == set(src), name
        for k, t in src.items():
            assert got[k].dtype == t.dtype and got[k].shape == t.shape, (name, k)
            assert got[k].contiguous().view(torch.uint8).equal(
                t.contiguous().view(torch.uint8)), (name, k)


# ------------------------------------------------------------- quantization

QUANT_LLAMA = dict(TINY_LLAMA, num_attention_heads=4, num_key_value_heads=2)
MODULES = ["self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj", "self_attn.o_proj",
           "mlp.gate_proj", "mlp.up_proj", "mlp.down_proj"]


def _get(tree, path):
    for part in path.split("."):
        tree = tree[part]
    return tree


def _with_noisy_hessians(solve, seed):
    """``solve`` with each Hessian perturbed by one float32 ulp (as
    ``tests/test_torch_quantize.py`` measures the reference's own drift)."""
    rng = np.random.default_rng(seed)

    def run(W, H, **kw):
        H = np.asarray(H, np.float32)
        H = H * (1 + np.float32(2**-23) * rng.choice(np.float32([-1, 1]), H.shape))
        return solve(W, np.triu(H) + np.triu(H, 1).T, **kw)

    return run


@pytest.fixture(scope="module", params=[3, 5])
def quantized(request, tmp_path_factory):
    """Both packages quantize one tiny checkpoint at ``bits``; the reference
    three times more with one-ulp noise on its Hessians, for its own
    drift."""
    bits = request.param
    d = tmp_path_factory.mktemp(f"quant{bits}")
    write_random_fp_checkpoint(d / "fp", QUANT_LLAMA, seed=0)
    ids = np.random.default_rng(1).integers(0, 512, (16, 64))
    noisy = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GPTQ_TPU_QUANT_LOG", str(d / "jax_quant_log.stream.csv"))
        jm = JGPTQModel.load(d / "fp", JQuantizeConfig(bits=bits, group_size=128))
        jlog = jm.quantize(ids, batch_size=4)
        for seed in range(3):
            mp.setattr(jquantize_loop, "gptq_quantize",
                       _with_noisy_hessians(jgptq_quantize, seed))
            jn = JGPTQModel.load(d / "fp", JQuantizeConfig(bits=bits, group_size=128))
            noisy.append((jn, jn.quantize(ids, batch_size=4)))
    tm = GPTQModel.load(d / "fp", QuantizeConfig(bits=bits, group_size=128), device="cpu")
    tlog = tm.quantize(ids, batch_size=4)
    tm.save(d / "by_port")
    return d, bits, jm, jlog, tm, tlog, noisy


def _codes(p):
    return tpack.unpack_qweight(torch.as_tensor(np.asarray(p.qweight)), p.bits,
                                planar=p.planar)


def test_quantize_matches_jax(quantized):
    """``QuantizeConfig(bits=3)`` and ``(bits=5)`` against the JAX package
    with ``tests/test_torch_quantize.py::test_quantize_matches_jax``'s
    limits: per module, codes within 2e-3 in layer 0 and 1e-2 in layer 1,
    or 1.5x the reference's own drift where that is larger; where the codes
    agree that far, scales within 1e-4, except at most 1.5x the share of
    scales that the reference's own drift moves past 1e-4, and those no
    further than 1.5x the furthest any scale of the module goes in the
    reference's own drift (at 5 bits one flipped code upstream moves 0.4% of
    layer 0's o_proj scales, by up to 7.7e-3, in the port's run and in the
    reference's own alike; at 3 bits the port's scales all lie within 1e-4);
    losses within 1e-2 or 1.5x the drift. 5 bits pack planar in both."""
    _, bits, jm, jlog, tm, tlog, noisy = quantized
    assert len(tlog) == len(jlog) == 2 * 7
    losses = {(r["layer"], r["module"]): r["loss"] for r in tlog}
    ref_losses = {(r["layer"], r["module"]): r["loss"] for r in jlog}
    for li, limit in ((0, 2e-3), (1, 1e-2)):
        for m in MODULES:
            p, r = (_get(x.params["model"]["layers"][li], m) for x in (tm, jm))
            assert p.bits == r.bits == bits and p.planar == r.planar == (bits == 5)
            frac = float((_codes(p) != _codes(r)).float().mean())
            drift = max(float((_codes(_get(n.params["model"]["layers"][li], m))
                               != _codes(r)).float().mean()) for n, _ in noisy)
            assert frac <= max(limit, 1.5 * drift), (li, m, frac, drift)
            if frac <= 2e-3:
                rs = np.asarray(r.scales, np.float32)
                rel = lambda s: np.abs(np.asarray(s, np.float32) - rs) / np.abs(rs)
                noisy_rel = [rel(_get(n.params["model"]["layers"][li], m).scales)
                             for n, _ in noisy]
                got_rel = rel(p.scales.float().numpy())
                moved = float((got_rel > 1e-4).mean())
                scale_drift = max(float((x > 1e-4).mean()) for x in noisy_rel)
                assert moved <= 1.5 * scale_drift, (li, m, moved, scale_drift)
                furthest = max(float(x.max()) for x in noisy_rel)
                assert float(got_rel.max()) <= max(1e-4, 1.5 * furthest), (li, m, furthest)
            ref = ref_losses[(li, m)]
            loss_drift = max(abs({(x["layer"], x["module"]): x["loss"]
                                  for x in nlog}[(li, m)] - ref) / ref for _, nlog in noisy)
            assert abs(losses[(li, m)] - ref) <= max(1e-2, 1.5 * loss_drift) * ref + 1e-8


def test_quantized_checkpoint_round_trips(quantized, tmp_path):
    """The port's save: ``gptq_p`` for 5 bits (v2 zeros), v1 stitched for 3;
    the JAX package reads back the port's dequantized weights; the port's
    load, post-init and save again write the same bytes; the loaded model
    runs K4."""
    d, bits, _, _, tm, *_ = quantized
    cfg = json.loads((d / "by_port" / "quantize_config.json").read_text())
    assert cfg["checkpoint_format"] == ("gptq_p" if bits == 5 else "gptq")
    served = GPTQModel.load(d / "by_port", device="cpu")
    served.save(tmp_path / "again")
    for f in sorted((d / "by_port").glob("*.safetensors")):
        a, b = load_file(f), load_file(tmp_path / "again" / f.name)
        assert list(a) == list(b)
        for k in a:
            assert a[k].contiguous().view(torch.uint8).equal(b[k].contiguous().view(torch.uint8)), k
    jmodel = JGPTQModel.load(d / "by_port")
    for li in range(2):
        for m in MODULES:
            tp = _get(served.params["model"]["layers"][li], m)
            assert kernel_route(tp) == "K4" and tp.planar == (bits == 5)
            np.testing.assert_array_equal(
                dequantize_weight(tp).numpy(),
                np.asarray(jdequant(_get(jmodel.params["model"]["layers"][li], m))))
