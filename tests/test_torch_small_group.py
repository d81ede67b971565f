"""Groups of 32 and 64 (K6) in the port against the JAX package.

K6's plain version (the route of contiguous 2/4/8-bit modules outside K1's
contract at most 256 rows) against the JAX package's ``_qmm_kernel``
(``qmatmul(..., rt=False)``) in interpret mode; the routes of the registry
case by case; the conversion of JAX modules; a tiny group-32 checkpoint
served by both packages, the JAX registry on its Pallas kernels in
interpret mode; and a group-32 checkpoint the port quantizes, saves and
serves. Inputs are numpy arrays from a seed.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptqmodel_tpu.models.auto import GPTQModel as JGPTQModel
from gptqmodel_tpu.models.transformer import forward_logits as jforward
from gptqmodel_tpu.ops import pallas_qmatmul
from gptqmodel_tpu.ops import registry as jregistry
from gptqmodel_tpu.ops.qlinear import dequantize_weight as jdequant
from gptqmodel_tpu.ops.qlinear import make_quant_linear, qlinear_forward_xla
from gptqmodel_tpu_torch import GPTQModel, QuantizeConfig
from gptqmodel_tpu_torch.convert import convert_quant_linear, to_torch
from gptqmodel_tpu_torch.models.optimize import _concat_quant
from gptqmodel_tpu_torch.models.safetensors_io import load_file
from gptqmodel_tpu_torch.models.transformer import forward_logits
from gptqmodel_tpu_torch.ops import _build, registry
from gptqmodel_tpu_torch.ops.qlinear import QuantLinear, dequantize_weight, qlinear_forward_torch
from gptqmodel_tpu_torch.ops.qmatmul import qmm, qmm_plain, qmm_supported
from gptqmodel_tpu_torch.ops.registry import (
    PALLAS_MAX_M,
    kernel_route,
    mlp_fusable,
    post_init_module,
    qlinear_forward,
)
from gptqmodel_tpu_torch.utils.testing import (
    write_random_fp_checkpoint,
    write_random_gptq_checkpoint,
)

# every module inside the JAX package's ``supports``: N a multiple of 128
# (q 256, k and v 4 heads of 32 = 128, gate and up 512, o and down 256)
TINY_LLAMA = {
    "model_type": "llama", "vocab_size": 512, "hidden_size": 256,
    "intermediate_size": 512, "num_hidden_layers": 2, "num_attention_heads": 8,
    "num_key_value_heads": 4, "rms_norm_eps": 1e-5, "rope_theta": 500000.0,
    "max_position_embeddings": 2048, "tie_word_embeddings": False, "hidden_act": "silu",
    "eos_token_id": 511,
}


def _jmodule(bits, g, sym, in_f=256, out_f=256, seed=0, scales="fp16"):
    """A JAX QuantLinear in the interchange layout (v1 zeros, fp16 scales,
    contiguous groups). ``scales``: "pow2" (exact in every type) or "fp16"."""
    rng = np.random.default_rng(seed)
    G = in_f // g
    codes = rng.integers(0, 2**bits, size=(out_f, in_f))
    if scales == "pow2":
        s = 2.0 ** rng.integers(-7, -4, size=(G, out_f))
    else:
        s = rng.uniform(0.005, 0.05, size=(G, out_f))
    zeros = (np.full((G, out_f), 2 ** (bits - 1)) if sym
             else rng.integers(0, 2**bits, size=(G, out_f)))
    return make_quant_linear(Q=codes.astype(np.int32), scales=s.astype(np.float16),
                             zeros=zeros.astype(np.int32), g_idx=None, bias=None, bits=bits,
                             group_size=g, sym=sym, v1=True)


def _port(jm):
    return post_init_module(convert_quant_linear(jm, device="cpu"))


def _jax_k6(jm, x):
    """The JAX package's ``_qmm_kernel`` on the module, in interpret mode."""
    jq = jregistry.post_init_module(jm)
    assert not jq.rt_layout
    y = pallas_qmatmul.qmatmul(jnp.asarray(x), jm.qweight, jq.scales, jq.zvals, bits=jm.bits,
                               group_size=jm.group_size, rt=False, interpret=True)
    return np.asarray(y.astype(jnp.float32))


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("M", [1, 7, 16])
@pytest.mark.parametrize("sym", [True, False])
@pytest.mark.parametrize("g", [32, 64])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_k6_plain_matches_jax_kernel(bits, g, sym, M):
    """Both sides dequantize each weight to ``bf16(bf16(c - z) * bf16(s))``
    and sum exact products in float32, in another order, before one bf16
    rounding: 1e-3 relative."""
    jm = _jmodule(bits, g, sym, seed=bits * 10 + g + sym)
    tm = _port(jm)
    assert kernel_route(tm) == "K6" and (tm.zero_const >= 0) == sym
    x = np.random.default_rng(M).standard_normal((M, 256)).astype(np.float32)
    ref = _jax_k6(jm, jnp.asarray(x, jnp.bfloat16))
    got = qmm_plain(to_torch(x, "cpu").to(torch.bfloat16), tm.qweight, tm.scales, tm.qzeros,
                    bits=bits, group_size=g, zero_const=tm.zero_const)
    assert got.dtype == torch.bfloat16 and got.shape == (M, 256)
    assert _rel(got.float().numpy(), ref) <= 1e-3


@pytest.mark.parametrize("sym", [True, False])
@pytest.mark.parametrize("g", [32, 64])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_k6_plain_equals_jax_kernel_on_pow2_inputs(bits, g, sym):
    """Power-of-two scales, integer zeros and small-integer activations make
    every weight, product and partial sum exact: both sides round the same
    value once to bf16, so they agree bit for bit. A scale or zero read
    from the wrong group or column, or a wrong field of a word, breaks it."""
    jm = _jmodule(bits, g, sym, seed=100 + bits * 10 + g + sym, scales="pow2")
    tm = _port(jm)
    x = np.random.default_rng(7).integers(-4, 5, size=(7, 256)).astype(np.float32)
    ref = _jax_k6(jm, jnp.asarray(x, jnp.bfloat16))
    got = qlinear_forward(tm, to_torch(x, "cpu").to(torch.bfloat16))
    np.testing.assert_array_equal(got.float().numpy(), ref)


def test_k6_plain_is_the_bf16_reference_route():
    """K6 and the route above 256 rows (dequantize to bf16, then the
    product) dequantize to the same bf16 weights: with exact sums they agree
    bit for bit. A float32 x is rounded to bf16 and the result kept in
    float32, as the TPU kernel does."""
    jm = _jmodule(4, 32, False, seed=3, scales="pow2")
    tm = _port(jm)
    x = to_torch(np.random.default_rng(8).integers(-4, 5, size=(5, 256)), "cpu").float()
    kw = dict(bits=4, group_size=32, zero_const=tm.zero_const)
    got = qmm_plain(x.to(torch.bfloat16), tm.qweight, tm.scales, tm.qzeros, **kw)
    assert torch.equal(got, qlinear_forward_torch(tm, x.to(torch.bfloat16)))
    xf = x / 3  # not bf16 values
    y32 = qmm_plain(xf, tm.qweight, tm.scales, tm.qzeros, **kw)
    assert y32.dtype == torch.float32
    np.testing.assert_allclose(y32.numpy(), _jax_k6(jm, jnp.asarray(xf.numpy())), rtol=1e-6,
                               atol=1e-6)
    assert _rel(y32.numpy(), qlinear_forward_torch(tm, xf).numpy()) > 1e-4


@pytest.mark.parametrize("bits,g,K,N,ok,jax_ok", [
    (4, 32, 256, 256, True, True), (4, 64, 4096, 6144, True, True),
    (2, 16, 256, 128, True, True), (8, 8, 256, 128, True, True),
    (4, 16, 14336, 4096, True, True),
    (4, 32, 256, 192, False, False),  # N % 128
    (4, 4, 256, 128, False, False),   # g % 8
    (2, 8, 256, 128, False, False),   # g % (32/bits): a word would span two groups
    (4, 32, 250, 128, False, False),  # K % g
    (3, 32, 256, 128, False, False),  # 3 bits: K4 / K5
    (4, 48, 240, 128, False, True),   # K % 32: the kernel's 4-word steps
    (2, 16, 240, 128, False, True),   # K % 64
])
def test_qmm_supported_is_the_jax_contract_narrowed(bits, g, K, N, ok, jax_ok):
    """``qmm_supported`` is the JAX package's ``supports`` on contiguous
    groups, narrowed by ``K % (128/bits) == 0`` (the last two cases)."""
    assert qmm_supported(bits, g, K, N) == ok
    assert pallas_qmatmul.supports(bits, g, K, N, True) == jax_ok


def _refuse_build(monkeypatch):
    def lib():
        raise RuntimeError("kernel library requested")

    monkeypatch.setattr(_build, "lib", lib)


def _count_calls(monkeypatch):
    """Wrap the registry's kernel wrappers and the reference forward with
    counters of their calls."""
    calls = {}

    def wrap(name):
        fn = getattr(registry, name)

        def counted(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **kw)

        monkeypatch.setattr(registry, name, counted)

    for name in ("qmatmul", "qmatmul_asym", "qmatmul_fused", "qmm", "qlinear_forward_torch"):
        wrap(name)
    return calls


@pytest.mark.parametrize("case,rows,route,want", [
    ("g128 sym", 1, "K1", "qmatmul"), ("g128 sym", 1024, "K1", "qmatmul"),
    ("g128 sym fused", 8, "K1", "qmatmul_fused"), ("g128 asym", 300, "K3", "qmatmul_asym"),
    ("g32 sym", 1, "K6", "qmm"), ("g32 sym", PALLAS_MAX_M, "K6", "qmm"),
    ("g32 sym", PALLAS_MAX_M + 1, "K6", "qlinear_forward_torch"),
    ("g64 asym", 8, "K6", "qmm"), ("g64 asym", 300, "K6", "qlinear_forward_torch"),
    ("g32 N=192", 1, "reference", "qlinear_forward_torch"),
    ("g32 act-order", 1, "reference", "qlinear_forward_torch"),
    ("g16 K=240", 1, "reference", "qlinear_forward_torch"),
])
def test_route_table(monkeypatch, case, rows, route, want):
    """The JAX registry's routes (``select_kernel``, ``PALLAS_MAX_M``): K1 (K7
    under ``GPTQ_TPU_RT_FUSED=1``) and K3 at any M; K6 at most 256 rows,
    the dequantize-then-matmul reference above and outside K6's contract;
    act-order at group 32 on the reference. On the CPU each wrapper takes
    its plain version, so the call reaches the wrapper the card would
    launch."""
    bits = 4
    g = int(case.split()[0][1:])
    in_f, out_f = (240, 128) if "K=240" in case else (256, 192 if "N=192" in case else 256)
    jm = _jmodule(bits, g, "asym" not in case, in_f=in_f, out_f=out_f, seed=rows)
    if "act-order" in case:
        jm.g_idx = (np.random.default_rng(1).permutation(in_f) // g).astype(np.int32)
    tm = _port(jm)
    if "fused" in case:
        monkeypatch.setenv("GPTQ_TPU_RT_FUSED", "1")
    calls = _count_calls(monkeypatch)
    x = np.random.default_rng(2).standard_normal((rows, in_f)).astype(np.float32)
    y = qlinear_forward(tm, to_torch(x, "cpu").to(torch.bfloat16))
    assert y.shape == (rows, out_f) and calls == {want: 1} and kernel_route(tm) == route
    ref = np.asarray(qlinear_forward_xla(jm, jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    assert _rel(y.float().numpy(), ref) <= 1e-2


def test_routes_off_the_cpu(monkeypatch):
    """On tensors off the CPU (here on the meta device) a group-32 module
    asks for K6 up to 256 rows and takes the counted reference route above;
    a 3-bit group-32 module, outside K4's contract, takes the reference
    route at any size, as the JAX package keeps it on XLA."""
    _refuse_build(monkeypatch)
    tm = _port(_jmodule(4, 32, True)).to("meta")
    before = dict(_build.LAUNCHES)
    with pytest.raises(RuntimeError, match="kernel library"):
        qlinear_forward(tm, torch.empty((2, 1, 256), dtype=torch.bfloat16, device="meta"))
    y = qlinear_forward(tm, torch.empty((2, 150, 256), dtype=torch.bfloat16, device="meta"))
    assert y.shape == (2, 150, 256)
    assert _build.LAUNCHES == before  # the reference counts on a CUDA tensor only
    p3 = QuantLinear(
        qweight=torch.empty((24, 128), dtype=torch.int32, device="meta"),
        qzeros=torch.empty((8, 12), dtype=torch.int32, device="meta"),
        scales=torch.empty((8, 128), dtype=torch.float16, device="meta"), g_idx=None,
        bias=None, bits=3, group_size=32, in_features=256, out_features=128, zero_const=4.0)
    assert kernel_route(p3) == "reference"
    y3 = qlinear_forward(p3, torch.empty((1, 256), dtype=torch.bfloat16, device="meta"))
    assert y3.shape == (1, 128) and _build.LAUNCHES == before


def test_k6_wrapper_takes_plain_version_on_cpu_only(monkeypatch):
    """A CPU tensor gets exactly the plain version; off the CPU the wrapper
    refuses f32 activations, a wrong ``qzeros`` shape and a group that
    splits a word before it asks for the kernel, and counts no launch."""
    tm = _port(_jmodule(4, 32, False, seed=4))
    x = to_torch(np.random.default_rng(5).standard_normal((3, 256)), "cpu").to(torch.bfloat16)
    args = (tm.qweight, tm.scales, tm.qzeros)
    kw = dict(bits=4, group_size=32, zero_const=tm.zero_const)
    assert torch.equal(qmm(x, *args, **kw), qmm_plain(x, *args, **kw))
    _refuse_build(monkeypatch)
    before = _build.LAUNCHES["qmm"]
    meta = [t.to("meta") for t in args]
    with pytest.raises(RuntimeError, match="kernel library"):
        qmm(x.to("meta"), *meta, **kw)
    with pytest.raises(TypeError, match="bf16"):
        qmm(x.to("meta").float(), *meta, **kw)
    with pytest.raises(ValueError, match="qzeros"):
        qmm(x.to("meta"), meta[0], meta[1], meta[2][:, :-1], **kw)
    with pytest.raises(ValueError, match="does not take"):
        qmm(x.to("meta"), *meta, bits=4, group_size=4, zero_const=tm.zero_const)
    assert _build.LAUNCHES["qmm"] == before


def test_fused_group32_modules_route_to_k6():
    """q/k/v and gate/up fuse at group 32 as at 128; the fused module runs K6,
    equal to its members side by side, and K2 never takes the MLP."""
    mods = [_port(_jmodule(4, 32, True, out_f=n, seed=n)) for n in (256, 128, 128)]
    fused = _concat_quant(mods)
    assert kernel_route(fused) == "K6" and fused.zero_const == 8.0
    assert not mlp_fusable(fused, mods[0])
    x = to_torch(np.random.default_rng(6).standard_normal((4, 256)), "cpu").to(torch.bfloat16)
    np.testing.assert_array_equal(qlinear_forward(fused, x).float().numpy(),
                                  torch.cat([qlinear_forward(m, x) for m in mods], 1)
                                  .float().numpy())


@pytest.mark.parametrize("g", [32, 64])
def test_convert_carries_group32_modules(g):
    """``convert.py`` needs nothing new: a JAX module at group 32 or 64, as
    loaded and after the JAX post-init (no repack below group 128), becomes
    the same arrays in the port, and the port's K6 gives the JAX K6's
    result."""
    jm = _jmodule(4, g, False, seed=g)
    jq = jregistry.post_init_module(jm)
    for src in (jm, jq):
        tm = convert_quant_linear(src, device="cpu")
        for f in ("qweight", "qzeros", "scales"):
            np.testing.assert_array_equal(getattr(tm, f).numpy(), np.asarray(getattr(jm, f)))
        np.testing.assert_array_equal(dequantize_weight(tm).numpy(), np.asarray(jdequant(jm)))
    x = np.random.default_rng(9).standard_normal((3, 256)).astype(np.float32)
    got = qlinear_forward(_port(jm), to_torch(x, "cpu").to(torch.bfloat16))
    assert _rel(got.float().numpy(), _jax_k6(jm, jnp.asarray(x, jnp.bfloat16))) <= 1e-3


@pytest.fixture
def jax_on_pallas_interpret():
    jregistry.set_backend("pallas_interpret")
    try:
        yield
    finally:
        jregistry.set_backend("auto")


@pytest.mark.parametrize("g,sym", [(32, True), (64, False)])
def test_group32_checkpoint_serves_as_jax(tmp_path, jax_on_pallas_interpret, g, sym):
    """A tiny checkpoint at group 32 (symmetric) or 64 (asymmetric) through
    both packages, the JAX registry on its Pallas kernels in interpret mode:
    every projection of the prompt and of each step runs K6 in both (at most
    256 rows), q/k/v and gate/up fused, K2 off. The greedy tokens are equal
    in float32 and in bf16. Teacher-forced on them, the logits agree within
    1e-2 in bf16 (4.7e-3 at group 32, 5.4e-3 at 64, measured: the same bf16
    weights and products, float32 sums in another order). In float32 the
    limit is 2e-3, not 1e-5: K6 rounds x to bf16 in both packages, as the
    TPU kernel does, so one float32 ulp between the packages' activations
    flips a bf16 rounding about once in 2^16 values. Measured: 9.0e-4 at
    both group sizes, where the rows and positions without a flip agree
    within 5e-7 and a flip at one prompt position moves that row's later
    logits by up to 8.5e-4."""
    write_random_gptq_checkpoint(tmp_path, TINY_LLAMA, seed=21, group_size=g, sym=sym)
    assert json.loads((tmp_path / "quantize_config.json").read_text())["group_size"] == g
    ids = np.random.default_rng(22).integers(0, 511, (2, 9))
    jmodel = JGPTQModel.load(tmp_path).optimize()
    tmodel = GPTQModel.load(tmp_path, device="cpu").optimize()
    lp = tmodel.params["model"]["layers"][0]
    assert set(lp["self_attn"]) == {"qkv_proj", "o_proj"} and not lp["mlp"].get("_fused")
    assert {kernel_route(m) for m in (*lp["self_attn"].values(), lp["mlp"]["gate_up_proj"],
                                      lp["mlp"]["down_proj"])} == {"K6"}
    for jdtype, tdtype, tol in ((jnp.float32, torch.float32, 2e-3),
                                (jnp.bfloat16, torch.bfloat16, 1e-2)):
        ref = np.asarray(jmodel.generate(ids, max_new_tokens=5, dtype=jdtype))
        np.testing.assert_array_equal(tmodel.generate(ids, max_new_tokens=5, dtype=tdtype), ref)
        forced = np.concatenate([ids, ref[:, :-1]], axis=1)
        jl = np.asarray(jforward(jmodel.spec, jmodel.params, jnp.asarray(forced), dtype=jdtype),
                        np.float32)[:, ids.shape[1] - 1:]
        tl = forward_logits(tmodel.spec, tmodel.params, torch.as_tensor(forced),
                            tdtype).float().numpy()[:, ids.shape[1] - 1:]
        assert _rel(tl, jl) <= tol, tdtype


def test_device_draw_honours_the_group_size(tmp_path):
    """``write_random_gptq_checkpoint(group_size=32, device=...)`` draws the
    scales and zeros of groups of 32, with the numpy draw's zero rule, and
    the port serves it on K6."""
    write_random_gptq_checkpoint(tmp_path, TINY_LLAMA, seed=2, group_size=32, sym=False,
                                 device="cpu")
    shard = load_file(tmp_path / "model-00002-of-00004.safetensors")
    pre = "model.layers.0.mlp.down_proj."
    assert tuple(shard[pre + "scales"].shape) == (512 // 32, 256)
    assert tuple(shard[pre + "qzeros"].shape) == (512 // 32, 256 // 8)
    words = shard[pre + "qzeros"].numpy().view(np.uint32)[..., None]
    z = ((words >> (4 * np.arange(8, dtype=np.uint32))) & 15) + 1
    assert z.min() >= 4 and z.max() < 12
    tmodel = GPTQModel.load(tmp_path, device="cpu").optimize()
    down = tmodel.params["model"]["layers"][0]["mlp"]["down_proj"]
    assert kernel_route(down) == "K6" and down.zero_const < 0
    ids = np.random.default_rng(3).integers(0, 511, (2, 5))
    assert tmodel.generate(ids, max_new_tokens=2, dtype=torch.float32).shape == (2, 2)


def test_group32_quantize_save_load(tmp_path):
    """``QuantizeConfig(group_size=32)``: the port quantizes a tiny
    checkpoint and saves it; the JAX package reads back the same
    dequantized weights; the port's load serves it on K6 with the JAX
    package's greedy tokens (its Pallas kernels in interpret mode), and its
    load and save again write the same bytes."""
    write_random_fp_checkpoint(tmp_path / "fp", TINY_LLAMA, seed=0)
    ids = np.random.default_rng(1).integers(0, 512, (8, 32))
    qm = GPTQModel.load(tmp_path / "fp", QuantizeConfig(group_size=32), device="cpu")
    qm.quantize(ids, batch_size=4)
    qm.save(tmp_path / "q1")
    tmodel = GPTQModel.load(tmp_path / "q1", device="cpu")
    tmodel.save(tmp_path / "q2")
    for f in sorted((tmp_path / "q1").glob("*.safetensors")):
        a, b = load_file(f), load_file(tmp_path / "q2" / f.name)
        assert list(a) == list(b)
        for k in a:
            assert a[k].contiguous().view(torch.uint8).equal(b[k].contiguous().view(torch.uint8)), k
    jmodel = JGPTQModel.load(tmp_path / "q1")
    lp = tmodel.params["model"]["layers"][1]
    for k in ("self_attn", "mlp"):
        for name, tp in lp[k].items():
            assert tp.group_size == 32 and kernel_route(tp) == "K6"
            np.testing.assert_array_equal(
                dequantize_weight(tp).numpy(),
                np.asarray(jdequant(jmodel.params["model"]["layers"][1][k][name])))
    prompt = ids[:2, :12]
    jregistry.set_backend("pallas_interpret")
    try:
        ref = np.asarray(jmodel.optimize().generate(prompt, max_new_tokens=4, dtype=jnp.float32))
    finally:
        jregistry.set_backend("auto")
    got = tmodel.optimize().generate(prompt, max_new_tokens=4, dtype=torch.float32)
    np.testing.assert_array_equal(got, ref)
