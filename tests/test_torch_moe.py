"""The port's qwen3_moe slice against the JAX package.

Both packages load one checkpoint that the port's writer made (2 layers,
hidden 256, 4 heads of 64, 2 KV heads, 8 experts, top-2, moe_intermediate
256, g 128, vocab 512). The JAX package runs its MoE kernels in interpret
mode (``registry.set_backend("pallas_interpret")``, set around each JAX call
and restored); the port runs on the CPU, where every wrapper takes its
kernel's plain version. One MoE layer is also driven through every kernel
route that the ``GPTQ_TPU_QMOE_*`` switches reach, in both packages.
"""

import contextlib
import dataclasses
import os
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptqmodel_tpu.models import transformer as jtr
from gptqmodel_tpu.models.auto import GPTQModel as JGPTQModel
from gptqmodel_tpu.models.loader import CheckpointReader as JReader
from gptqmodel_tpu.models.loader import build_params_tree as jbuild
from gptqmodel_tpu.models.spec import spec_from_hf_config as jspec_from_hf_config
from gptqmodel_tpu.ops import pallas_qmoe as jq
from gptqmodel_tpu.ops import registry as jregistry
from gptqmodel_tpu.ops.qlinear import make_quant_linear
from gptqmodel_tpu.ops.registry import post_init_module as jpost
from gptqmodel_tpu.quantization.config import QuantizeConfig as JQuantizeConfig
from gptqmodel_tpu_torch import GPTQModel, QuantizeConfig
from gptqmodel_tpu_torch.convert import convert_params, convert_quant_linear, convert_spec
from gptqmodel_tpu_torch.models import transformer
from gptqmodel_tpu_torch.models.spec import spec_from_hf_config
from gptqmodel_tpu_torch.ops import qmoe
from gptqmodel_tpu_torch.ops.registry import post_init_module, post_init_params
from gptqmodel_tpu_torch.utils.testing import write_random_qwen3_moe_checkpoint

TINY_QWEN3_MOE = {
    "model_type": "qwen3_moe", "vocab_size": 512, "hidden_size": 256,
    "intermediate_size": 512, "moe_intermediate_size": 256, "num_hidden_layers": 2,
    "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 64, "num_experts": 8,
    "num_experts_per_tok": 2, "norm_topk_prob": True, "rms_norm_eps": 1e-6,
    "rope_theta": 1000000.0, "tie_word_embeddings": False, "hidden_act": "silu",
    "decoder_sparse_step": 1, "mlp_only_layers": [], "max_position_embeddings": 2048,
    "eos_token_id": 511,
}
E, D, F = 8, 256, 256


@contextlib.contextmanager
def jax_kernels():
    """The JAX package's Pallas kernels in interpret mode, then the backend
    it had."""
    before = jregistry.get_backend()
    jregistry.set_backend("pallas_interpret")
    try:
        yield
    finally:
        jregistry.set_backend(before)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    d = tmp_path_factory.mktemp("qwen3_moe")
    write_random_qwen3_moe_checkpoint(d, TINY_QWEN3_MOE, seed=1)
    return d


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


def test_slice_matches_jax(checkpoint, monkeypatch):
    """``load -> optimize -> generate`` in float32: the port's 8 greedy
    tokens equal the argmax of the JAX package's teacher-forced logits over
    the same sequence (its MoE kernels in interpret mode), the logits agree
    within 1e-2 relative (both round the expert inputs to bf16 and differ in
    f32 sum order), and every layer routes each token to the same experts.
    The JAX package's attention projections run its XLA path: its K1 rounds
    the fp16 scales to bf16, which the port's K1 does not, a known
    difference that on its own takes these logits past 1e-2 and flips a
    route."""
    ids = np.random.default_rng(2).integers(0, 512, (2, 10))
    model = GPTQModel.load(checkpoint, device="cpu").optimize()
    assert all("experts_stacked_q" in lp["mlp"] and "qkv_proj" in lp["self_attn"]
               for lp in model.params["model"]["layers"])
    tokens = model.generate(ids, max_new_tokens=8, dtype=torch.float32)
    seq = np.concatenate([ids, tokens[:, :-1]], axis=1)

    routes = {"jax": [], "port": []}

    def recorder(fn, key, to_np):
        def topk(x, k):
            v, i = fn(x, k)
            routes[key].append(to_np(i))
            return v, i
        return topk

    monkeypatch.setattr(jtr, "_topk", recorder(jtr._topk, "jax", np.asarray))
    monkeypatch.setattr(transformer, "_topk",
                        recorder(transformer._topk, "port", lambda i: i.numpy()))
    monkeypatch.setattr(jregistry, "select_kernel", lambda p: "xla")
    with jax_kernels():
        jm = JGPTQModel.load(checkpoint).optimize()
        assert "experts_stacked_q" in jm.params["model"]["layers"][0]["mlp"]
        ref = np.asarray(jtr.forward_logits(jm.spec, jm.params, jnp.asarray(seq)))
    got = transformer.forward_logits(model.spec, model.params, torch.as_tensor(seq)).numpy()
    assert _rel(got, ref) <= 1e-2
    assert len(routes["jax"]) == len(routes["port"]) == 2
    for a, b in zip(routes["port"], routes["jax"]):
        np.testing.assert_array_equal(a, b)
    T = ids.shape[1]
    np.testing.assert_array_equal(tokens, ref[:, T - 1:T + 7].argmax(-1))


def test_converted_jax_tree_gives_the_port_logits(checkpoint):
    """``convert_spec`` and ``convert_params`` carry the JAX package's
    qwen3_moe spec and params tree (expert lists, the router, q_norm and
    k_norm) across: the converted tree gives the logits of the port's own
    load, exactly."""
    jtree = jbuild(JReader(checkpoint), JQuantizeConfig.from_pretrained(checkpoint))
    jspec = jspec_from_hf_config(TINY_QWEN3_MOE)
    spec = convert_spec(jspec)
    assert spec == spec_from_hf_config(TINY_QWEN3_MOE)
    assert (spec.qk_norm, spec.num_experts, spec.num_experts_per_tok,
            spec.moe_intermediate_size, spec.norm_topk_prob, spec.moe_scoring) == (
        True, 8, 2, 256, True, "softmax")
    params = post_init_params(convert_params(jtree, device="cpu"))
    layer = params["model"]["layers"][0]
    assert len(layer["mlp"]["experts"]) == E and layer["mlp"]["gate"]["weight"].shape == (E, D)
    assert layer["self_attn"]["q_norm"]["weight"].shape == (64,)
    ids = torch.as_tensor(np.random.default_rng(3).integers(0, 512, (2, 6)))
    model = GPTQModel.load(checkpoint, device="cpu")
    torch.testing.assert_close(transformer.forward_logits(spec, params, ids),
                               transformer.forward_logits(model.spec, model.params, ids),
                               rtol=0, atol=0)


def test_other_model_types_and_what_stays_llama_only_raise(checkpoint, tmp_path):
    """Only llama and qwen3_moe load; ``quantize()`` of a qwen3_moe directory
    and ``save()`` of a tree whose experts were stacked raise."""
    for mt in ("mixtral", "phimoe", "deepseek_v3", "gpt_oss"):
        with pytest.raises(NotImplementedError, match="model_type"):
            spec_from_hf_config(dict(TINY_QWEN3_MOE, model_type=mt))
    with pytest.raises(NotImplementedError, match="MoE quantization"):
        GPTQModel.from_pretrained(checkpoint, QuantizeConfig(), device="cpu").quantize(
            np.zeros((4, 8), np.int64))
    model = GPTQModel.load(checkpoint, device="cpu").optimize()
    with pytest.raises(NotImplementedError, match="stacked experts"):
        model.save(tmp_path / "out")
    spec = spec_from_hf_config(TINY_QWEN3_MOE)
    with pytest.raises(NotImplementedError, match="moe_scoring"):
        transformer.moe_mlp(dataclasses.replace(spec, moe_scoring="sigmoid"),
                            model.params["model"]["layers"][0]["mlp"],
                            torch.zeros((1, 2, D)))


# ------------------------------------------------------------- the routes


def _module(rng, out_f, in_f):
    Q = rng.integers(0, 16, size=(out_f, in_f)).astype(np.int32)
    zeros = np.full((in_f // 128, out_f), 8, np.int32)
    scales = rng.uniform(0.005, 0.02, size=(in_f // 128, out_f))
    return make_quant_linear(Q=Q, scales=scales, zeros=zeros, g_idx=None, bias=None,
                             bits=4, group_size=128, sym=True, v1=True)


@pytest.fixture(scope="module")
def layer():
    """One MoE layer: JAX QuantLinear experts (before post-init), a float32
    router and the two specs."""
    rng = np.random.default_rng(4)
    experts = [{f"{n}_proj": _module(rng, o, i) for n, (i, o) in
                (("gate", (D, F)), ("up", (D, F)), ("down", (F, D)))} for _ in range(E)]
    router = (rng.standard_normal((E, D)) * 0.05).astype(np.float32)
    jspec = jspec_from_hf_config(TINY_QWEN3_MOE)
    return experts, router, jspec, convert_spec(jspec)


def _mlps(layer, stacked: bool):
    """(JAX mlp params, port mlp params), stacked by each package's own
    optimize step or as expert lists."""
    from gptqmodel_tpu.models.optimize import stack_moe_experts as jstack
    from gptqmodel_tpu_torch.models.optimize import stack_moe_experts

    experts, router, jspec, spec = layer
    jexp = [{k: jpost(m) for k, m in e.items()} for e in experts]
    texp = [{k: post_init_module(convert_quant_linear(m, "cpu")) for k, m in e.items()}
            for e in experts]
    jm = {"gate": {"weight": jnp.asarray(router)}, "experts": jexp}
    tm = {"gate": {"weight": torch.from_numpy(router)}, "experts": texp}
    if stacked:
        with jax_kernels():
            jstack(jspec, {"model": {"layers": [{"mlp": jm}]}})
        stack_moe_experts(spec, {"model": {"layers": [{"mlp": tm}]}})
        assert "experts_stacked_q" in jm and "experts_stacked_q" in tm
    return jm, tm


# the five plain versions a route can end in, and the JAX functions they mirror
PORT_PLAIN = {"K10": (qmoe, "qmoe_mlp_e2e_plain"), "K11": (qmoe, "qmoe_mlp_matmul_dyn_plain"),
              "K12": (qmoe, "qmoe_mlp_matmul_plain"), "K13": (qmoe, "qmoe_matmul_plain"),
              "dense": (transformer, "_moe_packed_dense_fallback")}
JAX_KERNEL = {"K10": (jq, "qmoe_mlp_e2e"), "K11": (jq, "qmoe_mlp_matmul_dyn"),
              "K12": (jq, "qmoe_mlp_matmul"), "K13": (jq, "qmoe_matmul"),
              "dense": (jtr, "_moe_packed_dense_fallback")}


def _counting(monkeypatch, table):
    counts = dict.fromkeys(table, 0)
    for name, (mod, attr) in table.items():
        fn = getattr(mod, attr)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            counts[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(mod, attr, wrapped)
    return counts


# route -> (switches, the kernel each package reaches, tokens, top-k, tolerance).
# K10, K11, K12: the same contract and inner rounding in both packages, f32
# sums in another order: 2e-3. K13 rounds g and u to bf16 as well, and the
# dense fallback takes bf16 products of bf16 weights with bf16 outputs in
# both packages, so one-ulp flips there move the result more: 1e-2.
ROUTES = {
    "K10 rt (default)": ({}, "K10", 12, 2, 2e-3),
    "K10 ic": ({"RT": "0"}, "K10", 12, 2, 2e-3),
    "K11": ({"RT": "0", "E2E": "0"}, "K11", 12, 2, 2e-3),
    "K12": ({"RT": "0", "E2E": "0", "DYN": "0"}, "K12", 12, 2, 2e-3),
    "K13": ({"RT": "0", "FUSED": "0"}, "K13", 12, 2, 1e-2),
    "dense fallback of an rt stack": ({"E2E": "0"}, "dense", 12, 2, 1e-2),
    "K10 past 1024 routed rows": ({}, "K10", 260, 4, 2e-3),
    "dense fallback past 1024 routed rows": ({"RT": "0", "E2E": "0"}, "dense", 260, 4, 1e-2),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_moe_layer_routes_match_jax(layer, route, monkeypatch):
    """One MoE layer, float32 activations, under each switch setting: both
    packages reach the same kernel (counted on the port's plain versions and
    on the JAX functions) and agree within the route's tolerance."""
    env, kernel, N, k, tol = ROUTES[route]
    jspec = dataclasses.replace(layer[2], num_experts_per_tok=k)
    spec = dataclasses.replace(layer[3], num_experts_per_tok=k)
    with mock.patch.dict(os.environ, {f"GPTQ_TPU_QMOE_{k}": v for k, v in env.items()}):
        jm, tm = _mlps(layer, stacked=True)
        port, jaxc = _counting(monkeypatch, PORT_PLAIN), _counting(monkeypatch, JAX_KERNEL)
        h = (np.random.default_rng(N).standard_normal((1, N, D)) * 0.5).astype(np.float32)
        with jax_kernels():
            ref = np.asarray(jtr.moe_mlp(jspec, jm, jnp.asarray(h)))
        got = transformer.moe_mlp(spec, tm, torch.from_numpy(h)).numpy()
    reached = {k for k, n in port.items() if n}
    assert reached == {kernel} and {k for k, n in jaxc.items() if n} == {kernel}
    assert _rel(got, ref) <= tol


def test_dense_expert_loop_matches_jax(layer):
    """An un-stacked expert list runs the dense loop in both packages (every
    expert on every token, K1's plain version for each projection): 1e-3."""
    jm, tm = _mlps(layer, stacked=False)
    h = (np.random.default_rng(1).standard_normal((1, 12, D)) * 0.5).astype(np.float32)
    ref = np.asarray(jtr.moe_mlp(layer[2], jm, jnp.asarray(h)))
    got = transformer.moe_mlp(layer[3], tm, torch.from_numpy(h)).numpy()
    assert _rel(got, ref) <= 1e-3
