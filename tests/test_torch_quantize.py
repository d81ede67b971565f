"""The port's quantization path against the JAX package, on the CPU.

A tiny llama (2 layers, hidden 256, 4/2 heads, FFN 512, bf16 weights from a
seed) is quantized by both packages from the same checkpoint with 16
calibration rows of 64 tokens; the checkpoints each writes are read by the
other. The JAX quantizer streams a CSV log, which goes under a temporary
directory here.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gptqmodel_tpu.looper import quantize_loop as jquantize_loop
from gptqmodel_tpu.looper.calibration import prepare_calibration as jprepare
from gptqmodel_tpu.looper.quantize_loop import _build_groups as jbuild_groups
from gptqmodel_tpu.models.auto import GPTQModel as JGPTQModel
from gptqmodel_tpu.models.definitions import get_model_def
from gptqmodel_tpu.models.module_tree import parse_module_tree as jparse
from gptqmodel_tpu.models.transformer import decoder_layer as jdecoder_layer
from gptqmodel_tpu.models.transformer import forward_logits as jforward
from gptqmodel_tpu.models.transformer import make_causal_mask, rope_cos_sin as jrope
from gptqmodel_tpu.models.writer import save_quantized as jsave
from gptqmodel_tpu.quantization.config import QuantizeConfig as JQuantizeConfig
from gptqmodel_tpu.quantization.gptq import gptq_quantize as jgptq_quantize
from gptqmodel_tpu.utils.testing import random_dense_params, tiny_spec
from gptqmodel_tpu_torch import GPTQModel, QuantizeConfig
from gptqmodel_tpu_torch.convert import convert_params, convert_spec
from gptqmodel_tpu_torch.looper import quantize_loop
from gptqmodel_tpu_torch.looper.calibration import prepare_calibration
from gptqmodel_tpu_torch.looper.quantize_loop import _build_groups
from gptqmodel_tpu_torch.models.module_tree import LLAMA_TREE, parse_module_tree
from gptqmodel_tpu_torch.models.safetensors_io import load_file
from gptqmodel_tpu_torch.models.transformer import (
    TapsComplete,
    causal_mask,
    decoder_layer,
    forward_logits,
    rope_cos_sin,
    rope_inv_freq,
)
from gptqmodel_tpu_torch.models.writer import save_quantized
from gptqmodel_tpu_torch.ops.pack import unpack_qweight
from gptqmodel_tpu_torch.quantization.gptq import gptq_quantize
from gptqmodel_tpu_torch.utils.testing import write_random_fp_checkpoint

TINY_LLAMA = {
    "model_type": "llama", "vocab_size": 512, "hidden_size": 256,
    "intermediate_size": 512, "num_hidden_layers": 2, "num_attention_heads": 4,
    "num_key_value_heads": 2, "rms_norm_eps": 1e-5, "rope_theta": 500000.0,
    "max_position_embeddings": 2048, "tie_word_embeddings": False, "hidden_act": "silu",
    "eos_token_id": 511,
}
MODULES = ["self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj", "self_attn.o_proj",
           "mlp.gate_proj", "mlp.up_proj", "mlp.down_proj"]


def _get(tree, path):
    for part in path.split("."):
        tree = tree[part]
    return tree


def _with_noisy_hessians(solve, seed):
    """``solve`` with each Hessian it is given perturbed by one float32 ulp:
    every entry scaled by ``1 ± 2⁻²³``, the sign seeded, kept symmetric.
    Two float32 implementations of the same sums differ by about as much."""
    rng = np.random.default_rng(seed)

    def run(W, H, **kw):
        H = np.asarray(H, np.float32)
        H = H * (1 + np.float32(2**-23) * rng.choice(np.float32([-1, 1]), H.shape))
        return solve(W, np.triu(H) + np.triu(H, 1).T, **kw)

    return run


@pytest.fixture(scope="module")
def quantized(tmp_path_factory):
    """Both packages quantize one checkpoint; each saves its result. The
    reference also quantizes it three times more with one-ulp noise on its
    Hessians, which measures its own drift; the port's solves are recorded
    with their inputs."""
    d = tmp_path_factory.mktemp("quant")
    write_random_fp_checkpoint(d / "fp", TINY_LLAMA, seed=0)
    ids = np.random.default_rng(1).integers(0, 512, (16, 64))
    noisy = []
    solves = []

    def recorded(W, H, **kw):
        res = gptq_quantize(W, H, **kw)
        solves.append((W, H, kw, res))
        return res

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GPTQ_TPU_QUANT_LOG", str(d / "jax_quant_log.stream.csv"))
        jm = JGPTQModel.load(d / "fp", JQuantizeConfig(bits=4, group_size=128))
        jlog = jm.quantize(ids, batch_size=4)
        for seed in range(3):
            mp.setattr(jquantize_loop, "gptq_quantize",
                       _with_noisy_hessians(jgptq_quantize, seed))
            jn = JGPTQModel.load(d / "fp", JQuantizeConfig(bits=4, group_size=128))
            noisy.append((jn, jn.quantize(ids, batch_size=4)))
        mp.setattr(quantize_loop, "gptq_quantize", recorded)
        tm = GPTQModel.load(d / "fp", QuantizeConfig(bits=4, group_size=128), device="cpu")
        tlog = tm.quantize(ids, batch_size=4)
    jm.save(d / "by_jax")
    tm.save(d / "by_port")
    return d, jm, jlog, tm, tlog, noisy, solves


def test_module_tree_and_groups_match_jax():
    jplan = jparse(list(get_model_def("llama").tree_for("gptq")))
    plan = parse_module_tree(LLAMA_TREE)
    assert plan.layers_path == jplan.layers_path == "model.layers"
    subsets = plan.build_subsets()
    assert subsets == jplan.build_subsets()
    assert subsets == [["self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
                        "mlp.gate_proj", "mlp.up_proj"],
                       ["self_attn.o_proj", "mlp.down_proj"]]
    lp = random_dense_params(tiny_spec(layers=1))["model"]["layers"][0]
    qcfg = JQuantizeConfig()
    for subset in subsets:
        ref = [(g.tap, g.members) for g in jbuild_groups(subset, 0, qcfg, jplan, lp)]
        assert [(g.tap, g.members) for g in _build_groups(subset)] == ref
    # four input groups per layer: qkv, gate_up, o, down
    assert sum(len(_build_groups(s)) for s in subsets) == 4


def test_taps_of_a_dense_layer_match_jax():
    """The JAX package's dense params carried across by ``convert_params``:
    the recorded inputs of every module agree in float32, and the forward
    stops once the last requested tap is recorded."""
    spec = tiny_spec(layers=1)
    lp = random_dense_params(spec, seed=2)["model"]["layers"][0]
    tlp, tspec = convert_params(lp, device="cpu"), convert_spec(spec)
    h = np.random.default_rng(3).standard_normal((2, 16, spec.hidden_size)).astype(np.float32)
    positions = np.tile(np.arange(16), (2, 1))
    cos, sin = jrope(spec, jnp.asarray(positions))
    jtaps = {}
    jdecoder_layer(spec, lp, jnp.asarray(h), cos, sin, make_causal_mask(16, 16),
                   taps=jtaps, tap_paths=frozenset(MODULES))
    tcos, tsin = rope_cos_sin(torch.from_numpy(rope_inv_freq(tspec)), torch.as_tensor(positions))
    taps = {}
    with pytest.raises(TapsComplete):
        decoder_layer(tspec, tlp, torch.from_numpy(h), tcos, tsin, causal_mask(16, 16, "cpu"),
                      taps=taps, tap_paths=frozenset(MODULES))
    assert set(taps) == set(jtaps) == set(MODULES)
    for k in MODULES:
        np.testing.assert_allclose(taps[k].numpy(), np.asarray(jtaps[k]), rtol=1e-5, atol=1e-5)


def test_calibration_matches_jax():
    rng = np.random.default_rng(4)
    rows = [rng.integers(1, 500, n) for n in (7, 30, 12, 30, 5, 19, 25)]
    for kw in (dict(), dict(sort="asc"), dict(sort=None, max_length=16),
               dict(concat_size=10, batch_size=3)):
        got, ref = prepare_calibration(rows, **kw), jprepare(rows, **kw)
        np.testing.assert_array_equal(got.input_ids, ref.input_ids)
        np.testing.assert_array_equal(got.row_mask, ref.row_mask)
    with pytest.raises(NotImplementedError):
        prepare_calibration(["text needs a tokenizer"])


def _codes(p):
    return unpack_qweight(torch.as_tensor(np.asarray(p.qweight)), p.bits)


def _losses(log):
    return {(r["layer"], r["module"]): r["loss"] for r in log}


def test_quantize_matches_jax(quantized):
    """Per module, codes within 2e-3 in layer 0 and 1e-2 in layer 1, scales
    within 1e-4, the log's rows equal and their losses within 1e-2, or
    within 1.5x the reference's own drift where that is larger.

    GPTQ's error feedback amplifies float32 rounding: a code that flips
    re-routes the rest of its row, and the next modules see the changed
    weights. The reference's drift is measured on itself alone: its codes
    and losses with one ulp of noise on every Hessian, the most of three
    seeds. On this model that moves up to 0.4% of layer 0's o_proj codes,
    2% of its down_proj's and 5-16% of layer 1's. The log rounds losses
    to 8 decimals, a step the comparison allows."""
    _, jm, jlog, tm, tlog, noisy, _ = quantized
    assert len(tlog) == len(jlog) == 2 * 7
    rows = {(r["layer"], r["module"]): r for r in jlog}
    for got in tlog:
        ref = rows[(got["layer"], got["module"])]
        for key in ("samples", "damp", "bits", "group_size", "fallback"):
            assert got[key] == ref[key], (key, got, ref)
    losses, ref_losses = _losses(tlog), _losses(jlog)
    for li, limit in ((0, 2e-3), (1, 1e-2)):
        for m in MODULES:
            p, r = (_get(x.params["model"]["layers"][li], m) for x in (tm, jm))
            frac = float((_codes(p) != _codes(r)).float().mean())
            drift = max(float((_codes(_get(n.params["model"]["layers"][li], m))
                               != _codes(r)).float().mean()) for n, _ in noisy)
            ref = ref_losses[(li, m)]
            loss_drift = max(abs(_losses(nlog)[(li, m)] - ref) / ref for _, nlog in noisy)
            print(f"layer {li} {m}: codes {frac:.5f} (reference drift {drift:.5f}), "
                  f"loss {abs(losses[(li, m)] - ref) / ref:.2e} (drift {loss_drift:.2e})")
            assert frac <= max(limit, 1.5 * drift), (li, m, frac, drift)
            if frac <= 2e-3:
                np.testing.assert_allclose(p.scales.float().numpy(),
                                           np.asarray(r.scales, np.float32), rtol=1e-4)
            rtol = max(1e-2, 1.5 * loss_drift)
            assert abs(losses[(li, m)] - ref) <= rtol * ref + 1e-8, (li, m, ref, loss_drift)


def test_solves_in_the_flow_match_jax(quantized):
    """Each solve the port's quantize made, against the JAX package's
    ``gptq_quantize`` on the same weights and Hessian: codes within 2e-3,
    the same damp, and the loss within 1e-3."""
    *_, solves = quantized
    assert len(solves) == 2 * 4  # qkv, gate_up, o and down per layer
    for W, H, kw, res in solves:
        ref = jgptq_quantize(W.numpy(), H.numpy(), **kw)
        frac = float((res.Q.numpy() != np.asarray(ref.Q)).mean())
        print(f"{tuple(W.shape)}: codes {frac:.5f}, loss "
              f"{abs(res.avg_loss - ref.avg_loss) / ref.avg_loss:.2e}")
        assert frac <= 2e-3, (tuple(W.shape), frac)
        assert res.damp == ref.damp
        assert abs(res.avg_loss - ref.avg_loss) <= 1e-3 * ref.avg_loss


def test_writer_is_byte_equal_to_jax(quantized, tmp_path):
    """The JAX package's quantized params, carried across and saved by the
    port: every tensor byte-equal to the JAX writer's, the same shard index,
    and the same quantize_config.json."""
    _, jm, jlog, *_ = quantized
    params = convert_params(jm.params, device="cpu")
    qcfg = QuantizeConfig.from_dict(jm.qcfg.to_dict())
    save_quantized(tmp_path / "port", params, qcfg, jm.hf_config, quant_log=jlog,
                   max_shard_size=1 << 20)
    jsave(tmp_path / "jax", jm.params, jm.qcfg, jm.hf_config, quant_log=jlog,
          max_shard_size=1 << 20)
    index = json.loads((tmp_path / "port" / "model.safetensors.index.json").read_text())
    ref_index = json.loads((tmp_path / "jax" / "model.safetensors.index.json").read_text())
    assert index == ref_index and len(set(index["weight_map"].values())) > 1
    for fname in sorted(set(index["weight_map"].values())):
        got, ref = load_file(tmp_path / "port" / fname), load_file(tmp_path / "jax" / fname)
        assert list(got) == list(ref) or set(got) == set(ref)
        for k, t in ref.items():
            assert got[k].dtype == t.dtype and got[k].shape == t.shape, k
            assert got[k].contiguous().view(torch.uint8).equal(t.contiguous().view(torch.uint8)), k
    for name in ("quantize_config.json", "config.json"):
        assert (json.loads((tmp_path / "port" / name).read_text())
                == json.loads((tmp_path / "jax" / name).read_text()))
    assert ((tmp_path / "port" / "quant_log.csv").read_text()
            == (tmp_path / "jax" / "quant_log.csv").read_text())


@pytest.mark.parametrize("kw", [
    dict(), dict(desc_act=True, static_groups=True, sym=False), dict(bits=8, group_size=-1),
    dict(damp_percent=0.05, true_sequential=False, fallback_min_samples=4),
])
def test_quantize_config_json_matches_jax(tmp_path, kw):
    QuantizeConfig(**kw).save_pretrained(tmp_path / "port")
    JQuantizeConfig(**kw).save_pretrained(tmp_path / "jax")
    got = json.loads((tmp_path / "port" / "quantize_config.json").read_text())
    assert got == json.loads((tmp_path / "jax" / "quantize_config.json").read_text())
    assert QuantizeConfig.from_dict(got) == QuantizeConfig(**kw)


@pytest.mark.parametrize("ckpt", ["by_jax", "by_port"])
def test_checkpoints_round_trip_between_packages(quantized, ckpt):
    """Each package loads the checkpoint the other saved. In float32 both
    give the same greedy tokens. In bf16 the port's quantized products sum
    exact products in f32 and round once, where the reference dequantizes in
    bf16 (PERF.md, PR 2): teacher-forced on the reference's tokens, the
    logits agree within 2e-2 and the argmax differs only at near-ties, where
    the reference's top two logits lie closer than the largest difference."""
    d, *_ = quantized
    ids = np.random.default_rng(5).integers(0, 511, (2, 12))
    jmodel = JGPTQModel.load(d / ckpt).optimize()
    tmodel = GPTQModel.load(d / ckpt, device="cpu").optimize()
    ref = np.asarray(jmodel.generate(ids, max_new_tokens=8, dtype=jnp.float32))
    got = tmodel.generate(ids, max_new_tokens=8, dtype=torch.float32)
    np.testing.assert_array_equal(got, ref)

    toks = np.asarray(jmodel.generate(ids, max_new_tokens=8, dtype=jnp.bfloat16))
    forced = np.concatenate([ids, toks[:, :-1]], axis=1)
    jl = np.asarray(jforward(jmodel.spec, jmodel.params, jnp.asarray(forced),
                             dtype=jnp.bfloat16), np.float32)[:, ids.shape[1] - 1:]
    tl = forward_logits(tmodel.spec, tmodel.params, torch.as_tensor(forced),
                        torch.bfloat16).float().numpy()[:, ids.shape[1] - 1:]
    assert np.linalg.norm(tl - jl) <= 2e-2 * np.linalg.norm(jl)
    err = np.abs(tl - jl).max()
    mine, theirs = tl.argmax(-1), jl.argmax(-1)
    gap = (np.take_along_axis(jl, theirs[..., None], -1)
           - np.take_along_axis(jl, mine[..., None], -1))[..., 0]
    assert (gap[mine != theirs] <= 2 * err).all()


@pytest.mark.parametrize("kw", [dict(mock_quantization=True),
                                dict(fallback_min_samples=10**9)])
def test_rtn_paths_match_jax(quantized, monkeypatch, kw):
    """``mock_quantization``, and too few calibration rows for
    ``fallback_min_samples``, quantize every module by RTN in both packages:
    the weights alone decide, so the codes are equal in every layer."""
    d, *_ = quantized
    ids = np.random.default_rng(7).integers(0, 512, (4, 16))
    monkeypatch.setenv("GPTQ_TPU_QUANT_LOG", str(d / "jax_rtn.stream.csv"))
    jm = JGPTQModel.load(d / "fp", JQuantizeConfig(**kw))
    jlog = jm.quantize(ids, batch_size=4)
    tm = GPTQModel.load(d / "fp", QuantizeConfig(**kw), device="cpu")
    tlog = tm.quantize(ids, batch_size=4)
    assert [(r["module"], r["loss"], r["fallback"]) for r in tlog] == [
        (r["module"], r["loss"], r["fallback"]) for r in jlog]
    assert all(r["fallback"] for r in tlog)
    for li in range(2):
        for m in MODULES:
            p, r = (_get(x.params["model"]["layers"][li], m) for x in (tm, jm))
            assert torch.equal(_codes(p), _codes(r)), (li, m)


@pytest.mark.parametrize("field,value", [
    ("method", "awq"), ("gptaq", {"alpha": 0.25}), ("foem", {"beta": 0.2}), ("mse", 2.4),
    ("act_group_aware", True), ("rotation", "hadamard"), ("smooth", "rms_row"),
    ("fallback_smooth", "rms_row"), ("adapter", {"name": "eora"}), ("tp_pad", True),
    ("lm_head", True), ("journal", "j"), ("dynamic", {"-:.*": None}), ("method", "rtn"),
])
def test_quantize_raises_for_what_a_later_slice_brings(quantized, field, value):
    d, *_ = quantized
    m = GPTQModel.load(d / "fp", QuantizeConfig(**{field: value}), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        m.quantize(np.zeros((4, 8), np.int64))


def test_quantize_runs_on_the_card_unless_asked(quantized):
    d, *_ = quantized
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GPTQModel.load(d / "fp")
