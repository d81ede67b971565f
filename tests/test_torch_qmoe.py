"""The MoE kernels' plain versions, the stacks and the routing plan against
the JAX package.

The JAX kernels run in interpret mode on the same seeded experts; on the
JAX side only, x is plane-permuted (``_plane_permute_x``), the TPU kernels'
relayout. Tiny widths: E = 8, D = 256, F = 256, g = 128, 4-bit unless a
case says otherwise.
"""

import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptqmodel_tpu.ops import pallas_qmoe as jq
from gptqmodel_tpu.ops.pallas_qmatmul import _plane_permute_x
from gptqmodel_tpu.ops.qlinear import make_quant_linear
from gptqmodel_tpu.ops.registry import post_init_module as jpost
from gptqmodel_tpu_torch.convert import convert_quant_linear, to_torch
from gptqmodel_tpu_torch.models.transformer import _topk
from gptqmodel_tpu_torch.ops import _build, qmoe
from gptqmodel_tpu_torch.ops.registry import post_init_module

E, D, F = 8, 256, 256


def _module(rng, out_f, in_f, bits):
    Q = rng.integers(0, 2 ** bits, size=(out_f, in_f)).astype(np.int32)
    zeros = np.full((in_f // 128, out_f), 2 ** (bits - 1), np.int32)
    scales = rng.uniform(0.005, 0.02, size=(in_f // 128, out_f))
    return make_quant_linear(Q=Q, scales=scales, zeros=zeros, g_idx=None, bias=None,
                             bits=bits, group_size=128, sym=True, v1=True)


def _experts(seed, bits=4):
    """Per-expert gate/up/down as JAX QuantLinears, before any post-init."""
    rng = np.random.default_rng(seed)
    return {n: [_module(rng, o, i, bits) for _ in range(E)]
            for n, (i, o) in (("gate", (D, F)), ("up", (D, F)), ("down", (F, D)))}


def _stacks(experts, jax_side: bool, **env):
    """(gate|up, down), stacked by the JAX package or by the port, under the
    given ``GPTQ_TPU_QMOE_*`` settings."""
    env = {f"GPTQ_TPU_QMOE_{k}": v for k, v in env.items()}
    with mock.patch.dict(os.environ, env):
        if jax_side:
            st = {n: jq.stack_packed_experts([jpost(m) for m in ms])
                  for n, ms in experts.items()}
            return jq.fuse_gate_up(st["gate"], st["up"]), st["down"]
        st = {n: qmoe.stack_packed_experts(
            [post_init_module(convert_quant_linear(m, "cpu")) for m in ms])
            for n, ms in experts.items()}
        return qmoe.fuse_gate_up(st["gate"], st["up"]), st["down"]


def _routing(rng, N, k):
    """Distinct experts per token, as a top-k gives, weights summing to 1."""
    top_i = np.stack([rng.permutation(E)[:k] for _ in range(N)]).astype(np.int32)
    w = rng.uniform(0.1, 1.0, (N, k)).astype(np.float32)
    return top_i, w / w.sum(1, keepdims=True)


def _bf16(a) -> np.ndarray:
    """float32 values of a bf16 rounding."""
    return np.asarray(jnp.asarray(np.asarray(a, np.float32), jnp.bfloat16).astype(jnp.float32))


def _sorted_rows(seed, N, k, bm=8):
    """Slot-sorted bf16 rows ``[S·bm, D]`` (float32 values), ids, counts."""
    rng = np.random.default_rng(seed)
    top_i, _ = _routing(rng, N, k)
    S = qmoe.slot_bound(N * k, E, bm)
    pos, ids, counts, order = qmoe.build_slots(top_i, E, bm, S)
    xs = np.zeros((S * bm, D), np.float32)
    xs[pos] = _bf16(rng.standard_normal((N, D)) * 0.5)[order // k]
    return xs, ids, counts


def _t(a, dtype=None):
    t = to_torch(np.asarray(a), "cpu")
    return t if dtype is None else t.to(dtype)


def _j(st):
    """A port stack's arrays for the JAX kernels."""
    return jnp.asarray(st.qweight.numpy()), jnp.asarray(st.scales.float().numpy(), jnp.bfloat16)


def _pp(xs, bits):
    return _plane_permute_x(jnp.asarray(xs, jnp.bfloat16), D, 32 // bits, bits)


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


@pytest.mark.parametrize("env,rt", [({}, True), ({"RT": "0"}, False),
                                    ({"RT_SUBGROUP": "0"}, False)])
def test_stacks_match_jax(env, rt):
    """The port's stack holds the interchange words and the bf16 scales
    zero-padded to G_pad, as the JAX stack does with rt off; with rt on the
    JAX stack re-packs its words and the port sets the same flag."""
    experts = _experts(0)
    (jgu, jd), (gu, d) = _stacks(experts, True, **env), _stacks(experts, False, **env)
    for js, ts in ((jgu, gu), (jd, d)):
        assert (ts.rt, ts.G, ts.zero_const, ts.in_features, ts.out_features) == (
            js.rt, js.G, js.zero_const, js.in_features, js.out_features) and ts.rt == rt
        assert ts.scales.dtype == torch.bfloat16 and ts.scales.shape == js.scales.shape
        np.testing.assert_array_equal(ts.scales.float().numpy(),
                                      np.asarray(js.scales, np.float32))
        if not rt:
            np.testing.assert_array_equal(ts.qweight.numpy(), np.asarray(js.qweight))


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("out_dtype", ["bfloat16", "float32"])
def test_qmoe_matmul_plain_matches_jax(bits, out_dtype):
    """K13 (ic contract) against ``qmoe_matmul``: the same bf16 weights and
    exact products, f32 sums in another order, one rounding: 1e-3 relative.
    Padding rows are 0."""
    gu, _ = _stacks(_experts(bits, bits), False, RT="0")
    xs, ids, counts = _sorted_rows(bits, 8, 2)
    jdt, tdt = getattr(jnp, out_dtype), getattr(torch, out_dtype)
    ref = jq.qmoe_matmul(_pp(xs, bits), jnp.asarray(ids), jnp.asarray(counts), *_j(gu),
                         bits=bits, G=gu.G, bm=8, zero_const=gu.zero_const, interpret=True,
                         out_dtype=jdt)
    got = qmoe.qmoe_matmul(_t(xs, torch.bfloat16), _t(ids), _t(counts), gu.qweight, gu.scales,
                           bits=bits, G=gu.G, bm=8, zero_const=gu.zero_const, out_dtype=tdt)
    assert got.dtype == tdt and got.shape == ref.shape
    assert _rel(got.float().numpy(), ref) <= 1e-3
    dead = np.arange(8)[None, :] >= counts[:, None]
    assert not got.float().numpy().reshape(-1, 8, 2 * F)[dead].any()


def test_slot_mlp_plain_matches_jax():
    """K12 against ``qmoe_mlp_matmul`` and K11 against
    ``qmoe_mlp_matmul_dyn``: ic contract, inner rounded to bf16 in both,
    f32 sums in another order: 2e-3 relative. K11's plain version equals
    K12's."""
    gu, d = _stacks(_experts(3), False, RT="0")
    xs, ids, counts = _sorted_rows(3, 8, 2)
    n_used = np.asarray([(counts > 0).sum()], np.int32)
    jargs = (_pp(xs, 4), jnp.asarray(ids), jnp.asarray(counts))
    jkw = dict(bits=4, G_gu=gu.G, G_d=d.G, F=F, bm=8, zc=gu.zero_const, act="silu",
               interpret=True, out_dtype=jnp.bfloat16)
    ref_grid = jq.qmoe_mlp_matmul(*jargs, *_j(gu), *_j(d), **jkw)
    ref_dyn = jq.qmoe_mlp_matmul_dyn(*jargs, jnp.asarray(n_used), *_j(gu), *_j(d), **jkw)
    w = (gu.qweight, gu.scales, d.qweight, d.scales)
    kw = dict(bits=4, G_gu=gu.G, G_d=d.G, F=F, bm=8, zc_gu=gu.zero_const, zc_d=d.zero_const,
              out_dtype=torch.bfloat16)
    grid = qmoe.qmoe_mlp_matmul(_t(xs, torch.bfloat16), _t(ids), _t(counts), *w, **kw)
    dyn = qmoe.qmoe_mlp_matmul_dyn(_t(xs, torch.bfloat16), _t(ids), _t(counts), _t(n_used),
                                   *w, **kw)
    assert torch.equal(grid, dyn)
    assert _rel(grid.float().numpy(), ref_grid) <= 2e-3
    assert _rel(dyn.float().numpy(), ref_dyn) <= 2e-3


@pytest.mark.parametrize("env", [{}, {"RT": "0"}])
def test_e2e_plain_matches_jax(env):
    """K10 against ``qmoe_mlp_forward_e2e`` on the JAX package's own stacks
    (rt here by default, ic under ``GPTQ_TPU_QMOE_RT=0``), the rows placed by
    the JAX ``plan_rows_jit``: the same products in each contract, f32 sums
    in another order, inner rounded to bf16 in both: 2e-3 relative. The port
    rounds once to bf16 where the JAX function returns f32; rows of bm = 8
    and 16 agree."""
    experts = _experts(5)
    (jgu, jd), (gu, d) = _stacks(experts, True, **env), _stacks(experts, False, **env)
    rng = np.random.default_rng(5)
    N, k = 12, 2
    top_i, top_w = _routing(rng, N, k)
    x = _bf16(rng.standard_normal((N, D)) * 0.5)
    S = qmoe.slot_bound(N * k, E, 8)
    ids, counts, row_pos = jq.plan_rows_jit(jnp.asarray(top_i.reshape(-1)), E, 8, S)
    ref = jq.qmoe_mlp_forward_e2e(
        jnp.asarray(x), row_pos, jnp.arange(N * k) // k, jnp.asarray(top_w.reshape(-1)), ids,
        counts, jgu, jd, act="silu", bm=8, interpret=True)
    outs = []
    for bm in (8, 16):
        t_ids, t_counts, t_pos = qmoe.plan_rows(_t(top_i.reshape(-1)), E, bm,
                                                qmoe.slot_bound(N * k, E, bm))
        outs.append(qmoe.qmoe_mlp_forward_e2e(
            _t(x, torch.bfloat16), t_pos.reshape(N, k), _t(top_w), t_ids, t_counts, gu, d,
            act="silu", bm=bm, out_dtype=torch.float32))
    assert _rel(outs[0].numpy(), ref) <= 2e-3
    assert _rel(outs[1].numpy(), outs[0].numpy()) <= 1e-6


def _plan_cases():
    rng = np.random.default_rng(9)
    many = np.concatenate([np.full((20, 1), 3), rng.integers(0, E, (20, 1))], 1)
    many[many[:, 1] == 3, 1] = 5  # expert 3 takes 20 rows: three slots of 8
    unrouted = np.stack([rng.permutation([0, 1, 2, 4, 5, 6, 7])[:3] for _ in range(6)])
    logits = rng.standard_normal((10, E)).astype(np.float32)
    logits[:, 6] = logits[:, 2]  # ties in the router
    logits[:, 4] = logits[:, 2]
    tie = _topk(torch.softmax(torch.from_numpy(logits), -1), 3)[1].numpy()
    return {"several slots per expert": many, "an expert routed nowhere": unrouted,
            "router tie": tie}


@pytest.mark.parametrize("case,bm", [("several slots per expert", 8),
                                     ("several slots per expert", 16),
                                     ("an expert routed nowhere", 8), ("router tie", 8)])
def test_plans_match_jax(case, bm):
    """``plan_rows`` and ``plan_slots`` equal ``plan_rows_jit`` and
    ``plan_slots_jit`` (pad slots included) and the host oracle
    ``build_slots`` on every used slot; the port's oracle is the JAX one."""
    top_i = _plan_cases()[case].astype(np.int32)
    M = top_i.size
    S = qmoe.slot_bound(M, E, bm)
    flat = top_i.reshape(-1)
    for got, ref in zip(qmoe.plan_rows(_t(flat), E, bm, S),
                        jq.plan_rows_jit(jnp.asarray(flat), E, bm, S)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    pos, ids, counts, order = jq.build_slots(top_i, E, bm, S)
    for a, b in zip(qmoe.build_slots(top_i, E, bm, S), (pos, ids, counts, order)):
        np.testing.assert_array_equal(a, b)
    sids, scounts, spos = qmoe.plan_slots(_t(flat[order]), E, bm, S)
    for got, ref in zip((sids, scounts, spos),
                        jq.plan_slots_jit(jnp.asarray(flat[order]), E, bm, S)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    live = counts > 0
    np.testing.assert_array_equal(scounts.numpy(), counts)
    np.testing.assert_array_equal(spos.numpy(), pos)
    np.testing.assert_array_equal(sids.numpy()[live], ids[live])
    if case == "several slots per expert":
        assert (ids[live] == 3).sum() == -(-20 // bm)
    if case == "an expert routed nowhere":
        assert 3 not in ids[live]


def test_topk_breaks_ties_to_the_lower_index():
    """``lax.top_k``'s order: equal values keep their index order."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((16, 32)).astype(np.float32)
    x[:, 5] = x[:, 1]
    x[:, 9] = x[:, 1]
    x[:3] = 0.25  # whole rows of ties
    for k in (2, 8):
        v, i = _topk(torch.from_numpy(x), k)
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


def test_tensor_off_the_cpu_goes_to_the_kernels(monkeypatch):
    """A tensor that is not on the CPU (here on the meta device) never takes a
    plain version: each wrapper asks for the kernel library."""
    def lib():
        raise RuntimeError("kernel library requested")

    monkeypatch.setattr(_build, "lib", lib)
    gu, d = _stacks(_experts(2), False)
    gu, d = (qmoe.StackedQuantExperts(**{**s.__dict__, "qweight": s.qweight.to("meta"),
                                         "scales": s.scales.to("meta")}) for s in (gu, d))
    S, bm = 4, 8
    xs = torch.empty((S * bm, D), dtype=torch.bfloat16, device="meta")
    ids = torch.zeros(S, dtype=torch.int32, device="meta")
    w = (gu.qweight, gu.scales, d.qweight, d.scales)
    kw = dict(bits=4, G_gu=gu.G, G_d=d.G, F=F, bm=bm, zc_gu=8.0, zc_d=8.0)
    calls = [
        lambda: qmoe.qmoe_matmul(xs, ids, ids, gu.qweight, gu.scales, bits=4, G=gu.G, bm=bm,
                                 zero_const=8.0),
        lambda: qmoe.qmoe_mlp_matmul(xs, ids, ids, *w, **kw),
        lambda: qmoe.qmoe_mlp_matmul_dyn(xs, ids, ids, ids[:1], *w, **kw),
        lambda: qmoe.qmoe_mlp_e2e(xs[:3], ids, ids[:1], ids.repeat(bm),
                                  torch.empty(S * bm, device="meta"),
                                  torch.zeros((3, 2), dtype=torch.int32, device="meta"),
                                  *w, rt_gu=True, rt_d=True, **kw),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="kernel library"):
            call()
