"""The port's GPTQ solve against the JAX package, on the CPU.

The JAX package's K8 (``gptq_whole_solve``) and K9 (``gptq_block_inner``)
run in Pallas interpret mode, as its own tests run them; the port runs their
plain versions, which the CUDA kernels repeat. Tolerances are the JAX
package's for its K8 against the XLA scan (``tests/test_pallas_gptq.py``):
the f32 sums of the trailing product run in another order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gptqmodel_tpu.ops.qlinear import make_quant_linear as jmake_quant_linear
from gptqmodel_tpu.ops.pallas_gptq import gptq_block_inner as jblock_inner
from gptqmodel_tpu.ops.pallas_gptq import gptq_whole_solve as jwhole_solve
from gptqmodel_tpu.ops.pallas_gptq import mega_row_tile, solver_row_tile
from gptqmodel_tpu.quantization.gptq import accumulate_hessian as jaccumulate
from gptqmodel_tpu.quantization.gptq import gptq_quantize as jgptq_quantize
from gptqmodel_tpu.quantization.gptq import gptq_solve_core as jsolve_core
from gptqmodel_tpu.quantization.gptq import hessian_inverse as jhessian_inverse
from gptqmodel_tpu.quantization.quantizer import find_params_grouped as jfind_grouped
from gptqmodel_tpu.quantization.rtn import rtn_quantize as jrtn
from gptqmodel_tpu_torch.ops.gptq_solve import gptq_block_inner, gptq_whole_solve
from gptqmodel_tpu_torch.ops.qlinear import make_quant_linear
from gptqmodel_tpu_torch.quantization.gptq import (
    accumulate_hessian,
    gptq_quantize,
    gptq_solve_core,
    hessian_inverse,
)
from gptqmodel_tpu_torch.quantization.quantizer import find_params_grouped
from gptqmodel_tpu_torch.quantization.rtn import rtn_quantize


def _case(out_f, in_f, seed=0):
    rng = np.random.default_rng(seed)
    W = (rng.standard_normal((out_f, in_f)) * 0.05).astype(np.float32)
    X = rng.standard_normal((512, in_f)).astype(np.float32)
    return W, (2.0 / 512) * (X.T @ X)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close_solve(got, ref, loss_got, loss_ref):
    """(Q, Dq, scales) of both packages within the JAX package's tolerances."""
    Q, Dq, s = (np.asarray(a) for a in got)
    rQ, rDq, rs = (np.asarray(a) for a in ref)
    frac = float((Q != rQ).mean())
    assert frac < 2e-3, f"code mismatch fraction {frac}"
    np.testing.assert_allclose(Dq, rDq, rtol=1e-4, atol=2e-4)
    np.testing.assert_allclose(s, rs, rtol=1e-5)
    np.testing.assert_allclose(loss_got, loss_ref, rtol=1e-3)


@pytest.mark.parametrize("out_f,in_f", [(64, 256), (32, 512)])
@pytest.mark.parametrize("sym", [True, False])
@pytest.mark.parametrize("g", [64, 128, -1, "static"])
def test_whole_solve_plain_matches_jax_k8(out_f, in_f, sym, g):
    W, H = _case(out_f, in_f, seed=out_f + in_f)
    U = np.asarray(jhessian_inverse(jnp.asarray(H), 0.01)[0])
    if g == -1:  # per channel: both packages route through their solve core
        ref = jsolve_core(jnp.asarray(W), jnp.asarray(U), bits=4, group_size=-1, sym=sym,
                          solver="mega_interpret")
        got = gptq_solve_core(_t(W), _t(U), bits=4, group_size=-1, sym=sym)
        _close_solve((got["Q"], got["Wq"], got["scales"]),
                     (ref["Q"], ref["Wq"], ref["scales"]),
                     float(got["losses"].sum()), float(np.asarray(ref["losses"]).sum()))
        return
    static = g == "static"
    SP = ZP = None
    if static:  # per-column tables from the original W, groups of 128
        s_g, z_g = (np.asarray(a) for a in jfind_grouped(jnp.asarray(W), bits=4,
                                                          group_size=128, sym=sym))
        cols = np.arange(in_f) // 128
        SP, ZP = np.ascontiguousarray(s_g[cols].T), np.ascontiguousarray(z_g[cols].T)
    gs = 128 if static else g
    rQ, rDq, rL, rs, rz = jwhole_solve(
        jnp.asarray(W), jnp.asarray(U), None if SP is None else jnp.asarray(SP),
        None if ZP is None else jnp.asarray(ZP), maxq=15, group_size=gs, sym=sym,
        blocksize=128, rt=mega_row_tile(out_f, in_f, 128), static=static, interpret=True)
    Q, Dq, L, s, z = gptq_whole_solve(_t(W), _t(U), None if SP is None else _t(SP),
                                      None if ZP is None else _t(ZP), maxq=15,
                                      group_size=gs, sym=sym)
    if static:
        assert s is None and z is None
        s, rs = torch.zeros(1), np.zeros(1)
    else:
        np.testing.assert_array_equal(z.numpy(), np.asarray(rz))
    _close_solve((Q, Dq, s), (rQ, rDq, rs), float(L.sum()), float(np.asarray(rL).sum()))


@pytest.mark.parametrize("out_f", [32, 48])
def test_block_inner_plain_matches_jax_k9(out_f):
    rng = np.random.default_rng(out_f)
    Wb = (rng.standard_normal((out_f, 128)) * 0.05).astype(np.float32)
    A = rng.standard_normal((128, 256)).astype(np.float32)
    Hbb = np.triu((A @ A.T / 256 + 0.1 * np.eye(128)).astype(np.float32))
    S = rng.uniform(0.005, 0.02, size=(out_f, 128)).astype(np.float32)
    Z = np.full((out_f, 128), 8.0, np.float32)
    ref = jblock_inner(jnp.asarray(Wb), jnp.asarray(Hbb), jnp.asarray(S), jnp.asarray(Z),
                       maxq=15, rt=solver_row_tile(out_f), interpret=True)
    got = gptq_block_inner(_t(Wb), _t(Hbb), _t(S), _t(Z), maxq=15)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    for a, b in zip(got[1:], ref[1:]):  # the same arithmetic per column
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


def test_hessian_inverse_matches_jax():
    _, H = _case(8, 256, seed=4)
    U, damp = hessian_inverse(_t(H), 0.01)
    rU, rdamp = jhessian_inverse(jnp.asarray(H), 0.01)
    rU = np.asarray(rU)
    assert damp == rdamp
    np.testing.assert_allclose(U.numpy(), rU, rtol=1e-4, atol=1e-6 * np.abs(rU).max())


def test_damp_ladder_climbs_as_jax():
    """A rank-deficient Hessian with a tiny damp fails the residual check
    until the ladder has climbed; both packages stop at the same damp, and
    both give up on a matrix no damp repairs."""
    rng = np.random.default_rng(5)
    X = rng.standard_normal((8, 256)).astype(np.float32) * 100
    H = (X.T @ X).astype(np.float32)
    U, damp = hessian_inverse(_t(H), 1e-9, 1e-3)
    _, rdamp = jhessian_inverse(jnp.asarray(H), 1e-9, 1e-3)
    assert damp == rdamp > 1e-9
    neg = -np.eye(64, dtype=np.float32)
    with pytest.raises(np.linalg.LinAlgError):
        hessian_inverse(_t(neg), 0.01)
    with pytest.raises(np.linalg.LinAlgError):
        jhessian_inverse(jnp.asarray(neg), 0.01)


def test_accumulate_hessian_matches_jax():
    rng = np.random.default_rng(6)
    H, n = torch.zeros(64, 64), 0
    rH, rn = jnp.zeros((64, 64), jnp.float32), jnp.int32(0)
    for rows in (40, 24, 64):
        x = rng.standard_normal((rows, 64)).astype(np.float32)
        H, n = accumulate_hessian(H, n, _t(x))
        rH, rn = jaccumulate(rH, rn, jnp.asarray(x))
    assert n == int(rn)
    np.testing.assert_allclose(H.numpy(), np.asarray(rH), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("bits,sym,g", [(4, True, 128), (4, False, 64), (3, False, -1),
                                        (8, True, 32)])
def test_quantizer_and_rtn_match_jax(bits, sym, g):
    W, _ = _case(48, 256, seed=bits)
    s, z = find_params_grouped(_t(W), bits=bits, group_size=g, sym=sym)
    rs, rz = jfind_grouped(jnp.asarray(W), bits=bits, group_size=g, sym=sym)
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(z.numpy(), np.asarray(rz))
    got, ref = rtn_quantize(_t(W), bits=bits, group_size=g, sym=sym), jrtn(
        W, bits=bits, group_size=g, sym=sym)
    np.testing.assert_array_equal(got.Q.numpy(), ref.Q)
    np.testing.assert_array_equal(got.Wq.numpy(), ref.Wq)
    np.testing.assert_allclose(got.avg_loss, ref.avg_loss, rtol=1e-12)


def _dead_columns():
    W, H = _case(32, 512, seed=11)
    H[[3, 100, 257], :] = 0
    H[:, [3, 100, 257]] = 0
    return W, H


@pytest.mark.parametrize("name,case,kw", [
    ("desc_act", lambda: _case(32, 512, 7), dict(desc_act=True)),
    ("static_groups", lambda: _case(32, 512, 7), dict(static_groups=True)),
    ("desc_act+static", lambda: _case(32, 512, 7), dict(desc_act=True, static_groups=True)),
    ("bits3", lambda: _case(32, 512, 7), dict(bits=3)),
    ("padded_in320", lambda: _case(32, 320, 5), dict(group_size=64, sym=True)),
    ("group256", lambda: _case(32, 512, 7), dict(group_size=256)),
    ("dead_columns", _dead_columns, dict()),
])
def test_gptq_quantize_matches_jax(name, case, kw):
    W, H = case()
    base = dict(bits=4, group_size=128, sym=False, nsamples=512)
    base.update(kw)
    got = gptq_quantize(W, H, **base)
    ref = jgptq_quantize(W, H, **base)
    _close_solve((got.Q, got.Wq, got.scales), (ref.Q, ref.Wq, ref.scales),
                 got.avg_loss, ref.avg_loss)
    np.testing.assert_array_equal(got.zeros.numpy(), ref.zeros)
    np.testing.assert_array_equal(got.g_idx.numpy(), ref.g_idx)
    assert got.damp == ref.damp
    assert (got.perm is None) == (ref.perm is None)
    if ref.perm is not None:
        np.testing.assert_array_equal(got.perm.numpy(), ref.perm)


def test_gptq_quantize_nan_weights_raise_in_both():
    W, H = _case(32, 256, seed=9)
    W[5, 17] = np.nan
    with pytest.raises(ValueError, match="NaN"):
        gptq_quantize(W, H, bits=4, group_size=128, sym=True, nsamples=512)
    with pytest.raises(ValueError, match="NaN"):
        jgptq_quantize(W, H, bits=4, group_size=128, sym=True, nsamples=512)


@pytest.mark.parametrize("desc_act", [False, True])
def test_make_quant_linear_packs_gptq_results_as_jax(desc_act):
    """The JAX package's solve result packed by both packages (the port from
    torch tensors): the same qweight, qzeros, scales and g_idx."""
    W, H = _case(64, 256, seed=12)
    res = jgptq_quantize(W, H, bits=4, group_size=64, sym=False, desc_act=desc_act,
                         nsamples=512)
    kw = dict(bits=4, group_size=64, sym=False, bias=None)
    ref = jmake_quant_linear(Q=res.Q, scales=res.scales, zeros=res.zeros, g_idx=res.g_idx,
                             **kw)
    got = make_quant_linear(Q=_t(res.Q), scales=_t(res.scales), zeros=_t(res.zeros),
                            g_idx=_t(res.g_idx), device="cpu", **kw)
    assert (got.g_idx is None) == (ref.g_idx is None) == (not desc_act)
    for name in ("qweight", "qzeros", "scales", "g_idx"):
        a, b = getattr(got, name), getattr(ref, name)
        if b is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
