"""The orders K8 and K9 keep, replayed on the CPU, and the digests that hold
two builds' solves and checkpoints equal.

``csrc/gptq_solve.cu`` runs a block's column loop as 4 sub-blocks of 32
columns: one warp takes a sub-block's columns with their updates inside it,
then the sub-block's errors go to every later column, ascending in i. Each
element still receives ``w = w - e_i * h_ij`` (a rounded product, then a
rounded difference) for every earlier column i in ascending order, so the
schedule gives the plain version's bits; here it is replayed in torch ops.
"""

from __future__ import annotations

import hashlib

import numpy as np
import pytest
import torch

import chip_smoke
from gptqmodel_tpu_torch.models.safetensors_io import save_file
from gptqmodel_tpu_torch.ops.gptq_solve import BLOCK, gptq_block_inner_plain
from gptqmodel_tpu_torch.quantization.quantizer import _minmax, _params_from_range


def _block(seed: int, out_f: int = 24):
    rng = np.random.default_rng(seed)
    W = torch.from_numpy(rng.standard_normal((out_f, BLOCK), dtype=np.float32) * 0.02)
    X = torch.from_numpy(rng.standard_normal((4 * BLOCK, BLOCK), dtype=np.float32))
    H = (2.0 / X.shape[0]) * (X.T @ X) + 0.01 * torch.eye(BLOCK)
    U = torch.linalg.cholesky(torch.cholesky_inverse(torch.linalg.cholesky(H)), upper=True)
    s, z = _params_from_range(*_minmax(W, False), 15, False)
    return W, U.contiguous(), s[:, None].expand_as(W), z[:, None].expand_as(W)


def _sub_block_schedule(Wb, Hbb, S, Z, *, maxq: int, sub: int):
    """K9's schedule: each sub-block's chain with its own updates, then its
    errors applied to the later columns, i ascending."""
    W = Wb.clone()
    Q, Dq, E, L = (torch.empty_like(W) for _ in range(4))
    for s0 in range(0, BLOCK, sub):
        end = s0 + sub
        for i in range(s0, end):
            w, s, z, d = W[:, i], S[:, i], Z[:, i], Hbb[i, i]
            q = torch.clamp(torch.round(w / s) + z, 0, maxq)
            dq = s * (q - z)
            diff = w - dq
            err = diff / d
            Q[:, i], Dq[:, i], E[:, i] = q, dq, err
            L[:, i] = 0.5 * diff * diff / (d * d)
            W[:, i + 1:end] -= err[:, None] * Hbb[i, i + 1:end][None, :]
        for i in range(s0, end):  # deferred: every later sub-block's columns
            W[:, end:] -= E[:, i:i + 1] * Hbb[i, end:][None, :]
    return Q, Dq, E, L


@pytest.mark.parametrize("sub", [8, 32, 64])
def test_sub_block_schedule_gives_the_plain_bits(sub):
    Wb, Hbb, S, Z = _block(sub)
    got = _sub_block_schedule(Wb, Hbb, S, Z, maxq=15, sub=sub)
    ref = gptq_block_inner_plain(Wb, Hbb, S, Z, maxq=15)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_digest_is_the_bytes_in_order():
    a, b = torch.arange(6, dtype=torch.float32), torch.ones(2, 3)
    want = hashlib.sha256(a.numpy().tobytes() + b.numpy().tobytes()).hexdigest()
    assert chip_smoke.digest(a, None, b) == want
    assert chip_smoke.digest(b, a) != want
    c = a.clone()
    c[3] = float(np.nextafter(np.float32(3), np.float32(4)))  # one ulp up
    assert chip_smoke.digest(c, b) != want


def test_checkpoint_digests_ignore_the_sharding(tmp_path):
    rng = np.random.default_rng(0)
    tensors = {f"model.layers.{i}.mlp.down_proj.{k}":
               torch.from_numpy(rng.integers(0, 2**31, (4, 8), dtype=np.int64).astype(np.int32))
               for i in range(2) for k in ("qweight", "qzeros")}
    one, two = tmp_path / "one", tmp_path / "two"
    one.mkdir()
    two.mkdir()
    save_file(tensors, one / "model.safetensors")
    names = sorted(tensors)
    save_file({k: tensors[k] for k in names[:3]}, two / "model-00001-of-00002.safetensors")
    save_file({k: tensors[k] for k in names[3:]}, two / "model-00002-of-00002.safetensors")
    whole, modules = chip_smoke.checkpoint_digests(one)
    assert chip_smoke.checkpoint_digests(two) == (whole, modules)
    assert sorted(modules) == [f"model.layers.{i}.mlp.down_proj" for i in range(2)]
    tensors[names[0]][0, 0] ^= 1
    save_file(tensors, one / "model.safetensors")
    assert chip_smoke.checkpoint_digests(one)[0] != whole
