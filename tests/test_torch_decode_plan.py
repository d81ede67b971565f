"""The launch plan of the decode kernel of K1, K3, K7 and K2
(``ops/qmatmul.py``, ``decode_plan``), which the wrappers hand to the C
entries: invariants over shapes inside the kernels' contract, and the split
it gives each of Llama-3-8B's and Qwen3-30B-A3B's projections on an H100.
The kernel sizes its own shared memory; ``csrc/qmm_decode.cuh`` asserts at
compile time that it fits a block and that two blocks an SM keep 24 KB of
weights in flight."""

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from gptqmodel_tpu_torch.ops.qmatmul import (
    DECODE_COLS,
    DECODE_MAX_M,
    DECODE_MAX_SPLIT,
    DECODE_PLAN_SPLIT,
    H100_SMS,
    decode_blocks_per_sm,
    decode_plan,
)

# (K, N) of Llama-3-8B's projections as the port runs them: q/k/v and
# gate/up fused
LLAMA3_8B = {"qkv": (4096, 6144), "o": (4096, 4096), "gate_up": (4096, 28672),
             "down": (14336, 4096)}
# beside them, K1's qkv of Qwen3-30B-A3B (hidden 2048, 32 + 2 x 4 heads of
# 128) and K2's two passes at Llama-3-8B: gate/up pairs F / 32 tiles of 32
# gate and 32 up columns, as many as 2F / 64, then down on inner [M, F]
FILLING = {**LLAMA3_8B, "qwen3_30b_a3b_qkv": (2048, 5120), "k2_gate_up": (4096, 2 * 14336),
           "k2_down": (14336, 4096)}


@st.composite
def contract_shapes(draw):
    """(M, K, N, group_size) inside K3's and K7's contract: groups of a
    multiple of 128 (or -1, one group over K), K a multiple of g, N a
    multiple of 8."""
    g = 128 * draw(st.integers(1, 8))
    G = draw(st.integers(1, 160))
    group_size = draw(st.sampled_from([g, -1]))
    K = g * G if group_size > 0 else g
    N = 8 * draw(st.integers(1, 8192))
    M = draw(st.integers(1, DECODE_MAX_M))
    return M, K, N, group_size


@settings(max_examples=300, deadline=None)
@given(contract_shapes())
def test_plan_covers_every_group_once_in_whole_groups(shape):
    M, K, N, group_size = shape
    plan = decode_plan(M, K, N, group_size)
    g = group_size if group_size > 0 else K
    assert plan.groups == K // g
    covered = [grp for r in range(plan.split) for grp in plan.groups_of(r)]
    assert covered == list(range(plan.groups))  # each group once, in rank order
    assert all(len(plan.groups_of(r)) >= 1 for r in range(plan.split))
    assert plan.tiles * DECODE_COLS >= N > (plan.tiles - 1) * DECODE_COLS


@settings(max_examples=300, deadline=None)
@given(contract_shapes())
def test_plan_fits_a_cluster_and_shared_memory(shape):
    """A cluster of at most 8 blocks; the shared memory of each is the
    header's, asserted at compile time to fit."""
    M, K, N, group_size = shape
    plan = decode_plan(M, K, N, group_size)
    assert 1 <= plan.split <= DECODE_PLAN_SPLIT <= DECODE_MAX_SPLIT
    # the split is the fewest that reach the blocks per SM it aims at, unless
    # the cluster or the groups run out; and never fewer than two blocks per SM
    want = decode_blocks_per_sm(M) * H100_SMS
    assert want >= 2 * H100_SMS
    if plan.split < min(DECODE_PLAN_SPLIT, plan.groups):
        assert plan.blocks >= want
    if plan.split > 1:
        assert plan.tiles * (plan.split - 1) < want


@pytest.mark.parametrize("M", [1, 8, 16])
@pytest.mark.parametrize("proj", list(FILLING))
def test_llama3_projections_fill_the_card(proj, M):
    """Each projection launches at least two blocks per SM of an H100, at
    which the header asserts that the rings keep at least 24 KB of weights
    in flight on every SM, at every width."""
    K, N = FILLING[proj]
    plan = decode_plan(M, K, N, 128)
    assert plan.blocks >= 2 * H100_SMS
    assert plan.tiles * DECODE_COLS == N and plan.groups == K // 128


@pytest.mark.parametrize("M", [1, 8, 16])
def test_qwen3_moe_o_projection_takes_the_largest_cluster(M):
    """Qwen3-30B-A3B's o projection (4096 x 2048) has 32 column tiles: even
    the plan's largest cluster gives 224 blocks, under two per SM, so the
    plan takes that cluster at every M."""
    plan = decode_plan(M, 4096, 2048, 128)
    assert (plan.tiles, plan.split, plan.blocks) == (32, DECODE_PLAN_SPLIT, 224)
    assert plan.blocks < 2 * H100_SMS
