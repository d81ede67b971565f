"""The launch plan of the decode kernel of K1, K3, K4, K5, K6, K7 and K2
(``ops/qmatmul.py``, ``decode_plan``) and of K10's-K13's passes
(``ops/qmoe.py``, ``e2e_plan``; K11, K12 and K13 take it for the slot bound),
which the wrappers hand to the C entries: invariants over shapes inside
the kernels' contract, and the split it gives each of
Llama-3-8B's and Qwen3-30B-A3B's projections and MoE passes on an H100.
K6's small groups split K in 128-row chunks, and its shapes outside the
decode contract take the register tile by the plan's rule
(``qmm_decode_supported``); K4 and K5 take the plan's split at M <= 16.
The kernel sizes its own shared memory; ``csrc/qmm_decode.cuh`` asserts at
compile time that it fits a block and that two blocks an SM keep 24 KB of
weights in flight, and a card test reads the sizes from the library."""

from types import SimpleNamespace

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from gptqmodel_tpu_torch.ops import _build, qmoe
from gptqmodel_tpu_torch.ops import qmatmul as qmatmul_mod
from gptqmodel_tpu_torch.ops.qmatmul import (
    DECODE_CHUNK,
    DECODE_COLS,
    DECODE_MAX_M,
    DECODE_MAX_SPLIT,
    DECODE_PLAN_SPLIT,
    H100_SMS,
    KERNEL_BITS,
    PLANE_BITS,
    decode_blocks_per_sm,
    decode_plan,
    qmatmul_planes,
    qmatmul_planes_asym,
    qmatmul_planes_supported,
    qmm,
    qmm_decode_supported,
    qmm_supported,
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


# ---------------------------------------------------------------- K6 (qmm)


def k6_groups(bits: int) -> list[int]:
    """The groups inside ``qmm_supported`` at ``bits`` that divide a chunk."""
    return [g for g in (4, 8, 16, 32, 64, 128)
            if DECODE_CHUNK % g == 0 and qmm_supported(bits, g, 4096, 4096)]


@st.composite
def k6_shapes(draw):
    """(M, K, N, bits, group_size) on K6's decode route."""
    bits = draw(st.sampled_from(KERNEL_BITS))
    g = draw(st.sampled_from(k6_groups(bits)))
    K = DECODE_CHUNK * draw(st.integers(1, 160))
    N = 128 * draw(st.integers(1, 256))
    return draw(st.integers(1, DECODE_MAX_M)), K, N, bits, g


def test_k6_groups_are_those_qmm_takes_that_divide_a_chunk():
    assert {b: k6_groups(b) for b in KERNEL_BITS} == {
        2: [16, 32, 64, 128], 4: [8, 16, 32, 64, 128], 8: [8, 16, 32, 64, 128]}


@settings(max_examples=300, deadline=None)
@given(k6_shapes())
def test_k6_plan_covers_every_chunk_once_in_whole_groups(shape):
    """K6's cluster splits K in 128-row chunks: each rank sums whole chunks,
    at least one, in rank order, and so each chunk's groups whole."""
    M, K, N, bits, g = shape
    assert qmm_decode_supported(M, K, g)
    plan = decode_plan(M, K, N, g)
    per_chunk = DECODE_CHUNK // g
    assert (plan.groups, plan.per_unit) == (K // g, per_chunk)
    for r in range(plan.split):
        groups = plan.groups_of(r)
        assert len(groups) >= per_chunk
        assert groups.start % per_chunk == 0 and groups.stop % per_chunk == 0
    assert [grp for r in range(plan.split) for grp in plan.groups_of(r)] == list(range(K // g))
    assert plan.tiles * DECODE_COLS == N


@pytest.mark.parametrize("M", [1, 8, 16])
@pytest.mark.parametrize("bits", KERNEL_BITS)
def test_k6_cluster_fits(bits, M):
    """At every group K6's decode route takes, the cluster stays within
    ``DECODE_MAX_SPLIT`` and takes at most one block a chunk. The ring's
    fit is the header's ``static_assert``, and ``test_k6_rings_fit_a_block``
    reads its sizes from the library on the card."""
    for g in k6_groups(bits):
        for K in (DECODE_CHUNK, 4096, 14336):
            split = decode_plan(M, K, 4096, g).split
            assert 1 <= split <= min(DECODE_PLAN_SPLIT, K // DECODE_CHUNK) <= DECODE_MAX_SPLIT


@pytest.mark.parametrize("M", [1, 8, 16])
@pytest.mark.parametrize("proj", list(LLAMA3_8B))
def test_llama3_projections_at_group32_fill_the_card(proj, M):
    """K6 at group 32 on Llama-3-8B's projections: at least two blocks an SM,
    and the fewest clusters that reach ``decode_blocks_per_sm(M)`` (4 at
    M <= 8, 2 at 16) unless the cluster cap binds."""
    K, N = LLAMA3_8B[proj]
    plan = decode_plan(M, K, N, 32)
    want = decode_blocks_per_sm(M) * H100_SMS
    assert plan.blocks >= 2 * H100_SMS
    assert plan.split == min(DECODE_PLAN_SPLIT, K // DECODE_CHUNK, -(-want // plan.tiles))


def _handed_split(monkeypatch, entry, launches, call):
    """The split that a wrapper hands its C entry ``entry`` (the argument
    after its bits, planar or zero point: index 10 of K4's, K5's and K6's)
    for tensors off the CPU, here on the meta device with a stand-in
    library: ``call(meta)`` runs the wrapper once, ``meta(shape, dtype)``
    making its operands; ``launches`` is its ``_build.LAUNCHES`` key."""
    calls = []

    def stand_in(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(_build, "lib", lambda: SimpleNamespace(**{entry: stand_in}))
    monkeypatch.setattr(qmatmul_mod, "_sm_count", lambda index: H100_SMS)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: SimpleNamespace(cuda_stream=0))
    monkeypatch.setitem(_build.LAUNCHES, launches, 0)
    call(lambda shape, dtype: torch.empty(shape, dtype=dtype, device="meta"))
    assert _build.LAUNCHES[launches] == 1 and len(calls) == 1
    return calls[0][10]


def _k6_split(monkeypatch, M, K, N, bits, g, sym=True):
    """The split that ``qmm`` hands K6's C entry."""

    def call(meta):
        y = qmm(meta((M, K), torch.bfloat16), meta((K * bits // 32, N), torch.int32),
                meta((K // g, N), torch.float16), meta((K // g, N * bits // 32), torch.int32),
                bits=bits, group_size=g, zero_const=2.0 ** (bits - 1) if sym else -1.0)
        assert y.shape == (M, N)

    return _handed_split(monkeypatch, "gqt_qmm", "qmm", call)


@pytest.mark.parametrize("M", [1, 8, 16])
@pytest.mark.parametrize("bits,g", [(2, 16), (4, 8), (4, 32), (8, 64), (4, 128)])
@pytest.mark.parametrize("sym", [True, False])
def test_k6_decode_shapes_hand_the_kernel_the_plan_split(monkeypatch, M, bits, g, sym):
    K, N = 4096, 6144
    assert _k6_split(monkeypatch, M, K, N, bits, g, sym) == decode_plan(M, K, N, g).split >= 1


# (M, K, bits, g) inside qmm_supported but off the decode route: a group that
# does not divide 128, K not a whole number of chunks, or more than 16 rows
OFF_DECODE = {"g24": (8, 768, 4, 24), "g48": (8, 960, 4, 48), "g96": (1, 2304, 4, 96),
              "g192": (16, 4608, 8, 192), "k960": (8, 960, 4, 32), "k1088_g16": (1, 1088, 2, 16),
              "m17": (17, 4096, 4, 32), "m256": (256, 4096, 4, 32)}


@pytest.mark.parametrize("case", list(OFF_DECODE))
def test_k6_shapes_outside_the_decode_contract_take_the_register_tile(monkeypatch, case):
    M, K, bits, g = OFF_DECODE[case]
    N = 256
    assert qmm_supported(bits, g, K, N) and not qmm_decode_supported(M, K, g)
    assert _k6_split(monkeypatch, M, K, N, bits, g) == 0


# ------------------------------------------------------------ K4, K5 (planes)

# the layouts of K4's and K5's decode cases: 3-bit stitched, 5- and 7-bit planar
PLANE_DECODE_LAYOUTS = [(3, False), (5, True), (7, True)]


def _planes_split(monkeypatch, M, K, N, bits, planar, sym):
    """The split that ``qmatmul_planes`` (``sym``) or ``qmatmul_planes_asym``
    hands its C entry."""
    entry = "qmatmul_planes" if sym else "qmatmul_planes_asym"

    def call(meta):
        x, qweight = meta((M, K), torch.bfloat16), meta((K * bits // 32, N), torch.int32)
        scales = meta((K // 128, N), torch.float16)
        kw = dict(bits=bits, group_size=128, planar=planar)
        if sym:
            y = qmatmul_planes(x, qweight, scales, zero_const=2.0 ** (bits - 1), **kw)
        else:
            y = qmatmul_planes_asym(x, qweight, scales,
                                    meta((K // 128, N * bits // 32), torch.int32), **kw)
        assert y.shape == (M, N)

    return _handed_split(monkeypatch, "gqt_" + entry, entry, call)


@pytest.mark.parametrize("sym", [True, False])
@pytest.mark.parametrize("bits,planar", PLANE_DECODE_LAYOUTS)
@pytest.mark.parametrize("proj", list(LLAMA3_8B))
@pytest.mark.parametrize("M", [1, 8, 16])
def test_planes_decode_shapes_hand_the_kernel_the_plan_split(monkeypatch, M, proj, bits,
                                                              planar, sym):
    """K4 and K5 at M <= 16 on Llama-3-8B's projections hand the C entry the
    decode plan's split, as K1 does: their groups are whole 128-row units."""
    K, N = LLAMA3_8B[proj]
    assert qmatmul_planes_supported(bits, 128, K, N)
    split = _planes_split(monkeypatch, M, K, N, bits, planar, sym)
    assert split == decode_plan(M, K, N, 128).split >= 1


@pytest.mark.parametrize("sym", [True, False])
@pytest.mark.parametrize("bits,planar", PLANE_DECODE_LAYOUTS)
@pytest.mark.parametrize("M", [17, 1024])
def test_planes_above_sixteen_rows_take_the_register_tile(monkeypatch, M, bits, planar, sym):
    """Above ``DECODE_MAX_M`` rows K4 and K5 hand split 0: the register tile."""
    K, N = LLAMA3_8B["qkv"]
    assert _planes_split(monkeypatch, M, K, N, bits, planar, sym) == 0


# the shared memory the system keeps back for each resident block
BLOCK_RESERVED_SMEM = 1024


@pytest.mark.cuda
def test_planes_rings_fit_a_block():
    """K4's and K5's ring at 3, 5, 6 and 7 bits, as the library sizes it
    (``gqt_decode_smem_bytes``, g = 0), fits what a block of the card may
    take and leaves ``decode_blocks_per_sm(M)`` blocks an SM; those widths
    have no ring of K6's groups."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the sizes come from the CUDA library")
    props = torch.cuda.get_device_properties(0)
    lib = _build.lib()
    for bits in PLANE_BITS:
        for M in range(1, DECODE_MAX_M + 1):
            ring = lib.gqt_decode_smem_bytes(bits, M, 0)
            assert 0 < ring <= props.shared_memory_per_block_optin
            resident = props.shared_memory_per_multiprocessor // (ring + BLOCK_RESERVED_SMEM)
            assert resident >= decode_blocks_per_sm(M), (bits, M, ring)
        assert lib.gqt_decode_smem_bytes(bits, 8, 32) == -1
        assert lib.gqt_decode_smem_bytes(bits, DECODE_MAX_M + 1, 0) == -1


@pytest.mark.cuda
def test_k6_rings_fit_a_block():
    """K6's ring at every group its decode route takes, and K1's, as the
    library sizes them (``gqt_decode_smem_bytes``), fit what a block of the
    card may take; at group 32 and 4 bits enough blocks reside on an SM for
    the plan (5 at M = 8); a group that does not divide 128 has no ring."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the sizes come from the CUDA library")
    props = torch.cuda.get_device_properties(0)
    lib = _build.lib()
    for bits in KERNEL_BITS:
        for M in range(1, DECODE_MAX_M + 1):
            for g in [0] + k6_groups(bits):
                ring = lib.gqt_decode_smem_bytes(bits, M, g)
                assert 0 < ring <= props.shared_memory_per_block_optin
        assert lib.gqt_decode_smem_bytes(bits, 8, 24) == -1
    for M in (1, 8, 16):
        ring = lib.gqt_decode_smem_bytes(4, M, 32)
        resident = props.shared_memory_per_multiprocessor // (ring + BLOCK_RESERVED_SMEM)
        assert resident >= decode_blocks_per_sm(M)
        if M == 8:
            assert resident == 5


# ------------------------------------------------- K10 (qmoe_mlp_e2e)

# Qwen3-30B-A3B's MoE layer: hidden 2048, moe_intermediate 768, 128 experts,
# top-8, group 128
QWEN3_MOE = {"D": 2048, "F": 768, "E": 128, "k": 8}
K10_BMS = (8, 16, 24, 32)


def _k10_splits(monkeypatch, N, bm):
    """The (gate|up, down) cluster splits that ``qmoe_mlp_e2e`` hands K10's C
    entry for N tokens of Qwen3-30B-A3B at bm rows a slot (meta tensors, a
    stand-in library)."""
    calls = []

    def gqt_qmoe_e2e(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(_build, "lib", lambda: SimpleNamespace(gqt_qmoe_e2e=gqt_qmoe_e2e))
    monkeypatch.setattr(qmoe, "_sm_count", lambda index: H100_SMS)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: SimpleNamespace(cuda_stream=0))
    monkeypatch.setitem(_build.LAUNCHES, "qmoe_e2e", 0)
    D, F, E, k = (QWEN3_MOE[n] for n in "DFEk")
    S = qmoe.slot_bound(N * k, E, bm)
    meta = lambda shape, dtype: torch.empty(shape, dtype=dtype, device="meta")
    i32, bf16 = torch.int32, torch.bfloat16
    y = qmoe.qmoe_mlp_e2e(
        meta((N, D), bf16), meta((S,), i32), meta((1,), i32), meta((S * bm,), i32),
        meta((S * bm,), torch.float32), meta((N, k), i32), meta((E, D // 8, 2 * F), i32),
        meta((E, D // 128, 2 * F), bf16), meta((E, F // 8, D), i32),
        meta((E, 8, D), bf16), bits=4, G_gu=D // 128, G_d=F // 128, F=F, bm=bm, zc_gu=8.0,
        zc_d=8.0, rt_gu=True, rt_d=True)
    assert y.shape == (N, D) and _build.LAUNCHES["qmoe_e2e"] == 1 and len(calls) == 1
    return calls[0][25], calls[0][26]


@pytest.mark.parametrize("N", [1, 8, 1024])
def test_k10_plan_does_not_depend_on_bm(monkeypatch, N):
    """At decode (N = 1, 8) and at the prefill of 1024 tokens, the wrapper
    hands K10's C entry the same splits at every bm, those of ``e2e_plan``
    for the routed rows: a row's sums then do not depend on bm."""
    D, F, E, k = (QWEN3_MOE[n] for n in "DFEk")
    want = (qmoe.e2e_plan(N * k, E, D, 2 * F, 128).split,
            qmoe.e2e_plan(N * k, E, F, D, 128).split)
    assert [_k10_splits(monkeypatch, N, bm) for bm in K10_BMS] == [want] * len(K10_BMS)


# the splits of K10's passes at Qwen3-30B-A3B's widths: (gate|up, down)
K10_SPLITS = {1: (2, 1), 8: (1, 1), 1024: (1, 1)}


@pytest.mark.parametrize("N", list(K10_SPLITS))
@pytest.mark.parametrize("pass_", ["gate_up", "down"])
def test_k10_plan_fills_the_card(N, pass_):
    """Counting the min(E, M) slots that can hold rows, each pass launches
    at least ``E2E_BLOCKS_PER_SM`` blocks an SM with the fewest cluster
    blocks that do, unless a rank would get fewer than
    ``E2E_GROUPS_PER_RANK`` groups. At N = 1 (8 routed rows) gate|up (16
    groups) splits K in 2, and down (6 groups) not at all; from N = 8 on one
    block a (slot, tile) is already more than the card holds at once."""
    D, F, E, k = (QWEN3_MOE[n] for n in "DFEk")
    K, Nout = (D, 2 * F) if pass_ == "gate_up" else (F, D)
    M = N * k
    plan = qmoe.e2e_plan(M, E, K, Nout, 128)
    busy = plan.tiles * min(E, M)
    want = qmoe.E2E_BLOCKS_PER_SM * H100_SMS
    cap = max(1, min(DECODE_PLAN_SPLIT, plan.groups // qmoe.E2E_GROUPS_PER_RANK))
    assert plan.tiles == Nout // DECODE_COLS and plan.groups == K // 128
    assert 1 <= plan.split <= cap
    assert (busy * plan.split >= want or plan.split == cap) and (plan.split - 1) * busy < want
    assert plan.split == K10_SPLITS[N][pass_ == "down"]


@st.composite
def k10_shapes(draw):
    """(M, E, K, N, g) inside K10's contract: groups of a multiple of 128, K
    a multiple of g, N a multiple of 64 (gate|up: 2F, F a multiple of 128)."""
    g = 128 * draw(st.integers(1, 4))
    return (draw(st.integers(1, 16384)), draw(st.integers(1, 512)), g * draw(st.integers(1, 48)),
            64 * draw(st.integers(1, 256)), g)


@settings(max_examples=300, deadline=None)
@given(k10_shapes())
def test_k10_plan_covers_every_group_once(shape):
    """Each rank of a K10 cluster sums whole groups, in rank order, at least
    ``E2E_GROUPS_PER_RANK`` where K is split, and the ranks cover K once;
    the cluster stays within the plan's largest."""
    M, E, K, N, g = shape
    plan = qmoe.e2e_plan(M, E, K, N, g)
    assert 1 <= plan.split <= min(DECODE_PLAN_SPLIT, K // g)
    least = 1 if plan.split == 1 else qmoe.E2E_GROUPS_PER_RANK
    assert all(len(plan.groups_of(r)) >= least for r in range(plan.split))
    assert [grp for r in range(plan.split) for grp in plan.groups_of(r)] == list(range(K // g))


@pytest.mark.cuda
def test_k10_rings_fit_a_block():
    """K10's ring at every bm (8 to 32 rows a slot) and width, as the library
    sizes it (``gqt_qmoe_smem_bytes``), fits what a block of the card may
    take; at bm = 8 and 4 bits at least the plan's blocks an SM reside; a bm
    the kernel does not take has no ring."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the sizes come from the CUDA library")
    props = torch.cuda.get_device_properties(0)
    lib = _build.lib()
    for bits in KERNEL_BITS:
        for bm in K10_BMS:
            ring = lib.gqt_qmoe_smem_bytes(bits, bm)
            assert 0 < ring <= props.shared_memory_per_block_optin
            if bm <= DECODE_MAX_M:  # K1's ring at as many rows
                assert ring == lib.gqt_decode_smem_bytes(bits, bm, 0)
        assert lib.gqt_qmoe_smem_bytes(bits, 12) == lib.gqt_qmoe_smem_bytes(bits, 40) == -1
    ring = lib.gqt_qmoe_smem_bytes(4, 8)
    resident = props.shared_memory_per_multiprocessor // (ring + BLOCK_RESERVED_SMEM)
    assert resident >= qmoe.E2E_BLOCKS_PER_SM


# ------------------------------------- K11 and K12 (qmoe_mlp_matmul(_dyn))


# the parameters of the C entries in csrc/qmoe.cu, in order: the stand-in
# libraries below record each call's arguments by these names, and a call
# with another number of arguments fails
QMOE_MLP_PARAMS = ("x", "ids", "counts", "n_used", "S", "bm", "D", "F", "qw_gu", "s_gu",
                   "Gp_gu", "qw_d", "s_d", "Gp_d", "g", "zc_gu", "zc_d", "bits", "split_gu",
                   "split_d", "out_f32", "inner", "out", "stream")
QMOE_MATMUL_PARAMS = ("x", "ids", "counts", "S", "bm", "K", "N", "qw", "sc", "Gp", "g", "zc",
                      "bits", "split", "out_f32", "out", "stream")


def _recorder(calls, params):
    """A stand-in C entry that records each call's arguments by name."""
    def entry(*args):
        calls.append(dict(zip(params, args, strict=True)))
        return 0
    return entry


def _slot_mlp_call(monkeypatch, S, bm, dyn):
    """K11 (``dyn``) or K12 over S slots of Qwen3-30B-A3B at bm rows a slot
    (meta tensors, a stand-in library, fresh launch counts): the output and
    the arguments of each ``gqt_qmoe_mlp`` call, by name."""
    calls = []
    gqt_qmoe_mlp = _recorder(calls, QMOE_MLP_PARAMS)

    monkeypatch.setattr(_build, "lib", lambda: SimpleNamespace(gqt_qmoe_mlp=gqt_qmoe_mlp))
    monkeypatch.setattr(_build, "LAUNCHES", dict.fromkeys(_build.LAUNCHES, 0))
    monkeypatch.setattr(qmoe, "_sm_count", lambda index: H100_SMS)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: SimpleNamespace(cuda_stream=0))
    D, F, E = (QWEN3_MOE[n] for n in "DFE")
    meta = lambda shape, dtype: torch.empty(shape, dtype=dtype, device="meta")
    i32, bf16 = torch.int32, torch.bfloat16
    w = (meta((E, D // 8, 2 * F), i32), meta((E, 16, 2 * F), bf16), meta((E, F // 8, D), i32),
         meta((E, 8, D), bf16))
    kw = dict(bits=4, G_gu=D // 128, G_d=F // 128, F=F, bm=bm, zc_gu=8.0, zc_d=8.0)
    x, ids, counts = meta((S * bm, D), bf16), meta((S,), i32), meta((S,), i32)
    if dyn:
        y = qmoe.qmoe_mlp_matmul_dyn(x, ids, counts, meta((1,), i32), *w, **kw)
    else:
        y = qmoe.qmoe_mlp_matmul(x, ids, counts, *w, **kw)
    assert y.shape == (S * bm, D)
    return y, calls


def _slot_mlp_splits(monkeypatch, N, bm, dyn):
    """The (gate|up, down) cluster splits that K11 (``dyn``) or K12 hands
    ``gqt_qmoe_mlp`` for N tokens of Qwen3-30B-A3B at bm rows a slot."""
    k, E = QWEN3_MOE["k"], QWEN3_MOE["E"]
    _, calls = _slot_mlp_call(monkeypatch, qmoe.slot_bound(N * k, E, bm), bm, dyn)
    assert len(calls) == 1
    assert (calls[0]["n_used"] is not None) == dyn  # K11's, none for K12
    return calls[0]["split_gu"], calls[0]["split_d"]


@pytest.mark.parametrize("dyn", [False, True])
def test_slot_mlp_counts_only_the_launches_it_makes(monkeypatch, dyn):
    """K11 and K12 add one to their launch count where they call
    ``gqt_qmoe_mlp``, and nothing where there is no slot and no launch."""
    key = "qmoe_mlp_dyn" if dyn else "qmoe_mlp"
    _, calls = _slot_mlp_call(monkeypatch, 72, 8, dyn)
    assert len(calls) == 1 and _build.LAUNCHES[key] == 1
    _, calls = _slot_mlp_call(monkeypatch, 0, 8, dyn)
    assert calls == [] and _build.LAUNCHES[key] == 0


@pytest.mark.parametrize("bm", K10_BMS)
@pytest.mark.parametrize("N", [1, 8, 128])
def test_slot_mlp_plan_is_the_same_for_k11_and_k12(monkeypatch, N, bm):
    """K11 and K12 hand their C entry the same splits for the same inputs,
    those of ``e2e_plan`` for the slot bound: their rows' float32 sums
    are then the same sequence, and their outputs equal bit for bit."""
    D, F, E, k = (QWEN3_MOE[n] for n in "DFEk")
    S = qmoe.slot_bound(N * k, E, bm)
    want = (qmoe.e2e_plan(S, E, D, 2 * F, 128).split,
            qmoe.e2e_plan(S, E, F, D, 128).split)
    assert _slot_mlp_splits(monkeypatch, N, bm, True) == want
    assert _slot_mlp_splits(monkeypatch, N, bm, False) == want


@pytest.mark.parametrize("N", [1, 8, 128])
def test_slot_mlp_plan_gives_k10_splits_at_qwen3(N):
    """At Qwen3-30B-A3B's widths and the model's 8 rows a slot, the slot
    plan (from the slot bound) gives each pass the split that K10's plan
    gives for the routed rows: both run one ring, split and bm."""
    D, F, E, k = (QWEN3_MOE[n] for n in "DFEk")
    S = qmoe.slot_bound(N * k, E, 8)
    for K, Nout in ((D, 2 * F), (F, D)):
        assert qmoe.e2e_plan(S, E, K, Nout, 128) == qmoe.e2e_plan(N * k, E, K, Nout, 128)


# ---------------------------------------------------- K13 (qmoe_matmul)


def _qmoe_matmul_call(monkeypatch, S, bm, K, N):
    """K13 over S slots of bm rows against a stack of Qwen3-30B-A3B's E
    experts of K x N (meta tensors, a stand-in library, fresh launch
    counts): the arguments of each ``gqt_qmoe_matmul`` call, by name."""
    calls = []
    gqt_qmoe_matmul = _recorder(calls, QMOE_MATMUL_PARAMS)

    monkeypatch.setattr(_build, "lib", lambda: SimpleNamespace(gqt_qmoe_matmul=gqt_qmoe_matmul))
    monkeypatch.setattr(_build, "LAUNCHES", dict.fromkeys(_build.LAUNCHES, 0))
    monkeypatch.setattr(qmoe, "_sm_count", lambda index: H100_SMS)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: SimpleNamespace(cuda_stream=0))
    E = QWEN3_MOE["E"]
    meta = lambda shape, dtype: torch.empty(shape, dtype=dtype, device="meta")
    i32, bf16 = torch.int32, torch.bfloat16
    y = qmoe.qmoe_matmul(meta((S * bm, K), bf16), meta((S,), i32), meta((S,), i32),
                         meta((E, K // 8, N), i32), meta((E, 16, N), bf16), bits=4,
                         G=K // 128, bm=bm, zero_const=8.0)
    assert y.shape == (S * bm, N)
    return calls


@pytest.mark.parametrize("S", [72, 256])
def test_k13_plan_is_k11_gate_up_and_k12_down(monkeypatch, S):
    """At Qwen3-30B-A3B's widths and the slot bounds of N = 8 and 128 tokens
    (72 and 256 slots), K13 hands its C entry the split that K11 gives its
    gate|up pass over [D, 2F] and K12 its down pass over [F, D], at every
    bm: a function of the shapes alone, so that K13 on K12's inner sums each
    row as K12 does."""
    D, F = QWEN3_MOE["D"], QWEN3_MOE["F"]
    for bm in K10_BMS:
        _, (k11,) = _slot_mlp_call(monkeypatch, S, bm, True)
        _, (k12,) = _slot_mlp_call(monkeypatch, S, bm, False)
        (gate_up,) = _qmoe_matmul_call(monkeypatch, S, bm, D, 2 * F)
        (down,) = _qmoe_matmul_call(monkeypatch, S, bm, F, D)
        assert (gate_up["split"], down["split"]) == (k11["split_gu"], k12["split_d"])
        assert down["split"] == qmoe.e2e_plan(S, QWEN3_MOE["E"], F, D, F // 128).split
        assert gate_up["split"] == qmoe.e2e_plan(S, QWEN3_MOE["E"], D, 2 * F, D // 128).split


def test_k13_counts_only_the_launches_it_makes(monkeypatch):
    """K13 adds one to its launch count where it calls ``gqt_qmoe_matmul``,
    and nothing where there is no slot and no launch."""
    D, F = QWEN3_MOE["D"], QWEN3_MOE["F"]
    assert len(_qmoe_matmul_call(monkeypatch, 72, 8, F, D)) == 1
    assert _build.LAUNCHES["qmoe_matmul"] == 1
    assert _qmoe_matmul_call(monkeypatch, 0, 8, F, D) == []
    assert _build.LAUNCHES["qmoe_matmul"] == 0


@pytest.mark.cuda
def test_slot_mlp_rings_fit_a_block():
    """K11's and K12's passes run K10's ring: at every bm (8 to 32 rows a
    slot) and width the library's size (``gqt_qmoe_smem_bytes``) fits what a
    block of the card may take, and both passes launch at that bm."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the sizes come from the CUDA library")
    props = torch.cuda.get_device_properties(0)
    lib = _build.lib()
    dev = torch.device("cuda")
    E, D, F = 2, 256, 128
    for bits in KERNEL_BITS:
        pf = 32 // bits
        w = (torch.zeros((E, D // pf, 2 * F), dtype=torch.int32, device=dev),
             torch.zeros((E, 8, 2 * F), dtype=torch.bfloat16, device=dev),
             torch.zeros((E, F // pf, D), dtype=torch.int32, device=dev),
             torch.zeros((E, 8, D), dtype=torch.bfloat16, device=dev))
        for bm in K10_BMS:
            assert 0 < lib.gqt_qmoe_smem_bytes(bits, bm) <= props.shared_memory_per_block_optin
            x = torch.ones((2 * bm, D), dtype=torch.bfloat16, device=dev)
            ids = torch.tensor([0, 1], dtype=torch.int32, device=dev)
            counts = torch.tensor([bm, 1], dtype=torch.int32, device=dev)
            y = qmoe.qmoe_mlp_matmul(x, ids, counts, *w, bits=bits, G_gu=D // 128,
                                     G_d=F // 128, F=F, bm=bm, zc_gu=0.0, zc_d=0.0)
            torch.cuda.synchronize()
            assert y.shape == (2 * bm, D) and not y.any()
