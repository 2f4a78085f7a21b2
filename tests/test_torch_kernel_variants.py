"""The kernel wrappers' host-side decisions, on the CPU: which variant each
dtype and shape selects (``select_variant``), which tensor-core ``moe_gmm``
forward design each fill selects (``select_design``), the weight stream's
launch plan (``tc_plan``: row tile, split-K factors), the row tiles' plan
(``rows_plan``: grids, shared memory), the scratch sizes the wrapper
allocates, and the refusals of inputs no kernel takes. The kernels
themselves run on the card (``test_torch_cuda.py``)."""

import pytest
import torch

from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import moe_gmm as tgmm
from repro_torch.kernels import ops as tops

BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype,D,F,aligned,want", [
    (BF16, 4096, 14336, True, "tc"),       # Mixtral-8x7B
    (BF16, 96, 704, True, "tc"),           # multiples of 8, not of the tiles
    (BF16, 8, 8, True, "tc"),
    (BF16, 100, 704, True, "simt"),        # D % 8 != 0
    (BF16, 96, 700, True, "simt"),         # F % 8 != 0
    (BF16, 4096, 14336, False, "simt"),    # 16-byte copies need alignment
    (F32, 4096, 14336, True, "simt"),      # fp32 stays off the tensor cores
    (torch.float16, 4096, 14336, True, "simt"),
])
def test_moe_gmm_select_variant(dtype, D, F, aligned, want):
    assert tgmm.select_variant(dtype, D, F, aligned) == want


@pytest.mark.parametrize("hd", [16, 32, 48, 64, 80, 96, 112, 128])
def test_flash_select_variant_takes_every_multiple_of_16_in_bf16(hd):
    assert tflash.select_variant(BF16, hd) == "tc"
    assert tflash.select_variant(F32, hd) == "simt"
    assert tflash.select_variant(BF16, hd, aligned=False) == "simt"


@pytest.mark.parametrize("hd", [8, 24, 40, 72, 120, 144])
def test_flash_select_variant_other_head_sizes_go_to_the_cuda_cores(hd):
    assert tflash.select_variant(BF16, hd) == "simt"


# (S, D, F, max rows, SMs) -> (row tile, ks_up, ks_down)
PLANS = [
    ((8, 4096, 14336, 4, 132), (8, 1, 3)),      # decode: pass 2 is thin
    ((8, 4096, 14336, 64, 132), (64, 1, 3)),    # prefill chunk
    ((8, 4096, 14336, 128, 132), (128, 1, 3)),  # full tile
    ((8, 4096, 14336, 400, 132), (128, 1, 3)),  # generate's prefill
    ((8, 4096, 14336, 9, 132), (16, 1, 3)),
    ((8, 4096, 14336, 0, 132), (8, 1, 3)),
    ((8, 96, 704, 160, 132), (128, 2, 8)),      # both passes split
    ((8, 4352, 256, 8, 132), (8, 8, 1)),        # pass 1 only
    ((8, 128, 2112, 8, 132), (8, 1, 8)),        # pass 2 only
    ((2, 4096, 1024, 64, 132), (64, 8, 8)),
    ((1, 16, 16, 1, 132), (8, 1, 1)),           # one stage deep: no split
    ((8, 4096, 14336, 4, 16), (8, 1, 1)),       # a small card: grid enough
]


@pytest.mark.parametrize("args,want", PLANS)
def test_moe_gmm_tc_plan(args, want):
    assert tgmm.tc_plan(*args) == want


@pytest.mark.parametrize("args", [a for a, _ in PLANS])
def test_moe_gmm_tc_plan_bounds(args):
    """The row tile holds min(m, 128) rows with no smaller tile that does;
    a split never exceeds 8 or the pipeline stages of its axis, and only a
    grid under 2 blocks per SM is split."""
    S, D, F, m, sms = args
    rows, ks_up, ks_down = tgmm.tc_plan(*args)
    assert rows in tgmm.ROW_TILES and rows >= min(max(m, 1), 128)
    assert rows == 8 or rows // 2 < min(max(m, 1), 128)
    for ks, cols, per_block, depth in ((ks_up, F, 64, D),
                                       (ks_down, D, 128, F)):
        assert 1 <= ks <= min(8, -(-depth // 64))
        if -(-cols // per_block) * S >= 2 * sms:
            assert ks == 1


def test_moe_gmm_scratch_sizes():
    # decode on the card: pass 2 split 3 ways, [3, S, m, D] fp32 partials
    s = tgmm.scratch_shapes(8, 4096, 14336, 4, "tc", 132)
    assert s == {"mid": (8, 4, 14336), "part": (3 * 8 * 4 * 4096,)}
    # both passes split: the larger of pass 1's (w1 and w3 columns) and
    # pass 2's partials
    s = tgmm.scratch_shapes(8, 96, 704, 128, "tc", 132)
    assert s["part"] == (max(2 * 2 * 704, 8 * 96) * 8 * 128,)
    # past 128 rows the row tiles, which split nothing: no partials
    assert tgmm.scratch_shapes(8, 96, 704, 160, "tc", 132) == {
        "mid": (8, 160, 704), "part": (0,)}
    # no split, or the CUDA-core variant: no partials
    assert tgmm.scratch_shapes(1, 16, 16, 1, "tc", 132)["part"] == (0,)
    assert tgmm.scratch_shapes(8, 4096, 14336, 4, "simt", 132) == {
        "mid": (8, 4, 14336), "part": (0,)}


# the main paths' fills at Mixtral-8x7B width on 132 SMs: (max_fill,
# design): decode, a prefill chunk, a full tile, generate()'s prefill, the
# EP train step, the 32k prefill
MAIN_FILLS = [(4, "stream"), (64, "stream"), (128, "stream"),
              (400, "rows"), (2048, "rows"), (16384, "rows")]


@pytest.mark.parametrize("m,want", MAIN_FILLS)
def test_moe_gmm_select_design_at_the_main_fills(m, want):
    assert tgmm.select_design("tc", m) == want
    assert tgmm.select_design("simt", m) == "simt"


@pytest.mark.parametrize("m", [1, 8, 64, 100, 128, tgmm.ROWS_MIN_FILL])
def test_moe_gmm_fills_at_or_below_the_crossover_keep_the_stream(m):
    """Every fill at or below the crossover (itself at least the stream's
    largest row tile) runs the weight stream on its unchanged plan."""
    assert tgmm.ROWS_MIN_FILL >= tgmm.ROW_TILES[-1]
    assert tgmm.select_design("tc", m) == "stream"
    assert tgmm.select_design("tc", tgmm.ROWS_MIN_FILL + 1) == "rows"
    rows, ks_up, ks_down = tgmm.tc_plan(8, 4096, 14336, m, 132)
    assert rows == next(r for r in tgmm.ROW_TILES if r >= m)
    assert (ks_up, ks_down) == (1, 3)


# (S, D, F, max rows, SMs) -> (pass 1 grid, pass 2 grid)
ROWS_PLANS = [
    ((8, 4096, 14336, 4, 132), (132, 132)),       # one row tile a slot
    ((8, 4096, 14336, 64, 132), (132, 132)),
    ((8, 4096, 14336, 128, 132), (132, 132)),
    ((8, 4096, 14336, 400, 132), (132, 132)),     # generate's prefill
    ((8, 4096, 14336, 2048, 132), (132, 132)),    # the EP train step
    ((8, 4096, 14336, 16384, 132), (132, 132)),   # the 32k prefill
    ((1, 136, 200, 130, 132), (4, 2)),            # ragged: few tiles
    ((2, 64, 64, 1, 132), (4, 4)),
    ((1, 64, 64, 600, 132), (6, 6)),              # pairs of row tiles
    ((8, 4096, 14336, 16384, 16), (16, 16)),      # a small card
    ((8, 4096, 14336, 16384, 131), (130, 130)),   # an odd SM count
]


@pytest.mark.parametrize("args,want", ROWS_PLANS)
def test_moe_gmm_rows_plan(args, want):
    plan = tgmm.rows_plan(*args)
    assert (plan["up"]["grid"], plan["down"]["grid"]) == want


@pytest.mark.parametrize("args", [a for a, _ in ROWS_PLANS])
def test_moe_gmm_rows_plan_bounds(args):
    """Whole clusters of two blocks, one block per SM at most and at
    least one cluster; the clusters are the cluster tiles (two 128-row
    tiles at max_fill rows a slot x a column tile) where there are fewer
    than SMs can hold; one block's shared memory fits the card's 227 KB."""
    S, D, F, m, sms = args
    plan = tgmm.rows_plan(*args)
    for name, cols, width in (("up", F, 128), ("down", D, 256)):
        tiles = S * -(-max(m, 1) // 256) * -(-cols // width)
        assert plan[name]["tiles"] == tiles
        assert plan[name]["grid"] == 2 * max(1, min(sms // 2, tiles))
        assert plan[name]["grid"] % 2 == 0 and plan[name]["grid"] <= sms
        assert plan[name]["smem"] == tgmm.ROWS_SMEM <= 232448


def test_variant_counters_start_with_both_variants():
    for mod in (tgmm, tflash):
        assert set(mod.launches_by_variant) == {"tc", "simt"}
    assert set(tgmm.launches_by_design) == {"stream", "rows"}


def test_launch_counts_carry_the_designs_through_replays():
    """``ops.launch_counts`` lists the design counters and
    ``add_launch_counts`` adds a replayed capture's delta to them."""
    before = dict(tgmm.launches_by_design)
    counts = tops.launch_counts()
    assert counts["moe_gmm.rows"] == before["rows"]
    assert counts["moe_gmm.stream"] == before["stream"]
    tops.add_launch_counts({"moe_gmm.rows": 2, "moe_gmm.stream": 1}, 3)
    try:
        assert tgmm.launches_by_design == {"rows": before["rows"] + 6,
                                           "stream": before["stream"] + 3}
    finally:
        tops.add_launch_counts({"moe_gmm.rows": 2, "moe_gmm.stream": 1}, -3)
    assert tgmm.launches_by_design == before


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    before = (tgmm.launches, dict(tgmm.launches_by_variant),
              dict(tgmm.launches_by_design), tflash.launches,
              dict(tflash.launches_by_variant))
    x = torch.zeros((2, 4, 8), dtype=BF16)
    w = torch.zeros((2, 8, 8), dtype=BF16)
    fill = torch.tensor([1, 0], dtype=torch.int32)
    assert tops.moe_gmm(x, w, w, w, fill, 4).shape == x.shape
    q = torch.zeros((1, 4, 2, 16), dtype=BF16)
    assert tops.flash_attention(q, q[:, :, :1], q[:, :, :1]).shape == q.shape
    assert before == (tgmm.launches, dict(tgmm.launches_by_variant),
                      dict(tgmm.launches_by_design), tflash.launches,
                      dict(tflash.launches_by_variant))


def _gmm_args(dtype=BF16, S=2, C=4, D=8, F=8):
    x = torch.zeros((S, C, D), dtype=dtype)
    w = torch.zeros((S, D, F), dtype=dtype)
    w2 = torch.zeros((S, F, D), dtype=dtype)
    return x, w, w, w2, torch.zeros((S,), dtype=torch.int32)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_moe_gmm_launch_refuses_other_dtypes(dtype):
    with pytest.raises(TypeError, match="moe_gmm"):
        tgmm.launch(*_gmm_args(dtype), 4)


def test_moe_gmm_launch_refuses_cpu_tensors_and_autograd():
    """The kernels take CUDA tensors only: a CPU tensor is refused whether
    or not autograd records the call (``launch``, ``launch_bwd`` and the
    ``MoeGmm`` Function alike); on the CPU autograd runs through the plain
    version (``ops.moe_gmm``)."""
    x, w1, w3, w2, fill = _gmm_args()
    with pytest.raises(ValueError, match="moe_gmm: x must be on"):
        tgmm.launch(x, w1, w3, w2, fill, 4)
    xg = x.float().requires_grad_()
    with pytest.raises(ValueError, match="moe_gmm: x must be on"):
        tgmm.launch(xg, w1.float(), w3.float(), w2.float(), fill, 4)
    with pytest.raises(ValueError, match="moe_gmm: x must be on"):
        tgmm.MoeGmm.apply(xg, w1.float(), w3.float(), w2.float(), fill, 4)
    with pytest.raises(ValueError, match="moe_gmm: x must be on"):
        tgmm.launch_bwd(x, w1, w3, w2, fill, 4, x)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_flash_launch_refuses_other_dtypes(dtype):
    q = torch.zeros((1, 4, 2, 16), dtype=dtype)
    with pytest.raises(TypeError, match="flash_attention"):
        tflash.launch(q, q[:, :, :1], q[:, :, :1])


@pytest.mark.parametrize("q_shape,kv_shape", [
    ((1, 4, 2, 144), (1, 4, 1, 144)),   # hd above 128
    ((1, 4, 3, 16), (1, 4, 2, 16)),     # H % KVH != 0
    ((1, 4, 2, 16), (1, 4, 1, 32)),     # hd differs
    ((1, 4, 2, 16), (2, 4, 1, 16)),     # batch differs
    ((1, 4, 2, 16), (1, 4, 2, 16)),     # CPU tensors
])
def test_flash_launch_refuses_bad_shapes(q_shape, kv_shape):
    q = torch.zeros(q_shape, dtype=BF16)
    kv = torch.zeros(kv_shape, dtype=BF16)
    with pytest.raises(ValueError, match="flash_attention"):
        tflash.launch(q, kv, kv)
