"""The kernel wrappers' host-side decisions, on the CPU: which variant each
dtype and shape selects (``select_variant``), the tensor-core ``moe_gmm``
launch plan (``tc_plan``: row tile, split-K factors), the scratch sizes the
wrapper allocates for it, and the refusals of inputs no kernel takes. The
kernels themselves run on the card (``test_torch_cuda.py``)."""

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
    s = tgmm.scratch_shapes(8, 96, 704, 160, "tc", 132)
    assert s["part"] == (max(2 * 2 * 704, 8 * 96) * 8 * 160,)
    # no split, or the CUDA-core variant: no partials
    assert tgmm.scratch_shapes(1, 16, 16, 1, "tc", 132)["part"] == (0,)
    assert tgmm.scratch_shapes(8, 4096, 14336, 4, "simt", 132) == {
        "mid": (8, 4, 14336), "part": (0,)}


def test_variant_counters_start_with_both_variants():
    for mod in (tgmm, tflash):
        assert set(mod.launches_by_variant) == {"tc", "simt"}


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    before = (tgmm.launches, dict(tgmm.launches_by_variant), tflash.launches,
              dict(tflash.launches_by_variant))
    x = torch.zeros((2, 4, 8), dtype=BF16)
    w = torch.zeros((2, 8, 8), dtype=BF16)
    fill = torch.tensor([1, 0], dtype=torch.int32)
    assert tops.moe_gmm(x, w, w, w, fill, 4).shape == x.shape
    q = torch.zeros((1, 4, 2, 16), dtype=BF16)
    assert tops.flash_attention(q, q[:, :, :1], q[:, :, :1]).shape == q.shape
    assert before == (tgmm.launches, dict(tgmm.launches_by_variant),
                      tflash.launches, dict(tflash.launches_by_variant))


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
