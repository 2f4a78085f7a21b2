"""The selective scan's host-side decisions, on the CPU: the checkpoint and
partial-sum scratch the wrapper allocates for the kernels, the refusals of
inputs no kernel takes (made before the kernel library is loaded), the
routing of CPU tensors to the plain version, and the plain version and its
backward against the reference at the tile geometry the kernels use (T one
step either side of a checkpoint tile, d not a multiple of a block's
channels). The kernels themselves run on the card (``test_torch_cuda.py``).

Tolerance of the reference comparisons: 1e-5 relative to the largest value,
as in ``test_torch_ssm.py`` (the sums over T and d run in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import build
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ssm_scan as tssm

C, F32, BF16 = tssm.CHUNK, torch.float32, torch.bfloat16


@pytest.mark.parametrize("shape,want", [
    ((2, 2048, 8192, 16), (2, 128, 8192, 16)),   # the train shape
    ((2, 200, 8192, 16), (2, 13, 8192, 16)),
    ((1, 1, 5, 4), (1, 1, 5, 4)),
    ((1, C, 64, 16), (1, 1, 64, 16)),
    ((1, C + 1, 64, 1), (1, 2, 64, 1)),
    ((3, 2 * C - 1, 100, 12), (3, 2, 100, 12)),
])
def test_states_hold_one_state_per_checkpoint_tile(shape, want):
    assert tssm.states_shape(*shape) == want


@pytest.mark.parametrize("shape,want", [
    ((2, 2048, 8192), (2, 128, 2048, 32)),       # the train shape
    ((2, 200, 8192), (2, 128, 200, 32)),
    ((1, 1, 5), (1, 1, 1, 32)),
    ((3, 65, 64), (3, 1, 65, 32)),
    ((1, 7, 65), (1, 2, 7, 32)),
    ((2, 130, 100), (2, 2, 130, 32)),
])
def test_partials_hold_one_row_per_backward_block(shape, want):
    assert tssm.partials_shape(*shape) == want


def test_scratch_sizes_at_the_train_shape():
    # the partials stay at the 67 MB of the [2, 128, 2048, 32] fp32 layout
    # with 64-channel blocks; the checkpoints every CHUNK = 16 steps take
    # 134 MB
    part = np.prod(tssm.partials_shape(2, 2048, 8192)) * 4
    states = np.prod(tssm.states_shape(2, 2048, 8192, 16)) * 4
    assert part == 2 * 128 * 2048 * 32 * 4 == 67_108_864
    assert states == 2 * 2048 // C * 8192 * 16 * 4 == 134_217_728
    assert tssm.BWD_CHANNELS >= 64


def _args(B=1, T=5, d=8, N=4, dtype=F32):
    x = torch.zeros((B, T, d), dtype=dtype)
    Bs = torch.zeros((B, T, N), dtype=dtype)
    A = torch.zeros((d, N))
    return [x, x.clone(), Bs, Bs.clone(), A, torch.zeros(d)]


@pytest.fixture
def no_library(monkeypatch):
    """Any attempt to load (or build) the kernel library fails the test,
    and no launch may be counted."""
    def refuse(name):
        raise AssertionError(f"{name}: library loaded for refused inputs")

    monkeypatch.setattr(build, "library", refuse)
    before = tssm.launches, tssm.bwd_launches
    yield
    assert (tssm.launches, tssm.bwd_launches) == before


def _call(kind, args, dy=None, states=None):
    if kind == "fwd":
        return tssm.launch(*args, save_states=True)
    B, T, d = args[1].shape  # dt: x may be the input spoilt
    N = args[2].shape[-1]
    dy = torch.zeros_like(args[1]) if dy is None else dy
    if states is None:
        states = torch.zeros(tssm.states_shape(B, T, d, N))
    return tssm.launch_bwd(*args, dy, states)


@pytest.mark.parametrize("kind", ["fwd", "bwd"])
def test_cpu_tensors_are_refused(no_library, kind):
    with pytest.raises(ValueError, match="ssm_scan: x must be a CUDA tensor"):
        _call(kind, _args())


@pytest.mark.parametrize("kind", ["fwd", "bwd"])
@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_other_dtypes_are_refused(no_library, kind, dtype):
    with pytest.raises(TypeError, match="unsupported dtype"):
        _call(kind, _args(dtype=dtype))


@pytest.mark.parametrize("kind", ["fwd", "bwd"])
@pytest.mark.parametrize("N", [0, 17])
def test_state_sizes_outside_1_to_16_are_refused(no_library, kind, N):
    with pytest.raises(ValueError, match=f"state size {N} not in 1..16"):
        _call(kind, _args(N=N))


def _mismatch(i, shape):
    def edit(args):
        args[i] = torch.zeros(shape, dtype=args[i].dtype)
        return args
    return edit


# name -> (what the check names, how the inputs are spoilt)
MISMATCHES = {
    "dt-steps": ("dt is", _mismatch(1, (1, 6, 8))),
    "Bs-batch": ("Bs is", _mismatch(2, (2, 5, 4))),
    "Cs-state": ("Cs is", _mismatch(3, (1, 5, 3))),
    "A-channels": ("A is", _mismatch(4, (7, 4))),
    "D-shape": ("D is", _mismatch(5, (8, 1))),
    "Bs-dtype": ("Bs is", lambda a: a[:2] + [a[2].bfloat16()] + a[3:]),
    "A-bf16": ("A is", lambda a: a[:4] + [a[4].bfloat16(), a[5]]),
    "x-2d": ("x and Bs must be", lambda a: [a[0][0]] + a[1:]),
}


@pytest.mark.parametrize("kind", ["fwd", "bwd"])
@pytest.mark.parametrize("case", sorted(MISMATCHES))
def test_mismatched_inputs_are_refused(no_library, kind, case):
    names, spoil = MISMATCHES[case]
    with pytest.raises(ValueError, match=f"ssm_scan: {names}"):
        _call(kind, spoil(_args()))


@pytest.mark.parametrize("what", ["dy", "states"])
def test_backward_refuses_mismatched_dy_and_states(no_library, what):
    args = _args()
    bad = torch.zeros((1, 5, 9)) if what == "dy" else torch.zeros((1, 2, 8, 4))
    with pytest.raises(ValueError, match=f"ssm_scan: {what} is"):
        _call("bwd", args, **{what: bad})


def test_cpu_tensors_take_the_plain_version_and_count_no_launch(no_library):
    args = _args(T=C + 1)
    y = tops.ssm_scan(*args)
    assert y.shape == args[0].shape and y.dtype == F32


def _inputs(B, T, d, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, d)) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((B, T, d)) - 2))
    Bs = rng.standard_normal((B, T, N)) * 0.3
    Cs = rng.standard_normal((B, T, N)) * 0.3
    A = -np.exp(rng.standard_normal((d, N)) * 0.5)
    D = 1 + 0.1 * rng.standard_normal(d)
    dy = rng.standard_normal((B, T, d))
    return [a.astype(np.float32) for a in (x, dt, Bs, Cs, A, D)], dy.astype(
        np.float32)


def _close(got, want, rel=1e-5):
    want = np.asarray(want, np.float32)
    err = np.abs(np.asarray(got, np.float32) - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-30), err


@pytest.mark.parametrize("B,T,d,N", [
    (1, C - 1, 33, 5), (2, C + 1, 70, 12), (1, 2 * C + 1, 100, 1),
])
def test_plain_and_plain_bwd_match_the_reference_at_ragged_tiles(B, T, d, N):
    args, dy = _inputs(B, T, d, N, seed=T * d)
    y, vjp = jax.vjp(jref.ssm_scan_ref, *[jnp.asarray(a) for a in args])
    _close(tssm.plain(*[torch.from_numpy(a) for a in args]).numpy(), y)
    got = tssm.plain_bwd(*[torch.from_numpy(a) for a in args],
                         torch.from_numpy(dy))
    for g, w in zip(got, vjp(jnp.asarray(dy))):
        assert g.shape == tuple(w.shape)
        _close(g.numpy(), w)
