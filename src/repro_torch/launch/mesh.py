"""The device the port runs on: one NVIDIA H100 (PyTorch port of
``repro.launch.mesh``, whose constants are TPU v5e's).

Not ported: ``make_production_mesh``, ``make_test_mesh`` and ``set_mesh``.
One card has no mesh to build; the expert-parallel ranks that the
reference lays over its mesh axes are virtual ranks on the card, built by
``repro_torch.models.moe.EPSpec.build(n_ep, cfg, ...)``.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates (no sparsity), at the 700 W limit
PEAK_FLOPS = 989e12  # bf16 FLOP/s on the tensor cores
PEAK_FLOPS_FP32 = 67e12  # fp32 FLOP/s off the tensor cores
HBM_BW = 3.35e12  # bytes/s
HBM_BYTES = 80 * 2**30  # device memory
CHIPS = 1

# On one card a collective between virtual EP ranks (a rank-axis swap, a
# sum over ranks, a concatenation) is a copy inside HBM: each byte is read
# once and written once, so it moves at half the memory rate.
COLLECTIVE_BW = HBM_BW / 2
