"""Meshes of virtual devices on one NVIDIA H100 (PyTorch port of
``repro.launch.mesh``, whose constants are TPU v5e's).

A ``VirtualMesh`` (defined in ``models.sharding``, beside the rules that
read it) is the reference's device mesh without the devices: axis names
and sizes. Everything still lives on the one card; what a mesh
decides is which virtual device owns which slice of a tensor
(``models.sharding``), and so which rows each expert-parallel rank routes,
drops and counts (``models.moe``). ``make_test_mesh`` and
``make_production_mesh`` build the reference's shapes and axis names.

Not ported: ``set_mesh``. The reference enters a default-mesh context for
jit; the port passes its mesh explicitly (``Runtime.mesh``,
``moe_apply_ep(mesh=)``), so there is no context to enter.
"""

from __future__ import annotations

from repro_torch.models.sharding import VirtualMesh, make_test_mesh  # noqa: F401

# NVIDIA H100 SXM data sheet, dense rates (no sparsity), at the 700 W limit
PEAK_FLOPS = 989e12  # bf16 FLOP/s on the tensor cores
PEAK_FLOPS_FP32 = 67e12  # fp32 FLOP/s off the tensor cores
HBM_BW = 3.35e12  # bytes/s
HBM_BYTES = 80 * 2**30  # device memory
CHIPS = 1  # the card a step runs on; a mesh's size where a mesh is passed

# On one card a collective between virtual EP ranks (a rank-axis swap, a
# sum over ranks, a concatenation) is a copy inside HBM: each byte is read
# once and written once, so it moves at half the memory rate.
COLLECTIVE_BW = HBM_BW / 2


def make_production_mesh(*, multi_pod: bool = False) -> VirtualMesh:
    """Single pod (16, 16) = ("data", "model"); multi-pod (2, 16, 16) =
    ("pod", "data", "model")."""
    if multi_pod:
        return VirtualMesh(("pod", "data", "model"), (2, 16, 16))
    return VirtualMesh(("data", "model"), (16, 16))
