"""Shared builders for the port's parity tests: the same model built in the
JAX reference (``repro``) and in the PyTorch port (``repro_torch``), with
the reference's weights carried across as numpy arrays."""

import jax
import numpy as np
import torch

from repro.configs import get_config
from repro.launch.mesh import make_test_mesh
from repro.models import moe as JM
from repro.models import transformer as jtr
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.checkpoint.io import params_from_numpy
from repro_torch.configs import get_config as tget_config
from repro_torch.models import moe as TM
from repro_torch.models import transformer as ttr
from repro_torch.serving.engine import ServingEngine as TEngine

# EP geometry of the reference's serving equivalence suite
CAPACITY = 4096
SLOT_CAPACITY = 8192


def to_numpy(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def build_pair(arch: str, moe_impl: str = "ep", max_len: int = 64,
               capacity: int = CAPACITY, slot_capacity: int = SLOT_CAPACITY):
    """(reference engine, port engine on the CPU) over identical fp32
    weights: the reference's ``init_params(PRNGKey(0))``; MoE configs get
    the dense master copy and a uniform EP placement, as the reference's
    serving launcher builds them."""
    cfg = get_config(arch).reduced()
    tcfg = tget_config(arch).reduced()
    mesh = make_test_mesh(1, 1)
    _, n_groups = cfg.layer_pattern()
    if cfg.is_moe and moe_impl == "ep":
        spec = JM.EPSpec.build(mesh, cfg, ep_axes=("model",),
                               slots=cfg.num_experts, capacity=capacity,
                               slot_capacity=slot_capacity)
        jrt = jtr.Runtime(cfg=cfg, mesh=mesh, moe_impl="ep", ep_spec=spec)
        dense = jtr.init_params(
            jtr.Runtime(cfg=cfg, mesh=mesh, moe_impl="dense"),
            jax.random.PRNGKey(0))
        pl = JM.uniform_placement(1, spec.slots, cfg.num_experts)
        pls = jtr.stack_placement(pl, n_groups)
        params = dict(dense)
        params["groups"] = JM.regather_ep_groups(dense["groups"], pls,
                                                 n_groups)
        jeng = JEngine(rt=jrt, params=params, placement=pls,
                       dense_master=dense["groups"], max_len=max_len)
        tspec = TM.EPSpec(1, spec.slots, spec.capacity, spec.slot_capacity)
        trt = ttr.Runtime(cfg=tcfg, moe_impl="ep", ep_spec=tspec,
                          device="cpu")
        tparams = params_from_numpy(to_numpy(params), "cpu")
        teng = TEngine(rt=trt, params=tparams, placement=to_numpy(pls),
                       dense_master=params_from_numpy(
                           to_numpy(dense["groups"]), "cpu"),
                       max_len=max_len)
        return jeng, teng
    jrt = jtr.Runtime(cfg=cfg, mesh=mesh, moe_impl=moe_impl)
    params = jtr.init_params(jrt, jax.random.PRNGKey(0))
    jeng = JEngine(rt=jrt, params=params, placement=None, max_len=max_len)
    trt = ttr.Runtime(cfg=tcfg, moe_impl=moe_impl, device="cpu")
    teng = TEngine(rt=trt, params=params_from_numpy(to_numpy(params), "cpu"),
                   placement=None, max_len=max_len)
    return jeng, teng


def prompts(vocab: int, n: int, length: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, vocab, (n, length)).astype(np.int32)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def build_train_pair(arch: str):
    """The JAX trainer's runtime (``moe_impl="dense"``, no mesh) and the
    port's on the CPU, for ``arch``'s reduced config, over the reference's
    ``init_params(PRNGKey(0))``. Returns (jrt, jparams, trt, tparams); the
    port gets its own copy of the weights as numpy arrays."""
    cfg = get_config(arch).reduced()
    jrt = jtr.Runtime(cfg=cfg, moe_impl="dense")
    jparams = jtr.init_params(jrt, jax.random.PRNGKey(0))
    trt = ttr.Runtime(cfg=tget_config(arch).reduced(), moe_impl="dense",
                      device="cpu")
    return jrt, jparams, trt, params_from_numpy(to_numpy(jparams), "cpu")
