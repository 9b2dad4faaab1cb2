"""Carries the JAX package's weights and solver states into the port.

Every function takes the JAX pytrees as numpy arrays
(``jax.tree.map(np.asarray, x)``) and imports nothing of JAX, so the tests
can run the two packages on the same numbers; the port's own entry points
initialize from a seed instead.  A JAX PRNG key has no torch counterpart:
the state's rounding generator is seeded with `seed`, and the tests pass
the JAX draws explicitly.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.gadmm import ChainState, GraphState, Quadratic
from .core.sgadmm import SGADMMState
from .device import generator, resolve_device
from .dist.qgadmm import DistState
from .kernels.pack.ref import pack4_ref
from .tree import ParamLayout


def params_from_jax(np_tree, device=None):
    """Nested dict of numpy arrays -> the same dict of tensors on `device`.
    Covers the pytrees of ``repro.models.encdec.init`` and
    ``repro.models.ssm.init`` (stacked ``blocks/mamba/*`` and ``blocks/ln``),
    whose leaf names, shapes and layouts the port keeps."""
    dev = resolve_device(device)
    if isinstance(np_tree, dict):
        return {k: params_from_jax(v, dev) for k, v in np_tree.items()}
    a = np.array(np_tree)
    if a.dtype.name == "bfloat16":      # ml_dtypes: carry the bits across
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(dev)
    return torch.from_numpy(a).to(dev)


def state_from_jax(np_state, device=None, seed: int = 0,
                   pack_wire: bool = False) -> DistState:
    """A ``repro.dist.qgadmm.DistState`` of numpy arrays -> the port's flat
    DistState: every parameter tree becomes a (rows, D) f32 buffer in the
    JAX leaf order (a bf16 leaf's values exactly, its dtype in the layout);
    ``radius`` and ``bits`` keep their shapes ((W,), or (W, L) per leaf
    under per_tensor / layerwise).  Under staleness the (S, ...) ring
    becomes the port's list of S entries, oldest first, its uint8 rows
    nibble-packed when `pack_wire` (the trainer's ``DistConfig.pack_wire``),
    and ``hat_lag`` a flat buffer.  The JAX PRNG key has no torch
    counterpart; the rounding generator is seeded with `seed`, the
    participation generator with seed + 1."""
    dev = resolve_device(device)
    layout = ParamLayout.of(np_state.theta, lead=1)

    def flat(tree):
        tree = params_from_jax(tree, "cpu")
        return layout.flatten(tree, lead=1).to(dev).contiguous()

    def vec(a, dtype):
        return torch.from_numpy(np.array(a)).to(dtype).to(dev)

    inbox = []
    for i in range(len(np_state.inbox["wire"]) if len(np_state.inbox) else 0):
        wire = torch.from_numpy(np.array(np_state.inbox["wire"][i]))
        if pack_wire and wire.dtype == torch.uint8:
            wire = pack4_ref(wire)
        inbox.append({
            "wire": wire.to(dev),
            "radius": vec(np_state.inbox["radius"][i], torch.float32),
            "bits": vec(np_state.inbox["bits"][i], torch.int32),
            "sent": vec(np_state.inbox["sent"][i], torch.bool)})
    return DistState(
        theta=flat(np_state.theta), theta_hat=flat(np_state.theta_hat),
        hat_edge=flat(np_state.hat_edge), lam_edge=flat(np_state.lam_edge),
        radius=vec(np_state.radius, torch.float32),
        bits=vec(np_state.bits, torch.int32),
        opt_mu=flat(np_state.opt_mu), opt_nu=flat(np_state.opt_nu),
        opt_t=vec(np_state.opt_t, torch.int32),
        step=int(np_state.step),
        gen=torch.Generator(device=dev).manual_seed(seed),
        layout=layout, part_gen=torch.Generator().manual_seed(seed + 1),
        inbox=inbox,
        hat_lag=flat(np_state.hat_lag) if len(np_state.hat_lag) else None)


def _t(a, dev, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.array(a)).to(dev)
    return t if dtype is None else t.to(dtype)


def quadratic_from_jax(np_q, device=None) -> Quadratic:
    """``repro.core.gadmm.Quadratic`` (xtx, xty, minv) -> the port's."""
    dev = resolve_device(device)
    return Quadratic(xtx=_t(np_q.xtx, dev), xty=_t(np_q.xty, dev),
                     minv=_t(np_q.minv, dev))


def chain_state_from_jax(np_state, device=None, seed: int = 0) -> ChainState:
    """``repro.core.gadmm.ChainState`` -> the port's ChainState."""
    dev = resolve_device(device)
    return ChainState(
        theta=_t(np_state.theta, dev), theta_hat=_t(np_state.theta_hat, dev),
        lam=_t(np_state.lam, dev), radius=_t(np_state.radius, dev),
        bits=_t(np_state.bits, dev, torch.int32), gen=generator(seed, dev),
        step=int(np_state.step))


def graph_state_from_jax(np_state, device=None, seed: int = 0) -> GraphState:
    """``repro.core.gadmm.GraphState`` -> the port's GraphState."""
    dev = resolve_device(device)
    return GraphState(
        theta=_t(np_state.theta, dev), theta_hat=_t(np_state.theta_hat, dev),
        lam=_t(np_state.lam, dev), radius=_t(np_state.radius, dev),
        bits=_t(np_state.bits, dev, torch.int32),
        sent=_t(np_state.sent, dev, torch.bool), gen=generator(seed, dev),
        step=int(np_state.step))


def sgadmm_state_from_jax(np_state, device=None,
                          seed: int = 0) -> SGADMMState:
    """``repro.core.sgadmm.SGADMMState`` (flat (N, d) rows in the
    ``ravel_pytree`` order, which is the port's leaf order) -> the port's
    SGADMMState."""
    dev = resolve_device(device)
    return SGADMMState(
        theta=_t(np_state.theta, dev), theta_hat=_t(np_state.theta_hat, dev),
        lam=_t(np_state.lam, dev), radius=_t(np_state.radius, dev),
        bits=_t(np_state.bits, dev, torch.int32),
        adam_mu=_t(np_state.adam_mu, dev), adam_nu=_t(np_state.adam_nu, dev),
        adam_t=_t(np_state.adam_t, dev, torch.int32),
        gen=generator(seed, dev), step=int(np_state.step))
