"""Multi-worker Q-SGADMM trainer (paper Algorithm 1, eqs. 14-18) on one GPU.

The port of ``repro/dist/qgadmm.py``'s single-device step
(``QGADMMTrainer.make_train_step``, ``_build_step(sharded=False)``) on its
gauss-seidel branch.  The W workers are a leading batch dim on one card and
the exchange is a gather along the topology's directed edges.

State layout.  Every per-worker quantity is ONE flat (W, D) f32 buffer whose
columns are the model's parameters in the JAX package's leaf order
(``repro_torch.tree``): the wire buffer is the state itself, so flattening
costs nothing, and the local loss sees each row as a tree of views.  The
neighbor state is edge-indexed as in the JAX package: the 2E directed edges
(``core.topology.edge_index``, sorted by (dst, src)) own one (D,) row each of
``hat_edge`` (what dst knows of src's hat) and ``lam_edge`` (dst's mirror of
the edge dual, canonical head -> tail orientation).  The step updates the
state in place — at whisper-tiny W=4 it is 28 f32 copies of the model — and
returns it.

One round (one ``step``):
  1. the heads run ``local_iters`` Adam steps on the augmented Lagrangian of
     eq. 14 (data loss + dual + proximal terms to the neighbors' hats), with
     gradients from autograd; the data loss of every worker at its
     pre-update model is the ``loss`` metric (all W workers count);
  2. each worker's radius R = max |theta - hat| over its whole row;
  3. ONE codec kernel launch over the (W, D) buffer with a (W, D) uniform
     draw (``kernels/quantize``): every row is coded, only the phase's
     workers commit hat / radius / bits;
  4. the exchange: one ``pack4`` launch over the W rows (bits <= 4), a
     gather of the packed rows by the edges' source, one ``unpack4`` launch
     over the 2E rows — byte for byte what the JAX unsharded path moves
     unpacked;
  5. the receivers decode into ``hat_edge`` with the plain f32 arithmetic of
     the sender's kernel, so sender and receiver stay bitwise equal;
  6. the tails do 1-5 against the heads' fresh hats, then every edge dual
     takes the damped update of eq. 18.

Options of ``DistConfig`` that this port does not have yet raise
``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.gadmm import GADMMConfig
from repro_torch.core.quantizer import header_bits
from repro_torch.core.topology import build_topology, edge_index
from repro_torch.device import resolve_device
from repro_torch.kernels.pack import ops as pack_ops
from repro_torch.kernels.quantize import ops as q_ops
from repro_torch.tree import ParamLayout, leaves_with_path

Tensor = torch.Tensor

_ADAM_B1, _ADAM_B2, _ADAM_EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass(frozen=True)
class DistConfig:
    """Configuration of the trainer; the JAX package's field names and
    defaults (see ``repro/dist/qgadmm.py:DistConfig`` for each).

    Ported: num_workers, gadmm (rho, alpha, fixed bits), local_iters,
    local_lr, mode='gauss-seidel', radius_mode='global', pack_wire (auto:
    on at <= 4 bits), topology (chain, ring, star, torus2d).  ``wire_impl``
    chose the JAX codec; here the device decides (the CUDA kernels on the
    card, their plain versions on the CPU).  ``telemetry`` is accepted, but
    its extra metrics are not ported yet (ROADMAP Queue 1 item 1g).  Every
    other option raises NotImplementedError."""

    num_workers: int
    gadmm: GADMMConfig
    local_iters: int = 1
    local_lr: float = 1e-3
    mode: str = "gauss-seidel"
    microbatches: int = 1
    radius_mode: str = "global"
    state_dtype: Any = None
    uneven_shard: bool = False
    pack_wire: bool | None = None
    seq_shard: bool = False
    wire_impl: str = "jnp"
    overlap: bool = False
    topology: Any = "chain"
    censor: Any = None
    staleness: int = 0
    participation: float = 1.0
    layerwise: Any = None
    telemetry: bool = True
    check_invariants: bool = False

    def __post_init__(self):
        assert self.mode in ("gauss-seidel", "jacobi"), self.mode
        assert self.radius_mode in ("global", "per_tensor"), self.radius_mode
        assert self.wire_impl in ("jnp", "pallas", "pallas_compiled"), \
            self.wire_impl
        assert 0.0 < self.participation <= 1.0, self.participation
        assert self.gadmm.topk_frac >= 1.0, \
            "topk sparsification is not supported by the distributed trainer"
        unported = (
            (self.radius_mode != "global", "radius_mode='per_tensor'", "1a"),
            (self.layerwise is not None, "layerwise", "1b"),
            (self.censor is not None, "censor", "1c"),
            (self.staleness != 0, "staleness > 0", "1d"),
            (self.participation < 1.0, "participation < 1", "1e"),
            (self.mode != "gauss-seidel", "mode='jacobi'", "1f"),
            (self.overlap, "overlap", "1f"),
            (self.check_invariants, "check_invariants", "1g"),
            (self.microbatches != 1, "microbatches > 1", "1h"),
            (self.state_dtype is not None, "state_dtype", "1h"),
            (not self.gadmm.quantize, "quantize=False", "1h"),
            (self.gadmm.qcfg.adapt_bits, "qcfg.adapt_bits", "1h"),
            (self.uneven_shard or self.seq_shard, "uneven_shard/seq_shard",
             "4"),
        )
        for bad, what, item in unported:
            if bad:
                raise NotImplementedError(
                    f"DistConfig {what} is not ported yet "
                    f"(ROADMAP Queue 1 item {item})")
        build_topology(self.topology, self.num_workers)  # validate early
        bits = self.gadmm.qcfg.bits
        if self.pack_wire is None:
            object.__setattr__(self, "pack_wire", bits <= 4)
        if self.pack_wire:
            assert bits <= 4, "pack_wire needs <= 4-bit levels"


@dataclasses.dataclass
class DistState:
    """Flat per-worker state (see the module docstring).  Float buffers are
    (W, D) f32 in wire order, edge slabs (2E, D); ``gen`` draws the
    stochastic-rounding uniforms; ``layout`` maps a row back to the
    parameter tree."""

    theta: Tensor      # (W, D) current primal parameters
    theta_hat: Tensor  # (W, D) own last-quantized model (== what nbrs hold)
    hat_edge: Tensor   # (2E, D) dst's view of src's hat
    lam_edge: Tensor   # (2E, D) dst's mirror of the edge dual
    radius: Tensor     # (W,) f32 last committed radius
    bits: Tensor       # (W,) int32 last committed bit width
    opt_mu: Tensor     # (W, D) local Adam first moment
    opt_nu: Tensor     # (W, D) local Adam second moment
    opt_t: Tensor      # (W,) int32 Adam step counts
    step: int
    gen: torch.Generator
    layout: ParamLayout


def init_state(init_fn: Callable[[torch.Generator], dict], seed: int,
               dcfg: DistConfig, device=None) -> DistState:
    """State at k=0: every worker starts from the same init
    ``init_fn(generator)``, drawn from a generator seeded with `seed` on the
    device; hats, duals and moments at zero (the paper initializes
    theta_hat^0 = 0); the rounding draws come from a second generator seeded
    with seed + 1."""
    dev = resolve_device(device)
    params = init_fn(torch.Generator(device=dev).manual_seed(seed))
    layout = ParamLayout.of(params)
    for path, leaf in leaves_with_path(params):
        if leaf.dtype != torch.float32:
            raise NotImplementedError(
                f"leaf {'/'.join(path)} is {leaf.dtype}: only float32 "
                "parameters are ported (ROADMAP Queue 1 item 1h)")
    w, d = dcfg.num_workers, layout.size
    de = 2 * build_topology(dcfg.topology, w).num_edges
    z = lambda rows: torch.zeros((rows, d), dtype=torch.float32, device=dev)
    return DistState(
        theta=layout.flatten(params).to(dev)[None].repeat(w, 1),
        theta_hat=z(w), hat_edge=z(de), lam_edge=z(de),
        radius=torch.zeros((w,), dtype=torch.float32, device=dev),
        bits=torch.full((w,), dcfg.gadmm.qcfg.bits, dtype=torch.int32,
                        device=dev),
        opt_mu=z(w), opt_nu=z(w),
        opt_t=torch.zeros((w,), dtype=torch.int32, device=dev),
        step=0, gen=torch.Generator(device=dev).manual_seed(seed + 1),
        layout=layout)


class QGADMMTrainer:
    """Decentralized trainer for one model, all workers on one device.

    model: a repro_torch.models module (``loss_fn(params, batch, cfg)``).
    cfg:   its ArchConfig.
    dcfg:  DistConfig above.
    device: the card by default; "cpu" runs the kernels' plain versions.
    """

    def __init__(self, model, cfg, dcfg: DistConfig, device=None):
        self.model = model
        self.cfg = cfg
        self.dcfg = dcfg
        self.device = resolve_device(device)
        self.topo = build_topology(dcfg.topology, dcfg.num_workers)
        self.eidx = edge_index(self.topo)
        self.is_head = np.asarray(self.topo.head_mask, bool)
        dev = self.device
        self._src = torch.as_tensor(self.eidx.src, device=dev)
        self._dst = torch.as_tensor(self.eidx.dst, device=dev)
        self._sign = torch.as_tensor(self.eidx.sign_dst, device=dev)
        self._head_rows = torch.as_tensor(
            np.flatnonzero(self.eidx.sign_dst > 0), device=dev)

    # ------------------------------------------------------------- step ----
    def step(self, state: DistState, batch: dict, u=None):
        """One Q-SGADMM round, in place; returns (state, metrics).

        batch: {name: (W, ...) array} — each worker's own shard.
        u: optional (u_heads, u_tails), the (W, D) f32 uniform draws of the
        two phases' codec; None draws them from ``state.gen``.  (The tests
        pass the JAX step's own draws here.)"""
        dev = self.device
        w = self.dcfg.num_workers
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        if w > 1:
            phases = [self.is_head, ~self.is_head]
        else:
            phases = [np.ones((1,), bool)]
        sent_total = 0
        f0 = None
        for i, active in enumerate(phases):
            u_i = None if u is None else torch.as_tensor(u[i], device=dev)
            f = self._phase(state, batch, active, u_i, want_f0=(i == 0))
            if i == 0:
                f0 = f
            sent_total += int(active.sum())
        resid = self._dual_update(state)
        state.step += 1
        wire_bits = self.wire_bits_per_round(state.layout.size)
        metrics = {
            "loss": torch.mean(f0),
            "consensus_resid": resid,
            "radius_mean": torch.mean(state.radius),
            "bits_mean": torch.mean(state.bits.to(torch.float32)),
            "skip_rate": torch.tensor(1.0 - sent_total / w, device=dev),
            "wire_bits_per_round": torch.tensor(float(wire_bits),
                                                dtype=torch.float32,
                                                device=dev),
        }
        return state, metrics

    def _phase(self, st: DistState, batch: dict, active: np.ndarray, u,
               want_f0: bool):
        """Local Adam for the active workers, then codec + exchange + decode.
        Returns the (W,) pre-update data losses when want_f0 (inactive
        workers run the forward pass only), else None."""
        w = self.dcfg.num_workers
        f0 = (torch.zeros((w,), dtype=torch.float32, device=self.device)
              if want_f0 else None)
        for i in range(w):
            bw = {k: v[i] for k, v in batch.items()}
            if active[i]:
                fi = self._local_opt(st, i, bw)
            elif want_f0:
                with torch.no_grad():
                    fi = self.model.loss_fn(st.layout.views(st.theta[i]), bw,
                                            self.cfg)
            else:
                continue
            if want_f0:
                f0[i] = fi
        self._wire(st, active, u)
        return f0

    def _local_opt(self, st: DistState, i: int, bw: dict) -> Tensor:
        """local_iters Adam steps of worker i on eq. 14's augmented
        Lagrangian; updates its theta / moments / count in place and
        returns the data loss at the first iterate."""
        rho, lr = self.dcfg.gadmm.rho, self.dcfg.local_lr
        slots = [int(e) for e in self.eidx.slot[i] if e >= 0]
        sign = 1.0 if self.is_head[i] else -1.0
        th, m, v = st.theta[i], st.opt_mu[i], st.opt_nu[i]
        f0 = None
        for _ in range(self.dcfg.local_iters):
            flat = th.detach().clone().requires_grad_(True)
            f = self.model.loss_fn(st.layout.views(flat), bw, self.cfg)
            aug = f
            for e in slots:
                diff = flat - st.hat_edge[e]
                aug = aug + sign * torch.dot(st.lam_edge[e], diff) \
                    + 0.5 * rho * torch.sum(diff * diff)
            (g,) = torch.autograd.grad(aug, flat)
            if f0 is None:
                f0 = f.detach()
            st.opt_t[i] += 1
            tf = st.opt_t[i].to(torch.float32)
            m.mul_(_ADAM_B1).add_((1 - _ADAM_B1) * g)
            v.mul_(_ADAM_B2).add_((1 - _ADAM_B2) * g * g)
            bc1 = 1 - torch.pow(_ADAM_B1, tf)
            bc2 = 1 - torch.pow(_ADAM_B2, tf)
            th.sub_((lr * (m / bc1)) / (torch.sqrt(v / bc2) + _ADAM_EPS))
        return f0

    def _wire(self, st: DistState, active: np.ndarray, u) -> None:
        """Codec over all W rows, commit for the active ones, exchange along
        the directed edges and decode into hat_edge where the source sent."""
        dev = self.device
        w, d = st.theta.shape
        r_new = torch.amax(torch.abs(st.theta - st.theta_hat), dim=1)  # (W,)
        b_new = torch.full((w,), self.dcfg.gadmm.qcfg.bits, dtype=torch.int32,
                           device=dev)
        levels = torch.pow(2.0, b_new.to(torch.float32)) - 1.0
        if u is None:
            u = torch.rand((w, d), generator=st.gen, device=dev)
        q, hat_new = q_ops.quantize_dequantize(st.theta, st.theta_hat, u,
                                               r_new, levels)
        sent = torch.as_tensor(np.flatnonzero(active), device=dev)
        st.theta_hat[sent] = hat_new[sent]
        st.radius[sent] = r_new[sent]
        st.bits[sent] = b_new[sent]
        if self.eidx.num_directed == 0:
            return
        if self.dcfg.pack_wire:
            recv = pack_ops.unpack4(pack_ops.pack4(q)[self._src], d)
        else:
            recv = q[self._src]
        got = torch.as_tensor(np.flatnonzero(active[self.eidx.src]),
                              device=dev)
        src = self._src[got]
        st.hat_edge[got] = q_ops.decode_ref(
            st.hat_edge[got], recv[got], r_new[src][:, None],
            levels[src][:, None])

    def _dual_update(self, st: DistState) -> Tensor:
        """Damped dual update (eq. 18), lam_e += a*rho*(hat_head - hat_tail),
        seen from each directed edge as sign_dst * (hat[dst] - hat_edge);
        returns the consensus residual (each edge counted once, from its
        head)."""
        if self.eidx.num_directed == 0:
            return torch.zeros((), device=self.device)
        g = self.dcfg.gadmm
        diff = st.theta_hat[self._dst] - st.hat_edge
        st.lam_edge.add_((g.alpha * g.rho * self._sign)[:, None] * diff)
        head = diff[self._head_rows]
        return torch.sqrt(torch.sum(head * head))

    # ------------------------------------------------------- invariants ----
    def bit_sync(self, st: DistState) -> bool:
        """Sender == receiver: every hat_edge row is bitwise the source's
        own theta_hat."""
        return bool(torch.equal(st.hat_edge.view(torch.int32),
                                st.theta_hat[self._src].view(torch.int32)))

    # ------------------------------------------------------- accounting ----
    def wire_row_bytes(self, d: int) -> int:
        """Bytes of one worker's wire row for d parameters: packed_len(d)
        with pack_wire, else one byte per level (one device per worker
        row, so no group padding)."""
        return pack_ops.packed_len(d) if self.dcfg.pack_wire else d

    def wire_bits_per_round(self, d: int) -> int:
        """Bits on the wire per step: per phase and per direction each of
        the E edges carries one wire row plus the (R f32, b i32) header."""
        e = self.topo.num_edges
        if e == 0:
            return 0
        per_link = 8 * self.wire_row_bytes(d) + header_bits(num_radii=1)
        return 2 * 2 * e * per_link
