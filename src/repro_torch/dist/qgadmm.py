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
  2. each worker's per-leaf radii R = max |theta - hat| over each leaf; the
     global radius is their max.  The bit widths: fixed, eq. 11
     (``qcfg.adapt_bits``), or per leaf under ``layerwise`` (base widths,
     eq. 11 per leaf, or the bit-budget controller);
  3. ONE codec kernel launch over the (W, D) buffer with a (W, D) uniform
     draw (``kernels/quantize``).  The radius is one per row (global) or
     one per position (``radius_mode='per_tensor'``, expanded from the
     (W, L) table by the layout's position -> leaf map), the levels one per
     row or, under ``layerwise``, one per position; the wrapper picks the
     kernel variant from those shapes (K1 / K2 / K3).  Every row is coded;
     only the phase's workers commit, and under ``censor`` only those whose
     hat moved past the threshold; under ``layerwise`` only the leaves due
     this round (period gate, per-leaf thresholds);
  4. the exchange: one ``pack4`` launch over the W rows (levels <= 4 bits),
     a gather of the packed rows by the edges' source, one ``unpack4``
     launch over the 2E rows — byte for byte what the JAX unsharded path
     moves unpacked.  Every row moves, as in the JAX exchange;
  5. the receivers decode into ``hat_edge`` with the plain f32 arithmetic of
     the sender's kernel, where the source sent, so sender and receiver stay
     bitwise equal (an unsent leaf rides with radius 0, a no-op);
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

from repro_torch.core import censor as censor_mod
from repro_torch.core.gadmm import GADMMConfig
from repro_torch.core.quantizer import (_next_bits, allocate_bits,
                                        header_bits, levels_of)
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

    Ported: num_workers, gadmm (rho, alpha, qcfg with eq. 11), local_iters,
    local_lr, mode='gauss-seidel', radius_mode ('global', 'per_tensor'),
    pack_wire (auto: on when the widest level the run can reach is <= 4
    bits), topology (chain, ring, star, torus2d), censor
    (``core.censor.CensorConfig``), layerwise
    (``core.quantizer.LayerwiseConfig``; forces per_tensor).  ``wire_impl``
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
        if self.layerwise is not None:
            assert self.gadmm.quantize, \
                "layerwise bit allocation needs the quantized wire"
            object.__setattr__(self, "radius_mode", "per_tensor")
        unported = (
            (self.staleness != 0, "staleness > 0", "1d"),
            (self.participation < 1.0, "participation < 1", "1e"),
            (self.mode != "gauss-seidel", "mode='jacobi'", "1f"),
            (self.overlap, "overlap", "1f"),
            (self.check_invariants, "check_invariants", "1g"),
            (self.microbatches != 1, "microbatches > 1", "1h"),
            (self.state_dtype is not None, "state_dtype", "1h"),
            (not self.gadmm.quantize, "quantize=False", "1h"),
            (self.uneven_shard or self.seq_shard, "uneven_shard/seq_shard",
             "4"),
        )
        for bad, what, item in unported:
            if bad:
                raise NotImplementedError(
                    f"DistConfig {what} is not ported yet "
                    f"(ROADMAP Queue 1 item {item})")
        build_topology(self.topology, self.num_workers)  # validate early
        # the widest level the run can reach: the packed wire holds nibbles
        q = self.gadmm.qcfg
        max_b = q.max_bits if q.adapt_bits else q.bits
        lw = self.layerwise
        if lw is not None:
            if lw.adapt_bits or lw.budget_bits is not None:
                max_b = lw.max_bits
            elif lw.bits is None:
                max_b = q.bits
            elif isinstance(lw.bits, int):
                max_b = lw.bits
            else:
                max_b = max(int(b) for b in lw.bits)
        if self.pack_wire is None:
            object.__setattr__(self, "pack_wire", max_b <= 4)
        if self.pack_wire:
            assert max_b <= 4, "pack_wire needs <= 4-bit levels"


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
    radius: Tensor     # (W,) global | (W, L) per_tensor: last committed R
    bits: Tensor       # (W,) | (W, L) layerwise: last committed int32 width
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
    n_leaves = len(layout.sizes)
    de = 2 * build_topology(dcfg.topology, w).num_edges
    z = lambda rows: torch.zeros((rows, d), dtype=torch.float32, device=dev)
    r_shape = (w,) if dcfg.radius_mode == "global" else (w, n_leaves)
    if dcfg.layerwise is not None:
        lw_bits, _, _ = dcfg.layerwise.resolve(list(layout.sizes),
                                               dcfg.gadmm.qcfg.bits)
        bits0 = torch.tensor(lw_bits, dtype=torch.int32,
                             device=dev)[None].repeat(w, 1)
    else:
        bits0 = torch.full((w,), dcfg.gadmm.qcfg.bits, dtype=torch.int32,
                           device=dev)
    return DistState(
        theta=layout.flatten(params).to(dev)[None].repeat(w, 1),
        theta_hat=z(w), hat_edge=z(de), lam_edge=z(de),
        radius=torch.zeros(r_shape, dtype=torch.float32, device=dev),
        bits=bits0, opt_mu=z(w), opt_nu=z(w),
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
        self._deg = torch.as_tensor(self.topo.degree, dtype=torch.float32,
                                    device=dev)
        lw = dcfg.layerwise
        # eq. 11 per leaf runs against the layerwise range
        self._lw_qcfg = (dataclasses.replace(
            dcfg.gadmm.qcfg, adapt_bits=True, max_bits=lw.max_bits,
            bits=min(dcfg.gadmm.qcfg.bits, lw.max_bits))
            if lw is not None and lw.adapt_bits else None)
        self._tables: dict = {}

    def _layout_tables(self, layout: ParamLayout):
        """(position -> leaf map or None, layerwise (bits, periods, taus)
        device tables or None) for `layout`, built once per layout."""
        if layout not in self._tables:
            dev = self.device
            seg = (layout.leaf_index(dev)
                   if self.dcfg.radius_mode == "per_tensor" else None)
            lw_tabs = None
            lw = self.dcfg.layerwise
            if lw is not None:
                bits, periods, taus = lw.resolve(list(layout.sizes),
                                                 self.dcfg.gadmm.qcfg.bits)
                lw_tabs = (
                    torch.tensor(bits, dtype=torch.int32, device=dev),
                    torch.tensor(periods, dtype=torch.int32, device=dev),
                    None if taus is None
                    else torch.tensor(taus, dtype=torch.float32, device=dev))
            self._tables[layout] = (seg, lw_tabs)
        return self._tables[layout]

    # ------------------------------------------------------------- step ----
    def step(self, state: DistState, batch: dict, u=None):
        """One Q-SGADMM round, in place; returns (state, metrics).

        batch: {name: (W, ...) array} — each worker's own shard.
        u: optional (u_heads, u_tails), the (W, D) f32 uniform draws of the
        two phases' codec; None draws them from ``state.gen``.  (The tests
        pass the JAX step's own draws here.)

        Besides the JAX step's metrics, ``worker_sent`` (W,) counts each
        worker's transmissions this round and, under layerwise,
        ``leaf_bits_sent`` (W, L) is the width each leaf went out at (0
        where it was not sent)."""
        dev = self.device
        w = self.dcfg.num_workers
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        if w > 1:
            phases = [self.is_head, ~self.is_head]
        else:
            phases = [np.ones((1,), bool)]
        sent_phases, leaf_phases = [], []
        f0 = None
        for i, active in enumerate(phases):
            u_i = None if u is None else torch.as_tensor(u[i], device=dev)
            f, sent, leaf = self._phase(state, batch, active, u_i,
                                        want_f0=(i == 0))
            if i == 0:
                f0 = f
            sent_phases.append(sent)
            leaf_phases.append(leaf)
        resid = self._dual_update(state)
        lw = self.dcfg.layerwise is not None
        wire_bits = self.wire_bits_per_round(
            state.layout,
            sent_phases if self.dcfg.censor is not None else None,
            leaf_phases if lw else None)
        state.step += 1
        worker_sent = sum(s.to(torch.float32) for s in sent_phases)
        metrics = {
            "loss": torch.mean(f0),
            "consensus_resid": resid,
            "radius_mean": torch.mean(state.radius),
            "bits_mean": torch.mean(state.bits.to(torch.float32)),
            "skip_rate": 1.0 - torch.sum(worker_sent) / w,
            "wire_bits_per_round": torch.as_tensor(
                wire_bits, dtype=torch.float32, device=dev),
            "worker_sent": worker_sent,
        }
        if lw:
            metrics["leaf_bits_sent"] = sum(
                torch.where(eff, b, 0) for eff, b in leaf_phases)
        return state, metrics

    def _phase(self, st: DistState, batch: dict, active: np.ndarray, u,
               want_f0: bool):
        """Local Adam for the active workers, then codec + exchange + decode.
        Returns (the (W,) pre-update data losses when want_f0, else None,
        *the result of _wire).  Inactive workers run the forward pass only
        when want_f0."""
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
        return (f0, *self._wire(st, active, u))

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

    def _bit_widths(self, st: DistState, theta_l, hat_l, per_leaf_r,
                    r_global, lw_tabs):
        """(W,) or (W, L) int32 widths of this round's codec (JAX
        ``_quantize_all``): fixed, eq. 11 on the global radius ratio, or per
        leaf under layerwise (base widths, eq. 11 per leaf, or the budget
        controller over the per-leaf L2 of theta - hat)."""
        qcfg = self.dcfg.gadmm.qcfg
        lw = self.dcfg.layerwise
        w, n_leaves = per_leaf_r.shape
        if lw is not None:
            base_b = lw_tabs[0]
            if lw.budget_bits is not None:
                scores = torch.sqrt(censor_mod.per_leaf_sq(theta_l, hat_l))
                return allocate_bits(scores, st.layout.sizes, lw.budget_bits,
                                     lw.min_bits, lw.max_bits)
            if lw.adapt_bits:
                return _next_bits(self._lw_qcfg, st.bits, per_leaf_r,
                                  st.radius, base_bits=base_b[None])
            return base_b[None].expand(w, n_leaves)
        if qcfg.adapt_bits:
            r_prev = (st.radius if st.radius.dim() == 1
                      else torch.amax(st.radius, dim=1))
            return _next_bits(qcfg, st.bits, r_global, r_prev)
        return torch.full((w,), qcfg.bits, dtype=torch.int32,
                          device=self.device)

    def _wire(self, st: DistState, active: np.ndarray, u):
        """Codec over all W rows, commit where sent, exchange along the
        directed edges and decode into hat_edge where the source sent.
        Returns the (W,) transmit mask and, under layerwise, the pair
        ((W, L) per-leaf transmit mask, (W, L) payload widths), else
        None."""
        dev = self.device
        dcfg = self.dcfg
        lw = dcfg.layerwise
        w, d = st.theta.shape
        layout = st.layout
        seg, lw_tabs = self._layout_tables(layout)

        def per_pos(t: Tensor) -> Tensor:
            """(rows,) stays one value per row; (rows, L) -> (rows, D)."""
            return t.index_select(1, seg) if t.dim() == 2 else t

        def col(t: Tensor) -> Tensor:
            t = per_pos(t)
            return t[:, None] if t.dim() == 1 else t

        theta_l, hat_l = layout.split(st.theta), layout.split(st.theta_hat)
        per_leaf_r = torch.stack(
            [torch.amax(torch.abs(a - b), dim=1) if a.shape[1]
             else torch.zeros((w,), dtype=torch.float32, device=dev)
             for a, b in zip(theta_l, hat_l)], dim=1)             # (W, L)
        r_global = torch.amax(per_leaf_r, dim=1)                   # (W,)
        r_new = r_global if dcfg.radius_mode == "global" else per_leaf_r
        b_new = self._bit_widths(st, theta_l, hat_l, per_leaf_r, r_global,
                                 lw_tabs)
        levels = levels_of(b_new)
        if u is None:
            u = torch.rand((w, d), generator=st.gen, device=dev)
        q, hat_new = q_ops.quantize_dequantize(
            st.theta, st.theta_hat, u, per_pos(r_new), per_pos(levels))

        active_t = torch.as_tensor(active, device=dev)
        if lw is not None:
            # period gate and per-leaf thresholds; the candidate hat mixes
            # new and old per leaf, so the worker-level censor sees the
            # delta that would be committed
            _, periods, taus = lw_tabs
            leaf_sent = ((st.step % periods) == 0)[None].expand(w, -1)
            if taus is not None:
                thr = taus * torch.pow(
                    torch.tensor(lw.tau_xi, dtype=torch.float32, device=dev),
                    torch.tensor(float(st.step), device=dev))
                delta = torch.sqrt(censor_mod.per_leaf_sq(
                    layout.split(hat_new), hat_l))
                leaf_sent = leaf_sent & (delta > thr)
            hat_new = torch.where(per_pos(leaf_sent), hat_new, st.theta_hat,
                                  out=hat_new)
        sent = active_t
        if dcfg.censor is not None:
            sent = sent & censor_mod.transmit_mask(
                layout.split(hat_new), hat_l, dcfg.censor, st.step)
        if lw is not None:
            eff_leaf = leaf_sent & sent[:, None]                  # (W, L)
            commit = (sent, (eff_leaf, b_new))
            pay_r = torch.where(eff_leaf, r_new, 0.0)
            st.radius = torch.where(eff_leaf, r_new, st.radius)
            st.bits = torch.where(eff_leaf, b_new, st.bits)
        else:
            commit = (sent, None)
            pay_r = r_new
            st.radius = torch.where(
                sent.view((w,) + (1,) * (r_new.dim() - 1)), r_new, st.radius)
            st.bits = torch.where(sent, b_new, st.bits)
        st.theta_hat = torch.where(sent[:, None], hat_new, st.theta_hat,
                                   out=hat_new)

        if self.eidx.num_directed == 0:
            return commit
        if dcfg.pack_wire:
            recv = pack_ops.unpack4(pack_ops.pack4(q)[self._src], d)
        else:
            recv = q[self._src]
        # decode the rows whose source was active; keep the stored hat
        # where it was censored
        rows = torch.as_tensor(np.flatnonzero(active[self.eidx.src]),
                               device=dev)
        src = self._src[rows]
        dec = q_ops.decode_ref(st.hat_edge[rows], recv[rows],
                               col(pay_r[src]), col(levels[src]))
        if dcfg.censor is not None:
            dec = torch.where(sent[src][:, None], dec, st.hat_edge[rows])
        st.hat_edge[rows] = dec
        return commit

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

    def wire_bits_per_round(self, layout: ParamLayout, sent_phases=None,
                            leaf_phases=None):
        """Bits on the wire per step (JAX ``wire_bits_per_round``).

        Static (an int): per phase and per direction each of the E edges
        carries one wire row plus the header (R f32 per radius — one, or one
        per leaf under per_tensor — and b i32).  Censored (`sent_phases`,
        the per-phase (W,) masks; a tensor): every directed edge carries the
        1-bit flag, and worker w's payload moves on its deg(w) edges when it
        sent.  Layerwise (`leaf_phases`, per-phase (eff (W, L) bool, bits
        (W, L)); a tensor): every leaf slot carries a flag on every directed
        edge, and each sent leaf costs 8 * bytes_l + header_bits(), bytes_l
        = packed_len(d_l) at <= 4 bits, d_l above."""
        n_edges = self.topo.num_edges
        if n_edges == 0:
            return 0
        sizes = layout.sizes
        dev = self.device
        if leaf_phases is not None:
            bytes_pk = torch.tensor([pack_ops.packed_len(n) for n in sizes],
                                    dtype=torch.float32, device=dev)
            bytes_raw = torch.tensor(sizes, dtype=torch.float32, device=dev)
            total = torch.zeros((), device=dev)
            for eff, b in leaf_phases:
                bytes_l = torch.where(b <= 4, bytes_pk, bytes_raw)  # (W, L)
                link = torch.sum(eff.to(torch.float32)
                                 * (8.0 * bytes_l + header_bits()), dim=1)
                total = (total
                         + 2 * n_edges * len(sizes) * censor_mod.FLAG_BITS
                         + torch.sum(self._deg * link))
            return total
        n_r = len(sizes) if self.dcfg.radius_mode == "per_tensor" else 1
        per_link = 8 * self.wire_row_bytes(layout.size) + header_bits(
            num_radii=n_r)
        if sent_phases is None:
            return 2 * 2 * n_edges * per_link
        total = torch.zeros((), device=dev)
        for sent in sent_phases:
            total = (total + 2 * n_edges * censor_mod.FLAG_BITS
                     + per_link * torch.sum(sent.to(torch.float32)
                                            * self._deg))
        return total
