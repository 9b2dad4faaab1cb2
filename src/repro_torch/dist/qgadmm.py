"""Multi-worker Q-SGADMM trainer (paper Algorithm 1, eqs. 14-18) on one GPU.

The port of ``repro/dist/qgadmm.py``'s single-device step
(``QGADMMTrainer.make_train_step``, ``_build_step(sharded=False)``).  The W
workers are a leading batch dim on one card and the exchange is a gather
along the topology's directed edges.

State layout.  Every per-worker quantity is ONE flat (W, D) f32 buffer whose
columns are the model's parameters in the JAX package's leaf order
(``repro_torch.tree``): the wire buffer is the state itself, so flattening
costs nothing, and the local loss sees each row as a tree of leaves.  The
neighbor state is edge-indexed as in the JAX package: the 2E directed edges
(``core.topology.edge_index``, sorted by (dst, src)) own one (D,) row each of
``hat_edge`` (what dst knows of src's hat) and ``lam_edge`` (dst's mirror of
the edge dual, canonical head -> tail orientation).  The step updates the
state in place — at whisper-tiny W=4 it is 28 f32 copies of the model — and
returns it.  Leaves narrower than f32 (``state_dtype``, or a tree with
bf16 leaves) keep f32 buffers whose columns are rounded through the leaf's
dtype wherever the JAX result takes it (``ParamLayout.round_``): the
gradient, theta and the Adam moments after each step, the committed and
the decoded hats, the duals; the model sees those leaves in their own dtype.
So a bf16 state does not halve the buffers' memory.

One round is built from three pieces, as in the JAX trainer:
  * ``phase_compute`` — the phase's workers run ``local_iters`` Adam steps
    on the augmented Lagrangian of eq. 14 (data loss, over ``microbatches``
    chunks, plus dual and proximal terms to the neighbors' hats), gradients
    from autograd; then every worker's per-leaf radii R = max |theta - hat|
    and bit widths (fixed, eq. 11, or per leaf under ``layerwise``); then ONE
    codec kernel launch over the (W, D) buffer with a (W, D) uniform draw
    (``kernels/quantize``: K1 with one radius per row, K2 per position under
    ``per_tensor``, K3 with per-position levels under ``layerwise``).  Only
    the phase's workers commit — under ``censor`` only those whose hat moved
    past the threshold, under ``layerwise`` only the leaves due.  Returns
    the payload (levels, radius, widths, sent mask).  With
    ``quantize=False`` the payload is the f32 row itself and no kernel runs;
  * ``phase_apply`` — the exchange: one ``pack4`` launch over the W rows
    (levels <= 4 bits), a gather of the packed rows by the edges' source,
    one ``unpack4`` launch over the 2E rows; the receivers decode into
    ``hat_edge`` with the plain f32 arithmetic of the sender's kernel where
    the source sent, so sender and receiver stay bitwise equal;
  * ``dual_update`` — every edge dual takes the damped update of eq. 18.

Schedules (``mode``, ``overlap``, ``staleness``):
  * gauss-seidel: heads compute + apply, tails compute + apply, duals;
  * jacobi: one phase over all workers (the first draw), then the duals;
  * overlap: heads compute, tails compute against the PREVIOUS neighbor
    hats, then the heads' payload is applied, then the tails', then duals;
  * staleness S > 0: recv-done decodes the oldest entry of the S-deep ring
    ``inbox`` into ``hat_edge`` and the own-hat lag ``hat_lag``; both phases
    compute against those S-stale hats; the duals pair ``hat_lag[dst]`` with
    ``hat_edge`` (off while step < S); send merges the two phases' payloads
    into the ring.  With ``pack_wire`` the ring holds nibble-packed rows, so
    a stale round launches the codec twice, ``pack4`` once (send) and
    ``unpack4`` once (recv-done, skipped in the S fill rounds, whose
    entries carry no sender): over n >= S steps, 2n / n / n - S launches.

``participation < 1`` draws a (W,) Bernoulli mask each round from the
state's own host generator (or takes the caller's): absent workers neither
compute nor send, each neighbor term of the local loss is weighted by
``deg / #present neighbors`` (0 for an absent one), and an edge's dual moves
only when both endpoints take part.  Bits are billed on the round a
payload is sent.  Only ``uneven_shard`` / ``seq_shard`` (the multi-GPU
layouts) raise ``NotImplementedError``.
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
from repro_torch.tree import ParamLayout, map_leaves

Tensor = torch.Tensor

_ADAM_B1, _ADAM_B2, _ADAM_EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass(frozen=True)
class DistConfig:
    """Configuration of the trainer; the JAX package's field names and
    defaults (see ``repro/dist/qgadmm.py:DistConfig`` for each).

    ``wire_impl`` chose the JAX codec; here the device decides (the CUDA
    kernels on the card, their plain versions on the CPU).  ``state_dtype``
    is a torch dtype.  ``check_invariants`` makes ``launch/train.py`` run
    ``repro_torch.obs.checks`` after each log window.  ``uneven_shard`` and
    ``seq_shard`` raise NotImplementedError (multi-GPU, ROADMAP item 4)."""

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
        assert self.microbatches >= 1, self.microbatches
        assert self.gadmm.topk_frac >= 1.0, \
            "topk sparsification is not supported by the distributed trainer"
        assert not (self.overlap and self.mode != "gauss-seidel"), \
            "overlap (double-buffered exchange) only applies to the " \
            "two-phase gauss-seidel mode"
        assert self.staleness >= 0, self.staleness
        assert self.staleness == 0 or (self.mode == "gauss-seidel"
                                       and not self.overlap), \
            "staleness > 0 pipelines the two-phase gauss-seidel exchange " \
            "(jacobi and overlap have their own schedules)"
        if self.layerwise is not None:
            assert self.gadmm.quantize, \
                "layerwise bit allocation needs the quantized wire"
            object.__setattr__(self, "radius_mode", "per_tensor")
        if self.uneven_shard or self.seq_shard:
            raise NotImplementedError(
                "DistConfig uneven_shard/seq_shard is not ported yet "
                "(ROADMAP Queue 1 item 4)")
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
            object.__setattr__(self, "pack_wire",
                               bool(self.gadmm.quantize and max_b <= 4))
        if self.pack_wire and self.gadmm.quantize:
            assert max_b <= 4, "pack_wire needs <= 4-bit levels"


@dataclasses.dataclass
class DistState:
    """Flat per-worker state (see the module docstring).  Float buffers are
    (W, D) f32 in wire order, edge slabs (2E, D); ``gen`` draws the
    stochastic-rounding uniforms on the device, ``part_gen`` (host) the
    participation masks; ``layout`` maps a row back to the parameter tree.

    Under staleness S > 0, ``inbox`` is the in-flight ring, oldest entry
    first: S dicts of ``wire`` ((W, packed_len(D)) uint8 with pack_wire,
    (W, D) uint8 levels, or (W, D) f32 rows without quantization),
    ``radius``, ``bits`` and ``sent`` ((W,) bool; all False in the fill
    entries, so they decode to nothing); ``hat_lag`` is each worker's own
    hat S rounds ago, decoded from the same payload stream."""

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
    part_gen: torch.Generator | None = None
    inbox: list = dataclasses.field(default_factory=list)
    hat_lag: Tensor | None = None


def _empty_inbox(dcfg: DistConfig, radius: Tensor, bits: Tensor,
                d: int) -> list:
    """The S fill entries of a fresh staleness ring (zeros, nothing sent)."""
    w, dev = dcfg.num_workers, radius.device
    if not dcfg.gadmm.quantize:
        wire = lambda: torch.zeros((w, d), dtype=torch.float32, device=dev)
    else:
        cols = pack_ops.packed_len(d) if dcfg.pack_wire else d
        wire = lambda: torch.zeros((w, cols), dtype=torch.uint8, device=dev)
    return [{"wire": wire(), "radius": torch.zeros_like(radius),
             "bits": torch.zeros_like(bits),
             "sent": torch.zeros((w,), dtype=torch.bool, device=dev)}
            for _ in range(dcfg.staleness)]


def init_state(init_fn: Callable[[torch.Generator], dict], seed: int,
               dcfg: DistConfig, device=None) -> DistState:
    """State at k=0: every worker starts from the same init
    ``init_fn(generator)``, drawn from a generator seeded with `seed` on the
    device, its floating leaves cast to ``state_dtype`` when set; hats,
    duals and moments at zero (the paper initializes theta_hat^0 = 0); the
    rounding draws come from a generator seeded with seed + 1, the
    participation masks from a host generator seeded with seed + 2."""
    dev = resolve_device(device)
    params = init_fn(torch.Generator(device=dev).manual_seed(seed))
    if dcfg.state_dtype is not None:
        params = map_leaves(lambda a: a.to(dcfg.state_dtype)
                            if a.is_floating_point() else a, params)
    layout = ParamLayout.of(params)
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
    radius = torch.zeros(r_shape, dtype=torch.float32, device=dev)
    stale = dcfg.staleness > 0
    return DistState(
        theta=layout.flatten(params).to(dev)[None].repeat(w, 1),
        theta_hat=z(w), hat_edge=z(de), lam_edge=z(de),
        radius=radius, bits=bits0, opt_mu=z(w), opt_nu=z(w),
        opt_t=torch.zeros((w,), dtype=torch.int32, device=dev),
        step=0, gen=torch.Generator(device=dev).manual_seed(seed + 1),
        layout=layout, part_gen=torch.Generator().manual_seed(seed + 2),
        inbox=_empty_inbox(dcfg, radius, bits0, d) if stale else [],
        hat_lag=z(w) if stale else None)


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
        self._head_t = torch.as_tensor(self.is_head, device=dev)
        self._deg = torch.as_tensor(self.topo.degree, dtype=torch.float32,
                                    device=dev)
        # per worker: its (edge color, directed-edge row) pairs
        self._slots = [[(c, int(e)) for c, e in enumerate(row) if e >= 0]
                       for row in self.eidx.slot]
        lw = dcfg.layerwise
        # eq. 11 per leaf runs against the layerwise range
        self._lw_qcfg = (dataclasses.replace(
            dcfg.gadmm.qcfg, adapt_bits=True, max_bits=lw.max_bits,
            bits=min(dcfg.gadmm.qcfg.bits, lw.max_bits))
            if lw is not None and lw.adapt_bits else None)
        self._tables: dict = {}

    def _layout_tables(self, layout: ParamLayout):
        """(position -> leaf map or None, layerwise (bits, periods, taus)
        device tables or None, Adam constants or None) for `layout`, built
        once per layout.  The Adam constants exist for a layout with leaves
        narrower than f32: per position (D,) f32 tables of b1, 1 - b1, b2,
        1 - b2, each rounded to its leaf's dtype, as the JAX update's
        Python constants take a bf16 leaf's dtype."""
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
            adam = None
            if layout.narrow:
                adam = []
                for c in (_ADAM_B1, 1 - _ADAM_B1, _ADAM_B2, 1 - _ADAM_B2):
                    t = torch.full((layout.size,), c, dtype=torch.float32)
                    for off, n, dt in layout.narrow:
                        t[off:off + n] = torch.tensor(c).to(dt).float()
                    adam.append(t.to(dev))
            self._tables[layout] = (seg, lw_tabs, adam)
        return self._tables[layout]

    def _col(self, layout: ParamLayout, t: Tensor) -> Tensor:
        """(rows,) -> (rows, 1); a (rows, L) per-leaf table -> (rows, D)."""
        if t.dim() == 1:
            return t[:, None]
        return t.index_select(1, self._layout_tables(layout)[0])

    # ------------------------------------------------------------- step ----
    def step(self, state: DistState, batch: dict, u=None, part=None):
        """One Q-SGADMM round, in place; returns (state, metrics).

        batch: {name: (W, ...) array} — each worker's own shard.
        u: optional (u_first, u_second), the (W, D) f32 uniform draws of the
        phases' codec (jacobi uses the first); None draws them from
        ``state.gen``.  part: optional (W,) bool participation mask of this
        round (participation < 1); None draws it from ``state.part_gen``.
        (The tests pass the JAX step's own draws and mask here.)

        Besides the JAX step's metrics, ``worker_sent`` (W,) counts each
        worker's transmissions this round and, under layerwise,
        ``leaf_bits_sent`` (W, L) is the width each leaf went out at (0
        where it was not sent).  With ``telemetry`` the JAX step's
        telemetry metrics come too."""
        dev = self.device
        dcfg = self.dcfg
        w = dcfg.num_workers
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        u_at = lambda i: None if u is None else torch.as_tensor(u[i],
                                                                device=dev)
        part_np = pw = edge_part = None
        if dcfg.participation < 1.0:
            if part is None:
                part = (torch.rand((w,), generator=state.part_gen)
                        < dcfg.participation)
            part_np = (part.cpu().numpy() if isinstance(part, Tensor)
                       else np.asarray(part)).astype(bool)
            pw, edge_part = self._participation_weights(part_np)
        mask = (lambda a: a) if part_np is None else (lambda a: a & part_np)
        lam_old = (state.lam_edge[self._head_rows]
                   if dcfg.telemetry and self.eidx.num_directed else None)

        heads, tails = self.is_head, ~self.is_head
        stale = dcfg.staleness > 0 and w > 1 and self.topo.num_edges > 0
        if stale:
            f0, payloads = self._stale_round(state, batch, u_at, mask, pw,
                                             edge_part)
        elif dcfg.mode == "gauss-seidel" and w > 1:
            # overlap: the tails compute against the previous neighbor hats
            # while the heads' payload is in flight
            f0, pl_h = self.phase_compute(state, batch, mask(heads), u_at(0),
                                          want_f0=True, pw=pw)
            if not dcfg.overlap:
                self.phase_apply(state, pl_h)
            _, pl_t = self.phase_compute(state, batch, mask(tails), u_at(1),
                                         pw=pw)
            if dcfg.overlap:
                self.phase_apply(state, pl_h)
            self.phase_apply(state, pl_t)
            self.dual_update(state, edge_part)
            payloads = [pl_h, pl_t]
        else:
            f0, pl = self.phase_compute(state, batch,
                                        mask(np.ones((w,), bool)), u_at(0),
                                        want_f0=True, pw=pw)
            self.phase_apply(state, pl)
            self.dual_update(state, edge_part)
            payloads = [pl]
        state.step += 1
        return state, self._metrics(state, f0, payloads, part_np, lam_old)

    def _participation_weights(self, part: np.ndarray):
        """JAX ``participation_masks`` from a (W,) bool mask: the (W, C)
        degree-renormalized neighbor weights (f32, as numpy) and the (2E,)
        both-endpoints dual gate (a device tensor, or None without
        edges)."""
        port = self.topo.port
        pmask = (port >= 0).astype(np.float32)
        nbr_part = part[np.maximum(port, 0)].astype(np.float32) * pmask
        deg = np.sum(pmask, axis=1)
        present = np.sum(nbr_part, axis=1)
        pw = nbr_part * (deg / np.maximum(present, np.float32(1.0)))[:, None]
        edge_part = None
        if self.eidx.num_directed:
            edge_part = torch.as_tensor(
                (part[self.eidx.src] & part[self.eidx.dst]).astype(np.float32),
                device=self.device)
        return pw, edge_part

    def _metrics(self, st: DistState, f0, payloads, part_np, lam_old):
        dcfg = self.dcfg
        dev = self.device
        w = dcfg.num_workers
        lw = dcfg.layerwise is not None
        sent_phases = [p["sent"] for p in payloads]
        leaf_phases = ([(p["leaf_sent"], p["bits"]) for p in payloads]
                       if lw else None)
        dynamic = dcfg.censor is not None or dcfg.participation < 1.0
        sp = sent_phases if dynamic else None
        f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
        worker_sent = sum(s.to(torch.float32) for s in sent_phases)
        metrics = {
            "loss": torch.mean(f0),
            "consensus_resid": self._consensus_resid(st),
            "radius_mean": torch.mean(st.radius),
            "bits_mean": torch.mean(st.bits.to(torch.float32)),
            "skip_rate": 1.0 - torch.sum(worker_sent) / w,
            "wire_bits_per_round": f32(self.wire_bits_per_round(
                st.layout, sp, leaf_phases)),
            "worker_sent": worker_sent,
        }
        if lw:
            metrics["leaf_bits_sent"] = sum(
                torch.where(eff, b, 0) for eff, b in leaf_phases)
        if dcfg.telemetry:
            pay, hdr, flg = self.wire_bits_components(st.layout, sp,
                                                      leaf_phases)
            dual_sq = torch.zeros((), device=dev)
            if lam_old is not None:
                dl = st.lam_edge[self._head_rows] - lam_old
                dual_sq = torch.sum(dl * dl)
            metrics.update({
                "wire_bits_payload": f32(pay),
                "wire_bits_header": f32(hdr),
                "wire_bits_flags": f32(flg),
                # directed links that carried payload / stayed silent
                "tx_links": sum(torch.sum(s.to(torch.float32) * self._deg)
                                for s in sent_phases),
                "skip_links": torch.sum((1.0 - worker_sent) * self._deg),
                "dual_resid": torch.sqrt(dual_sq),
                "participants": f32(float(w if part_np is None
                                          else part_np.sum())),
            })
            if lw:
                metrics["leaf_bits"] = torch.mean(
                    st.bits.to(torch.float32), dim=0)
        return metrics

    def _data_loss(self, params: dict, bw: dict) -> Tensor:
        """The worker's data loss; with microbatches > 1, dim 0 of its batch
        splits into that many chunks, whose losses are summed in order and
        divided by their count."""
        mb = self.dcfg.microbatches
        if mb <= 1:
            return self.model.loss_fn(params, bw, self.cfg)
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        for j in range(mb):
            chunk = {}
            for k, v in bw.items():
                if v.shape[0] % mb:
                    raise ValueError(f"batch {k!r} of {v.shape[0]} rows does "
                                     f"not split into {mb} microbatches")
                chunk[k] = v.reshape((mb, v.shape[0] // mb) + v.shape[1:])[j]
            total = total + self.model.loss_fn(params, chunk, self.cfg)
        return total / mb

    def phase_compute(self, st: DistState, batch: dict, active: np.ndarray,
                      u=None, want_f0: bool = False, pw=None):
        """Local Adam for the active workers, then codec and commit (JAX
        ``phase_compute``); the exchange is NOT applied.  Returns (the (W,)
        pre-update data losses when want_f0, else None; the payload).

        pw: (W, C) neighbor weights of the local loss (participation), None
        for the full topology.  Inactive workers run the forward pass only
        when want_f0.  The payload: ``active`` (the host mask), ``sent``
        ((W,) bool), and either ``q`` (W, D) levels, ``radius``, ``bits``,
        ``levels`` (and under layerwise ``leaf_sent`` (W, L)), or, without
        quantization, ``row``: the committed f32 hats."""
        w = self.dcfg.num_workers
        f0 = (torch.zeros((w,), dtype=torch.float32, device=self.device)
              if want_f0 else None)
        for i in range(w):
            bw = {k: v[i] for k, v in batch.items()}
            if active[i]:
                fi = self._local_opt(st, i, bw, pw)
            elif want_f0:
                with torch.no_grad():
                    fi = self._data_loss(st.layout.views(st.theta[i]), bw)
            else:
                continue
            if want_f0:
                f0[i] = fi
        if self.dcfg.gadmm.quantize:
            return f0, self._codec(st, active, u)
        return f0, self._full_precision(st, active)

    def _local_opt(self, st: DistState, i: int, bw: dict, pw) -> Tensor:
        """local_iters Adam steps of worker i on eq. 14's augmented
        Lagrangian; updates its theta / moments / count in place and
        returns the data loss at the first iterate.  A layout with narrower
        leaves takes ``_narrow_grad`` and rounds each Adam operation through
        the leaf dtype, where the JAX update computes in that dtype."""
        rho, lr = self.dcfg.gadmm.rho, self.dcfg.local_lr
        sign = 1.0 if self.is_head[i] else -1.0
        lay = st.layout
        adam = self._layout_tables(lay)[2]
        r = lay.round_
        th, m, v = st.theta[i], st.opt_mu[i], st.opt_nu[i]
        f0 = None
        for _ in range(self.dcfg.local_iters):
            flat = th.detach().clone().requires_grad_(True)
            f = self._data_loss(lay.views(flat), bw)
            if adam is None:
                aug = f
                for c, e in self._slots[i]:
                    diff = flat - st.hat_edge[e]
                    if pw is None:
                        aug = aug + sign * torch.dot(st.lam_edge[e], diff) \
                            + 0.5 * rho * torch.sum(diff * diff)
                    else:
                        wgt = float(pw[i, c])
                        aug = aug + wgt * sign * torch.dot(st.lam_edge[e],
                                                           diff) \
                            + 0.5 * rho * (wgt * torch.sum(diff * diff))
                (g,) = torch.autograd.grad(aug, flat)
            else:
                (g,) = torch.autograd.grad(f, flat)
                g = self._narrow_grad(st, i, g, pw)
            if f0 is None:
                f0 = f.detach()
            st.opt_t[i] += 1
            tf = st.opt_t[i].to(torch.float32)
            if adam is None:
                m_new = m.mul_(_ADAM_B1).add_((1 - _ADAM_B1) * g)
                v_new = v.mul_(_ADAM_B2).add_((1 - _ADAM_B2) * g * g)
            else:
                # the stored moments are rounded; the update reads the
                # sums before their last rounding, as XLA's fused step does
                b1, c1, b2, c2 = adam
                m_new = r(b1 * m) + r(c1 * g)
                v_new = r(b2 * v) + r(r(c2 * g) * g)
                m.copy_(r(m_new.clone()))
                v.copy_(r(v_new.clone()))
            bc1 = 1 - torch.pow(_ADAM_B1, tf)
            bc2 = 1 - torch.pow(_ADAM_B2, tf)
            r(th.sub_((lr * (m_new / bc1))
                      / (torch.sqrt(v_new / bc2) + _ADAM_EPS)))
        return f0

    def _narrow_grad(self, st: DistState, i: int, g_data: Tensor,
                     pw) -> Tensor:
        """Worker i's gradient of the augmented Lagrangian with the
        narrower leaves' columns accumulated as the JAX gradient of a bf16
        leaf is: each term's contribution rounded to the leaf dtype, then
        summed with a rounding per addition, in the reverse of the
        forward's order (the last slot's proximal then dual term first, the
        data loss last).  `g_data` is the data loss's gradient (already
        rounded by the cast in ``layout.views``)."""
        rho = self.dcfg.gadmm.rho
        r = st.layout.round_
        sign = 1.0 if self.is_head[i] else -1.0
        th = st.theta[i]
        acc = None
        for c, e in reversed(self._slots[i]):
            wgt = 1.0 if pw is None else float(pw[i, c])
            for term in (r((0.5 * rho * wgt) * (2.0 * (th - st.hat_edge[e]))),
                         r((wgt * sign) * st.lam_edge[e])):
                acc = term if acc is None else r(acc + term)
        return g_data if acc is None else r(acc + g_data)

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

    def _per_leaf_radius(self, st: DistState) -> Tensor:
        """(W, L) max |theta - hat| per leaf (0 for an empty leaf)."""
        w = st.theta.shape[0]
        return torch.stack(
            [torch.amax(torch.abs(a - b), dim=1) if a.shape[1]
             else torch.zeros((w,), dtype=torch.float32, device=self.device)
             for a, b in zip(st.layout.split(st.theta),
                             st.layout.split(st.theta_hat))], dim=1)

    def _codec(self, st: DistState, active: np.ndarray, u) -> dict:
        """Codec over all W rows, commit where sent; returns the payload."""
        dev = self.device
        dcfg = self.dcfg
        lw = dcfg.layerwise
        w, d = st.theta.shape
        layout = st.layout
        _, lw_tabs, _ = self._layout_tables(layout)
        per_pos = lambda t: self._col(layout, t) if t.dim() == 2 else t

        theta_l, hat_l = layout.split(st.theta), layout.split(st.theta_hat)
        per_leaf_r = self._per_leaf_radius(st)                     # (W, L)
        r_global = torch.amax(per_leaf_r, dim=1)                   # (W,)
        r_new = r_global if dcfg.radius_mode == "global" else per_leaf_r
        b_new = self._bit_widths(st, theta_l, hat_l, per_leaf_r, r_global,
                                 lw_tabs)
        levels = levels_of(b_new)
        if u is None:
            u = torch.rand((w, d), generator=st.gen, device=dev)
        q, hat_new = q_ops.quantize_dequantize(
            st.theta, st.theta_hat, u, per_pos(r_new), per_pos(levels))
        layout.round_(hat_new)

        active_t = torch.as_tensor(active, device=dev)
        leaf_sent = None
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
        payload = {"active": active, "sent": sent, "q": q, "bits": b_new,
                   "levels": levels}
        if lw is not None:
            eff_leaf = leaf_sent & sent[:, None]                  # (W, L)
            payload.update(leaf_sent=eff_leaf,
                           radius=torch.where(eff_leaf, r_new, 0.0))
            st.radius = torch.where(eff_leaf, r_new, st.radius)
            st.bits = torch.where(eff_leaf, b_new, st.bits)
        else:
            payload["radius"] = r_new
            st.radius = torch.where(
                sent.view((w,) + (1,) * (r_new.dim() - 1)), r_new, st.radius)
            st.bits = torch.where(sent, b_new, st.bits)
        st.theta_hat = torch.where(sent[:, None], hat_new, st.theta_hat,
                                   out=hat_new)
        return payload

    def _full_precision(self, st: DistState, active: np.ndarray) -> dict:
        """Full-precision GADMM (``quantize=False``): the hat is theta
        itself where sent, and the f32 row is the payload; the radius is
        tracked for the metrics.  No kernel runs."""
        dcfg = self.dcfg
        w = dcfg.num_workers
        layout = st.layout
        per_leaf_r = self._per_leaf_radius(st)
        sent = torch.as_tensor(active, device=self.device)
        if dcfg.censor is not None:
            sent = sent & censor_mod.transmit_mask(
                layout.split(st.theta), layout.split(st.theta_hat),
                dcfg.censor, st.step)
        st.theta_hat = torch.where(sent[:, None], st.theta, st.theta_hat)
        r_new = (torch.amax(per_leaf_r, dim=1) if st.radius.dim() == 1
                 else per_leaf_r)
        st.radius = torch.where(
            sent.view((w,) + (1,) * (r_new.dim() - 1)), r_new, st.radius)
        return {"active": active, "sent": sent, "row": st.theta_hat}

    def phase_apply(self, st: DistState, payload: dict) -> None:
        """The exchange of one phase's payload (JAX ``phase_apply``): the
        rows move along the directed edges (pack4 -> gather -> unpack4 with
        pack_wire), and each receiver decodes into its ``hat_edge`` row
        where the source sent — with the sender's f32 arithmetic, so the
        decoded hat is bitwise the sender's.  Every row moves, as in the
        JAX exchange."""
        if self.eidx.num_directed == 0:
            return
        layout = st.layout
        rows = torch.as_tensor(
            np.flatnonzero(payload["active"][self.eidx.src]),
            device=self.device)
        src = self._src[rows]
        if self.dcfg.gadmm.quantize:
            q = payload["q"]
            if self.dcfg.pack_wire:
                recv = pack_ops.unpack4(pack_ops.pack4(q)[self._src],
                                        q.shape[1])
            else:
                recv = q[self._src]
            dec = layout.round_(q_ops.decode_ref(
                st.hat_edge[rows], recv[rows],
                self._col(layout, payload["radius"][src]),
                self._col(layout, payload["levels"][src])))
        else:
            dec = payload["row"][src]
        if self.dcfg.censor is not None:
            dec = torch.where(payload["sent"][src][:, None], dec,
                              st.hat_edge[rows])
        st.hat_edge[rows] = dec

    def dual_update(self, st: DistState, edge_mask=None, own=None) -> None:
        """Damped dual update (eq. 18), lam_e += a*rho*(hat_head - hat_tail),
        seen from each directed edge as sign_dst * (own[dst] - hat_edge),
        ``own`` the workers' own hats (``theta_hat``; ``hat_lag`` under
        staleness).  `edge_mask` (2E,) zeroes selected edges' increments.
        In a narrower leaf's columns each operation rounds through the leaf
        dtype, the scale a*rho*sign included, as the JAX update's do."""
        if self.eidx.num_directed == 0:
            return
        g = self.dcfg.gadmm
        lay = st.layout
        own = st.theta_hat if own is None else own
        coef = self._sign if edge_mask is None else self._sign * edge_mask
        scale = g.alpha * g.rho * coef
        diff = lay.round_(own[self._dst] - st.hat_edge)
        inc = scale[:, None] * diff
        for off, n, dt in lay.narrow:
            inc[:, off:off + n] = (scale.to(dt).float()[:, None]
                                   * diff[:, off:off + n])
        st.lam_edge.add_(lay.round_(inc))
        lay.round_(st.lam_edge)

    def _consensus_resid(self, st: DistState) -> Tensor:
        """||theta_hat[dst] - hat_edge|| over the edges, each counted once
        (from its head)."""
        if self.eidx.num_directed == 0:
            return torch.zeros((), device=self.device)
        rows = self._head_rows
        head = st.theta_hat[self._dst[rows]] - st.hat_edge[rows]
        return torch.sqrt(torch.sum(head * head))

    # ------------------------------------------------- staleness pipeline --
    def _stale_round(self, st: DistState, batch: dict, u_at, mask, pw,
                     edge_part):
        """One staleness-S round (JAX ``_stale_round``): recv-done on the
        oldest ring entry, both phases against the S-stale hats, the dual
        update on matching S-stale snapshots (off in the S fill rounds),
        then send.  Returns (f0, the two phases' payloads)."""
        dcfg = self.dcfg
        s_depth = dcfg.staleness
        layout = st.layout
        d = layout.size
        entry = st.inbox.pop(0)
        if st.step >= s_depth:
            # recv-done: decode into the edge slab and the own-hat lag
            wire = entry["wire"]
            sent, src = entry["sent"], self._src
            if dcfg.gadmm.quantize:
                if dcfg.pack_wire:
                    wire = pack_ops.unpack4(wire, d)
                r, lv = entry["radius"], levels_of(entry["bits"])
                dec_e = layout.round_(q_ops.decode_ref(
                    st.hat_edge, wire[src], self._col(layout, r[src]),
                    self._col(layout, lv[src])))
                dec_l = layout.round_(q_ops.decode_ref(
                    st.hat_lag, wire, self._col(layout, r),
                    self._col(layout, lv)))
            else:
                dec_e, dec_l = wire[src], wire
            st.hat_edge = torch.where(sent[src][:, None], dec_e, st.hat_edge)
            st.hat_lag = torch.where(sent[:, None], dec_l, st.hat_lag)

        f0, pl_h = self.phase_compute(st, batch, mask(self.is_head), u_at(0),
                                      want_f0=True, pw=pw)
        _, pl_t = self.phase_compute(st, batch, mask(~self.is_head), u_at(1),
                                     pw=pw)
        if st.step >= s_depth:
            self.dual_update(st, edge_part, own=st.hat_lag)

        # send: the phases partition the workers, so row w comes from one
        head = self._head_t
        mix = lambda a, b: torch.where(
            head.view((-1,) + (1,) * (a.dim() - 1)), a, b)
        if dcfg.gadmm.quantize:
            wire = mix(pl_h["q"], pl_t["q"])
            if dcfg.pack_wire:
                wire = pack_ops.pack4(wire)
            radius = mix(pl_h["radius"], pl_t["radius"])
            bits = mix(pl_h["bits"], pl_t["bits"])
        else:
            wire = mix(pl_h["row"], pl_t["row"])
            radius, bits = (torch.zeros_like(entry["radius"]),
                            torch.zeros_like(entry["bits"]))
        st.inbox.append({"wire": wire, "radius": radius, "bits": bits,
                         "sent": pl_h["sent"] | pl_t["sent"]})
        return f0, [pl_h, pl_t]

    # ------------------------------------------------------- invariants ----
    def bit_sync(self, st: DistState) -> bool:
        """Sender == receiver: every hat_edge row is bitwise the source's
        own hat (``theta_hat``; under staleness its S-round lag
        ``hat_lag``, the hat the receivers have decoded so far)."""
        own = st.hat_lag if st.hat_lag is not None else st.theta_hat
        return bool(torch.equal(st.hat_edge.view(torch.int32),
                                own[self._src].view(torch.int32)))

    # ------------------------------------------------------- accounting ----
    def wire_row_bytes(self, d: int) -> int:
        """Bytes of one worker's wire row for d parameters: packed_len(d)
        with pack_wire, one byte per level otherwise, 4 d without
        quantization (one device per worker row, so no group padding)."""
        if not self.dcfg.gadmm.quantize:
            return 4 * d
        return pack_ops.packed_len(d) if self.dcfg.pack_wire else d

    def _per_link(self, layout: ParamLayout) -> tuple[int, int]:
        """(payload bits of one wire row, its header bits)."""
        row_bits = 8 * self.wire_row_bytes(layout.size)
        if not self.dcfg.gadmm.quantize:
            return row_bits, 0
        n_r = (len(layout.sizes) if self.dcfg.radius_mode == "per_tensor"
               else 1)
        return row_bits, header_bits(num_radii=n_r)

    def wire_bits_per_round(self, layout: ParamLayout, sent_phases=None,
                            leaf_phases=None):
        """Bits on the wire per step (JAX ``wire_bits_per_round``).

        Static (an int): per phase (2 in gauss-seidel, with or without
        overlap; 1 in jacobi) and per direction each of the E edges carries
        one wire row plus the header (R f32 per radius — one, or one per
        leaf under per_tensor — and b i32; none without quantization).
        Dynamic (`sent_phases`, the per-phase (W,) masks, under censoring or
        participation < 1; a tensor): every directed edge carries the 1-bit
        flag, and worker w's payload moves on its deg(w) edges when it sent.
        Layerwise (`leaf_phases`, per-phase (eff (W, L) bool, bits (W, L));
        a tensor): every leaf slot carries a flag on every directed edge,
        and each sent leaf costs 8 * bytes_l + header_bits(), bytes_l =
        packed_len(d_l) at <= 4 bits, d_l above (``mixed_packed_len``)."""
        n_edges = self.topo.num_edges
        if n_edges == 0:
            return 0
        if leaf_phases is not None:
            total = torch.zeros((), device=self.device)
            for eff, b in leaf_phases:
                link = torch.sum(eff.to(torch.float32)
                                 * (8.0 * self._leaf_bytes(layout, b)
                                    + header_bits()), dim=1)
                total = (total
                         + 2 * n_edges * len(layout.sizes)
                         * censor_mod.FLAG_BITS
                         + torch.sum(self._deg * link))
            return total
        row_bits, sideband = self._per_link(layout)
        per_link = row_bits + sideband
        if sent_phases is None:
            n_phases = 2 if self.dcfg.mode == "gauss-seidel" else 1
            return n_phases * 2 * n_edges * per_link
        total = torch.zeros((), device=self.device)
        for sent in sent_phases:
            total = (total + 2 * n_edges * censor_mod.FLAG_BITS
                     + per_link * torch.sum(sent.to(torch.float32)
                                            * self._deg))
        return total

    def wire_bits_components(self, layout: ParamLayout, sent_phases=None,
                             leaf_phases=None):
        """``wire_bits_per_round`` split into its (payload, header, flags)
        terms, argument for argument (JAX ``wire_bits_components``); their
        sum is the total up to float summation order."""
        n_edges = self.topo.num_edges
        if n_edges == 0:
            return 0.0, 0.0, 0.0
        if leaf_phases is not None:
            pay = hdr = torch.zeros((), device=self.device)
            for eff, b in leaf_phases:
                e = eff.to(torch.float32)
                pay = pay + torch.sum(self._deg * torch.sum(
                    e * 8.0 * self._leaf_bytes(layout, b), dim=1))
                hdr = hdr + torch.sum(self._deg * torch.sum(e, dim=1)
                                      * header_bits())
            return pay, hdr, float(len(leaf_phases) * 2 * n_edges
                                   * len(layout.sizes) * censor_mod.FLAG_BITS)
        row_bits, sideband = self._per_link(layout)
        if sent_phases is None:
            n_phases = 2 if self.dcfg.mode == "gauss-seidel" else 1
            links = n_phases * 2 * n_edges
            return float(row_bits * links), float(sideband * links), 0.0
        links = sum(torch.sum(s.to(torch.float32) * self._deg)
                    for s in sent_phases)
        return (row_bits * links, sideband * links,
                float(len(sent_phases) * 2 * n_edges * censor_mod.FLAG_BITS))

    def _leaf_bytes(self, layout: ParamLayout, bits: Tensor) -> Tensor:
        """(W, L) bytes of each leaf's segment at `bits`: packed_len(d_l)
        at <= 4 bits, d_l above."""
        sizes = layout.sizes
        bytes_pk = torch.tensor([pack_ops.packed_len(n) for n in sizes],
                                dtype=torch.float32, device=self.device)
        bytes_raw = torch.tensor(sizes, dtype=torch.float32,
                                 device=self.device)
        return torch.where(bits <= 4, bytes_pk, bytes_raw)
