"""The port's chain and graph Q-GADMM (Algorithm 1, CQ-GGADMM), its data
makers, placement and energy model against the JAX package, on the CPU.

Shared inputs: the JAX state and quadratic are carried across with
``repro_torch.convert`` and the port consumes the JAX step's own draws
(``key, k_h, k_t = split(state.key, 3)``, one (N, d) uniform per phase).

Tolerances, per comparison:
- ``regression_shards`` / ``classification_shards``, the placements and
  every energy of ``comm_model``: equal (numpy on both sides, rtol 0).
- ``quantize_rows`` against the un-jitted JAX function (``jax.disable_jit()``,
  each op rounded on its own): bitwise equal.
- ``gadmm_step`` and ``graph_step`` against the JAX functions, un-jitted
  and jitted: bits, sent masks and wire bits exact; theta, hats and radii
  to atol 1e-5, duals to atol rho x 1e-6 = 2.4e-5 + rtol 1e-6 (a dual
  update adds rho times the difference of two hats; duals reach
  |lam| ~ 60, where an ulp is 3.8e-6).  The port's local solve is one
  batched product, which sums in another order than XLA's dot (a
  multiply-add chain in k order); the jitted function also folds the
  constant 2^b - 1 into a reciprocal (step = 2R * (1/3)) and contracts
  ``hat + step * q`` and ``lam + c * resid`` into FMAs.  So values differ
  by a few ulp: measured at most 4.8e-7 on theta, 2.4e-7 on hats and
  radii, 1.14e-5 on the duals (at |lam| 1.4: rho x 2 hat ulps), at 4-64%
  of the positions.  No level moved: the measured fraction of positions
  beyond these bounds is 0, and the tests require 0.
- The graph step's ``edge`` and ``port`` layouts: bitwise equal on the CPU
  (the dense products add the 0/1-weighted terms in ascending order).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import comm_model as jcm
from repro.core import gadmm as jg
from repro.core import topology as jtopo
from repro.core.censor import CensorConfig as JCensorConfig
from repro.core.quantizer import QuantizerConfig as JQuantizerConfig
from repro.data import synthetic as jsyn
from repro_torch.convert import (chain_state_from_jax, graph_state_from_jax,
                                 quadratic_from_jax)
from repro_torch.core import comm_model as tcm
from repro_torch.core import gadmm as tg
from repro_torch.core import topology as ttopo
from repro_torch.core.censor import CensorConfig
from repro_torch.core.quantizer import QuantizerConfig
from repro_torch.data import synthetic as tsyn

N, D = 20, 6


@pytest.fixture(scope="module")
def problem():
    """tests/test_gadmm.py's fixture: N 20, 4000 samples, d 6, seed 1."""
    xs, ys, _ = jsyn.regression_shards(n_workers=N, samples=4000, d=D,
                                       seed=1)
    xtx = np.einsum("nmd,nme->nde", xs.astype(np.float64), xs)
    xty = np.einsum("nmd,nm->nd", xs.astype(np.float64), ys)
    theta_star = np.linalg.solve(xtx.sum(0), xty.sum(0))
    return xs, ys, theta_star


def cfgs(quantize=True, bits=2, **kw):
    """The same GADMMConfig for both packages."""
    adapt = kw.pop("adapt_bits", False)
    return (jg.GADMMConfig(rho=24.0, quantize=quantize,
                           qcfg=JQuantizerConfig(bits=bits, adapt_bits=adapt),
                           **kw),
            tg.GADMMConfig(rho=24.0, quantize=quantize,
                           qcfg=QuantizerConfig(bits=bits, adapt_bits=adapt),
                           **kw))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _draws(key):
    """The JAX step's two phase draws, as tensors."""
    _, k_h, k_t = jax.random.split(key, 3)
    return [torch.from_numpy(np.array(jax.random.uniform(k, (N, D))))
            for k in (k_h, k_t)]


def _assert_fields(jst, tst, fields, bitwise=False, exact=("bits", "sent")):
    for f in fields:
        a, b = np.asarray(getattr(jst, f)), getattr(tst, f).numpy()
        if bitwise or f in exact:
            np.testing.assert_array_equal(b, a, err_msg=f)
        else:
            # a dual update adds rho (24) times the difference of two hats,
            # each a few ulp off: 24 x 4.8e-7 < 1.2e-5 per update, hence
            # rho x 1e-6; duals reach |lam| ~ 60, where 3 ulp are 1.1e-5
            lam = f == "lam"
            np.testing.assert_allclose(b, a, rtol=1e-6 if lam else 0,
                                       atol=24e-6 if lam else 1e-5,
                                       err_msg=f)


# ---------------------------------------------------------------- data -----
@pytest.mark.parametrize("heterogeneous", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_regression_shards_bitwise(seed, heterogeneous):
    a = jsyn.regression_shards(7, 700, 5, seed, heterogeneous=heterogeneous)
    b = tsyn.regression_shards(7, 700, 5, seed, heterogeneous=heterogeneous)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_classification_shards_bitwise():
    a = jsyn.classification_shards(4, 400, 32, seed=2)
    b = tsyn.classification_shards(4, 400, 32, seed=2)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


# --------------------------------------------------- placement, energy -----
@pytest.mark.parametrize("kind", ["chain", "ring", "star", "torus2d",
                                  "cluster_of_stars", "federated"])
def test_placement_and_energy_match(kind):
    jp = jtopo.random_placement(20, seed=3, topology=kind)
    tp = ttopo.random_placement(20, seed=3, topology=kind)
    for f in ("positions", "chain", "chain_hop_dist", "ps_dist"):
        np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f), f)
    assert tp.ps_index == jp.ps_index
    np.testing.assert_array_equal(tp.resolved_topology().edges,
                                  jp.resolved_topology().edges)
    np.testing.assert_array_equal(tp.broadcast_dist(), jp.broadcast_dist())
    radio = (jcm.RadioConfig(n_workers=20), tcm.RadioConfig(n_workers=20))
    bits = np.linspace(76.0, 200.0, 20)
    sent = np.arange(20) % 3 != 0
    assert tcm.round_energy_decentralized(
        bits, tp.broadcast_dist(), radio[1]) == \
        jcm.round_energy_decentralized(bits, jp.broadcast_dist(), radio[0])
    assert tcm.round_energy_ps(96.0, tp.ps_dist, 192.0, radio[1]) == \
        jcm.round_energy_ps(96.0, jp.ps_dist, 192.0, radio[0])
    for s in (None, sent):
        assert tcm.round_energy_topology(tp, bits, radio[1], sent=s) == \
            jcm.round_energy_topology(jp, bits, radio[0], sent=s)
    assert tcm.tx_energy(1000, 50, 4e4, 1e-3, 1e-6) == \
        jcm.tx_energy(1000, 50, 4e4, 1e-3, 1e-6)
    for a, b in zip(ttopo.head_tail_split(21), jtopo.head_tail_split(21)):
        np.testing.assert_array_equal(a, b)


# -------------------------------------------------------------- codec ------
@pytest.mark.parametrize("bits,adapt,topk", [(2, False, 1.0), (4, True, 1.0),
                                             (8, False, 1.0),
                                             (4, False, 0.5)])
def test_quantize_rows_matches_jax(bits, adapt, topk):
    """One codec launch over all rows, active rows committed: bitwise equal
    to the un-jitted JAX function (levels, hats, radii, widths); against the
    jitted one the levels, radii and widths are equal and the hats within
    1e-6 (a few ulp at |hat| < 4: the folded reciprocal step and the FMA
    contracted reconstruction; 4.8e-7 measured).  Rows include R_prev = 0
    (eq. 11 falls back to the base width) and an all-zero difference
    (R = 0: hat unchanged); top-k ties are broken by index."""
    rng = np.random.default_rng(bits)
    n, d = 64, 6
    theta = rng.normal(size=(n, d)).astype(np.float32)
    hat = (theta + 0.3 * rng.normal(size=(n, d))).astype(np.float32)
    hat[5] = theta[5]                                   # R == 0
    theta[7, :4] = hat[7, :4] + 0.25                    # top-k ties
    active = rng.random(n) < 0.6
    r_prev = (0.5 * rng.random(n)).astype(np.float32)
    r_prev[::7] = 0.0
    b_prev = rng.integers(1, 8, n).astype(np.int32)
    jc, tc = cfgs(bits=bits, adapt_bits=adapt, topk_frac=topk)
    key = jax.random.PRNGKey(bits)
    u = np.array(jax.random.uniform(key, (n, d)))
    args = [jnp.asarray(a) for a in (theta, hat, active)] + [key] + [
        jnp.asarray(a) for a in (r_prev, b_prev)]
    with jax.disable_jit():
        eager = jg.quantize_rows(*args, jc)
    jit = jax.jit(jg.quantize_rows, static_argnums=6)(*args, jc)
    t = tg.quantize_rows(*(torch.from_numpy(a) for a in
                           (theta, hat, active, u, r_prev, b_prev)), tc)
    for ref in (eager, jit):
        np.testing.assert_array_equal(t[3].numpy(), np.asarray(ref[3]))
        np.testing.assert_array_equal(t[1].numpy(), np.asarray(ref[1]))
        np.testing.assert_array_equal(t[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(t[0].numpy(), np.asarray(eager[0]))
    np.testing.assert_allclose(t[0].numpy(), np.asarray(jit[0]), rtol=0,
                               atol=1e-6)
    # the receiver's decode of the levels is the sender's hat, bitwise
    rx = tg.dequantize_rows(t[3], torch.from_numpy(hat), t[1], t[2])
    if topk == 1.0:
        np.testing.assert_array_equal(rx.numpy()[active], t[0].numpy()[active])


# --------------------------------------------------------------- chain -----
@pytest.mark.parametrize("quantize,bits", [(True, 2), (True, 4), (False, 2)])
def test_gadmm_step_matches_jax(problem, quantize, bits):
    """One gadmm_step from a shared state (5 JAX steps in) and the JAX
    draws, against the un-jitted and the jitted JAX step: bits exact and
    the rest to atol 1e-5 (no position beyond)."""
    xs, ys, _ = problem
    jc, tc = cfgs(quantize=quantize, bits=bits)
    q = jg.make_quadratic(jnp.asarray(xs), jnp.asarray(ys), jc.rho)
    step = jax.jit(functools.partial(jg.gadmm_step, q=q, cfg=jc))
    st = jg.init_state(N, D, jc)
    for _ in range(5):
        st = step(st)
    tq = quadratic_from_jax(_np(q), "cpu")
    tst = tg.gadmm_step(chain_state_from_jax(_np(st), "cpu"), tq, tc,
                        u=_draws(st.key))
    assert tst.step == 6
    fields = ("theta", "theta_hat", "lam", "radius", "bits")
    with jax.disable_jit():
        _assert_fields(jg.gadmm_step(st, q, jc), tst, fields)
    _assert_fields(step(st), tst, fields)


def test_gadmm_without_quantization_sets_hat_to_theta(problem):
    xs, ys, _ = problem
    _, tc = cfgs(quantize=False)
    q = tg.make_quadratic(torch.from_numpy(xs), torch.from_numpy(ys), tc.rho)
    st = tg.init_state(N, D, tc, device="cpu")
    for _ in range(3):
        st = tg.gadmm_step(st, q, tc)
    assert torch.equal(st.theta_hat, st.theta)


@pytest.mark.parametrize("kw,d", [({"quantize": False}, 6),
                                  ({"bits": 2}, 6),
                                  ({"bits": 4, "adapt_bits": True}, 1000),
                                  ({"bits": 4, "topk_frac": 0.25}, 30)])
def test_bits_per_round_matches_jax(kw, d):
    jc, tc = cfgs(**kw)
    assert tg.bits_per_round(tc, N, d) == jg.bits_per_round(jc, N, d)
    if kw == {"bits": 2}:
        assert tg.bits_per_round(tc, 50, 6) == 50 * (2 * 6 + 64)


def test_rechain_and_residuals_match_jax(problem):
    xs, ys, _ = problem
    jc, tc = cfgs(bits=4)
    q = jg.make_quadratic(jnp.asarray(xs), jnp.asarray(ys), jc.rho)
    st = jax.jit(functools.partial(jg.gadmm_step, q=q, cfg=jc))(
        jg.init_state(N, D, jc))
    perm = np.random.default_rng(0).permutation(N)
    tst = tg.rechain(chain_state_from_jax(_np(st), "cpu"), perm)
    _assert_fields(jg.rechain(st, perm), tst,
                   ("theta", "theta_hat", "lam", "radius", "bits"),
                   bitwise=True)
    jq = jg.rechain_quadratic(q, perm, jc.rho)
    tq = tg.rechain_quadratic(quadratic_from_jax(_np(q), "cpu"), perm, tc.rho)
    np.testing.assert_array_equal(tq.xtx.numpy(), np.asarray(jq.xtx))
    np.testing.assert_allclose(tq.minv.numpy(), np.asarray(jq.minv),
                               rtol=1e-5, atol=1e-9)
    for a, b in zip(tg.residuals(tst), jg.residuals(jg.rechain(st, perm))):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6)
    # make_quadratic on the CPU: the same factor to float32 rounding
    tq0 = tg.make_quadratic(torch.from_numpy(xs), torch.from_numpy(ys),
                            tc.rho)
    for f in ("xtx", "xty", "minv"):
        np.testing.assert_allclose(getattr(tq0, f).numpy(),
                                   np.asarray(getattr(q, f)), rtol=1e-5,
                                   atol=1e-9, err_msg=f)


def test_qgadmm_2bit_converges_to_optimum(problem):
    """The JAX test's bound after 400 rounds of the port's own draws:
    max |theta - theta*| < 3e-2 max(|theta*|, 1); GADMM after 250 rounds
    within 2e-2 of it."""
    xs, ys, theta_star = problem
    scale = max(float(np.abs(theta_star).max()), 1.0)
    for quantize, rounds, tol in ((True, 400, 3e-2), (False, 250, 2e-2)):
        _, tc = cfgs(quantize=quantize)
        q = tg.make_quadratic(torch.from_numpy(xs), torch.from_numpy(ys),
                              tc.rho)
        st = tg.init_state(N, D, tc, seed=0, device="cpu")
        for _ in range(rounds):
            st = tg.gadmm_step(st, q, tc)
        err = float(np.abs(st.theta.numpy() - theta_star[None]).max())
        assert err < tol * scale, (quantize, err)


# --------------------------------------------------------------- graph -----
GRAPHS = {"ring": (jtopo.ring_topology(N), ttopo.ring_topology(N)),
          "star": (jtopo.star_topology(N), ttopo.star_topology(N)),
          "torus2d": (jtopo.torus2d_topology(2, 10),
                      ttopo.torus2d_topology(2, 10))}


@pytest.mark.parametrize("censored", [False, True])
@pytest.mark.parametrize("kind", sorted(GRAPHS))
def test_graph_step_matches_jax(problem, kind, censored):
    """One graph_step from a shared state (8 JAX steps in; with a censor
    threshold that silences part of the workers there), against the
    un-jitted and the jitted JAX step: bits and sent masks exact and the
    rest to atol 1e-5; the port's two layouts bitwise equal;
    graph_bits_per_round exact."""
    xs, ys, _ = problem
    jt, tt = GRAPHS[kind]
    jc, tc = cfgs(bits=2)
    jcen = JCensorConfig(tau=0.5, xi=0.9) if censored else None
    tcen = CensorConfig(tau=0.5, xi=0.9) if censored else None
    q = jg.make_graph_quadratic(jnp.asarray(xs), jnp.asarray(ys), jc.rho, jt)
    step = jax.jit(functools.partial(jg.graph_step, q=q, cfg=jc, topo=jt,
                                     censor=jcen))
    st = jg.graph_init_state(jt, D, jc)
    for _ in range(8):
        st = step(st)
    tq = quadratic_from_jax(_np(q), "cpu")
    u = _draws(st.key)
    with jax.disable_jit():
        eager = jg.graph_step(st, q, jc, jt, censor=jcen)
    fields = ("theta", "theta_hat", "lam", "radius", "bits", "sent")
    port = tg.graph_step(graph_state_from_jax(_np(st), "cpu"), tq, tc, tt,
                         censor=tcen, layout="port", u=u)
    tst = tg.graph_step(graph_state_from_jax(_np(st), "cpu"), tq, tc, tt,
                        censor=tcen, layout="edge", u=u)
    _assert_fields(port, tst, fields, bitwise=True)
    _assert_fields(eager, tst, fields)
    _assert_fields(step(st), tst, fields)
    if censored:
        assert 0 < int(tst.sent.sum()) < N
    for c in (False, True):
        want = jg.graph_bits_per_round(jc, jt, D, eager.sent, censored=c)
        got = tg.graph_bits_per_round(tc, tt, D, tst.sent, censored=c)
        assert float(got) == float(want), c


@pytest.mark.parametrize("seed", range(4))
def test_graph_layouts_agree(seed):
    """The edge layout (padded (N, C) neighbour tables summed in ascending
    source order) against the dense port layout, over 3 censored steps on
    a random connected bipartite graph (a random tree plus cross-parity
    chords): bitwise on the CPU."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 9))
    parents = [int(rng.integers(0, i)) for i in range(1, n)]
    edges = [(p, i) for i, p in enumerate(parents, start=1)]
    depth = [0] * n
    for i, p in enumerate(parents, start=1):
        depth[i] = depth[p] + 1
    for u, v in rng.integers(0, n, (3, 2)):
        if depth[u] % 2 != depth[v] % 2 and (min(u, v), max(u, v)) not in edges:
            edges.append((int(min(u, v)), int(max(u, v))))
    topo = ttopo.bipartite_topology(n, edges)
    xs, ys, _ = tsyn.regression_shards(n_workers=n, samples=4 * n, d=3,
                                       seed=3)
    cfg = tg.GADMMConfig(rho=5.0, qcfg=QuantizerConfig(bits=2))
    cen = CensorConfig(tau=1.0, xi=0.9)
    q = tg.make_graph_quadratic(torch.from_numpy(xs), torch.from_numpy(ys),
                                cfg.rho, topo)
    states = {lay: tg.graph_init_state(topo, 3, cfg, seed=seed, device="cpu")
              for lay in ("edge", "port")}
    tcs = {lay: tg.graph_consts(topo, lay, "cpu") for lay in states}
    for _ in range(3):
        u = [torch.rand((n, 3)) for _ in range(2)]
        states = {lay: tg.graph_step(s, q, cfg, topo, censor=cen,
                                     layout=lay, u=u, tc=tcs[lay])
                  for lay, s in states.items()}
        for f in ("theta", "theta_hat", "lam", "radius", "bits", "sent"):
            assert torch.equal(getattr(states["edge"], f),
                               getattr(states["port"], f)), (edges, f)


def test_graph_dual_update_edge_mask():
    topo = ttopo.ring_topology(4)
    tc = tg.graph_consts(topo, device="cpu")
    cfg = tg.GADMMConfig(rho=2.0, alpha=0.5)
    hat = torch.arange(8, dtype=torch.float32).reshape(4, 2)
    lam = torch.ones((topo.num_edges, 2))
    mask = torch.tensor([1.0, 0.0, 1.0, 0.0])
    out = tg.graph_dual_update(lam, hat, cfg, tc, edge_mask=mask)
    want = lam + cfg.alpha * cfg.rho * (hat[tc["e_head"]] - hat[tc["e_tail"]]) \
        * mask[:, None]
    assert torch.equal(out, want)
    assert torch.equal(out[1], lam[1])


# ---------------------------------------------------------------- f64 ------
def test_float64_raises(problem):
    xs, ys, _ = problem
    _, tc = cfgs()
    with pytest.raises(TypeError, match="item 11"):
        tg.make_quadratic(torch.from_numpy(xs).double(),
                          torch.from_numpy(ys).double(), tc.rho)
    z = torch.zeros((N, D), dtype=torch.float64)
    with pytest.raises(TypeError, match="item 11"):
        tg.quantize_rows(z, z, torch.ones(N, dtype=torch.bool),
                         torch.zeros((N, D)), torch.zeros(N),
                         torch.full((N,), 2, dtype=torch.int32), tc)
