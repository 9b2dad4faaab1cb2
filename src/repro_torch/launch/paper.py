"""The paper's own experiments on the card: Fig. 2 (linear regression) and
Fig. 4 (the DNN), the counterpart of ``examples/quickstart.py``,
``examples/decentralized_dnn.py`` and the curves of
``benchmarks/bench_linreg.py`` / ``bench_dnn.py``.

  PYTHONPATH=src python -m repro_torch.launch.paper linreg [--rounds 400]
  PYTHONPATH=src python -m repro_torch.launch.paper dnn [--rounds 40]

``linreg`` (the paper's N 50 workers, 20,000 samples, d 6, rho 24, 2 bits)
runs GADMM, Q-GADMM at 2 and 4 bits, GD, QGD and ADIANA, and prints
|F - F*| every ``--log-every`` rounds, the rounds to the relative target
|F - F*| <= REL_TARGET |F*|, the bits per round and the energy of the
paper's radio model (Sec. V-A).  ``--topology ring|star|torus2d`` (the
placement's graph) and ``--censor`` switch Q-GADMM to the graph step.
``dnn`` (the paper's 784-128-64-10 MLP, 10 workers of 600 samples, 8 bits,
rho 1, alpha 0.01, 10 local Adam steps at lr 3e-3, batch 100) runs Q-SGADMM and SGADMM and prints the consensus and worker-0
accuracy, the bits per round and the ms per round (host clock around a
round that ends in a device sync).

States are float32 (the JAX benchmark's linear regression runs in float64
under ``jax_enable_x64``; the port's float64 codec is ROADMAP Queue 1 item
11).  Every quantized round launches the codec (K1); each result row
carries the kernel launches of its run.  Runs on the card unless
``--device cpu``; matrix products in full float32 (TF32 off).
"""
import argparse
import json
import sys
import time

import numpy as np

# |F - F*| <= REL_TARGET * |F*|: the scale-free stand-in for the paper's
# 1e-4 absolute threshold (benchmarks/bench_linreg.py's REL_TARGET)
REL_TARGET = 1e-4
# Fig. 2: d 6, rho 24; Q-GADMM at 2 and 4 bits, QGD and ADIANA at 2
LINREG_DIM, LINREG_RHO, LINREG_BITS, QGADMM_BITS = 6, 24.0, 2, (2, 4)
# Fig. 4: 8 bits, rho 1, dual damping alpha 0.01, local Adam at lr 3e-3 on
# batches of 100
DNN_BITS, DNN_RHO, DNN_ALPHA, DNN_LR, DNN_BATCH = 8, 1.0, 0.01, 3e-3, 100


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    lin = sub.add_parser("linreg", help="paper Fig. 2: linear regression")
    lin.add_argument("--workers", type=int, default=50)
    lin.add_argument("--samples", type=int, default=20000)
    lin.add_argument("--rounds", type=int, default=600)
    lin.add_argument("--topology", default="chain",
                     choices=["chain", "ring", "star", "torus2d"],
                     help="Q-GADMM's graph (not chain: the graph step)")
    lin.add_argument("--censor", action="store_true",
                     help="CQ-GGADMM censoring (tau 0.05, xi 0.9; the "
                          "graph step)")
    lin.add_argument("--log-every", type=int, default=25)
    dnn = sub.add_parser("dnn", help="paper Fig. 4: the DNN")
    dnn.add_argument("--workers", type=int, default=10)
    dnn.add_argument("--samples", type=int, default=6000)
    dnn.add_argument("--local-iters", type=int, default=10)
    dnn.add_argument("--rounds", type=int, default=40)
    dnn.add_argument("--log-every", type=int, default=5)
    for p in (lin, dnn):
        p.add_argument("--seed", type=int, default=0,
                       help="seeds the data, the weights and the draws")
        p.add_argument("--device", default=None,
                       help="torch device (default: the CUDA card; 'cpu' "
                            "runs the kernels' plain versions)")
    return ap.parse_args(argv)


def _setup(args):
    import torch

    from repro_torch.device import resolve_device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = resolve_device(args.device)
    print(f"device: {dev}" + (f" ({torch.cuda.get_device_name(dev)})"
                              if dev.type == "cuda" else ""))
    return dev


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _launches_since(before: dict) -> dict:
    """The kernel launches made since the snapshot `before` (nonzero
    counts only)."""
    from repro_torch import kernels
    return {k: v - before[k] for k, v in kernels.LAUNCHES.items()
            if v != before[k]}


def _timed(dev, fn):
    """(result, ms per round, kernel launches of the run) of
    fn() -> (result, rounds); the clock ends after a device sync."""
    from repro_torch import kernels
    before = dict(kernels.LAUNCHES)
    _sync(dev)
    t0 = time.perf_counter()
    out, rounds = fn()
    _sync(dev)
    return (out, 1e3 * (time.perf_counter() - t0) / rounds,
            _launches_since(before))


def _rounds_to(losses: np.ndarray, target: float) -> float:
    """First 1-based round with loss <= target; inf when never reached."""
    hit = np.nonzero(losses <= target)[0]
    return float(hit[0]) + 1.0 if len(hit) else float("inf")


def run_linreg(args: argparse.Namespace) -> dict:
    """Fig. 2's runs; returns {"rows": [...], "curves": {alg: losses},
    "theta_star": ...}.  Each row: alg, rounds_to_target,
    bits_per_round (mean over the rounds), total bits and energy to the
    target, energy per round, the final max |theta - theta*|, ms per
    round (the run's steps, synced at its end; the objective is taken
    afterwards) and the kernel launches of the run."""
    import torch

    from repro_torch.core import comm_model as cm
    from repro_torch.core import gadmm
    from repro_torch.core.baselines import PSProblem, run_adiana, run_gd
    from repro_torch.core.censor import CensorConfig
    from repro_torch.core.quantizer import QuantizerConfig
    from repro_torch.core.topology import random_placement
    from repro_torch.data.synthetic import regression_shards

    dev = _setup(args)
    n, d, rounds = args.workers, LINREG_DIM, args.rounds
    xs_np, ys_np, _ = regression_shards(n, args.samples, d, args.seed,
                                        heterogeneous=False)
    xs = torch.from_numpy(xs_np).to(dev)
    ys = torch.from_numpy(ys_np).to(dev)
    xtx = torch.einsum("nmd,nme->nde", xs, xs)
    xty = torch.einsum("nmd,nm->nd", xs, ys)
    # the reference optimum in float64 (a metric, never a state)
    theta_star = torch.linalg.solve(xtx.sum(0).double(),
                                    xty.sum(0).double()).float()
    prob = PSProblem(xtx=xtx, xty=xty)
    fstar = float(prob.objective(theta_star))
    target = REL_TARGET * abs(fstar)
    scale = max(float(theta_star.abs().max()), 1.0)
    graph = args.topology != "chain" or args.censor
    placement = random_placement(n, seed=args.seed, topology=args.topology)
    topo = placement.resolved_topology()
    radio = cm.RadioConfig(n_workers=n)
    bd = placement.broadcast_dist()
    censor = CensorConfig() if args.censor else None
    print(f"linreg: N {n}, {args.samples} samples, d {d}, rho {LINREG_RHO}, "
          f"{rounds} rounds, |F*| {abs(fstar):.6g}, target |F - F*| <= "
          f"{target:.4g}; Q-GADMM on the "
          + (f"{args.topology} graph{' with censoring' if censor else ''}"
             if graph else "chain"))

    rows, curves = [], {}

    def record(alg, losses, bits_k, energy_k, err, ms, launches):
        r = _rounds_to(losses, target)
        hit = int(r) if np.isfinite(r) else None
        rows.append(dict(
            alg=alg, rounds_to_target=r,
            bits_per_round=float(np.mean(bits_k)),
            total_bits=float(np.sum(bits_k[:hit])) if hit else float("inf"),
            energy_per_round_J=float(np.mean(energy_k)),
            total_energy_J=(float(np.sum(energy_k[:hit])) if hit
                            else float("inf")),
            final_loss=float(losses[-1]), max_theta_err=err,
            ms_per_round=ms, launches=launches))
        curves[alg] = losses

    def chain_run(cfg):
        """(quadratic, thetas per round, sent masks or None); the
        quadratic's factorization is timed with the run."""
        q = gadmm.make_quadratic(xs, ys, cfg.rho)
        st = gadmm.init_state(n, d, cfg, seed=args.seed, device=dev)
        thetas = []
        for _ in range(rounds):
            st = gadmm.gadmm_step(st, q, cfg)
            thetas.append(st.theta)
        return (q, thetas, None), rounds

    def graph_run(cfg):
        q = gadmm.make_graph_quadratic(xs, ys, cfg.rho, topo)
        tc = gadmm.graph_consts(topo, device=dev)
        st = gadmm.graph_init_state(topo, d, cfg, seed=args.seed, device=dev)
        thetas, sent = [], []
        for _ in range(rounds):
            st = gadmm.graph_step(st, q, cfg, topo, censor=censor, tc=tc)
            thetas.append(st.theta)
            sent.append(st.sent)
        return (q, thetas, torch.stack(sent)), rounds

    def losses_of(q, thetas):
        """|F - F*| per round, outside the timed run."""
        f = torch.stack([q.objective(t) for t in thetas])
        return torch.abs(f - q.objective(theta_star.expand(n, d))
                         ).cpu().numpy()

    def theta_err(theta):
        return float((theta - theta_star).abs().max())

    gcfg = gadmm.GADMMConfig(rho=LINREG_RHO, quantize=False)
    # one untimed GADMM round first: the libraries' one-time costs of the
    # first work on the device stay out of the first timed run
    gadmm.gadmm_step(gadmm.init_state(n, d, gcfg, seed=args.seed, device=dev),
                     gadmm.make_quadratic(xs, ys, gcfg.rho), gcfg)
    _sync(dev)
    (q, thetas, _), ms, launches = _timed(dev, lambda: chain_run(gcfg))
    per = gadmm.bits_per_round(gcfg, n, d)
    e = cm.round_energy_decentralized(np.full(n, per / n), bd, radio)
    record("GADMM", losses_of(q, thetas), np.full(rounds, float(per)),
           np.full(rounds, e), theta_err(thetas[-1]), ms, launches)
    for b in QGADMM_BITS:
        qcfg = gadmm.GADMMConfig(rho=LINREG_RHO, quantize=True,
                                 qcfg=QuantizerConfig(bits=b))
        (q, thetas, sent), ms, launches = _timed(
            dev, lambda: (graph_run if graph else chain_run)(qcfg))
        per_worker = gadmm.bits_per_round(qcfg, 1, d)
        if sent is None:
            bits_k = np.full(rounds, float(gadmm.bits_per_round(qcfg, n, d)))
            energy_k = np.full(rounds, cm.round_energy_decentralized(
                np.full(n, float(per_worker)), bd, radio))
        else:
            sent_np = sent.cpu().numpy()
            bits_k = np.array([float(gadmm.graph_bits_per_round(
                qcfg, topo, d, s, censored=censor is not None))
                for s in sent])
            energy_k = np.array([cm.round_energy_topology(
                placement, per_worker, radio,
                sent=s if censor is not None else None) for s in sent_np])
        record(f"Q-GADMM-{b}b", losses_of(q, thetas), bits_k, energy_k,
               theta_err(thetas[-1]), ms, launches)
        if sent is not None:
            rows[-1]["sent_per_round"] = sent.sum(1).cpu().tolist()

    def ps(name, fn):
        (thetas, bpr), ms, launches = _timed(dev, lambda: (fn(), rounds))
        f = torch.stack([prob.objective(t) for t in thetas])
        e = cm.round_energy_ps((bpr - 32 * d) / n, placement.ps_dist,
                               32 * d, radio)
        record(name, torch.abs(f - fstar).cpu().numpy(),
               np.full(rounds, float(bpr)), np.full(rounds, e),
               theta_err(thetas[-1]), ms, launches)

    lr = 1.0 / prob.lipschitz()
    ps("GD", lambda: run_gd(prob, rounds, lr=lr))
    ps("QGD", lambda: run_gd(prob, rounds, lr=lr, quantize_bits=LINREG_BITS,
                             seed=args.seed))
    ps("ADIANA", lambda: run_adiana(prob, rounds, bits=LINREG_BITS,
                                    seed=args.seed))

    names = [r["alg"] for r in rows]
    print("|F - F*| by round:")
    print(f"{'round':>6s} " + " ".join(f"{a:>12s}" for a in names))
    for k in range(args.log_every, rounds + 1, args.log_every):
        print(f"{k:6d} " + " ".join(f"{curves[a][k - 1]:12.4e}"
                                     for a in names))
    for r in rows:
        print(f"{r['alg']:>12s}: rounds to target {r['rounds_to_target']}, "
              f"{r['bits_per_round']:.6g} bits/round, "
              f"{r['energy_per_round_J']:.4g} J/round, "
              f"to target {r['total_bits']:.4g} bits / "
              f"{r['total_energy_J']:.4g} J, max |theta - theta*| "
              f"{r['max_theta_err']:.3e}, {r['ms_per_round']:.3f} ms/round, "
              f"launches {r['launches']}")
    print(json.dumps({"linreg": {"device": str(dev), "rounds": rounds,
                                 "theta_star_scale": scale,
                                 "rows": rows}}))
    return {"rows": rows, "curves": curves, "theta_star": theta_star,
            "theta_star_scale": scale, "topology": topo}


def run_dnn(args: argparse.Namespace) -> dict:
    """Fig. 4's decentralized runs; returns {"rows": [...]} with, per
    algorithm, the final consensus / worker-0 accuracy, the accuracy curve
    at the logged rounds, the bits per round, the per-round ms and the
    kernel launches of the run."""
    import torch

    from repro_torch import kernels
    from repro_torch.core.gadmm import GADMMConfig
    from repro_torch.core.quantizer import QuantizerConfig
    from repro_torch.core.sgadmm import SGADMMConfig, SGADMMTrainer
    from repro_torch.data.synthetic import classification_shards
    from repro_torch.device import generator
    from repro_torch.models import mlp

    dev = _setup(args)
    n = args.workers
    xs_np, ys_np = classification_shards(n, args.samples, mlp.LAYERS[0][0],
                                         seed=args.seed)
    xs = torch.from_numpy(xs_np).to(dev)
    ys = torch.from_numpy(ys_np).to(dev)
    x_all, y_all = xs.reshape(-1, xs.shape[-1]), ys.reshape(-1)
    rows = []
    for name, quantize in (("Q-SGADMM", True), ("SGADMM", False)):
        cfg = SGADMMConfig(
            gadmm=GADMMConfig(rho=DNN_RHO, quantize=quantize,
                              qcfg=QuantizerConfig(bits=DNN_BITS),
                              alpha=DNN_ALPHA),
            local_iters=args.local_iters, local_lr=DNN_LR,
            batch_size=DNN_BATCH)
        tr = SGADMMTrainer(mlp.loss_fn,
                           mlp.init_params(generator(args.seed, dev)), n,
                           cfg, seed=args.seed, device=dev)
        print(f"{name}: {tr.d} params, {tr.bits_per_round()} bits/round "
              f"({n * 32 * tr.d} unquantized)")
        rng = np.random.default_rng(args.seed)
        before = dict(kernels.LAUNCHES)
        step_ms, curve = [], []
        for it in range(1, args.rounds + 1):
            sel = torch.from_numpy(
                rng.integers(0, xs.shape[1], size=(n, DNN_BATCH))).to(dev)
            xb = torch.take_along_dim(xs, sel[:, :, None], dim=1)
            yb = torch.take_along_dim(ys, sel, dim=1)
            _sync(dev)
            t0 = time.perf_counter()
            tr.train_step(xb, yb)
            _sync(dev)
            step_ms.append(1e3 * (time.perf_counter() - t0))
            if it % args.log_every == 0 or it in (1, args.rounds):
                acc = float(mlp.accuracy(tr.mean_params(), x_all, y_all))
                acc0 = float(mlp.accuracy(tr.worker_params(0), x_all, y_all))
                curve.append((it, acc, acc0))
                print(f"  round {it:3d}: acc(consensus)={acc:.3f} "
                      f"acc(worker0)={acc0:.3f} ({step_ms[-1]:.2f} ms)")
        launches = _launches_since(before)
        ms = sorted(step_ms[1:]) or step_ms
        rows.append(dict(alg=name, params=tr.d, acc=curve[-1][1],
                         acc_worker0=curve[-1][2], curve=curve,
                         bits_per_round=tr.bits_per_round(),
                         first_round_ms=step_ms[0],
                         median_round_ms=ms[len(ms) // 2],
                         launches=launches))
    for r in rows:
        print(f"{r['alg']:>9s}: acc {r['acc']:.3f} (worker 0 "
              f"{r['acc_worker0']:.3f}), {r['bits_per_round']} bits/round, "
              f"{r['median_round_ms']:.2f} ms/round median (first "
              f"{r['first_round_ms']:.1f} ms), launches {r['launches']}")
    print(json.dumps({"dnn": {"device": str(dev), "rounds": args.rounds,
                              "rows": rows}}))
    return {"rows": rows}


def main(argv=None):
    args = parse_args(argv)
    (run_linreg if args.cmd == "linreg" else run_dnn)(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
