"""End-to-end decentralized training launcher of the port (one GPU).

  PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-tiny \
      --workers 4 --bits 4 --steps 5

runs W workers of the full whisper-tiny on the card (the Q-SGADMM chain,
gauss-seidel, global radius, nibble-packed wire at <= 4 bits).  The JAX
launcher's flags, with the same names and defaults
(``repro/launch/train.py``), select the rest: ``--topology`` the graph
(the two-tier ``cluster_of_stars`` / ``federated`` included), ``--mode``
gauss-seidel or jacobi, ``--no-quantize`` full-precision GADMM,
``--staleness`` the pipelined exchange, ``--participation`` the per-round
Bernoulli rate, ``--censor`` (with ``--censor-tau`` / ``--censor-xi``),
``--layerwise`` (with ``--layerwise-period``) and ``--bit-budget`` (implies
``--layerwise``) the CQ-GGADMM / L-FGADMM wire.  ``--smoke --device cpu``
runs the same paths on whisper-tiny-smoke with the kernels' plain versions.
Prints the JAX launcher's step line.  With ``REPRO_CHECK=1`` (or
``DistConfig.check_invariants``) the live invariants of
``repro_torch.obs.checks`` run on every step of each log window.  float32
matmuls run in full float32 (TF32 off, set explicitly here).
"""
import argparse
import sys
import time


def parse_args(argv=None) -> argparse.Namespace:
    from repro_torch.core.topology import TOPOLOGY_KINDS

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="whisper-tiny")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--per-worker-batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--rho", type=float, default=1.0)
    ap.add_argument("--bits", type=int, default=8)
    ap.add_argument("--no-quantize", action="store_true")
    ap.add_argument("--local-iters", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--mode", default="gauss-seidel",
                    choices=["gauss-seidel", "jacobi"])
    ap.add_argument("--topology", default="chain",
                    choices=list(TOPOLOGY_KINDS),
                    help="worker graph (ring: even workers; torus2d: "
                         "workers %% 4 == 0)")
    ap.add_argument("--censor", action="store_true",
                    help="CQ-GGADMM censored transmissions")
    ap.add_argument("--censor-tau", type=float, default=0.05)
    ap.add_argument("--censor-xi", type=float, default=0.9)
    ap.add_argument("--staleness", type=int, default=0,
                    help="S>0 pipelines the exchange: compute runs against "
                         "S-round-old neighbor hats while S payload rounds "
                         "stay in flight")
    ap.add_argument("--participation", type=float, default=1.0,
                    help="per-round Bernoulli participation rate in (0, 1]; "
                         "<1 drops workers from random rounds with "
                         "degree-renormalized neighbor sums")
    ap.add_argument("--layerwise", action="store_true",
                    help="L-FGADMM per-leaf wire: large leaves transmit "
                         "every --layerwise-period rounds at per-leaf bit "
                         "widths")
    ap.add_argument("--layerwise-period", type=int, default=2,
                    help="exchange period of the large leaves (top "
                         "half of the model by parameter count)")
    ap.add_argument("--bit-budget", type=int, default=None, metavar="BITS",
                    help="adaptive per-leaf bit allocation under a fixed "
                         "sum(bits_l * d_l) payload budget per "
                         "transmission (implies --layerwise)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain versions)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the weights, the rounding draws and the data")
    return ap.parse_args(argv)


def setup(args: argparse.Namespace):
    """(trainer, state, batches) for the parsed CLI arguments; `batches` is
    an endless generator of the workers' (W, ...) batches."""
    import torch

    from repro_torch.core.censor import CensorConfig
    from repro_torch.core.gadmm import GADMMConfig
    from repro_torch.core.quantizer import LayerwiseConfig, QuantizerConfig
    from repro_torch.data.pipeline import ExtraInputs, LMShardLoader
    from repro_torch.device import resolve_device
    from repro_torch.dist.qgadmm import DistConfig, QGADMMTrainer, init_state
    from repro_torch.models import registry

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = resolve_device(args.device)
    print(f"device: {device}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else ""))

    cfg = registry.get_config(args.arch, smoke=args.smoke)
    model = registry.get_model(cfg)
    dcfg = DistConfig(
        num_workers=args.workers,
        gadmm=GADMMConfig(rho=args.rho, quantize=not args.no_quantize,
                          qcfg=QuantizerConfig(bits=args.bits), alpha=0.01),
        local_iters=args.local_iters, local_lr=args.lr, mode=args.mode,
        topology=args.topology, staleness=args.staleness,
        participation=args.participation,
        censor=(CensorConfig(tau=args.censor_tau, xi=args.censor_xi)
                if args.censor else None),
        layerwise=(LayerwiseConfig(large_leaf_period=args.layerwise_period,
                                   budget_bits=args.bit_budget)
                   if args.layerwise or args.bit_budget is not None
                   else None))
    trainer = QGADMMTrainer(model, cfg, dcfg, device=device)
    state = init_state(lambda g: model.init(g, cfg), args.seed, dcfg,
                       device=device)
    loader = LMShardLoader(args.workers, args.per_worker_batch, args.seq,
                           cfg.vocab, seed=args.seed)
    frames = ExtraInputs.frames(args.workers, args.per_worker_batch,
                                cfg.encoder_frames, cfg.d_model,
                                seed=args.seed)

    def batches():
        while True:
            yield dict(loader.next_batch(), frames=frames)

    return trainer, state, batches()


def run(args: argparse.Namespace):
    """Train as the CLI does; returns (trainer, state, log) with one
    (step, {metric: float}, seconds per step) entry per printed line."""
    from repro_torch.obs import checks

    trainer, state, batches = setup(args)
    check = checks.enabled(trainer.dcfg)

    log = []
    t0 = time.time()
    window = []
    for step in range(args.steps):
        state, metrics = trainer.step(state, next(batches))
        window.append((step, metrics))
        if (step + 1) % args.log_every == 0 or step + 1 == args.steps:
            recs = [{"step": k, "metrics": {
                n: float(v) if v.dim() == 0 else v.tolist()
                for n, v in ms.items()}}                # syncs the device
                for k, ms in window]
            dt = (time.time() - t0) / len(window)
            m = recs[-1]["metrics"]
            extra = (f" skip={m['skip_rate']:.2f} "
                     f"wire_bits={m['wire_bits_per_round']:.3g}"
                     if args.censor or trainer.dcfg.layerwise is not None
                     else "")
            print(f"step {step + 1}: loss={m['loss']:.4f} "
                  f"resid={m['consensus_resid']:.4f} "
                  f"R={m['radius_mean']:.5f}"
                  f"{extra} "
                  f"({dt:.2f}s/step)")
            log.append((step + 1, m, dt))
            if check:
                checks.check_step_window(trainer, state, recs)
                checks.check_edge_mirrors(trainer, state)
            t0, window = time.time(), []
    if check:
        print("REPRO_CHECK: wire accounting + edge mirrors OK")
    print("done")
    return trainer, state, log


def main(argv=None):
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
