"""End-to-end decentralized training launcher of the port (one GPU).

  PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-tiny \
      --workers 4 --bits 4 --steps 5

runs W workers of the full whisper-tiny on the card (the Q-SGADMM chain,
gauss-seidel, global radius, nibble-packed wire at <= 4 bits).  ``--smoke
--device cpu`` runs the same path on whisper-tiny-smoke with the kernels'
plain versions.  Prints the JAX launcher's step line
(``repro/launch/train.py``).  float32 matmuls run in full float32 (TF32
off, set explicitly here).
"""
import argparse
import sys
import time


def parse_args(argv=None) -> argparse.Namespace:
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
    ap.add_argument("--local-iters", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
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

    from repro_torch.core.gadmm import GADMMConfig
    from repro_torch.core.quantizer import QuantizerConfig
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
        gadmm=GADMMConfig(rho=args.rho, quantize=True,
                          qcfg=QuantizerConfig(bits=args.bits), alpha=0.01),
        local_iters=args.local_iters, local_lr=args.lr)
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
    trainer, state, batches = setup(args)

    log = []
    t0 = time.time()
    window = 0
    for step in range(args.steps):
        state, metrics = trainer.step(state, next(batches))
        window += 1
        if (step + 1) % args.log_every == 0 or step + 1 == args.steps:
            m = {k: float(v) for k, v in metrics.items()}  # syncs the device
            dt = time.time() - t0
            print(f"step {step + 1}: loss={m['loss']:.4f} "
                  f"resid={m['consensus_resid']:.4f} "
                  f"R={m['radius_mean']:.5f} "
                  f"({dt / window:.2f}s/step)")
            log.append((step + 1, m, dt / window))
            t0, window = time.time(), 0
    print("done")
    return trainer, state, log


def main(argv=None):
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
