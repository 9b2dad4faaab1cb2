"""Where a training step's time goes on the card.

  PYTHONPATH=src python -m repro_torch.launch.profile --arch whisper-tiny \
      --workers 4 --bits 4 [--warmup 2] [--profile-steps 3] [--trace PATH]

Builds the training CLI's run (``launch.train.setup``; every other flag is
the training CLI's), runs ``--warmup`` steps, then ``--profile-steps`` steps
under ``torch.profiler``.  Prints the device time per step of every kernel,
grouped into the port's wire kernels, matrix products and the rest, and one
JSON line.  The wall time per step comes from as many unprofiled steps
(host clock, ending in a device sync), since tracing slows the host; the
idle share is 1 - kernel time / that wall time (one stream, so kernels do not
overlap).  Needs the card: it refuses to profile the CPU.
"""
import argparse
import json
import sys
import time

_GEMM_TAGS = ("gemm", "Gemm", "cutlass", "xmma", "cublas")


def _group(name: str) -> str:
    for tag, group in (("qdq_kernel", "codec"), ("unpack4_kernel", "unpack4"),
                       ("pack4_kernel", "pack4")):
        if tag in name:
            return group
    if any(t in name for t in _GEMM_TAGS):
        return "matmul"
    return "other"


def main(argv=None):
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--profile-steps", type=int, default=3)
    ap.add_argument("--trace", default=None,
                    help="also write a Chrome trace (Perfetto) here")
    args, rest = ap.parse_known_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import train

    trainer, state, batches = train.setup(train.parse_args(rest))
    if trainer.device.type != "cuda":
        raise SystemExit("profile: device time exists only on the card")
    for _ in range(args.warmup):
        state, _ = trainer.step(state, next(batches))
    n = args.profile_steps
    work = [next(batches) for _ in range(2 * n)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in work[:n]:
        state, metrics = trainer.step(state, b)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for b in work[n:]:
            state, metrics = trainer.step(state, b)
        torch.cuda.synchronize()
    kernels = []
    for e in prof.key_averages():
        # device-side events only: a CPU op's entry repeats its kernels' time
        if str(e.device_type).endswith("CUDA"):
            us = getattr(e, "self_device_time_total", 0) or 0
            kernels.append((us / 1e3 / n, e.count / n, e.key))
    kernels.sort(reverse=True)
    busy_ms = sum(k[0] for k in kernels)
    if busy_ms <= 0:
        raise SystemExit("profile: the trace holds no device time")
    step_ms = wall * 1e3 / n
    groups: dict = {}
    for ms, _, name in kernels:
        g = _group(name)
        groups[g] = groups.get(g, 0.0) + ms
    print(f"step {step_ms:.2f} ms wall (unprofiled); kernels {busy_ms:.2f} ms "
          f"({busy_ms / step_ms:.1%}), idle {1 - busy_ms / step_ms:.1%}")
    for g, ms in sorted(groups.items(), key=lambda x: -x[1]):
        print(f"  {g:8s} {ms:9.3f} ms/step ({ms / busy_ms:.1%} of busy)")
    print("top kernels (ms/step, launches/step):")
    for ms, cnt, name in kernels[:15]:
        print(f"  {ms:9.3f}  {cnt:6.1f}  {name[:110]}")
    if args.trace:
        prof.export_chrome_trace(args.trace)
        print(f"wrote {args.trace}")
    print(json.dumps({"profile": {
        "device": torch.cuda.get_device_name(trainer.device),
        "steps": n, "step_ms": step_ms, "device_busy_ms": busy_ms,
        "idle_share": 1 - busy_ms / step_ms, "groups_ms": groups,
        "top": [{"name": k[2], "ms": k[0], "launches": k[1]}
                for k in kernels[:15]],
        "loss": float(metrics["loss"])}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
