"""Where a training step's or a served request's time goes on the card.

  PYTHONPATH=src python -m repro_torch.launch.profile --arch whisper-tiny \
      --workers 4 --bits 4 [--warmup 2] [--profile-steps 3] [--trace PATH]
  PYTHONPATH=src python -m repro_torch.launch.profile --serve --full \
      --batch 4 --prompt-len 1024 [--profile-steps 8] [--trace PATH]

Training: builds the training CLI's run (``launch.train.setup``; every other
flag is the training CLI's), runs ``--warmup`` steps, then
``--profile-steps`` steps under ``torch.profiler``.  Serving (``--serve``;
every other flag is the serving CLI's): one warm-up request, then one
prefill of the first ``--prompt-len`` and ``--profile-steps`` decode steps,
unprofiled and then profiled, each phase on its own (the trace is the decode
steps'); it also prints the weights' memory and the peak of each phase.
Prints the device time per step (or per prefill) of every kernel, grouped
into the port's kernels, matrix products and the rest, and one JSON line.
The wall time comes from the unprofiled run (host clock, ending in a device
sync), since tracing slows the host; the idle share is 1 - kernel time /
that wall time (one stream, so kernels do not overlap).  Needs the card: it
refuses to profile the CPU.
"""
import argparse
import json
import sys
import time

_GEMM_TAGS = ("gemm", "Gemm", "cutlass", "xmma", "cublas")


def _group(name: str) -> str:
    for tag, group in (("qdq_kernel", "codec"), ("unpack4_kernel", "unpack4"),
                       ("pack4_kernel", "pack4"), ("ssd_intra_kernel", "ssd")):
        if tag in name:
            return group
    if any(t in name for t in _GEMM_TAGS):
        return "matmul"
    return "other"


def _device_time(fn, n: int):
    """Run fn() under torch.profiler; returns ([(ms per n, launches per n,
    kernel name)] of the device-side events, largest first; the profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = []
    for e in prof.key_averages():
        # device-side events only: a CPU op's entry repeats its kernels' time
        if str(e.device_type).endswith("CUDA"):
            us = getattr(e, "self_device_time_total", 0) or 0
            kernels.append((us / 1e3 / n, e.count / n, e.key))
    kernels.sort(reverse=True)
    if sum(k[0] for k in kernels) <= 0:
        raise SystemExit("profile: the trace holds no device time")
    return kernels, prof


def _report(label: str, wall_ms: float, kernels: list) -> dict:
    """Print the breakdown of one phase; return its JSON entry."""
    busy_ms = sum(k[0] for k in kernels)
    groups: dict = {}
    for ms, _, name in kernels:
        g = _group(name)
        groups[g] = groups.get(g, 0.0) + ms
    print(f"{label} {wall_ms:.2f} ms wall (unprofiled); kernels "
          f"{busy_ms:.2f} ms ({busy_ms / wall_ms:.1%}), "
          f"idle {1 - busy_ms / wall_ms:.1%}")
    for g, ms in sorted(groups.items(), key=lambda x: -x[1]):
        print(f"  {g:8s} {ms:9.3f} ms ({ms / busy_ms:.1%} of busy)")
    print(f"top kernels (ms, launches per {label}):")
    for ms, cnt, name in kernels[:15]:
        print(f"  {ms:9.3f}  {cnt:6.1f}  {name[:110]}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / wall_ms, "groups_ms": groups,
            "top": [{"name": k[2], "ms": k[0], "launches": k[1]}
                    for k in kernels[:15]]}


def profile_trainer(trainer, state, batches, warmup: int, n: int):
    """`warmup` steps, then `n` steps timed (host clock, synced) and `n`
    more under torch.profiler; prints the breakdown and returns (its JSON
    entry, the profiler).  Also used by ``chip_smoke.py`` for the trainer
    paths the CLI does not reach."""
    import torch

    if trainer.device.type != "cuda":
        raise SystemExit("profile: device time exists only on the card")
    for _ in range(warmup):
        state, _ = trainer.step(state, next(batches))
    work = [next(batches) for _ in range(2 * n)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in work[:n]:
        state, metrics = trainer.step(state, b)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    def steps():
        nonlocal state, metrics
        for b in work[n:]:
            state, metrics = trainer.step(state, b)

    kernels, prof = _device_time(steps, n)
    out = {"device": torch.cuda.get_device_name(trainer.device), "steps": n,
           **_report("step", wall * 1e3 / n, kernels),
           "loss": float(metrics["loss"])}
    out["step_ms"] = out["wall_ms"]
    return out, prof


def _train(args, rest):
    from repro_torch.launch import train

    return profile_trainer(*train.setup(train.parse_args(rest)),
                           args.warmup, args.profile_steps)


def _serve(args, rest):
    import torch

    from repro_torch.launch import serve

    sargs = serve.parse_args(rest)
    server, params = serve.setup(sargs)
    if server.device.type != "cuda":
        raise SystemExit("profile: device time exists only on the card")
    tokens = serve.prompts(sargs, server, 0)
    n = args.profile_steps
    serve.serve_request(server, params, tokens, 2)            # warm-up
    dev = server.device
    weights = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    logits, cache = server.prefill(params, {"tokens": tokens})
    torch.cuda.synchronize(dev)
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    peak_prefill = torch.cuda.max_memory_allocated(dev)
    tok = torch.argmax(logits, dim=-1)
    pos = torch.full_like(tok, tokens.shape[1])
    torch.cuda.reset_peak_memory_stats(dev)
    step_s = []
    c = cache
    for _ in range(n):
        t0 = time.perf_counter()
        _, c = server.decode(params, tok, c, pos)
        torch.cuda.synchronize(dev)
        step_s.append(time.perf_counter() - t0)
    peak_decode = torch.cuda.max_memory_allocated(dev)
    del c
    step_ms = 1e3 * sorted(step_s)[n // 2]

    def decode():
        c = cache
        for _ in range(n):
            _, c = server.decode(params, tok, c, pos)

    pre, _ = _device_time(lambda: server.prefill(
        params, {"tokens": tokens}), 1)
    dec, prof = _device_time(decode, n)
    print(f"memory: weights {weights:,} B; peak in prefill "
          f"{peak_prefill:,} B, in a decode step {peak_decode:,} B")
    return {"device": torch.cuda.get_device_name(server.device),
            "arch": server.cfg.name, "batch": sargs.batch,
            "prompt_len": tokens.shape[1], "decode_steps": n,
            "weights_bytes": weights, "peak_prefill_bytes": peak_prefill,
            "peak_decode_bytes": peak_decode,
            "prefill": _report("prefill", prefill_ms, pre),
            "decode_step": _report("decode_step", step_ms, dec)}, prof


def main(argv=None):
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--serve", action="store_true",
                    help="profile the serving path (launch/serve.py's flags)")
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--profile-steps", type=int, default=3)
    ap.add_argument("--trace", default=None,
                    help="also write a Chrome trace (Perfetto) here")
    args, rest = ap.parse_known_args(argv)
    out, prof = (_serve if args.serve else _train)(args, rest)
    if args.trace:
        prof.export_chrome_trace(args.trace)
        print(f"wrote {args.trace}")
    print(json.dumps({"profile": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
