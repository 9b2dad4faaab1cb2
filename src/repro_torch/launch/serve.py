"""Serving launcher of the port: batched prefill + greedy decode on one GPU.

  PYTHONPATH=src python -m repro_torch.launch.serve --full --batch 4 \
      --prompt-len 1024 1000 --gen-len 32

serves mamba2-2.7b at its published widths on the card: random float32
weights from seed 0, one request batch of ``--batch`` random prompts per
``--prompt-len`` value, each prefilled (the chunked SSD scan, K6 once per
layer) and then decoded greedily for ``--gen-len`` tokens.  Counterpart of
``repro/launch/serve.py``, with its flags and defaults (``--smoke`` by
default; ``--full`` / ``--no-smoke`` for the published widths) except the
XLA-only ``--devices``; ``--device cpu`` runs the kernels' plain versions.
Prints the prefill time, the decode rate and the peak device memory.
float32 matmuls run in full float32 (TF32 off, set explicitly here).
"""
import argparse
import sys
import time


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-2.7b")
    ap.add_argument("--smoke", default=True,
                    action=argparse.BooleanOptionalAction)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, nargs="+", default=[32],
                    help="one request batch per value, served in turn")
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain versions)")
    return ap.parse_args(argv)


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_request(server, params, tokens, gen_len: int) -> dict:
    """Prefill `tokens` (B, S), then `gen_len` greedy decode steps.  Returns
    the prefill logits (B, vocab), the decode logits (gen_len, B, vocab), the
    generated tokens (B, gen_len + 1: the prefill's argmax, then each
    step's), the prefill seconds and the seconds of each decode step."""
    import torch
    dev = server.device
    _sync(dev)
    t0 = time.time()
    logits, cache = server.prefill(params, {"tokens": tokens})
    tok = torch.argmax(logits, dim=-1)
    _sync(dev)
    prefill_s = time.time() - t0
    gen, step_logits, step_s = [tok], [], []
    s = tokens.shape[1]
    for i in range(gen_len):
        t0 = time.time()
        pos = torch.full((tokens.shape[0],), s + i, dtype=torch.int32,
                         device=dev)
        lg, cache = server.decode(params, tok, cache, pos)
        tok = torch.argmax(lg, dim=-1)
        _sync(dev)
        step_s.append(time.time() - t0)
        gen.append(tok)
        step_logits.append(lg)
    return {"prefill_logits": logits,
            "decode_logits": (torch.stack(step_logits) if step_logits
                              else logits.new_zeros((0, *logits.shape))),
            "tokens": torch.stack(gen, dim=1), "prefill_s": prefill_s,
            "decode_s": step_s}


def setup(args: argparse.Namespace):
    """(server, params) for the parsed CLI arguments: the model's random
    weights from seed 0 on the device, TF32 off."""
    import torch

    from repro_torch.device import generator, resolve_device
    from repro_torch.dist.serve import Server
    from repro_torch.models import registry
    from repro_torch.models.config import num_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = resolve_device(args.device)
    cfg = registry.get_config(args.arch, smoke=args.smoke)
    model = registry.get_model(cfg)
    server = Server(model=model, cfg=cfg, batch_size=args.batch,
                    device=device)
    print(f"device: {device}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else "")
          + f"; {cfg.name}: {num_params(cfg):,} parameters")
    return server, model.init(generator(0, device), cfg)


def prompts(args: argparse.Namespace, server, i: int):
    """Request batch i: (batch, prompt_len[i]) random tokens from seed 1 + i."""
    import numpy as np
    import torch
    rng = np.random.default_rng(1 + i)
    return torch.from_numpy(rng.integers(
        0, server.cfg.vocab, (args.batch, args.prompt_len[i]))).to(server.device)


def run(args: argparse.Namespace) -> dict:
    """Serve as the CLI does; returns {"cfg", "params", "server",
    "requests": [(prompt tokens, serve_request's dict) per batch]}."""
    import torch

    server, params = setup(args)
    device = server.device
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    requests = []
    for i, plen in enumerate(args.prompt_len):
        tokens = prompts(args, server, i)
        out = serve_request(server, params, tokens, args.gen_len)
        dec = out["decode_s"]
        rate = (f"({args.batch * len(dec) / sum(dec):.1f} tok/s, "
                f"{1e3 * sorted(dec)[len(dec) // 2]:.2f} ms/step median)"
                if dec else "")
        print(f"request {i}: prefill({plen}) x {args.batch} in "
              f"{out['prefill_s']:.3f}s; decoded {len(dec)} steps x "
              f"{args.batch} seqs in {sum(dec):.3f}s {rate}")
        requests.append((tokens, out))
    if device.type == "cuda":
        print(f"max_memory_allocated: "
              f"{torch.cuda.max_memory_allocated(device):,} B")
    return {"cfg": server.cfg, "params": params, "server": server,
            "requests": requests}


def main(argv=None):
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
