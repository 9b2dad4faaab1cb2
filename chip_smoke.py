#!/usr/bin/env python3
"""Chip smoke of the PyTorch / CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:
  1. print the card (``nvidia-smi`` name and power limit); build every CUDA
     source with nvcc (in parallel) and print its registers and spills;
  2. hold each kernel against its plain PyTorch version on the card, at the
     trainer's shapes (whisper-tiny, W = 4 rows of D = 56,355,840) and at
     ragged sizes: levels, hats and packed bytes must be bitwise equal;
  3. check the trainer against the same trainer on the CPU (plain versions)
     on a small input (whisper-tiny-smoke, 2 steps, shared draws);
  4. drive the main path through the CLI's entry point, with every launch
     count at 0 just before: full whisper-tiny, W = 4 workers, 4-bit packed
     wire, 5 steps; require finite metrics, sender == receiver bit-sync on
     every edge, and 2 launches per step of the codec, pack4 and unpack4;
  5. time each kernel (CUDA events) beside its plain version and its bound,
     and print one JSON line listing them.
The last line is ``{"ok": true, "device": {...}}``.  Needs one CUDA card; it
imports nothing of JAX and nothing of the JAX package.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
W, STEPS, BITS = 4, 5, 4
CHAIN_SRC = [1, 0, 2, 1, 3, 2]   # source worker of each directed chain edge
CODECS = (("row", "quantize_dequantize"),
          ("vec_r", "quantize_dequantize_vec_r"),
          ("vec_rl", "quantize_dequantize_vec_rl"))


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bitwise_equal(a, b) -> bool:
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.is_floating_point:
        a = a.view(torch.int16 if a.element_size() == 2 else torch.int32)
        b = b.view(torch.int16 if b.element_size() == 2 else torch.int32)
    return bool(torch.equal(a, b))


def max_abs_err(pairs) -> float:
    return max(float((a.float() - b.float()).abs().max()) if a.numel() else 0.0
               for a, b in pairs)


def codec_inputs(rows, n, dtype, seed):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    theta = (0.05 * torch.randn((rows, n), generator=g, device="cuda")).to(dtype)
    hat = (0.05 * torch.randn((rows, n), generator=g, device="cuda")).to(dtype)
    u = torch.rand((rows, n), generator=g, device="cuda")
    r = (theta.float() - hat.float()).abs().amax(dim=1)
    return theta, hat, u, r


def codec_case(mode, rows, n, dtype, seed):
    """Inputs of one codec variant: per-row R and levels ("row"), per-element
    R with an R == 0 segment ("vec_r"), or per-element R and levels
    ("vec_rl").  Returns the kernel's arguments and the plain version's
    broadcast radius / levels."""
    import torch
    theta, hat, u, r = codec_inputs(rows, n, dtype, seed)
    lv = torch.full((rows,), 2.0 ** BITS - 1.0, device="cuda")
    if mode != "row":
        r = r[:, None].expand(rows, n).contiguous()
        r[0, : n // 5] = 0.0
    if mode == "vec_rl":
        lv = lv[:, None].expand(rows, n).contiguous()
        lv[:, n // 2:] = 3.0
    rb = r if mode != "row" else r[:, None]
    lb = lv if mode == "vec_rl" else lv[:, None]
    return theta, hat, u, r, lv, rb, lb


def check_codec(q_ops, mode, rows, n, dtype, seed) -> float:
    """Kernel vs plain version, bitwise, and the receiver's decode."""
    import torch
    theta, hat, u, r, lv, rb, lb = codec_case(mode, rows, n, dtype, seed)
    q, h = q_ops.quantize_dequantize(theta, hat, u, r, lv)
    q_ref, h_ref = q_ops.quantize_dequantize_ref(theta, hat, u, rb, lb)
    torch.cuda.synchronize()
    tag = f"codec {mode} {tuple(theta.shape)} {dtype}"
    e = max_abs_err([(q, q_ref), (h, h_ref)])
    if not (bitwise_equal(q, q_ref) and bitwise_equal(h, h_ref)):
        fail(f"{tag}: kernel != plain (max abs err {e})")
    if not bitwise_equal(q_ops.decode_ref(hat, q, rb, lb), h):
        fail(f"{tag}: receiver decode != sender hat")
    print(f"  {tag}: bitwise equal")
    return e


def pack_case(d):
    """The path's pack / unpack inputs: W rows of 4-bit levels, and their
    packed rows gathered by the chain's directed-edge sources (2E = 6)."""
    import torch
    from repro_torch.kernels.pack import ops as pack_ops
    g = torch.Generator(device="cuda").manual_seed(5)
    q = torch.randint(0, 16, (W, d), generator=g, device="cuda",
                      dtype=torch.uint8)
    return q, pack_ops.pack4_ref(q)[CHAIN_SRC]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a CUDA card")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"the port's sources are not at {ROOT / 'src' / 'repro_torch'}")
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch import kernels
    from repro_torch.configs import whisper_tiny
    from repro_torch.kernels import build
    from repro_torch.kernels.pack import ops as pack_ops
    from repro_torch.kernels.quantize import ops as q_ops
    from repro_torch.models.config import num_params

    # ---- 1. card and build ---------------------------------------------
    print(smi_line())
    t0 = time.time()
    logs = build.build_logs()
    print(f"built {sorted(logs)} in {time.time() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "Compiling entry" in line or "registers" in line \
                    or "spill" in line:
                print(f"  [{name}] {line.strip()}")

    # ---- 2. kernels vs plain versions -----------------------------------
    d = num_params(whisper_tiny.config())
    err = {}
    for mode, name in CODECS:
        err[name] = max(check_codec(q_ops, mode, rows, n, dtype, 11)
                        for dtype in (torch.float32, torch.bfloat16)
                        for rows, n in ((W, d), (3, 33_001), (1, 129)))
        torch.cuda.empty_cache()
    plen = pack_ops.packed_len(d)
    q_path, recv = pack_case(d)
    pk = pack_ops.pack4(q_path)
    pk_ref = pack_ops.pack4_ref(q_path)
    un = pack_ops.unpack4(recv, d)
    un_ref = pack_ops.unpack4_ref(recv, d)
    torch.cuda.synchronize()
    if not bitwise_equal(pk, pk_ref) or not bitwise_equal(pk[CHAIN_SRC], recv):
        fail("pack4 kernel != plain")
    if not (bitwise_equal(un, un_ref) and bitwise_equal(un, q_path[CHAIN_SRC])):
        fail("unpack4 kernel != plain, or the round trip lost levels")
    g = torch.Generator(device="cuda").manual_seed(6)
    for n in (1, 129, 255, 256, 257, 33_001):
        qs = torch.randint(0, 16, (3, n), generator=g, device="cuda",
                           dtype=torch.uint8)
        p = pack_ops.pack4(qs)
        if not (bitwise_equal(p, pack_ops.pack4_ref(qs))
                and bitwise_equal(pack_ops.unpack4(p, n), qs)):
            fail(f"pack/unpack at n={n} != plain")
    err["pack4"] = max_abs_err([(pk, pk_ref)])
    err["unpack4"] = max_abs_err([(un, un_ref)])
    print(f"  pack4 {tuple(q_path.shape)} / unpack4 {tuple(recv.shape)} and "
          "ragged n: byte-identical, round trip exact")
    del q_path, recv, pk, pk_ref, un, un_ref
    torch.cuda.empty_cache()

    # ---- 3. trainer on the card vs on the CPU, small input ---------------
    check_small_trainer()

    # ---- 4. the main path, counted --------------------------------------
    from repro_torch.launch import train
    args = train.parse_args(["--arch", "whisper-tiny", "--workers", str(W),
                             "--bits", str(BITS), "--steps", str(STEPS),
                             "--log-every", "1"])
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    trainer, state, log = train.run(args)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    print(f"launches on the main path: {launches}")
    want = {"quantize_dequantize": 2 * STEPS, "pack4": 2 * STEPS,
            "unpack4": 2 * STEPS}
    for k, v in want.items():
        if launches[k] != v:
            fail(f"{k} launched {launches[k]} times on the main path, "
                 f"expected {v}")
    if state.layout.size != d:
        fail(f"whisper-tiny has {state.layout.size} parameters, not {d}")
    for step, m, _ in log:
        for k in ("loss", "consensus_resid", "radius_mean"):
            if not torch.isfinite(torch.tensor(m[k])):
                fail(f"step {step}: {k} = {m[k]}")
    if not trainer.bit_sync(state):
        fail("hat_edge is not bitwise the sender's theta_hat")
    print("  metrics finite; hat_edge bitwise == theta_hat[src] on all "
          f"{trainer.eidx.num_directed} directed edges")
    step_s = sorted(s for _, _, s in log[1:])
    trainer_line = {"trainer": {
        "arch": "whisper-tiny", "workers": W, "bits": BITS, "steps": STEPS,
        "params_per_worker": d, "first_step_s": log[0][2],
        "median_step_s": step_s[len(step_s) // 2],
        "max_memory_allocated_bytes": peak,
        "loss_first": log[0][1]["loss"], "loss_last": log[-1][1]["loss"]}}
    print(json.dumps(trainer_line))
    del state, trainer
    torch.cuda.empty_cache()

    # ---- 5. timing -------------------------------------------------------
    rows = []

    def entry(name, source, replaces, fn, plain, nbytes, iters=20):
        ms = time_ms(fn, iters)
        plain_ms = time_ms(plain, 3, warmup=1)
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                     "bound_by": "bytes", "library_ms": None})

    qsrc = "src/repro_torch/csrc/quantize.cu"
    qrep = "src/repro/kernels/quantize/quantize.py:"
    n_el = W * d
    per_el = {"quantize_dequantize": 17, "quantize_dequantize_vec_r": 21,
              "quantize_dequantize_vec_rl": 25}
    lines = {"quantize_dequantize": "144", "quantize_dequantize_vec_r": "155",
             "quantize_dequantize_vec_rl": "130"}
    for mode, name in CODECS:
        theta, hat, u, r, lv, rb, lb = codec_case(mode, W, d, torch.float32,
                                                  11)
        entry(name, qsrc, qrep + lines[name],
              lambda: q_ops.quantize_dequantize(theta, hat, u, r, lv),
              lambda: q_ops.quantize_dequantize_ref(theta, hat, u, rb, lb),
              n_el * per_el[name] + (8 * W if name == "quantize_dequantize"
                                     else 0))
        del theta, hat, u, r, lv, rb, lb
        torch.cuda.empty_cache()
    q_path, recv = pack_case(d)
    psrc = "src/repro_torch/csrc/pack.cu"
    entry("pack4", psrc, "src/repro/kernels/pack/pack.py:46",
          lambda: pack_ops.pack4(q_path), lambda: pack_ops.pack4_ref(q_path),
          W * d + W * plen)
    entry("unpack4", psrc, "src/repro/kernels/pack/pack.py:64",
          lambda: pack_ops.unpack4(recv, d),
          lambda: pack_ops.unpack4_ref(recv, d),
          recv.shape[0] * (plen + d))
    for r in rows:
        print(f"  {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.3f} ms, "
              f"bound {r['bound_ms']:.4f} ms by bytes, reckoned), "
              f"{r['launches']} launches on the main path")
    print(json.dumps({"kernels": rows}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def check_small_trainer():
    """whisper-tiny-smoke, 2 steps, on the card (kernels) and on the CPU
    (plain versions) from the same init, batches and draws: metrics rtol
    1e-3, and theta within 1e-4 at all but 1e-3 of the positions (matmul
    sums differ between the two devices; Adam's first steps amplify a tiny
    difference where the gradient is ~0)."""
    import numpy as np
    import torch

    from repro_torch.configs import whisper_tiny
    from repro_torch.core.gadmm import GADMMConfig
    from repro_torch.core.quantizer import QuantizerConfig
    from repro_torch.data.pipeline import ExtraInputs, LMShardLoader
    from repro_torch.dist.qgadmm import DistConfig, QGADMMTrainer, init_state
    from repro_torch.models import encdec

    cfg = whisper_tiny.smoke_config()
    dcfg = DistConfig(num_workers=W, gadmm=GADMMConfig(
        rho=1.0, qcfg=QuantizerConfig(bits=BITS), alpha=0.01))
    sides = {}
    for dev in ("cpu", "cuda"):
        tr = QGADMMTrainer(encdec, cfg, dcfg, device=dev)
        st = init_state(lambda g: encdec.init(g, cfg), 0, dcfg, device=dev)
        sides[dev] = (tr, st)
    st_cpu = sides["cpu"][1]
    sides["cuda"][1].theta.copy_(st_cpu.theta)     # same init on both
    loader = LMShardLoader(W, 2, 16, cfg.vocab)
    frames = ExtraInputs.frames(W, 2, cfg.encoder_frames, cfg.d_model)
    rng = np.random.default_rng(0)
    for k in range(2):
        batch = dict(loader.next_batch(), frames=frames)
        u = [rng.random((W, st_cpu.layout.size), dtype=np.float32)
             for _ in range(2)]
        out = {dev: tr.step(st, batch, u=u)[1] for dev, (tr, st)
               in sides.items()}
        for name in ("loss", "consensus_resid", "radius_mean"):
            a, b = float(out["cpu"][name]), float(out["cuda"][name])
            if not abs(a - b) <= 1e-3 * abs(a):
                fail(f"small trainer step {k}: {name} cuda {b} vs cpu {a}")
        th = (sides["cuda"][1].theta.cpu() - st_cpu.theta).abs()
        frac = float((th > 1e-4).float().mean())
        if frac > 1e-3:
            fail(f"small trainer step {k}: theta differs at {frac:.2e}")
        for dev, (tr, st) in sides.items():
            if not tr.bit_sync(st):
                fail(f"small trainer on {dev}: sender/receiver desync")
    print("  small trainer (whisper-tiny-smoke, 2 steps): card == CPU within "
          "tolerance, bit-synced on both")


if __name__ == "__main__":
    sys.exit(main())
