#!/usr/bin/env python3
"""Chip smoke of the PyTorch / CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:
  1. print the card (``nvidia-smi`` name and power limit); build every CUDA
     source with nvcc (in parallel) and print its registers and spills;
  2. hold each wire kernel against its plain PyTorch version on the card, at
     the trainer's shapes (whisper-tiny, W = 4 rows of D = 56,355,840) and at
     ragged sizes, unpack4 also at rows that start off 16-byte alignment,
     and the codec (K1) at the shapes and widths of paths 5-7 (50 x 6 at 2
     and 4 bits, 50 x 6 at 2 bits from a zero hat, 10 x 109,386 at 8 bits,
     each with an R = 0 row; timed there too): levels, hats and packed
     bytes must be bitwise equal, and the receiver's decode equal to the
     sender's hat; and ``pack_mixed`` / ``unpack_mixed`` (pack4 / unpack4
     once per <= 4-bit segment) bitwise against their plain versions on
     the framings of tests/test_kernels.py and on whisper-tiny's 25 leaves
     at 2, 4 and 8 bits;
  2b. hold the SSD kernel (K6) against its plain version at the serving
     shape (BC 16, Q 256, H 80, P 64, N 128), at ragged shapes (Q 8, 32,
     200; H 5, 80; N = P = 16), at the longest chunk (Q 768), at uneven
     tiles past 256 keys (Q 300), at H = 13 (not a multiple of the head
     group) and under a steep decay (la falling by 200 per step), float32
     and bfloat16 inputs, to max |kernel - plain| <= 1e-5 max |plain|
     (3xTF32 products on the tensor cores, sums in another order); and one
     two-group ``ssd_scan`` on the card against the CPU's;
  3. check the trainer against the same trainer on the CPU (plain versions)
     on a small input (whisper-tiny-smoke, 2 steps, 3 under staleness,
     shared draws and participation masks), in each quantizer mode and
     option: global 4-bit, per_tensor, layerwise with per-leaf periods and
     thresholds, layerwise with a bit budget, censoring (with a tau that
     censors the tails in step 2), jacobi, overlap, staleness 1 with
     censoring, staleness 2 with layerwise, participation 0.5 (ring; ring
     with staleness 1; chain with censoring), quantize=False, microbatches
     2, a bf16 state, cluster_of_stars and federated: widths, sent masks,
     skip rates and wire bits exact;
  3b. serve mamba2-smoke on the card against the same server on the CPU
     (B = 2, prompt 20: three chunks of 8, the last padded; then 4
     teacher-forced decode steps): logits and caches to rtol 1e-4 / atol
     1e-5, TF32 off;
  3c. the paper's chain and graph Q-GADMM (N 20, d 6, ring with censoring)
     and Q-SGADMM (MLP 32-24-10, N 6) on the card against the same steps
     on the CPU, with the same draws: chain and graph widths and sent
     masks equal, theta, hats and radii to atol 1e-5, duals to the sum
     over the steps of 2 alpha rho max |hat difference| + 1e-6 max |lam|;
     SGADMM theta within 1e-4 at all but 1e-3 of the positions; two codec
     launches per quantized step; then 40 rounds of Q-SGADMM and SGADMM on
     that MLP on the card, where the tests tell them apart: Q-SGADMM's
     accuracy > 0.8 and within 0.08 of SGADMM's at under 1/3.5 of its bits;
  4. drive the six trainer paths at full whisper-tiny (W = 4 workers, 5
     steps, a chain unless named), each with every launch count at 0 just
     before:
       path 1, the CLI at 4 bits, global radius, packed wire: the codec
         (K1), pack4 and unpack4 launched twice per step;
       path 2, the trainer API with radius_mode='per_tensor' and eq. 11
         capped at 4 bits, packed wire: the per-element-radius codec (K2),
         pack4 and unpack4 twice per step;
       path 3, the CLI with --layerwise --bit-budget (4 bits per parameter)
         --censor: the per-element radius-and-levels codec (K3) twice per
         step, unpacked wire (widths 1 to 8);
       path 8, the CLI with --topology ring --staleness 2 --participation
         0.75: K1 twice per step, pack4 once per step (send into the ring),
         unpack4 once per step but the 2 fill rounds (recv-done); some
         worker absent (seed 0: worker 1 in step 4, worker 3 in step 5);
         hat_edge bitwise hat_lag[src];
       path 9, the trainer API with overlap=True and microbatches=2: K1,
         pack4 and unpack4 twice per step;
       path 10, the CLI with --mode jacobi --no-quantize: no kernel, wire
         bits 1 x 2E x 8 x 4D per step, a falling loss;
     each requires finite metrics, sender == receiver bit-sync on every
     edge, bits_mean in range, the wire bits of every step equal to the
     closed form of its billing branch, the live invariants of
     ``repro_torch.obs.checks`` (wire accounting, dual mirrors; the CLI
     runs them too, REPRO_CHECK=1), and prints one JSON line;
     then path 4, serve: full mamba2-2.7b (2,831,296,000 float32 parameters,
     random from seed 0) through ``launch/serve.py``'s ``run``, B = 4, two
     request batches (prompt 1024, then 1000), each followed by 32 greedy
     decode tokens, with every launch count at 0 just before: exactly
     64 x 2 = 128 launches of K6 and none of K1-K5, finite logits, and the
     prefill / decode logits of the second batch equal, to atol = rtol =
     2e-3, to one ``forward`` over its prompt and first 24 generated
     tokens; prints one JSON line;
     then the paper's own algorithms through ``launch/paper.py``, each with
     every launch count at 0 just before:
       path 5, ``linreg`` at the paper's widths (N 50, 20,000 samples, d 6,
         rho 24, 2 bits), 400 rounds of GADMM, Q-GADMM at 2 and 4 bits, GD,
         QGD and ADIANA: the codec (K1) launched 2 x 400 times by each
         Q-GADMM run, 400 by QGD, 400 by ADIANA, never by GADMM or GD and
         no other kernel; Q-GADMM's bits per round 50 (b 6 + 64); Q-GADMM
         at 2 bits within max |theta - theta*| < 3e-2 max(|theta*|, 1);
       path 6, the same with Q-GADMM on the placement's ring with
         censoring (the graph step): the same launches, some round
         censored, each round's bits those of ``graph_bits_per_round`` from
         its sent mask (payload per sender, one flag per worker), Q-GADMM
         at 2 bits within the same bound;
       path 7, ``dnn`` at the paper's MLP (784-128-64-10, 109,386
         parameters, N 10, 8 bits), 40 rounds of Q-SGADMM and SGADMM: K1
         twice per Q-SGADMM round, never for SGADMM; bits per round
         10 (8 x 109,386 + 64); Q-SGADMM's accuracy within 0.08 of
         SGADMM's;
     each prints one JSON line;
  5. time each kernel (CUDA events) beside its plain version and its bound
     (K6's for its route: bytes against 3 x its operations at the TF32
     rate, printed beside its old float32 CUDA-core bound), and print one
     JSON line listing them with their launches summed over the ten
     paths, and the device's busy and idle share of paths 5-7, each a
     ``launch/paper.py`` call cut to 100 (linreg) or 5 (dnn) rounds, and
     of paths 8-10 (3 steps after 2 warm-up, ``launch/profile.py``), with
     their peak memory (``torch.profiler``).
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
F32_FLOPS = 67e12           # H100 SXM float32 outside the tensor cores
TF32_FLOPS = 495e12         # H100 SXM dense TF32 on the tensor cores
SSD_PASSES = 3              # K6's 3xTF32: three TF32 products per product
W, STEPS, BITS = 4, 5, 4
CHAIN_SRC = [1, 0, 2, 1, 3, 2]   # source worker of each directed chain edge
FLAG_BITS = 1                    # censor flag per directed edge (and leaf)
# whisper-tiny's 4 bits per parameter: the budget controller mixes 1..8 bits
BIT_BUDGET = 4 * 56_355_840
# censors the tails in step 2 of whisper-tiny-smoke from seed 0 (their L2
# delta 13.31 / 13.38 against the threshold 13.43; the heads' 13.47)
SMALL_TAU = 14.92
# SSD kernel: mamba2-2.7b's prefill of B = 4 x 1024 tokens in chunks of 256
SSD_SERVE = (16, 256, 80, 64, 128)     # (BC, Q, H, P, N)
SSD_RAGGED = [(4, q, h, 16, 16) for q in (8, 32, 200) for h in (5, 80)]
# the longest chunk (three spans of keys), uneven tiles past 256, H not a
# multiple of the kernel's head group of 10
SSD_LONG = [(1, 768, 16, 64, 128), (2, 300, 8, 64, 128), (2, 128, 13, 64, 128)]
SSD_STEEP = (4, 256, 80, 64, 128)      # la falls by 200 per step
SSD_REL = 1e-5          # max |kernel - plain| / max |plain|
SERVE_ARGS = ["--full", "--batch", "4", "--prompt-len", "1024", "1000",
              "--gen-len", "32"]
SERVE_PARAMS = 2_831_296_000
CONSIST_STEPS = 24      # decode steps of batch 2 held against one forward
CONSIST_TOL = 2e-3      # atol = rtol, as tests/test_arch_smoke.py
# the paper's experiments (launch/paper.py): Fig. 2 and Fig. 4
LINREG_N, LINREG_D, LINREG_ROUNDS = 50, 6, 400
DNN_N, DNN_D, DNN_BITS, DNN_ROUNDS = 10, 109_386, 8, 40
THETA_TOL = 3e-2        # tests/test_gadmm.py: max |theta - theta*| / scale
ACC_GAP = 0.08          # tests/test_sgadmm.py: Q-SGADMM vs SGADMM accuracy
SMALL_ACC, SMALL_BITS_RATIO = 0.8, 3.5   # ... and its accuracy and bits bounds
# mixed-width framings of tests/test_kernels.py::test_pack_mixed_roundtrip
MIXED_SEGS = [((256,), (4,)), ((100, 200), (2, 8)),
              ((7, 0, 300, 65), (8, 4, 3, 5)), ((0, 0), (1, 8)),
              ((1000, 1, 129), (4, 1, 6))]
K1 = "quantize_dequantize"
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
    from repro_torch.kernels.ssd import ops as ssd_ops
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
    err[K1] = max(err[K1], codec_at_paper_shapes(q_ops))
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
    # unpack4 rows starting off 16-byte alignment (n % 16 != 0: the byte
    # loop) and rows of whole groups (n % 256 == 0: the 16-byte path)
    for rows, n in ((3, 33_001), (6, 33_001), (3, 4_104), (6, 4_104),
                    (6, 65_536)):
        qs = torch.randint(0, 16, (rows, n), generator=g, device="cuda",
                           dtype=torch.uint8)
        p = pack_ops.pack4_ref(qs)
        u = pack_ops.unpack4(p, n)
        if not (bitwise_equal(u, pack_ops.unpack4_ref(p, n))
                and bitwise_equal(u, qs)):
            fail(f"unpack4 at {rows} rows of n={n} != plain")
    check_pack_mixed(pack_ops, whisper_tiny)
    err["pack4"] = max_abs_err([(pk, pk_ref)])
    err["unpack4"] = max_abs_err([(un, un_ref)])
    print(f"  pack4 {tuple(q_path.shape)} / unpack4 {tuple(recv.shape)}, "
          "ragged n and unaligned rows: byte-identical, round trip exact")
    del q_path, recv, pk, pk_ref, un, un_ref
    torch.cuda.empty_cache()

    # ---- 2b. the SSD kernel vs its plain version ------------------------
    err["ssd_intra"] = check_ssd()

    # ---- 3. trainer on the card vs on the CPU, small input, every mode ---
    check_small_trainers()
    # ---- 3b. small serve on the card vs on the CPU ----------------------
    check_small_serve()
    # ---- 3c. the paper's algorithms on the card vs on the CPU -----------
    check_small_paper()

    # ---- 4. the three trainer paths, counted ----------------------------
    from repro_torch.launch import train
    path_launches = []
    cli = ["--arch", "whisper-tiny", "--workers", str(W), "--bits", str(BITS),
           "--steps", str(STEPS), "--log-every", "1"]
    path_launches.append(run_path(
        "global", lambda: train.run(train.parse_args(cli)),
        {"quantize_dequantize": 2 * STEPS, "pack4": 2 * STEPS,
         "unpack4": 2 * STEPS}, (BITS, BITS), d))
    path_launches.append(run_path(
        "per_tensor", per_tensor_run,
        {"quantize_dequantize_vec_r": 2 * STEPS, "pack4": 2 * STEPS,
         "unpack4": 2 * STEPS}, (1, BITS), d))
    path_launches.append(run_path(
        "layerwise_budget_censor",
        lambda: train.run(train.parse_args(
            cli + ["--layerwise", "--bit-budget", str(BIT_BUDGET),
                   "--censor"])),
        {"quantize_dequantize_vec_rl": 2 * STEPS}, (1, 8), d))
    # path 8: seed 0's participation draws (host generator, seed + 2) leave
    # worker 1 out of step 4 and worker 3 out of step 5
    path_launches.append(run_path(
        "ring_stale2_part075",
        lambda: train.run(train.parse_args(
            cli + ["--topology", "ring", "--staleness", "2",
                   "--participation", "0.75"])),
        {"quantize_dequantize": 2 * STEPS, "pack4": STEPS,
         "unpack4": STEPS - 2}, (BITS, BITS), d, check=some_absent))
    path_launches.append(run_path(
        "overlap_microbatches2", lambda: api_run(overlap=True, microbatches=2),
        {"quantize_dequantize": 2 * STEPS, "pack4": 2 * STEPS,
         "unpack4": 2 * STEPS}, (BITS, BITS), d))
    path_launches.append(run_path(
        "jacobi_full_precision",
        lambda: train.run(train.parse_args(
            cli + ["--mode", "jacobi", "--no-quantize"])),
        {}, (BITS, BITS), d, check=loss_falls))
    path_launches.append(serve_path())
    lin = ["linreg", "--rounds", str(LINREG_ROUNDS)]
    path_launches.append(linreg_path("linreg_chain", lin))
    path_launches.append(linreg_path(
        "linreg_ring_censor", lin + ["--topology", "ring", "--censor"]))
    path_launches.append(dnn_path())
    launches = {k: sum(pl[k] for pl in path_launches) for k in kernels.KERNELS}

    # ---- 5. timing -------------------------------------------------------
    rows = []

    def entry(name, source, replaces, fn, plain, nbytes, iters=20, flops=0,
              flop_rate=F32_FLOPS):
        ms = time_ms(fn, iters)
        plain_ms = time_ms(plain, 3, warmup=1)
        by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        by_ops = flops / flop_rate * 1e3
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": max(by_bytes, by_ops),
                     "bound_by": "operations" if by_ops > by_bytes
                     else "bytes", "library_ms": None})

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
    del q_path, recv
    torch.cuda.empty_cache()
    ssd_in = ssd_inputs(SSD_SERVE, torch.float32, 21)
    bc, q, h, p, n = SSD_SERVE
    ssd_flops = bc * q * (q + 1) // 2 * (2 * p * h + 2 * n)
    entry("ssd_intra", "src/repro_torch/csrc/ssd.cu",
          "src/repro/kernels/ssd/ssd.py:71",
          lambda: ssd_ops.ssd_intra(*ssd_in),
          lambda: ssd_ops.ssd_intra_ref(*ssd_in),
          4 * (2 * bc * q * h * p + 2 * bc * q * h + 2 * bc * q * n),
          flops=SSD_PASSES * ssd_flops, flop_rate=TF32_FLOPS)
    print(f"  ssd_intra bound on its route (3xTF32 on the tensor cores): "
          f"{rows[-1]['bound_ms']:.4f} ms by {rows[-1]['bound_by']}; on the "
          f"float32 CUDA cores it was {ssd_flops / F32_FLOPS * 1e3:.4f} ms "
          "by operations")
    for r in rows:
        print(f"  {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.3f} ms, "
              f"bound {r['bound_ms']:.4f} ms by {r['bound_by']}, reckoned), "
              f"{r['launches']} launches on the ten paths")
    paper_idle_share()
    trainer_profiles()
    print(json.dumps({"kernels": rows}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def ssd_inputs(shape, dtype, seed, steep=False):
    """K6's inputs on the card: x, b, c ~ N(0, 1), dt = softplus(N(0, 1)),
    la a decreasing cumulative sum (as tests/test_ssd_kernel.py draws them);
    with steep, la falls by 200 per step instead."""
    import torch
    import torch.nn.functional as F
    bc, q, h, p, n = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *s: torch.randn(s, generator=g, device="cuda")
    x, dt = rn(bc, q, h, p), F.softplus(rn(bc, q, h))
    la = torch.cumsum(-rn(bc, q, h).abs() * 0.3, dim=1)
    if steep:
        la = torch.cumsum(torch.full_like(la, -200.0), dim=1)
    b, c = rn(bc, q, n), rn(bc, q, n)
    return [t.to(dtype).contiguous() for t in (x, dt, la, b, c)]


def check_ssd() -> float:
    """Phase 2b: K6 against its plain version at the serving shape, the
    ragged ones, the long ones and under a steep decay, float32 and
    bfloat16; then a two-group ssd_scan on the card against the CPU.
    Returns the max abs error at the serving shape in float32 (the path's
    inputs)."""
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.models import ssm
    serve_err = 0.0
    cases = [(sh, False) for sh in [SSD_SERVE] + SSD_RAGGED + SSD_LONG]
    for shape, steep in cases + [(SSD_STEEP, True)]:
        for dtype in (torch.float32, torch.bfloat16):
            ins = ssd_inputs(shape, dtype, sum(shape), steep)
            y = ssd_ops.ssd_intra(*ins)
            ref = ssd_ops.ssd_intra_ref(*ins)
            torch.cuda.synchronize()
            e = float((y - ref).abs().max())
            scale = float(ref.abs().max())
            tag = f"ssd_intra {shape} {dtype}{' steep decay' if steep else ''}"
            if not (torch.isfinite(y).all() and e <= SSD_REL * scale):
                fail(f"{tag}: max abs err {e} > {SSD_REL} x max |plain| "
                     f"{scale}")
            print(f"  {tag}: max abs err {e:.3e} = {e / scale:.2e} x "
                  f"max |plain| ({scale:.1f})")
            if shape == SSD_SERVE and dtype == torch.float32 and not steep:
                serve_err = e
            del ins, y, ref
    torch.cuda.empty_cache()
    rng = np.random.default_rng(9)
    bsz, s, h, p, g, n = 2, 600, 16, 64, 2, 64    # 3 chunks of 256, padded
    cpu = [torch.from_numpy(a.astype(np.float32)) for a in (
        rng.normal(size=(bsz, s, h, p)),
        np.log1p(np.exp(rng.normal(size=(bsz, s, h)) - 1.0)),
        np.log(np.linspace(1.0, 16.0, h)),
        rng.normal(size=(bsz, s, g, n)), rng.normal(size=(bsz, s, g, n)))]
    before = kernels.LAUNCHES["ssd_intra"]
    y, st = ssm.ssd_scan(*(t.cuda() for t in cpu), chunk=256)
    torch.cuda.synchronize()
    if kernels.LAUNCHES["ssd_intra"] != before + g:
        fail("ssd_scan with 2 groups did not launch K6 once per group")
    y_ref, st_ref = ssm.ssd_scan(*cpu, chunk=256)
    for name, a, b in (("y", y, y_ref), ("state", st, st_ref)):
        e = float((a.cpu() - b).abs().max())
        if e > 1e-4 * float(b.abs().max()):
            fail(f"ssd_scan G=2: {name} card vs CPU max abs err {e}")
    print(f"  ssd_scan (B {bsz}, S {s}, H {h}, G {g}, chunk 256): card == "
          "CPU within 1e-4 x max, K6 once per group")
    return serve_err


def check_small_serve():
    """Phase 3b: mamba2-smoke served on the card and on the CPU from the
    same weights: prefill of a 20-token prompt, then 4 teacher-forced decode
    steps; logits and caches to rtol 1e-4 / atol 1e-5."""
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.configs import mamba2_2_7b
    from repro_torch.dist.serve import Server
    from repro_torch.models import ssm
    from repro_torch.tree import map_leaves

    cfg = mamba2_2_7b.smoke_config()
    params = ssm.init(torch.Generator().manual_seed(0), cfg)
    tokens = torch.from_numpy(
        np.random.default_rng(3).integers(0, cfg.vocab, (2, 24)))
    outs = {}
    for dev in ("cpu", "cuda"):
        pd = map_leaves(lambda t: t.to(dev), params)
        server = Server(model=ssm, cfg=cfg, batch_size=2, device=dev)
        tk = tokens.to(dev)
        before = kernels.LAUNCHES["ssd_intra"]
        lg, cache = server.prefill(pd, {"tokens": tk[:, :20]})
        seq = [(lg, cache["conv"], cache["state"])]
        for i in range(20, 24):
            pos = torch.full((2,), i, dtype=torch.int32, device=dev)
            lg, cache = server.decode(pd, tk[:, i], cache, pos)
            seq.append((lg, cache["conv"], cache["state"]))
        launched = kernels.LAUNCHES["ssd_intra"] - before
        if launched != (cfg.n_layers if dev == "cuda" else 0):
            fail(f"small serve on {dev}: K6 launched {launched} times")
        outs[dev] = [[t.cpu() for t in step] for step in seq]
    for i, (a, b) in enumerate(zip(outs["cuda"], outs["cpu"])):
        for name, x, y in zip(("logits", "conv", "state"), a, b):
            if not torch.allclose(x, y, rtol=1e-4, atol=1e-5):
                fail(f"small serve step {i}: {name} card vs CPU max abs err "
                     f"{float((x - y).abs().max())}")
    e = max(float((x - y).abs().max()) for a, b in zip(outs["cuda"],
                                                        outs["cpu"])
            for x, y in zip(a, b))
    print(f"  small serve (mamba2-smoke, B 2, prompt 20, 4 decode steps): "
          f"card == CPU within rtol 1e-4 / atol 1e-5 (max abs err {e:.2e}); "
          f"K6 {cfg.n_layers} launches on the card")


def serve_path():
    """Path 4: full mamba2-2.7b through launch/serve.py's run, every launch
    count at 0 just before; checks the launches, the logits and the
    prefill / decode consistency; prints one JSON line and returns the
    launch counts."""
    import torch

    from repro_torch import kernels
    from repro_torch.launch import serve
    from repro_torch.models import layers as L
    from repro_torch.models import ssm
    from repro_torch.models.config import num_params
    from repro_torch.tree import leaves_with_path

    print("path serve:")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    out = serve.run(serve.parse_args(SERVE_ARGS))
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    cfg, params = out["cfg"], out["params"]
    print(f"  launches: {launches}")
    want = {"ssd_intra": cfg.n_layers * len(out["requests"])}
    for k in kernels.KERNELS:
        if launches[k] != want.get(k, 0):
            fail(f"path serve: {k} launched {launches[k]} times, expected "
                 f"{want.get(k, 0)}")
    n = sum(t.numel() for _, t in leaves_with_path(params))
    if not n == num_params(cfg) == SERVE_PARAMS:
        fail(f"mamba2-2.7b has {n} parameters, not {SERVE_PARAMS}")
    for i, (_, res) in enumerate(out["requests"]):
        for name in ("prefill_logits", "decode_logits"):
            if not torch.isfinite(res[name]).all():
                fail(f"path serve request {i}: {name} not finite")
    # prefill / decode consistency: one forward over the second batch's
    # prompt and its first CONSIST_STEPS generated tokens
    tokens, res = out["requests"][1]
    s = tokens.shape[1]
    seq = torch.cat([tokens, res["tokens"][:, :CONSIST_STEPS]], dim=1)
    with torch.inference_mode():
        h = ssm.forward(params, seq, cfg)
        full = L.unembed(params["embed"], h[:, s - 1:], cfg)
    got = torch.cat([res["prefill_logits"][:, None],
                     res["decode_logits"][:CONSIST_STEPS].transpose(0, 1)],
                    dim=1)
    e = float((got - full).abs().max())
    if not torch.allclose(got, full, rtol=CONSIST_TOL, atol=CONSIST_TOL):
        fail(f"path serve: prefill / decode logits differ from one forward "
             f"over {seq.shape[1]} positions by up to {e}")
    print(f"  prefill + {CONSIST_STEPS} decode steps == one forward over "
          f"{seq.shape[1]} positions within {CONSIST_TOL} (max abs err "
          f"{e:.2e}, max |logit| {float(full.abs().max()):.2f})")
    dec = [sorted(r["decode_s"]) for _, r in out["requests"]]
    med = [d[len(d) // 2] for d in dec]
    batch = seq.shape[0]
    print(json.dumps({"serve": {
        "arch": cfg.name, "params": n, "batch": batch,
        "prompt_len": [t.shape[1] for t, _ in out["requests"]],
        "gen_len": len(dec[0]),
        "prefill_s": [r["prefill_s"] for _, r in out["requests"]],
        "decode_ms_per_step_median": [1e3 * m for m in med],
        "decode_tok_per_s": [batch * len(d) / sum(d) for d in dec],
        "max_memory_allocated_bytes": peak,
        "consistency_max_abs_err": e, "launches": launches}}))
    del out, params, h, full
    torch.cuda.empty_cache()
    return launches


def per_tensor_run():
    """Path 2 through the trainer API (the CLI has no radius-mode flag):
    per_tensor radius and eq. 11 capped at 4 bits."""
    from repro_torch.core.quantizer import QuantizerConfig
    return api_run(radius_mode="per_tensor", qcfg=QuantizerConfig(
        bits=BITS, adapt_bits=True, max_bits=BITS))


def api_setup(qcfg=None, **kw):
    """(trainer, state, batches) of full whisper-tiny through the trainer
    API, with the CLI's data (per-worker batch 4, seq 128) and DistConfig
    options `kw`; `qcfg` defaults to BITS fixed."""
    from repro_torch.configs import whisper_tiny
    from repro_torch.core.gadmm import GADMMConfig
    from repro_torch.core.quantizer import QuantizerConfig
    from repro_torch.data.pipeline import ExtraInputs, LMShardLoader
    from repro_torch.dist.qgadmm import DistConfig, QGADMMTrainer, init_state
    from repro_torch.models import encdec

    cfg = whisper_tiny.config()
    dcfg = DistConfig(num_workers=W, gadmm=GADMMConfig(
        rho=1.0, alpha=0.01, qcfg=qcfg or QuantizerConfig(bits=BITS)), **kw)
    trainer = QGADMMTrainer(encdec, cfg, dcfg)
    state = init_state(lambda g: encdec.init(g, cfg), 0, dcfg)
    loader = LMShardLoader(W, 4, 128, cfg.vocab)
    frames = ExtraInputs.frames(W, 4, cfg.encoder_frames, cfg.d_model)

    def batches():
        while True:
            yield dict(loader.next_batch(), frames=frames)

    return trainer, state, batches()


def api_run(**kw):
    """STEPS steps of ``api_setup(**kw)``, printing the step line; returns
    (trainer, state, log) like ``train.run``."""
    import torch

    trainer, state, batches = api_setup(**kw)
    log = []
    for k in range(STEPS):
        t0 = time.time()
        state, m = trainer.step(state, next(batches))
        m = {n: float(v) if v.dim() == 0 else v.tolist()
             for n, v in m.items()}                        # syncs the device
        torch.cuda.synchronize()
        dt = time.time() - t0
        print(f"step {k + 1}: loss={m['loss']:.4f} "
              f"resid={m['consensus_resid']:.4f} R={m['radius_mean']:.5f} "
              f"bits={m['bits_mean']:.2f} ({dt:.2f}s/step)")
        log.append((k + 1, m, dt))
    return trainer, state, log


def some_absent(trainer, state, log):
    """Path 8: some worker sat out some round, and hat_edge is bitwise
    the S-round lag of its source's hat."""
    present = [m["participants"] for _, m, _ in log]
    if not min(present) < W:
        fail(f"path 8: every worker took part in every step ({present})")
    if state.hat_lag is None or len(state.inbox) != 2:
        fail("path 8: no staleness ring")
    print(f"  participants per step {present}; hat_edge == hat_lag[src]")


def loss_falls(trainer, state, log):
    """Path 10: the loss falls over the run."""
    first, last = log[0][1]["loss"], log[-1][1]["loss"]
    if not last < first:
        fail(f"path 10: loss {first} -> {last} does not fall")
    print(f"  loss falls {first:.4f} -> {last:.4f}")


def packed_len(n: int) -> int:
    """pack4's wire length: 128 bytes per 256 levels."""
    return 128 * -(-n // 256)


def closed_form_wire_bits(trainer, state, m) -> float:
    """The wire bits of one step from its committed masks and the graph's
    degrees: every phase (one in jacobi) and direction of every edge
    carries a row (4 bytes a parameter unquantized) plus its header (none
    unquantized); censored or with partial participation, a flag per
    directed edge and phase plus the payload of each sender on each of its
    edges; layerwise, a flag per leaf slot and directed edge plus, per sent
    leaf, its nibble-packed (<= 4 bits) or byte-wide segment and header."""
    dcfg = trainer.dcfg
    deg, edges = trainer.topo.degree, trainer.topo.num_edges
    phases = 1 if dcfg.mode == "jacobi" else 2
    sizes = state.layout.sizes
    if dcfg.layerwise is not None:
        total = phases * 2 * edges * len(sizes) * FLAG_BITS
        for w, row in enumerate(m["leaf_bits_sent"]):
            for b, n in zip(row, sizes):
                if b > 0:
                    nbytes = packed_len(n) if b <= 4 else n
                    total += deg[w] * (8 * nbytes + 64)
        return float(total)
    d = state.layout.size
    n_r = len(sizes) if dcfg.radius_mode == "per_tensor" else 1
    if not dcfg.gadmm.quantize:
        per_link = 8 * 4 * d
    else:
        per_link = (8 * (packed_len(d) if dcfg.pack_wire else d)
                    + 32 * n_r + 32)
    if dcfg.censor is None and dcfg.participation == 1.0:
        return float(phases * 2 * edges * per_link)
    return float(phases * 2 * edges * FLAG_BITS + per_link * sum(
        s * g for s, g in zip(m["worker_sent"], deg)))


def run_path(mode, run, want, bits_range, d, check=None):
    """Drive one trainer path with every launch count at 0 just before;
    check its launches, metrics, bit-sync, wire bits and the live
    invariants of ``obs.checks`` (also run by the CLI itself: REPRO_CHECK
    is set), then `check`(trainer, state, log); print its JSON line and
    return its launch counts."""
    import os

    import torch

    from repro_torch import kernels
    from repro_torch.obs import checks
    os.environ[checks.ENV_FLAG] = "1"
    print(f"path {mode}:")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    trainer, state, log = run()
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    print(f"  launches: {launches}")
    for k in kernels.KERNELS:
        if launches[k] != want.get(k, 0):
            fail(f"path {mode}: {k} launched {launches[k]} times, expected "
                 f"{want.get(k, 0)}")
    if state.layout.size != d:
        fail(f"whisper-tiny has {state.layout.size} parameters, not {d}")
    lo, hi = bits_range
    for step, m, _ in log:
        for k in ("loss", "consensus_resid", "radius_mean"):
            if not torch.isfinite(torch.tensor(m[k])):
                fail(f"path {mode} step {step}: {k} = {m[k]}")
        if not lo <= m["bits_mean"] <= hi:
            fail(f"path {mode} step {step}: bits_mean {m['bits_mean']} "
                 f"outside [{lo}, {hi}]")
        want_bits = closed_form_wire_bits(trainer, state, m)
        if abs(m["wire_bits_per_round"] - want_bits) > 1e-6 * want_bits:
            fail(f"path {mode} step {step}: wire bits "
                 f"{m['wire_bits_per_round']} != closed form {want_bits}")
    if not trainer.bit_sync(state):
        fail(f"path {mode}: hat_edge is not bitwise the sender's hat")
    checks.check_step_window(trainer, state, [
        {"step": step - 1, "metrics": m} for step, m, _ in log])
    checks.check_edge_mirrors(trainer, state)
    if check is not None:
        check(trainer, state, log)
    print(f"  metrics finite, bits_mean in [{lo}, {hi}], wire bits == closed "
          "form; hat_edge bitwise == the sender's hat on all "
          f"{trainer.eidx.num_directed} directed edges; obs.checks wire "
          "accounting + edge mirrors OK")
    step_s = sorted(s for _, _, s in log[1:])
    print(json.dumps({"trainer": {
        "arch": "whisper-tiny", "mode": mode, "workers": W, "steps": STEPS,
        "topology": trainer.topo.kind, "params_per_worker": d,
        "pack_wire": trainer.dcfg.pack_wire, "launches": launches,
        "first_step_s": log[0][2], "median_step_s": step_s[len(step_s) // 2],
        "max_memory_allocated_bytes": peak,
        "skip_rate": [m["skip_rate"] for _, m, _ in log],
        "bits_mean": [m["bits_mean"] for _, m, _ in log],
        "wire_bits_per_round": [m["wire_bits_per_round"] for _, m, _ in log],
        "loss_first": log[0][1]["loss"], "loss_last": log[-1][1]["loss"]}}))
    del state, trainer
    torch.cuda.empty_cache()
    return launches


def check_small_trainers():
    """whisper-tiny-smoke on the card (kernels) and on the CPU (plain
    versions) from the same init, batches, draws and participation masks,
    2 steps (3 under staleness, so the ring delivers), in every quantizer
    mode and every option: metrics rtol 1e-3; widths, sent masks, skip rate
    and wire bits exact; theta within 1e-4 (one ulp of the leaf dtype in a
    bf16 leaf) at all but 1e-3 of the positions (matmul sums differ between
    the two devices; Adam's first steps amplify a tiny difference where
    the gradient is ~0); both sides bit-synced.  The censoring cases must
    censor some worker but not all in one of their steps, the
    participation cases leave some worker out."""
    import torch

    from repro_torch.core.censor import CensorConfig
    from repro_torch.core.gadmm import GADMMConfig
    from repro_torch.core.quantizer import LayerwiseConfig
    n_leaves = 25
    tables = LayerwiseConfig(
        bits=tuple(2 if i % 2 else 4 for i in range(n_leaves)),
        periods=tuple(2 if i % 3 == 2 else 1 for i in range(n_leaves)),
        taus=1.0, tau_xi=0.9)
    censor = CensorConfig(tau=SMALL_TAU, xi=0.9)
    modes = {
        "global": {},
        "per_tensor": {"radius_mode": "per_tensor"},
        "layerwise_periods_taus": {"layerwise": tables},
        "layerwise_budget": {"layerwise": LayerwiseConfig(
            budget_bits=4 * 182_400)},
        "censor": {"censor": censor},
        "jacobi": {"mode": "jacobi"},
        "overlap": {"overlap": True},
        "staleness1_censor": {"staleness": 1, "censor": censor},
        "staleness2_layerwise": {"staleness": 2, "layerwise": tables},
        "participation_ring": {"participation": 0.5, "topology": "ring"},
        "participation_ring_staleness1": {"participation": 0.5,
                                          "staleness": 1, "topology": "ring"},
        "participation_censor": {"participation": 0.5, "censor": censor},
        "full_precision": {"gadmm": GADMMConfig(rho=1.0, quantize=False,
                                                alpha=0.01)},
        "microbatches2": {"microbatches": 2},
        "bf16_state": {"state_dtype": torch.bfloat16},
        "cluster_of_stars": {"topology": "cluster_of_stars"},
        "federated": {"topology": "federated"},
    }
    for mode, kw in modes.items():
        skips, present = check_small_trainer(mode, kw)
        if mode == "censor" and not any(0.0 < s < 1.0 for s in skips):
            fail(f"small trainer censor: skip rates {skips} censor no worker "
                 "or all of them")
        if "participation" in mode and not min(present) < W:
            fail(f"small trainer {mode}: every worker took part ({present})")


def check_small_trainer(mode, kw):
    """One mode of check_small_trainers; returns the per-step skip rates
    and participant counts."""
    import numpy as np
    import torch

    from repro_torch.configs import whisper_tiny
    from repro_torch.core.gadmm import GADMMConfig
    from repro_torch.core.quantizer import QuantizerConfig
    from repro_torch.data.pipeline import ExtraInputs, LMShardLoader
    from repro_torch.dist.qgadmm import DistConfig, QGADMMTrainer, init_state
    from repro_torch.models import encdec

    cfg = whisper_tiny.smoke_config()
    kw = dict(kw)
    gcfg = kw.pop("gadmm", GADMMConfig(
        rho=1.0, qcfg=QuantizerConfig(bits=BITS), alpha=0.01))
    dcfg = DistConfig(num_workers=W, gadmm=gcfg, **kw)
    sides = {}
    for dev in ("cpu", "cuda"):
        tr = QGADMMTrainer(encdec, cfg, dcfg, device=dev)
        st = init_state(lambda g: encdec.init(g, cfg), 0, dcfg, device=dev)
        sides[dev] = (tr, st)
    st_cpu = sides["cpu"][1]
    sides["cuda"][1].theta.copy_(st_cpu.theta)     # same init on both
    lay = st_cpu.layout
    tol = torch.full((lay.size,), 1e-4)
    for off, n, dt in lay.narrow:                  # one ulp of a bf16 leaf
        mag = st_cpu.theta[:, off:off + n].abs().amax(0).clamp(min=1e-30)
        tol[off:off + n] = torch.maximum(
            torch.tensor(1e-4), torch.exp2(torch.floor(torch.log2(mag)) - 7))
    loader = LMShardLoader(W, 2, 16, cfg.vocab)
    frames = ExtraInputs.frames(W, 2, cfg.encoder_frames, cfg.d_model)
    rng = np.random.default_rng(0)
    skips, present = [], []
    for k in range(3 if dcfg.staleness else 2):
        batch = dict(loader.next_batch(), frames=frames)
        u = [rng.random((W, st_cpu.layout.size), dtype=np.float32)
             for _ in range(2)]
        part = (rng.random(W) < dcfg.participation
                if dcfg.participation < 1.0 else None)
        out = {dev: tr.step(st, batch, u=u, part=part)[1]
               for dev, (tr, st) in sides.items()}
        for name in ("loss", "consensus_resid", "radius_mean"):
            a, b = float(out["cpu"][name]), float(out["cuda"][name])
            if not abs(a - b) <= 1e-3 * abs(a):
                fail(f"small trainer {mode} step {k}: {name} cuda {b} vs "
                     f"cpu {a}")
        for name in ("bits_mean", "skip_rate", "wire_bits_per_round",
                     "worker_sent"):
            a, b = out["cpu"][name], out["cuda"][name].cpu()
            if not torch.equal(a, b):
                fail(f"small trainer {mode} step {k}: {name} cuda {b} vs "
                     f"cpu {a}")
        if not torch.equal(sides["cuda"][1].bits.cpu(), st_cpu.bits):
            fail(f"small trainer {mode} step {k}: widths differ")
        skips.append(float(out["cuda"]["skip_rate"]))
        present.append(float(out["cuda"]["participants"]))
        th = (sides["cuda"][1].theta.cpu() - sides["cpu"][1].theta).abs()
        frac = float((th > tol).float().mean())
        if frac > 1e-3:
            fail(f"small trainer {mode} step {k}: theta differs at "
                 f"{frac:.2e}")
        for dev, (tr, st) in sides.items():
            if not tr.bit_sync(st):
                fail(f"small trainer {mode} on {dev}: sender/receiver desync")
    print(f"  small trainer {mode} (whisper-tiny-smoke, {k + 1} steps): card "
          f"== CPU within tolerance, bit-synced on both; skip rates {skips}, "
          f"participants {present}")
    return skips, present


def check_pack_mixed(pack_ops, whisper_tiny):
    """Phase 2: pack_mixed / unpack_mixed on the card (pack4 / unpack4 per
    <= 4-bit segment) bitwise against their plain versions, on the
    framings of tests/test_kernels.py and on whisper-tiny's 25 leaves at
    2, 4 and 8 bits in turn."""
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.models import encdec
    from repro_torch.tree import ParamLayout
    sizes = ParamLayout.of(encdec.init(torch.Generator(device="cuda"),
                                       whisper_tiny.config())).sizes
    cases = MIXED_SEGS + [(sizes, tuple((2, 4, 8)[i % 3]
                                        for i in range(len(sizes))))]
    rng = np.random.default_rng(8)
    for seg_sizes, bits in cases:
        q = torch.from_numpy(np.concatenate(
            [rng.integers(0, 2 ** b, n, dtype=np.uint8)
             for n, b in zip(seg_sizes, bits)] + [np.zeros(0, np.uint8)]))
        before = dict(kernels.LAUNCHES)
        pk = pack_ops.pack_mixed(q.cuda(), seg_sizes, bits)
        un = pack_ops.unpack_mixed(pk, seg_sizes, bits)
        torch.cuda.synchronize()
        segs = sum(1 for n, b in zip(seg_sizes, bits) if n and b <= 4)
        got = [kernels.LAUNCHES[k] - before[k] for k in ("pack4", "unpack4")]
        if got != [segs, segs]:
            fail(f"pack_mixed {len(seg_sizes)} segments: pack4 / unpack4 "
                 f"launched {got}, expected {segs} each")
        if not (bitwise_equal(pk.cpu(), pack_ops.pack_mixed_ref(
                q, seg_sizes, bits)) and bitwise_equal(un.cpu(), q)
                and pk.numel() == pack_ops.mixed_packed_len(seg_sizes, bits)):
            fail(f"pack_mixed over {len(seg_sizes)} segments at {bits} bits "
                 "!= plain, or the round trip lost levels")
    print(f"  pack_mixed / unpack_mixed: {len(cases)} framings "
          f"(whisper-tiny's {len(sizes)} leaves at 2/4/8 bits among them) "
          "byte-identical to plain, round trip exact")


def _step_launches(fn, want: int, tag: str):
    """Run fn() and fail unless it launched the codec `want` times and no
    other kernel."""
    from repro_torch import kernels
    before = dict(kernels.LAUNCHES)
    out = fn()
    got = {k: kernels.LAUNCHES[k] - before[k] for k in kernels.KERNELS}
    if got != {k: (want if k == K1 else 0) for k in kernels.KERNELS}:
        fail(f"{tag}: launches {got}, expected {want} of {K1} and no other")
    return out


def check_small_paper():
    """Phase 3c: chain Q-GADMM (2 bits, 5 steps) and graph Q-GADMM (ring,
    censored, 8 steps) on N 20, d 6, and Q-SGADMM on the MLP 32-24-10, N 6
    (2 rounds), each on the card and on the CPU from the same state with
    the same draws.  Chain and graph: widths and sent masks equal, theta,
    hats and radii to atol 1e-5 (the local solve's batched product sums in
    another order on each device); the duals integrate the hats, so their
    bound grows each step by 2 alpha rho max |hat difference| + 1e-6
    max |lam|.  SGADMM's theta within 1e-4 at all but 1e-3 of the
    positions."""
    import numpy as np
    import torch

    from repro_torch.core import gadmm
    from repro_torch.core.censor import CensorConfig
    from repro_torch.core.quantizer import QuantizerConfig
    from repro_torch.core.sgadmm import SGADMMConfig, SGADMMTrainer
    from repro_torch.core.topology import ring_topology
    from repro_torch.data.synthetic import (classification_shards,
                                            regression_shards)
    from repro_torch.device import generator
    from repro_torch.models import mlp

    n, d = 20, 6
    xs, ys, _ = regression_shards(n_workers=n, samples=4000, d=d, seed=1)
    xs, ys = torch.from_numpy(xs), torch.from_numpy(ys)
    cfg = gadmm.GADMMConfig(rho=24.0, qcfg=QuantizerConfig(bits=2))
    topo = ring_topology(n)
    cen = CensorConfig(tau=0.5, xi=0.9)
    g = torch.Generator().manual_seed(0)

    def to(tup, dev):
        return type(tup)(*(x.to(dev) for x in tup))

    for kind in ("chain", "graph"):
        if kind == "chain":
            q = gadmm.make_quadratic(xs, ys, cfg.rho)
            init = lambda dev: gadmm.init_state(n, d, cfg, device=dev)
            fields = ("theta", "theta_hat", "lam", "radius", "bits")
            steps = 5
        else:
            q = gadmm.make_graph_quadratic(xs, ys, cfg.rho, topo)
            init = lambda dev: gadmm.graph_init_state(topo, d, cfg,
                                                      device=dev)
            fields = ("theta", "theta_hat", "lam", "radius", "bits", "sent")
            steps = 8
            tcs = {dev: gadmm.graph_consts(topo, device=dev)
                   for dev in ("cpu", "cuda")}
        sides = {dev: (init(dev), to(q, dev)) for dev in ("cpu", "cuda")}
        censored, worst, lam_tol = 0, [0.0, 0.0], 0.0
        for k in range(steps):
            u = [torch.rand((n, d), generator=g) for _ in range(2)]
            for dev, (st, qd) in sides.items():
                ud = [x.to(dev) for x in u]
                if kind == "chain":
                    run = lambda: gadmm.gadmm_step(st, qd, cfg, u=ud)
                else:
                    run = lambda: gadmm.graph_step(st, qd, cfg, topo,
                                                   censor=cen, u=ud,
                                                   tc=tcs[dev])
                st = (_step_launches(run, 2, f"small {kind} step {k}")
                      if dev == "cuda" else run())
                sides[dev] = (st, qd)
            a, b = sides["cuda"][0], sides["cpu"][0]
            # the duals integrate the hats: each step may add 2 alpha rho
            # max |hat difference|, plus their own rounding
            lam_tol += (2 * cfg.alpha * cfg.rho * max_abs_err(
                [(a.theta_hat.cpu(), b.theta_hat)])
                + 1e-6 * float(b.lam.abs().max()))
            for f in fields:
                x, y = getattr(a, f).cpu(), getattr(b, f)
                if f in ("bits", "sent"):
                    ok = torch.equal(x, y)
                else:
                    e = max_abs_err([(x, y)])
                    worst[f == "lam"] = max(worst[f == "lam"], e)
                    ok = e <= (lam_tol if f == "lam" else 1e-5)
                if not ok:
                    fail(f"small {kind} step {k}: {f} card != CPU (max abs "
                         f"err {max_abs_err([(x, y)])}, duals' bound "
                         f"{lam_tol:.3e})")
            if kind == "graph":
                censored += int((~b.sent).sum())
        if kind == "graph" and not censored:
            fail("small graph: censoring silenced no worker")
        print(f"  small {kind} Q-GADMM (N {n}, d {d}, {steps} steps"
              f"{', ring, censored' if kind == 'graph' else ''}): widths"
              f"{' and sent masks' if kind == 'graph' else ''} equal, "
              f"theta / hats / radii within 1e-5 (max abs err "
              f"{worst[0]:.3e}), duals {worst[1]:.3e} within {lam_tol:.3e}, "
              "K1 twice per step")

    layers = [(32, 24), (24, 10)]
    cx, cy = classification_shards(n_workers=6, samples=1800, dim=32, seed=0)
    p0 = mlp.init_params(generator(0, "cpu"), layers)
    scfg = SGADMMConfig(gadmm=gadmm.GADMMConfig(
        rho=1.0, qcfg=QuantizerConfig(bits=8), alpha=0.01), local_iters=10,
        local_lr=3e-3, batch_size=64)
    trs = {dev: SGADMMTrainer(mlp.loss_fn,
                              {k: v.to(dev) for k, v in p0.items()}, 6, scfg,
                              device=dev) for dev in ("cpu", "cuda")}
    rng = np.random.default_rng(0)
    for k in range(2):
        sel = rng.integers(0, cx.shape[1], size=(6, 64))
        xb = torch.from_numpy(np.take_along_axis(cx, sel[:, :, None], 1))
        yb = torch.from_numpy(np.take_along_axis(cy, sel, 1))
        u = [torch.rand((6, trs["cpu"].d), generator=g) for _ in range(2)]
        trs["cpu"].train_step(xb, yb, u=u)
        _step_launches(lambda: trs["cuda"].train_step(
            xb.cuda(), yb.cuda(), u=[x.cuda() for x in u]), 2,
            f"small sgadmm round {k}")
        a, b = trs["cuda"].state, trs["cpu"].state
        frac = float(((a.theta.cpu() - b.theta).abs() > 1e-4).float().mean())
        if not torch.equal(a.bits.cpu(), b.bits) or frac > 1e-3:
            fail(f"small sgadmm round {k}: theta differs at {frac:.2e} "
                 "of the positions (or the widths differ)")
    print(f"  small Q-SGADMM (MLP 32-24-10, N 6, 2 rounds): card == CPU "
          f"within tolerance (theta beyond 1e-4 at {frac:.2e}), K1 twice "
          "per round")
    check_small_sgadmm_outcome(layers, cx, cy, p0, scfg)


def check_small_sgadmm_outcome(layers, cx, cy, p0, scfg):
    """40 rounds of Q-SGADMM and SGADMM on the card at the size where the
    tests tell them apart (MLP 32-24-10, N 6, batches of 64 from
    default_rng(0)): the bounds of tests/test_torch_sgadmm.py's
    test_40_rounds_reach_the_jax_tests_bounds — Q-SGADMM's consensus
    accuracy > 0.8 and within 0.08 of SGADMM's, at under 1 / 3.5 of its
    bits per round."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.core.sgadmm import SGADMMTrainer
    from repro_torch.models import mlp
    x_all = torch.from_numpy(cx.reshape(-1, cx.shape[-1])).cuda()
    y_all = torch.from_numpy(cy.reshape(-1)).cuda()
    acc, bits = {}, {}
    for quantize in (True, False):
        cfg = dataclasses.replace(scfg, gadmm=dataclasses.replace(
            scfg.gadmm, quantize=quantize))
        tr = SGADMMTrainer(mlp.loss_fn, {k: v.cuda() for k, v in p0.items()},
                           6, cfg, device="cuda")
        rng = np.random.default_rng(0)
        for _ in range(DNN_ROUNDS):
            sel = rng.integers(0, cx.shape[1], size=(6, 64))
            tr.train_step(
                torch.from_numpy(np.take_along_axis(cx, sel[:, :, None],
                                                    1)).cuda(),
                torch.from_numpy(np.take_along_axis(cy, sel, 1)).cuda())
        acc[quantize] = float(mlp.accuracy(tr.mean_params(), x_all, y_all))
        bits[quantize] = tr.bits_per_round()
    if not (acc[True] > SMALL_ACC and acc[True] > acc[False] - ACC_GAP
            and bits[True] < bits[False] / SMALL_BITS_RATIO):
        fail(f"small Q-SGADMM 40 rounds: accuracy {acc[True]} vs SGADMM "
             f"{acc[False]}, bits {bits[True]} vs {bits[False]}")
    print(f"  small Q-SGADMM vs SGADMM ({layers}, N 6, {DNN_ROUNDS} rounds): "
          f"accuracy {acc[True]:.3f} vs {acc[False]:.3f} (> {SMALL_ACC}, "
          f"within {ACC_GAP}), bits per round {bits[True]} vs {bits[False]} "
          f"(under 1/{SMALL_BITS_RATIO})")


def linreg_path(mode, argv):
    """Paths 5 and 6: ``launch/paper.py linreg`` with every launch count at
    0 just before; checks each run's launches, Q-GADMM's wire bits and
    convergence; prints one JSON line and returns the launch counts."""
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.launch import paper

    print(f"path {mode}:")
    kernels.reset_launches()
    out = paper.run_linreg(paper.parse_args(argv))
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    print(f"  launches: {launches}")
    n, d, r = LINREG_N, LINREG_D, LINREG_ROUNDS
    want_run = {"GADMM": 0, "Q-GADMM-2b": 2 * r, "Q-GADMM-4b": 2 * r,
                "GD": 0, "QGD": r, "ADIANA": r}
    rows = {row["alg"]: row for row in out["rows"]}
    if sorted(rows) != sorted(want_run):
        fail(f"path {mode}: runs {sorted(rows)}")
    for alg, want in want_run.items():
        got = rows[alg]["launches"]
        if got != ({K1: want} if want else {}):
            fail(f"path {mode}: {alg} launched {got}, expected {want} of {K1}")
    for k in kernels.KERNELS:
        if launches[k] != (sum(want_run.values()) if k == K1 else 0):
            fail(f"path {mode}: {k} launched {launches[k]} times in all")
    for b in (2, 4):
        row = rows[f"Q-GADMM-{b}b"]
        per = b * d + 64
        if "sent_per_round" in row:
            sent = np.asarray(row["sent_per_round"], float)
            want_bits = float(np.mean(sent * per + n))
            if not sent.min() < n:
                fail(f"path {mode}: Q-GADMM-{b}b censored no worker")
        else:
            want_bits = float(n * per)
        if row["bits_per_round"] != want_bits:
            fail(f"path {mode}: Q-GADMM-{b}b bits per round "
                 f"{row['bits_per_round']} != closed form {want_bits}")
    bound = THETA_TOL * out["theta_star_scale"]
    err = rows["Q-GADMM-2b"]["max_theta_err"]
    if not err < bound:
        fail(f"path {mode}: Q-GADMM-2b max |theta - theta*| {err} >= {bound}")
    for alg, row in rows.items():
        if not np.isfinite(row["final_loss"]):
            fail(f"path {mode}: {alg} final loss {row['final_loss']}")
    print(f"  launches per run as the closed form, Q-GADMM bits per round == "
          f"closed form, Q-GADMM-2b max |theta - theta*| {err:.3e} < {bound:.3e}")
    print(json.dumps({"paper": {"path": mode, "rounds": r, "rows": [
        {k: v for k, v in row.items() if k != "sent_per_round"}
        for row in out["rows"]]}}))
    return launches


def dnn_path():
    """Path 7: ``launch/paper.py dnn`` at the paper's MLP with every launch
    count at 0 just before; checks launches, bits and accuracies; prints
    one JSON line and returns the launch counts."""
    import torch

    from repro_torch import kernels
    from repro_torch.launch import paper

    print("path dnn:")
    kernels.reset_launches()
    out = paper.run_dnn(paper.parse_args(["dnn", "--rounds",
                                          str(DNN_ROUNDS)]))
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    print(f"  launches: {launches}")
    rows = {row["alg"]: row for row in out["rows"]}
    q, f = rows["Q-SGADMM"], rows["SGADMM"]
    if q["launches"] != {K1: 2 * DNN_ROUNDS} or f["launches"] != {}:
        fail(f"path dnn: launches {q['launches']} / {f['launches']}")
    for k in kernels.KERNELS:
        if launches[k] != (2 * DNN_ROUNDS if k == K1 else 0):
            fail(f"path dnn: {k} launched {launches[k]} times in all")
    if q["params"] != DNN_D:
        fail(f"path dnn: the MLP has {q['params']} parameters")
    want = DNN_N * (DNN_BITS * DNN_D + 64)
    if q["bits_per_round"] != want or f["bits_per_round"] != DNN_N * 32 * DNN_D:
        fail(f"path dnn: bits per round {q['bits_per_round']} / "
             f"{f['bits_per_round']}, expected {want} / {DNN_N * 32 * DNN_D}")
    if not q["acc"] > f["acc"] - ACC_GAP:
        fail(f"path dnn: Q-SGADMM accuracy {q['acc']} not within {ACC_GAP} "
             f"of SGADMM's {f['acc']}")
    print(f"  launches as the closed form, bits per round == closed form, "
          f"accuracy {q['acc']:.3f} vs {f['acc']:.3f}")
    print(json.dumps({"paper": {"path": "dnn", "rounds": DNN_ROUNDS,
                                "rows": out["rows"]}}))
    return launches


def codec_at_paper_shapes(q_ops) -> float:
    """K1 at the shapes and widths of paths 5-7, one radius and width per
    row: Q-GADMM's (50, 6) at 2 and 4 bits, QGD / ADIANA's (50, 6) at 2
    bits from a zero hat, Q-SGADMM's (10, 109,386) at 8 bits; row 0 has
    R = 0 (hat == theta, or a zero gradient).  Kernel against plain version
    bitwise, and the receiver's decode against the sender's hat, as
    ``check_codec``; returns the largest error.  Then, on the same inputs,
    the kernel's device time per launch (torch.profiler) and, with CUDA
    events around 200 back-to-back calls, the wrapper's issue time per call
    (at these sizes the host issues slower than the card runs), beside the
    plain version's; not part of the kernels line."""
    import torch

    from repro_torch.launch.profile import _device_time
    out, worst = [], 0.0
    for tag, rows, n, bits, zero_hat in (
            ("Q-GADMM", LINREG_N, LINREG_D, 2, False),
            ("Q-GADMM", LINREG_N, LINREG_D, 4, False),
            ("QGD / ADIANA", LINREG_N, LINREG_D, 2, True),
            ("Q-SGADMM", DNN_N, DNN_D, DNN_BITS, False)):
        theta, hat, u, _ = codec_inputs(rows, n, torch.float32, 13 + bits)
        if zero_hat:
            hat = torch.zeros_like(theta)
            theta[0] = 0.0
        else:
            hat[0] = theta[0]
        r = (theta - hat).abs().amax(dim=1)
        lv = torch.full((rows,), 2.0 ** bits - 1.0, device="cuda")
        call = lambda: q_ops.quantize_dequantize(theta, hat, u, r, lv)
        plain = lambda: q_ops.quantize_dequantize_ref(
            theta, hat, u, r[:, None], lv[:, None])
        q, h = call()
        q_ref, h_ref = plain()
        torch.cuda.synchronize()
        name = f"{K1} {tag} ({rows}, {n}) {bits} bits"
        e = max_abs_err([(q, q_ref), (h, h_ref)])
        worst = max(worst, e)
        if not (bitwise_equal(q, q_ref) and bitwise_equal(h, h_ref)):
            fail(f"{name}: kernel != plain (max abs err {e})")
        if not bitwise_equal(q_ops.decode_ref(hat, q, r[:, None],
                                              lv[:, None]), h):
            fail(f"{name}: receiver decode != sender hat")
        if not bool((h[0] == hat[0]).all()):
            fail(f"{name}: the R == 0 row moved its hat")
        issue = time_ms(call, 200)
        plain_ms = time_ms(plain, 50)
        kern, _ = _device_time(lambda: [call() for _ in range(200)], 200)
        dev = sum(k[0] for k in kern if "qdq_kernel" in k[2])
        bound = (rows * n * 17 + 8 * rows) / HBM_BYTES_PER_S * 1e3
        out.append({"run": tag, "shape": [rows, n], "bits": bits,
                    "device_ms": dev, "issue_ms": issue, "plain_ms": plain_ms,
                    "bound_ms": bound})
        print(f"  {name}: bitwise equal to plain, decode == hat; "
              f"{dev:.5f} ms on the card per launch (bound {bound:.6f} ms by "
              f"bytes, reckoned), {issue:.4f} ms per call issued back to "
              f"back, plain {plain_ms:.4f} ms")
    print(json.dumps({"codec_at_paper_shapes": out}))
    return worst


def paper_idle_share():
    """The device's busy and idle share of paths 5-7 as ``launch/paper.py``
    runs them, cut to 100 rounds (linreg) and 5 rounds (dnn), set-up and
    the objective's evaluation included: the device time of one call under
    torch.profiler against the wall time of one call unprofiled (host
    clock, synced)."""
    import contextlib
    import io

    import torch

    from repro_torch.launch import paper
    from repro_torch.launch.profile import _device_time

    cases = [("linreg chain (path 5)", paper.run_linreg,
              ["linreg", "--rounds", "100"]),
             ("linreg ring, censored (path 6)", paper.run_linreg,
              ["linreg", "--rounds", "100", "--topology", "ring",
               "--censor"]),
             ("dnn (path 7)", paper.run_dnn, ["dnn", "--rounds", "5"])]
    out = []
    for name, run, argv in cases:
        args = paper.parse_args(argv)
        fn = lambda: run(args)
        with contextlib.redirect_stdout(io.StringIO()):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
            kern, _ = _device_time(fn, 1)
        busy = sum(k[0] for k in kern)
        launches = sum(k[1] for k in kern)
        codec = sum(k[0] for k in kern if "qdq_kernel" in k[2])
        out.append({"run": name, "argv": argv, "wall_ms": wall,
                    "device_ms": busy, "idle_share": 1 - busy / wall,
                    "kernel_launches": launches, "codec_ms": codec,
                    "ms_per_round": {r["alg"]: r.get("ms_per_round",
                                                     r.get("median_round_ms"))
                                     for r in res["rows"]}})
        print(f"  {name}: {wall:.1f} ms wall, {busy:.2f} ms device "
              f"({launches:.0f} kernels, codec {codec:.3f} ms), idle "
              f"{100 * (1 - busy / wall):.1f}%")
    print(json.dumps({"paper_profile": out}))


def trainer_profiles():
    """Step time, peak memory and the device's busy and idle share of
    trainer paths 8-10 (``launch/profile.py``'s ``profile_trainer``: 2
    warm-up steps, 3 timed, 3 under torch.profiler)."""
    import contextlib
    import io

    import torch

    from repro_torch.launch import profile, train
    cli = ["--arch", "whisper-tiny", "--workers", str(W), "--bits", str(BITS)]
    cases = [
        ("path 8 ring, staleness 2, participation 0.75", lambda: train.setup(
            train.parse_args(cli + ["--topology", "ring", "--staleness", "2",
                                    "--participation", "0.75"]))),
        ("path 9 overlap, microbatches 2",
         lambda: api_setup(overlap=True, microbatches=2)),
        ("path 10 jacobi, full precision", lambda: train.setup(
            train.parse_args(cli + ["--mode", "jacobi", "--no-quantize"]))),
    ]
    out = []
    for name, setup in cases:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with contextlib.redirect_stdout(io.StringIO()):
            res, _ = profile.profile_trainer(*setup(), 2, 3)
        res = {"run": name, "peak_bytes": torch.cuda.max_memory_allocated(),
               **{k: res[k] for k in ("step_ms", "device_busy_ms",
                                      "idle_share", "groups_ms")}}
        out.append(res)
        print(f"  {name}: {res['step_ms']:.1f} ms per step, "
              f"{res['device_busy_ms']:.1f} ms device, idle "
              f"{100 * res['idle_share']:.1f}%, peak {res['peak_bytes']:,} B")
    print(json.dumps({"trainer_profile": out}))


if __name__ == "__main__":
    sys.exit(main())
