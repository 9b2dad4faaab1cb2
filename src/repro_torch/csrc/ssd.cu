// Intra-chunk SSD: the quadratic half of Mamba2's chunked state-space-duality
// scan (arXiv:2405.21060), for one group of B/C shared by every head (G = 1).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd/ssd.py:_kernel (through
// its wrapper ssd_intra).  For each row bc of BC = batch * chunks:
//   CB[t,k]   = sum_n C[t,n] * B[k,n]
//   W[t,k,h]  = CB[t,k] * exp(la[t,h] - la[k,h]) * dt[k,h]   for k <= t, else 0
//   y[t,h,:]  = sum_k W[t,k,h] * x[k,h,:]
// x (BC,Q,H,P), dt and la (BC,Q,H), b and c (BC,Q,N): all float32 or all
// bfloat16, contiguous; y (BC,Q,H,P) float32.  Every sum is taken in float32
// with CUDA-core FMAs (no tensor cores, so no TF32), in another order than the
// plain version's: the two agree to a stated tolerance, not bitwise.
//
// Bound on an H100 (reckoned from shapes, not measured): operations.  At the
// serving shape (BC 16, Q 256, H 80, P 64, N 128) the causal half needs
// BC * Q(Q+1)/2 * (2 P H + 2 N) = 5.52 GFLOP, 0.082 ms at the 67 TFLOP/s
// float32 rate, against 175 MB of inputs and outputs, 0.052 ms at 3.35 TB/s.
//
// Design.  A block owns TQ = 64 query rows t of one bc, HB = 16 heads and
// TP = 64 head-dim columns; 256 threads, each holding a 4 x 4 register tile
// (rows ty + 16i, columns tx + 16j).
//   1. CB for the block's rows and every key k below the block's last row is
//      computed once, staged 16 state columns at a time, and kept in shared
//      memory (TQ x Qpad floats): it is shared by every head, since G = 1.
//   2. For each head, the key tiles 0..(the diagonal tile) are walked: the
//      key tile of x goes to shared memory, the W tile is formed there from
//      CB, la and dt, and the register tile accumulates W . x.  Key tiles
//      above the diagonal are skipped (causality halves the work).
// The decay is masked in the exponent: exp is taken only for k <= t, where
// la[t] - la[k] <= 0 (la is a decreasing cumulative sum), never of the
// positive differences above the diagonal.  Ragged Q, H, P and N are masked
// on load and store; nothing is padded in device memory.  Shared memory is
// (TQ * Qpad + TK * TP + TQ * (TK + 1) + TQ + 2 TK) floats, 99,328 B at
// Q = 256, so Q is limited to 768.  Simple and right first: wgmma / TMA and
// a persistent schedule are later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TQ = 64;          // query rows per block
constexpr int TK = 64;          // keys per tile (== TQ: tile tt is the diagonal)
constexpr int TP = 64;          // head-dim columns per block
constexpr int HB = 16;          // heads per block
constexpr int NCH = 16;         // state columns staged per step of CB
constexpr int WSTR = TK + 1;    // row stride of the W tile (no bank conflicts)
constexpr int BSTR = TK + 1;    // row stride of the staged B^T
constexpr int kThreads = 256;   // 16 x 16
constexpr int kMaxQ = 768;

enum { DTYPE_F32 = 0, DTYPE_BF16 = 1 };

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }

int smem_floats(int qpad) { return TQ * qpad + TK * TP + TQ * WSTR + TQ + 2 * TK; }

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_intra_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                 const T* __restrict__ la, const T* __restrict__ b,
                 const T* __restrict__ c, float* __restrict__ y,
                 int Q, int H, int P, int N, int qpad, int n_ttiles,
                 int n_pchunks) {
  extern __shared__ float smem[];
  float* cbs = smem;              // TQ x qpad
  float* xs = cbs + TQ * qpad;    // TK x TP; staging of C and B^T in step 1
  float* ws = xs + TK * TP;       // TQ x WSTR
  float* lat = ws + TQ * WSTR;    // TQ
  float* lak = lat + TQ;          // TK
  float* dtk = lak + TK;          // TK

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int64_t bc = blockIdx.x / n_ttiles;
  const int tt = blockIdx.x % n_ttiles;
  const int h0 = (blockIdx.y / n_pchunks) * HB;
  const int p0 = (blockIdx.y % n_pchunks) * TP;
  const int t0 = tt * TQ;
  const int nkt = tt + 1;
  const int64_t row0 = bc * Q;    // first (bc, t) row

  // ---- 1. CB[t0 .. t0+TQ, 0 .. nkt*TK) into shared memory ----------------
  float* cst = xs;                // TQ x NCH
  float* bst = xs + TQ * NCH;     // NCH x BSTR
  const T* cb_c = c + row0 * N;
  const T* cb_b = b + row0 * N;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * TK;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int n0 = 0; n0 < N; n0 += NCH) {
      for (int e = tid; e < TQ * NCH; e += kThreads) {
        const int r = e / NCH, n = e % NCH, nn = n0 + n;
        const int t = t0 + r, k = k0 + r;
        cst[r * NCH + n] = (t < Q && nn < N) ? ld(cb_c + (int64_t)t * N + nn) : 0.f;
        bst[n * BSTR + r] = (k < Q && nn < N) ? ld(cb_b + (int64_t)k * N + nn) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int n = 0; n < NCH; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = cst[(ty + 16 * i) * NCH + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = bst[n * BSTR + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        cbs[(ty + 16 * i) * qpad + k0 + tx + 16 * j] = acc[i][j];
  }

  // ---- 2. per head: y[t, h, p0..] = sum over k <= t of W[t, k] x[k, h, p0..]
  const int nh = min(HB, H - h0);
  const int pw = min(TP, P - p0);
  for (int hh = 0; hh < nh; ++hh) {
    const int h = h0 + hh;
    if (tid < TQ) {
      const int t = t0 + tid;
      lat[tid] = t < Q ? ld(la + (row0 + t) * H + h) : 0.f;
    }
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int kt = 0; kt < nkt; ++kt) {
      const int k0 = kt * TK;
      __syncthreads();            // the previous tile's xs / ws reads are done
      if (tid < TK) {
        const int k = k0 + tid;
        lak[tid] = k < Q ? ld(la + (row0 + k) * H + h) : 0.f;
        dtk[tid] = k < Q ? ld(dt + (row0 + k) * H + h) : 0.f;
      }
      for (int e = tid; e < TK * TP; e += kThreads) {
        const int r = e / TP, col = e % TP, k = k0 + r;
        xs[e] = (k < Q && col < pw) ? ld(x + ((row0 + k) * H + h) * P + p0 + col) : 0.f;
      }
      __syncthreads();
      for (int e = tid; e < TQ * TK; e += kThreads) {
        const int r = e / TK, kc = e % TK, t = t0 + r, k = k0 + kc;
        float w = 0.f;
        if (k <= t && t < Q)      // the exponent is masked, never exp(> 0)
          w = cbs[r * qpad + k] * expf(lat[r] - lak[kc]) * dtk[kc];
        ws[r * WSTR + kc] = w;
      }
      __syncthreads();
#pragma unroll 8
      for (int kc = 0; kc < TK; ++kc) {
        float wv[4], xv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) wv[i] = ws[(ty + 16 * i) * WSTR + kc];
#pragma unroll
        for (int j = 0; j < 4; ++j) xv[j] = xs[kc * TP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(wv[i], xv[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + ty + 16 * i;
      if (t >= Q) continue;
      float* yr = y + ((row0 + t) * H + h) * P + p0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        if (col < pw) yr[col] = acc[i][j];
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* la, const void* b,
           const void* c, void* y, long long bc, int q, int h, int p, int n,
           cudaStream_t stream) {
  const int n_ttiles = (q + TQ - 1) / TQ;
  const int qpad = n_ttiles * TK;
  const int n_pchunks = (p + TP - 1) / TP;
  const size_t smem = sizeof(float) * (size_t)smem_floats(qpad);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_intra_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(bc * n_ttiles), (unsigned)(((h + HB - 1) / HB) * n_pchunks));
  ssd_intra_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), static_cast<const T*>(la),
      static_cast<const T*>(b), static_cast<const T*>(c), static_cast<float*>(y),
      q, h, p, n, qpad, n_ttiles, n_pchunks);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The largest chunk length Q the kernel takes (its CB rows live in shared memory).
int repro_ssd_max_q() { return kMaxQ; }

// x (bc,q,h,p), dt/la (bc,q,h), b/c (bc,q,n), all of `dtype` (0 float32,
// 1 bfloat16), contiguous -> y (bc,q,h,p) float32.  Returns the CUDA error
// of the launch (0 on success); -1 for arguments the kernel does not take.
int repro_ssd_intra(int dtype, const void* x, const void* dt, const void* la,
                    const void* b, const void* c, void* y, long long bc, int q,
                    int h, int p, int n, void* stream) {
  if (bc <= 0 || q <= 0 || q > kMaxQ || h <= 0 || p <= 0 || n <= 0) return -1;
  if (bc * ((q + TQ - 1) / TQ) > 0x7fffffffLL) return -1;
  if ((long long)((h + HB - 1) / HB) * ((p + TP - 1) / TP) > 65535) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32) return launch<float>(x, dt, la, b, c, y, bc, q, h, p, n, s);
  if (dtype == DTYPE_BF16) return launch<__nv_bfloat16>(x, dt, la, b, c, y, bc, q, h, p, n, s);
  return -1;
}

const char* repro_ssd_error_string(int code) {
  if (code == -1) return "arguments the ssd_intra kernel does not take";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
