// Intra-chunk SSD: the quadratic half of Mamba2's chunked state-space-duality
// scan (arXiv:2405.21060), for one group of B/C shared by every head (G = 1).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd/ssd.py:_kernel (through
// its wrapper ssd_intra).  For each row bc of BC = batch * chunks:
//   CB[t,k]   = sum_n C[t,n] * B[k,n]
//   W[t,k,h]  = CB[t,k] * exp(la[t,h] - la[k,h]) * dt[k,h]   for k <= t, else 0
//   y[t,h,:]  = sum_k W[t,k,h] * x[k,h,:]
// x (BC,Q,H,P), dt and la (BC,Q,H), b and c (BC,Q,N): all float32 or all
// bfloat16, contiguous; y (BC,Q,H,P) float32.
//
// Precision: both products run on the tensor cores (mma.sync m16n8k8, TF32
// operands, float32 accumulation) split 3xTF32: each float32 operand a is
// hi = tf32_rna(a) and lo = a - hi truncated to TF32, and a.b is taken as
// lo.hi + hi.lo + hi.hi (lo.lo dropped), about 2^-21 relative per product:
// float32-accurate, not bitwise equal to the plain version (gate: 1e-5 x
// max |y|; TF32 alone would give about 6e-4).  bf16 inputs are exact in
// TF32, so their lo is 0 and that pass is skipped: CB takes one pass, W.x two.
//
// Bound on an H100 (reckoned from shapes, not measured): bytes.  At the
// serving shape (BC 16, Q 256, H 80, P 64, N 128) the causal half needs
// BC * Q(Q+1)/2 * (2 P H + 2 N) = 5.52 GFLOP, three times over in 3xTF32:
// 0.033 ms at the 495 TFLOP/s TF32 rate, against 175 MB of inputs and
// outputs, 0.052 ms at 3.35 TB/s.  (On the CUDA cores in float32 it was
// bound by operations, 0.082 ms at 67 TFLOP/s.)
//
// Design.  A block has 4 warps and owns one bc, a pair of query tiles of
// TQ = 64 rows, HG = 10 heads and TP = 64 head-dim columns; warp w owns query
// rows 16w..16w+15.  What it does about each cost of the first (CUDA-core)
// version of this kernel:
//   1. Products on the CUDA cores, shared-memory bound: both products run on
//      the tensor cores in 3xTF32 (above), pass by pass over 8 independent
//      accumulators.  The split is integer work (add, mask) plus one
//      subtraction.
//   2. W's round trip through shared memory: W is formed in registers,
//      straight in the A-fragment layout.  The fragment's columns tig and
//      tig+4 are taken as keys 2 tig and 2 tig+1, the C-fragment's columns
//      where CB lies, and x's B fragment reads the same two keys.  The
//      exponent is masked: exp(-inf) = 0 where k > t (only in the diagonal
//      tile), never exp of the positive differences above the diagonal.
//   3. Three barriers per key tile and synchronous x loads: x's key tiles (64
//      keys x 64 columns) stream through a ring of 16-byte cp.async copies
//      with one barrier per tile; tile i+1 loads while tile i is multiplied,
//      and so do la[k], dt[k] and la[t] of tile i+1, into registers.
//      C and B go through a three-stage ring of 16 state columns.
//   4. Few, uneven blocks: a block takes query tile tt and tile NT-1-tt, so
//      every block walks NT+1 key tiles (at even NT); at the serving shape
//      16 bc x 2 pairs x 8 head groups = 256 equal blocks, one wave at two
//      blocks per SM (101,888 B of shared memory each in float32).
//   5. CB recomputed per head group on the CUDA cores: CB for the tile's rows
//      is computed once per block on the tensor cores and reused by its 10
//      heads.  The head group is the trade between that recomputation (CB
//      costs as much as two heads of W.x) and the grid (80 / 10 groups make
//      the one wave above); the accumulators do not grow with it, since the
//      heads run one after the other.  Each thread keeps its CB fragment in
//      shared memory in its own lane's slot and reads back only what it wrote.
// y is written from the accumulators with 8-byte stores where P is even.
// Ragged Q, H, P and N are masked on load and store (zero-filled copies);
// nothing is padded in device memory.  CB is kept for at most KC = 256 keys:
// a longer chunk (Q up to 768) takes its keys in spans of 256, the later
// spans adding to the y the earlier ones stored.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TQ = 64;          // query rows per tile (4 warps x 16)
constexpr int TK = 64;          // keys per tile (== TQ: tile tt is the diagonal)
constexpr int TP = 64;          // head-dim columns per block
constexpr int HG = 10;          // heads per block
constexpr int KC = 256;         // keys whose CB a block keeps at once
constexpr int NCH = 16;         // state columns staged per step of CB
constexpr int kCbStages = 3;    // stages of the C / B staging ring
constexpr int kXStages = 2;     // stages of the x ring
constexpr int kMinBlocks = 2;   // blocks per SM the registers are sized for
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxQ = 768;

enum { DTYPE_F32 = 0, DTYPE_BF16 = 1 };

template <typename T> struct Cfg;
// Row strides (elements) of the staged tiles, chosen so that the fragment
// reads of a warp hit 32 distinct banks and every row starts 16-byte aligned.
template <> struct Cfg<float> {
  static constexpr int XSTR = TP + 4;    // 272 B
  static constexpr int SSTR = NCH + 4;   // 80 B
  static constexpr bool kExact = false;  // float32 needs the lo passes
};
template <> struct Cfg<__nv_bfloat16> {
  static constexpr int XSTR = TP + 8;    // 144 B
  static constexpr int SSTR = NCH + 8;   // 48 B
  static constexpr bool kExact = true;   // bf16 is exact in TF32
};

template <typename T>
__host__ __device__ constexpr int x_stage_bytes() { return TK * Cfg<T>::XSTR * (int)sizeof(T); }
template <typename T>
__host__ __device__ constexpr int s_stage_bytes() { return 2 * TQ * Cfg<T>::SSTR * (int)sizeof(T); }
template <typename T>
__host__ __device__ constexpr int ring_bytes() {
  return kXStages * x_stage_bytes<T>() > kCbStages * s_stage_bytes<T>()
             ? kXStages * x_stage_bytes<T>() : kCbStages * s_stage_bytes<T>();
}
constexpr int kCbBytes = kWarps * (KC / 8) * 2 * 32 * 8;   // float2 per lane
constexpr int kVecBytes = kXStages * 3 * TK * 4;           // la_k, dt_k, la_t
template <typename T>
__host__ __device__ constexpr int smem_bytes() { return kCbBytes + ring_bytes<T>() + kVecBytes; }

__device__ __forceinline__ float tof(float v) { return v; }
__device__ __forceinline__ float tof(__nv_bfloat16 v) { return __bfloat162float(v); }

// a = hi + lo to about 2^-21 relative: hi is a rounded to the nearest TF32
// value, ties away from zero (as cvt.rna.tf32.f32: add half of the 13 dropped
// bits to the magnitude, then clear them); lo = a - hi, exact in float32, is
// truncated to TF32.  Integer and one float operation: the x operand is split
// by every warp that reads it, so the split is on the hot path.
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(a) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(a - __uint_as_float(hi)) & 0xFFFFE000u;
}

// A value that is exact in TF32 (a bf16 input): hi = a, lo = 0.
template <bool kExact>
__device__ __forceinline__ void split_in(float a, uint32_t& hi, uint32_t& lo) {
  if (kExact) { hi = __float_as_uint(a); lo = 0u; }
  else split(a, hi, lo);
}

// Not volatile: the products have no side effects, so the compiler may
// interleave the independent accumulators' products.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d[j] += a.b[j] for 8 n-tiles in 3xTF32: lo.hi, hi.lo, hi.hi (smallest
// terms first), pass by pass over the n-tiles so that consecutive products
// feed different accumulators.  Passes whose lo is known to be zero are
// skipped.
template <bool kExactA, bool kExactB>
__device__ __forceinline__ void mma3x8(float (&d)[8][4], const uint32_t (&ah)[4],
                                       const uint32_t (&al)[4],
                                       const uint32_t (&bh)[8][2],
                                       const uint32_t (&bl)[8][2]) {
  if (!kExactA) {
#pragma unroll
    for (int j = 0; j < 8; ++j) mma(d[j], al, bh[j][0], bh[j][1]);
  }
  if (!kExactB) {
#pragma unroll
    for (int j = 0; j < 8; ++j) mma(d[j], ah, bl[j][0], bl[j][1]);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) mma(d[j], ah, bh[j][0], bh[j][1]);
}

// One key tile of y += W . x for a warp's 16 rows and 64 columns.  W is
// formed in registers in the A-fragment layout: its columns tig and tig+4
// are keys kk = 8j + 2 tig and kk + 1, the C-fragment columns where the
// warp's CB lies (cbp), and x's B fragment reads the same two keys.  In the
// diagonal tile (diag) the exponent is masked: exp(-inf) = 0 where k > t.
template <typename T>
__device__ __forceinline__ void wx_tile(float (&acc)[8][4], const float2* cbp,
                                        const float* vs, const T* xs, float lta,
                                        float ltb, int row_a, int g, bool diag) {
  constexpr int XSTR = Cfg<T>::XSTR;
  const int tig = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int kk = 8 * j + 2 * tig;
    const float2 ca = cbp[64 * j], cb2 = cbp[64 * j + 32];
    const float2 lk = *reinterpret_cast<const float2*>(vs + kk);
    const float2 dk = *reinterpret_cast<const float2*>(vs + TK + kk);
    float da0 = lta - lk.x, da1 = lta - lk.y, db0 = ltb - lk.x, db1 = ltb - lk.y;
    if (diag) {
      if (kk > row_a) da0 = -INFINITY;
      if (kk + 1 > row_a) da1 = -INFINITY;
      if (kk > row_a + 8) db0 = -INFINITY;
      if (kk + 1 > row_a + 8) db1 = -INFINITY;
    }
    uint32_t ah[4], al[4];
    split(ca.x * expf(da0) * dk.x, ah[0], al[0]);    // W[row a, kk]
    split(cb2.x * expf(db0) * dk.x, ah[1], al[1]);   // W[row a + 8, kk]
    split(ca.y * expf(da1) * dk.y, ah[2], al[2]);    // W[row a, kk + 1]
    split(cb2.y * expf(db1) * dk.y, ah[3], al[3]);   // W[row a + 8, kk + 1]
    const T* xr = xs + kk * XSTR + g;
    uint32_t bh[8][2], bl[8][2];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      split_in<Cfg<T>::kExact>(tof(xr[8 * i]), bh[i][0], bl[i][0]);
      split_in<Cfg<T>::kExact>(tof(xr[XSTR + 8 * i]), bh[i][1], bl[i][1]);
    }
    mma3x8<false, Cfg<T>::kExact>(acc, ah, al, bh, bl);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int kPending>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// Copy a rows x cols tile (row r at src + r * src_stride, zero beyond
// rows_valid / cols_valid) into shared memory with row stride dst_stride.
// With vec, 16-byte cp.async copies (cols_valid a multiple of the chunk);
// otherwise element by element.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int dst_stride, const T* src,
                                          int64_t src_stride, int rows, int cols,
                                          int rows_valid, int cols_valid, bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int E = 16 / sizeof(T);
    const int cpr = cols / E;
    for (int e = tid; e < rows * cpr; e += kThreads) {
      const int r = e / cpr, c = (e % cpr) * E;
      const bool ok = r < rows_valid && c < cols_valid;
      cp_async16(dst + r * dst_stride + c, ok ? src + r * src_stride + c : src, ok);
    }
  } else {
    for (int e = tid; e < rows * cols; e += kThreads) {
      const int r = e / cols, c = e % cols;
      dst[r * dst_stride + c] = (r < rows_valid && c < cols_valid)
                                    ? src[r * src_stride + c] : T(0.f);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
ssd_intra_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                 const T* __restrict__ la, const T* __restrict__ b,
                 const T* __restrict__ c, float* __restrict__ y,
                 int Q, int H, int P, int N, int n_tiles, int n_pairs,
                 int n_pchunks, int vec_x, int vec_bc) {
  constexpr int XSTR = Cfg<T>::XSTR, SSTR = Cfg<T>::SSTR;
  constexpr bool kExact = Cfg<T>::kExact;
  extern __shared__ __align__(16) unsigned char smem[];
  float2* cbs = reinterpret_cast<float2*>(smem);                  // CB fragments
  unsigned char* ring = smem + kCbBytes;                          // x or C / B stages
  float* vecs = reinterpret_cast<float*>(ring + ring_bytes<T>());  // [stage][3][TK]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int r0 = 16 * warp;                 // the warp's first row in the tile
  const int64_t bc = blockIdx.x / n_pairs;
  const int pair = blockIdx.x % n_pairs;
  const int h0 = (blockIdx.y / n_pchunks) * HG;
  const int p0 = (blockIdx.y % n_pchunks) * TP;
  const int nh = min(HG, H - h0);
  const int pw = min(TP, P - p0);
  const int nsc = (N + NCH - 1) / NCH;
  const int64_t row0 = bc * Q;              // first (bc, t) row
  const T* xb = x + (row0 * H) * P + p0;
  const T* cb_c = c + row0 * N;
  const T* cb_b = b + row0 * N;

  for (int which = 0; which < 2; ++which) {
    const int tt = which == 0 ? pair : n_tiles - 1 - pair;
    if (which == 1 && tt == pair) break;    // odd tile count: the middle tile
    const int t0 = tt * TQ;
    const int nk = (tt + 1) * TK;           // keys 0 .. the diagonal tile
    for (int ks = 0; ks < nk; ks += KC) {
      const int ntk = min(KC, nk - ks) / TK;

      // ---- 1. CB[t0 .. t0+TQ, ks .. ks+ntk*TK) on the tensor cores ---------
      {
        __syncthreads();                    // the ring's last readers are done
        auto stage_c = [&](int it) {
          return reinterpret_cast<T*>(ring + (it % kCbStages) * s_stage_bytes<T>());
        };
        const int n_items = ntk * nsc;
        // every call commits one group (empty past the last item), so that
        // wait_group counts items
        auto issue = [&](int it) {
          if (it < n_items) {
            const int kt = it / nsc, sc = it % nsc;
            const int n0 = sc * NCH, k0 = ks + kt * TK;
            T* cs = stage_c(it);
            T* bs = cs + TQ * SSTR;
            load_tile<T>(cs, SSTR, cb_c + (int64_t)t0 * N + n0, N, TQ, NCH,
                         Q - t0, N - n0, vec_bc);
            load_tile<T>(bs, SSTR, cb_b + (int64_t)k0 * N + n0, N, TK, NCH,
                         Q - k0, N - n0, vec_bc);
          }
          cp_commit();
        };
        float acc[8][4];
#pragma unroll
        for (int it = 0; it < kCbStages - 1; ++it) issue(it);
        for (int it = 0; it < n_items; ++it) {
          cp_wait<kCbStages - 2>();         // item it has landed
          __syncthreads();                  // and item it-1's stage is free
          issue(it + kCbStages - 1);
          const int kt = it / nsc, sc = it % nsc;
          if (sc == 0) {
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
          }
          const T* cs = stage_c(it);
          const T* bs = cs + TQ * SSTR;
#pragma unroll
          for (int s8 = 0; s8 < NCH; s8 += 8) {
            uint32_t ah[4], al[4];
            const T* cr = cs + (r0 + g) * SSTR + s8 + tig;
            split_in<kExact>(tof(cr[0]), ah[0], al[0]);
            split_in<kExact>(tof(cr[8 * SSTR]), ah[1], al[1]);
            split_in<kExact>(tof(cr[4]), ah[2], al[2]);
            split_in<kExact>(tof(cr[8 * SSTR + 4]), ah[3], al[3]);
            uint32_t bh[8][2], bl[8][2];
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const T* br = bs + (8 * j + g) * SSTR + s8 + tig;
              split_in<kExact>(tof(br[0]), bh[j][0], bl[j][0]);
              split_in<kExact>(tof(br[4]), bh[j][1], bl[j][1]);
            }
            mma3x8<kExact, kExact>(acc, ah, al, bh, bl);
          }
          if (sc == nsc - 1) {
            // C fragment: rows g / g+8, keys 8j + 2 tig, +1; kept per lane
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              float2* dst = cbs + ((warp * (KC / 8) + kt * 8 + j) * 2) * 32 + lane;
              dst[0] = make_float2(acc[j][0], acc[j][1]);
              dst[32] = make_float2(acc[j][2], acc[j][3]);
            }
          }
        }
      }

      // ---- 2. per head: y[t, h, p0..] += sum over keys of this span --------
      {
        __syncthreads();                    // the CB staging reads are done
        auto stage_x = [&](int it) {
          return reinterpret_cast<T*>(ring + (it % kXStages) * x_stage_bytes<T>());
        };
        const int n_items = nh * ntk;
        // la[k], dt[k] (threads 0..63: la_k and la_t; 64..127: dt_k) of an
        // item, loaded into registers while the item before is multiplied
        auto fetch = [&](int it, float& v0, float& v1) {
          v0 = v1 = 0.f;
          if (it >= n_items) return;
          const int h = h0 + it / ntk;
          const int k0 = ks + (it % ntk) * TK;
          const int r = tid & (TK - 1);
          const int k = k0 + r, t = t0 + r;
          if (tid < TK) {
            if (k < Q) v0 = tof(la[(row0 + k) * H + h]);
            if (t < Q) v1 = tof(la[(row0 + t) * H + h]);
          } else if (k < Q) {
            v0 = tof(dt[(row0 + k) * H + h]);
          }
        };
        auto put = [&](int it, float v0, float v1) {
          float* vs = vecs + (it % kXStages) * 3 * TK;    // [la_k | dt_k | la_t]
          const int r = tid & (TK - 1);
          if (tid < TK) { vs[r] = v0; vs[2 * TK + r] = v1; }
          else vs[TK + r] = v0;
        };
        // every call commits one group (empty past the last item)
        auto issue = [&](int it) {
          if (it < n_items) {
            const int h = h0 + it / ntk;
            const int k0 = ks + (it % ntk) * TK;
            load_tile<T>(stage_x(it), XSTR, xb + ((int64_t)k0 * H + h) * P,
                         (int64_t)H * P, TK, TP, Q - k0, pw, vec_x);
          }
          cp_commit();
        };
        {
          float v0, v1;
          fetch(0, v0, v1);
          put(0, v0, v1);
#pragma unroll
          for (int i = 0; i < kXStages - 1; ++i) issue(i);
        }
        float acc[8][4];
        for (int it = 0; it < n_items; ++it) {
          cp_wait<kXStages - 2>();          // item it has landed
          __syncthreads();                  // and item it-1's stage is free
          issue(it + kXStages - 1);
          float v0, v1;
          fetch(it + 1, v0, v1);
          const int hh = it / ntk, kt = it % ntk;
          const int h = h0 + hh;
          const int ktg = ks / TK + kt;
          const bool diag = ktg == tt;
          const int ta = t0 + r0 + g, tb = ta + 8;       // this lane's rows
          float* yr_a = y + ((row0 + ta) * H + h) * P + p0;
          float* yr_b = y + ((row0 + tb) * H + h) * P + p0;
          const bool pe = (P & 1) == 0;
          if (kt == 0) {
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const int col = 8 * i + 2 * tig;
              float v[4] = {0.f, 0.f, 0.f, 0.f};
              if (ks > 0) {                 // a later key span adds to y
                if (ta < Q && col < pw) { v[0] = yr_a[col]; if (col + 1 < pw) v[1] = yr_a[col + 1]; }
                if (tb < Q && col < pw) { v[2] = yr_b[col]; if (col + 1 < pw) v[3] = yr_b[col + 1]; }
              }
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[i][e] = v[e];
            }
          }
          const float* vs = vecs + (it % kXStages) * 3 * TK;
          const float lta = vs[2 * TK + r0 + g], ltb = vs[2 * TK + r0 + g + 8];
          const T* xs = stage_x(it);
          const float2* cbp = cbs + (warp * (KC / 8) + kt * 8) * 64 + lane;
          wx_tile<T>(acc, cbp, vs, xs, lta, ltb, r0 + g, g, diag);
          if (kt == ntk - 1) {
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const int col = 8 * i + 2 * tig;
              if (col >= pw) continue;
              if (pe) {
                if (ta < Q) *reinterpret_cast<float2*>(yr_a + col) = make_float2(acc[i][0], acc[i][1]);
                if (tb < Q) *reinterpret_cast<float2*>(yr_b + col) = make_float2(acc[i][2], acc[i][3]);
              } else {
                if (ta < Q) { yr_a[col] = acc[i][0]; if (col + 1 < pw) yr_a[col + 1] = acc[i][1]; }
                if (tb < Q) { yr_b[col] = acc[i][2]; if (col + 1 < pw) yr_b[col + 1] = acc[i][3]; }
              }
            }
          }
          put(it + 1, v0, v1);              // its stage was read in item it-1
        }
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* la, const void* b,
           const void* c, void* y, long long bc, int q, int h, int p, int n,
           cudaStream_t stream) {
  const int n_tiles = (q + TQ - 1) / TQ;
  const int n_pairs = (n_tiles + 1) / 2;
  const int n_pchunks = (p + TP - 1) / TP;
  constexpr int smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      ssd_intra_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  auto aligned = [](const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; };
  const int vec_x = (p * (int)sizeof(T)) % 16 == 0 && aligned(x);
  const int vec_bc = (n * (int)sizeof(T)) % 16 == 0 && aligned(b) && aligned(c);
  const dim3 grid((unsigned)(bc * n_pairs), (unsigned)(((h + HG - 1) / HG) * n_pchunks));
  ssd_intra_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), static_cast<const T*>(la),
      static_cast<const T*>(b), static_cast<const T*>(c), static_cast<float*>(y),
      q, h, p, n, n_tiles, n_pairs, n_pchunks, vec_x, vec_bc);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The largest chunk length Q the kernel takes.
int repro_ssd_max_q() { return kMaxQ; }

// x (bc,q,h,p), dt/la (bc,q,h), b/c (bc,q,n), all of `dtype` (0 float32,
// 1 bfloat16), contiguous -> y (bc,q,h,p) float32.  Returns the CUDA error
// of the launch (0 on success); -1 for arguments the kernel does not take.
int repro_ssd_intra(int dtype, const void* x, const void* dt, const void* la,
                    const void* b, const void* c, void* y, long long bc, int q,
                    int h, int p, int n, void* stream) {
  if (bc <= 0 || q <= 0 || q > kMaxQ || h <= 0 || p <= 0 || n <= 0) return -1;
  if (bc * (((q + TQ - 1) / TQ + 1) / 2) > 0x7fffffffLL) return -1;
  if ((long long)((h + HG - 1) / HG) * ((p + TP - 1) / TP) > 65535) return -1;
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
