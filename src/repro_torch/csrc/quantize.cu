// Fused stochastic quantize-dequantize of the Q-GADMM wire (paper eqs. 6-13).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/quantize/quantize.py:
//   _kernel        (scalar R and levels)          -> MODE_R_ROW
//   _kernel_vec_r  (per-element R)                -> MODE_R_ELEM
//   _kernel_vec_rl (per-element R and levels)     -> MODE_RL_ELEM
// all sharing the body of _qdq_math.
//
// Per element of a (rows, cols) buffer, with a supplied uniform draw u:
//   step = 2 * max(R, 1e-30) / levels
//   c    = (x - h + R) / step
//   q    = clip(floor(c) + (u < c - floor(c)), 0, levels)      -> uint8
//   hat  = (h + step * q) - R                                  -> hat's dtype
// and where R == 0: q = 0 and the hat is left unchanged.  MODE_R_ROW takes one
// R and one levels value per row (the trainer's (W,) global radius and bit
// widths); the per-element modes read them from (rows, cols) buffers.
//
// Rounding: the receiver decodes the same hat with plain PyTorch ops, one
// rounded f32 operation at a time, so every operation here is an explicit
// round-to-nearest intrinsic.  nvcc would otherwise contract h + step * q into
// an FMA, and a hat that differs by one ulp desyncs sender and receiver.  No
// --use_fast_math.  The bf16 hat is rounded to nearest even, as torch's cast.
//
// Bound on an H100 (reckoned from shapes, not measured): memory.  The f32 form
// reads theta, hat and u (12 B) and writes q and the hat (5 B): 17 B per
// element, 3.83 GB for the trainer's (4, 56,355,840) whisper-tiny buffer, so
// at least 1.14 ms at 3.35 TB/s.  About a dozen flops per element is far below
// the card's float32 rate.
//
// Design: one flat grid-stride pass, blockIdx.y selecting the row, one element
// per thread per iteration; the ragged tail is masked by the loop bound, so no
// padding to 128 lanes.  This first version is simple and right; vectorised
// 16-byte accesses and other speed work come later.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

enum { MODE_R_ROW = 0, MODE_R_ELEM = 1, MODE_RL_ELEM = 2 };
enum { DTYPE_F32 = 0, DTYPE_BF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

template <typename T, int MODE>
__global__ void qdq_kernel(const T* __restrict__ theta, const T* __restrict__ hat,
                           const float* __restrict__ u,
                           const float* __restrict__ radius,
                           const float* __restrict__ levels,
                           uint8_t* __restrict__ q_out, T* __restrict__ hat_out,
                           int64_t cols) {
  const int64_t row = blockIdx.y;
  const int64_t base = row * cols;
  const float r_row = MODE == MODE_R_ROW ? radius[row] : 0.0f;
  const float lv_row = MODE == MODE_RL_ELEM ? 1.0f : levels[row];
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; c < cols;
       c += stride) {
    const int64_t i = base + c;
    const float r = MODE == MODE_R_ROW ? r_row : radius[i];
    const float lv = MODE == MODE_RL_ELEM ? levels[i] : lv_row;
    const float x = to_f32(theta[i]);
    const float h = to_f32(hat[i]);
    const float step = __fdiv_rn(__fmul_rn(2.0f, fmaxf(r, 1e-30f)), lv);
    const float cc = __fdiv_rn(__fadd_rn(__fsub_rn(x, h), r), step);
    const float low = floorf(cc);
    const float p = __fsub_rn(cc, low);
    float q = __fadd_rn(low, u[i] < p ? 1.0f : 0.0f);
    q = fminf(fmaxf(q, 0.0f), lv);
    const float nh = __fsub_rn(__fadd_rn(h, __fmul_rn(step, q)), r);
    const bool active = r > 0.0f;
    q_out[i] = active ? (uint8_t)q : (uint8_t)0;
    store(hat_out, i, active ? nh : h);
  }
}

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocksPerRow = 4096;

template <typename T, int MODE>
void launch(const void* theta, const void* hat, const float* u, const float* radius,
            const float* levels, void* q, void* hat_out, int64_t rows, int64_t cols,
            cudaStream_t stream) {
  int64_t bx = (cols + kThreads - 1) / kThreads;
  if (bx > kMaxBlocksPerRow) bx = kMaxBlocksPerRow;
  dim3 grid((unsigned)bx, (unsigned)rows);
  qdq_kernel<T, MODE><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(theta), static_cast<const T*>(hat), u, radius, levels,
      static_cast<uint8_t*>(q), static_cast<T*>(hat_out), cols);
}

template <typename T>
void dispatch_mode(int mode, const void* theta, const void* hat, const float* u,
                   const float* radius, const float* levels, void* q, void* hat_out,
                   int64_t rows, int64_t cols, cudaStream_t stream) {
  switch (mode) {
    case MODE_R_ROW:
      launch<T, MODE_R_ROW>(theta, hat, u, radius, levels, q, hat_out, rows, cols, stream);
      break;
    case MODE_R_ELEM:
      launch<T, MODE_R_ELEM>(theta, hat, u, radius, levels, q, hat_out, rows, cols, stream);
      break;
    default:
      launch<T, MODE_RL_ELEM>(theta, hat, u, radius, levels, q, hat_out, rows, cols, stream);
      break;
  }
}

}  // namespace

extern "C" {

// Launches the codec on `stream`; returns cudaGetLastError() after the launch
// (0 on success).  rows must be in [1, 65535], cols >= 1, mode and dtype one of
// the enums above; the caller checks them.
int repro_qdq(int mode, int dtype, const void* theta, const void* hat, const float* u,
              const float* radius, const float* levels, void* q, void* hat_out,
              long long rows, long long cols, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_BF16) {
    dispatch_mode<__nv_bfloat16>(mode, theta, hat, u, radius, levels, q, hat_out,
                                 rows, cols, s);
  } else {
    dispatch_mode<float>(mode, theta, hat, u, radius, levels, q, hat_out, rows, cols, s);
  }
  return (int)cudaGetLastError();
}

const char* repro_qdq_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
