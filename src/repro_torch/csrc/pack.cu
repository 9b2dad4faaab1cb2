// int4 nibble pack / unpack of the Q-GADMM wire (levels < 16, bits <= 4).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/pack/pack.py:
//   _pack_kernel   (pack4)   -> pack4_kernel
//   _unpack_kernel (unpack4) -> unpack4_kernel
//
// Wire format, unchanged from src/repro/kernels/pack/ref.py (it is the wire
// contract and the unit of bit accounting): a row of n levels is zero-padded
// to whole 256-level groups; byte r*128 + c of the packed row holds
//   lo = level[r*256 + c]  |  hi = level[r*256 + 128 + c] << 4
// so a packed row is packed_len(n) = 128 * ceil(n / 256) bytes.  Each kernel
// runs over a batch of rows (blockIdx.y), every row laid out exactly as the
// single-row format; unpack returns the first n levels of each row.
//
// Bound on an H100 (reckoned from shapes, not measured): memory.  pack reads 1
// B and writes 0.5 B per level: 0.34 GB for the trainer's 4 rows of
// 56,355,840 levels, at least 0.10 ms at 3.35 TB/s.  unpack of the 2E = 6
// directed-edge rows moves 0.51 GB, at least 0.15 ms.
//
// pack4 (K4): one byte per thread per grid-stride iteration, neighbouring
// threads on neighbouring bytes; the padding is produced by masking the loads,
// not by padding the input.
//
// unpack4 (K5), vectorized.  Its first version read and wrote one byte per
// thread per iteration (32 B per warp store instruction) and loaded every
// packed byte twice, once per nibble: bound by load/store instructions, at 40%
// of its byte bound.  Now one thread takes 16 packed bytes of a group with one
// 16-byte load and writes their 16 low nibbles at g*256 + c and their 16 high
// nibbles at g*256 + 128 + c with two 16-byte stores: each packed byte is read
// once, and every access of a warp covers whole 32-byte sectors.  Packed rows
// are always 16-byte aligned (plen is a multiple of 128); an output row starts
// at row*n, so it takes the vector path when its start is 16-byte aligned.
// Other rows, and the last partial group of every row, take a byte loop in the
// same kernel.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocksPerRow = 4096;

__global__ void pack4_kernel(const uint8_t* __restrict__ q, uint8_t* __restrict__ out,
                             int64_t n, int64_t plen) {
  const int64_t row = blockIdx.y;
  const uint8_t* qr = q + row * n;
  uint8_t* orow = out + row * plen;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < plen; j += stride) {
    const int64_t lo_i = ((j >> 7) << 8) + (j & 127);
    const int64_t hi_i = lo_i + 128;
    const unsigned lo = lo_i < n ? qr[lo_i] : 0u;
    const unsigned hi = hi_i < n ? qr[hi_i] : 0u;
    orow[j] = (uint8_t)(lo | (hi << 4));
  }
}

__device__ __forceinline__ uint32_t lo_nibbles(uint32_t w) { return w & 0x0F0F0F0Fu; }
__device__ __forceinline__ uint32_t hi_nibbles(uint32_t w) { return (w >> 4) & 0x0F0F0F0Fu; }

__global__ void unpack4_kernel(const uint8_t* __restrict__ p, uint8_t* __restrict__ out,
                               int64_t n, int64_t plen) {
  const int64_t row = blockIdx.y;
  const uint8_t* prow = p + row * plen;
  uint8_t* orow = out + row * n;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool vec = ((reinterpret_cast<uintptr_t>(prow) |
                     reinterpret_cast<uintptr_t>(orow)) & 15) == 0;
  const int64_t full = vec ? n >> 8 : 0;           // whole 256-level groups
  for (int64_t v = tid; v < full * 8; v += stride) {
    const int64_t g = v >> 3;
    const int c = (int)(v & 7) << 4;
    const uint4 w = *reinterpret_cast<const uint4*>(prow + (g << 7) + c);
    const uint4 lo = make_uint4(lo_nibbles(w.x), lo_nibbles(w.y), lo_nibbles(w.z),
                                lo_nibbles(w.w));
    const uint4 hi = make_uint4(hi_nibbles(w.x), hi_nibbles(w.y), hi_nibbles(w.z),
                                hi_nibbles(w.w));
    *reinterpret_cast<uint4*>(orow + (g << 8) + c) = lo;
    *reinterpret_cast<uint4*>(orow + (g << 8) + 128 + c) = hi;
  }
  for (int64_t i = (full << 8) + tid; i < n; i += stride) {
    const int64_t k = i & 255;
    const uint8_t b = prow[((i >> 8) << 7) + (k & 127)];
    orow[i] = k < 128 ? (uint8_t)(b & 0xF) : (uint8_t)(b >> 4);
  }
}

dim3 grid_for(int64_t work, int64_t rows) {
  int64_t bx = (work + kThreads - 1) / kThreads;
  if (bx > kMaxBlocksPerRow) bx = kMaxBlocksPerRow;
  return dim3((unsigned)bx, (unsigned)rows);
}

}  // namespace

extern "C" {

// (rows, n) uint8 levels -> (rows, plen) packed bytes, plen = 128*ceil(n/256).
// Returns cudaGetLastError() after the launch (0 on success).
int repro_pack4(const void* q, void* out, long long rows, long long n, long long plen,
                void* stream) {
  pack4_kernel<<<grid_for(plen, rows), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(q), static_cast<uint8_t*>(out), n, plen);
  return (int)cudaGetLastError();
}

// (rows, plen) packed bytes -> (rows, n) uint8 levels.
int repro_unpack4(const void* packed, void* out, long long rows, long long n,
                  long long plen, void* stream) {
  // one thread per 32 levels on the vector path
  unpack4_kernel<<<grid_for((n + 31) / 32, rows), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(packed), static_cast<uint8_t*>(out), n, plen);
  return (int)cudaGetLastError();
}

const char* repro_pack_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
