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
// Design: one byte per thread per grid-stride iteration, neighbouring threads
// on neighbouring bytes; the padding is produced by masking the loads, not by
// padding the input.  Simple and right first; wider accesses are later work.
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

__global__ void unpack4_kernel(const uint8_t* __restrict__ p, uint8_t* __restrict__ out,
                               int64_t n, int64_t plen) {
  const int64_t row = blockIdx.y;
  const uint8_t* prow = p + row * plen;
  uint8_t* orow = out + row * n;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
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
  unpack4_kernel<<<grid_for(n, rows), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(packed), static_cast<uint8_t*>(out), n, plen);
  return (int)cudaGetLastError();
}

const char* repro_pack_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
