// Three small kernels that run the wgmma forms of wgmma_bf16.cuh which the
// bf16 flash kernels and ln_matmul_bf16 are built on, so that a card test
// can hold each against torch.mm in f32 on its own (a wrong descriptor
// gives a silently wrong product or an illegal address, never a CPU
// failure). They replace no TPU kernel and lie on no path of the port.
//
// The operands are staged by the threads themselves, not by TMA, into the
// layout that TMA's 128-byte swizzle writes: 16-byte chunk c of the
// 128-byte row r stored at chunk position c ^ (r % 8), each slab on a
// 1024-byte boundary. So the tests also pin the layout the descriptors
// assume, independently of the tensor maps.
//
//   wgmma_ss_kmajor: D[64, N] = A[64, 64] . B[N, 64]^T, both operands
//     K-major (a row of 64 K values a 128-byte slab row: Q and K in the
//     flash forward, the normalised strip in ln_matmul_bf16), four k16
//     steps 32 bytes apart inside the row (desc_k128).
//   wgmma_rs: D[64, N] = A[64, 64] . B[64, N], A from registers (the
//     m16n8k16 fragment: P in the flash forward), B MN-major (N
//     contiguous, slabs of 64 columns: V), four k16 steps 2048 bytes
//     apart (desc_sw128).
//   wgmma_ss_mn_b: D[64, N] = A[64, 64] . B[64, N], A K-major from shared
//     memory (desc_k128: ds in the bf16 flash backward's dq), B MN-major
//     (desc_sw128: K there).
// N is 64 or 128; one warpgroup; D in f32, row-major.

#include <cuda_bf16.h>

#include "wgmma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;

// Byte offset of element (r, c) of a [rows, 64] bf16 slab under the
// 128-byte swizzle.
__device__ __forceinline__ int swz(int r, int c) {
  return 128 * r + 16 * ((c / 8) ^ (r % 8)) + 2 * (c % 8);
}

// The dynamic shared memory from its first 1024-byte boundary (the
// launch asks for 1024 bytes more than the operands take).
__device__ __forceinline__ unsigned char* aligned_smem() {
  extern __shared__ __align__(16) unsigned char raw[];
  return raw + (1024 - wgmma::smem_addr(raw) % 1024) % 1024;
}

// Writes a warpgroup's m64nN accumulators to d [64, N] row-major.
template <int N>
__device__ __forceinline__ void store_acc(const float (&acc)[N / 2],
                                          float* d) {
  const int t = threadIdx.x, lane = t % 32;
  const int row = 16 * (t / 32) + lane / 4;
#pragma unroll
  for (int i = 0; i < N / 2; ++i)
    d[(row + 8 * ((i >> 1) & 1)) * N + 8 * (i >> 2) + 2 * (lane % 4) +
      (i & 1)] = acc[i];
}

template <int N>
__global__ void __launch_bounds__(128)
ss_kmajor(const bf16* __restrict__ a, const bf16* __restrict__ b,
          float* __restrict__ d) {
  unsigned char* sa = aligned_smem();
  unsigned char* sb = sa + 64 * 128;
  for (int i = threadIdx.x; i < 64 * 64; i += 128)
    *reinterpret_cast<bf16*>(sa + swz(i / 64, i % 64)) = a[i];
  for (int i = threadIdx.x; i < N * 64; i += 128)
    *reinterpret_cast<bf16*>(sb + swz(i / 64, i % 64)) = b[i];
  wgmma::fence_proxy_async();
  __syncthreads();
  float acc[N / 2];
  wgmma::fence_operand(acc);
  wgmma::fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma::mma_ss<N, 0, 0>(
        acc, wgmma::desc_k128(wgmma::smem_addr(sa) + 32 * kk),
        wgmma::desc_k128(wgmma::smem_addr(sb) + 32 * kk), kk > 0);
  wgmma::commit();
  wgmma::wait<0>();
  wgmma::fence_operand(acc);
  store_acc<N>(acc, d);
}

template <int N>
__global__ void __launch_bounds__(128)
rs(const bf16* __restrict__ a, const bf16* __restrict__ b,
   float* __restrict__ d) {
  // B [64 k, N] as N / 64 MN-major slabs of 64 rows of k
  unsigned char* sb = aligned_smem();
  for (int i = threadIdx.x; i < 64 * N; i += 128) {
    const int k = i / N, n = i % N;
    *reinterpret_cast<bf16*>(sb + n / 64 * 64 * 128 + swz(k, n % 64)) = b[i];
  }
  wgmma::fence_proxy_async();
  __syncthreads();
  // A's fragments: rows g and g + 8 of the warp's 16, k 2t, 2t + 1 and
  // 2t + 8, 2t + 9 of each k16 step
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int row = 16 * (threadIdx.x / 32) + g;
  unsigned af[4][4];
#pragma unroll
  for (int kc = 0; kc < 4; ++kc)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int m = row + 8 * (r & 1), k = 16 * kc + 8 * (r >> 1) + 2 * t;
      af[kc][r] = *reinterpret_cast<const unsigned*>(a + m * 64 + k);
    }
  float acc[N / 2];
  wgmma::fence_operand(acc);
  wgmma::fence();
#pragma unroll
  for (int kc = 0; kc < 4; ++kc)
    wgmma::mma_rs<N, 1>(
        acc, af[kc],
        wgmma::desc_sw128(wgmma::smem_addr(sb) + 2048 * kc, 64 * 128, 1024),
        kc > 0);
  wgmma::commit();
  wgmma::wait<0>();
  wgmma::fence_operand(acc);
  store_acc<N>(acc, d);
}

template <int N>
__global__ void __launch_bounds__(128)
ss_mn_b(const bf16* __restrict__ a, const bf16* __restrict__ b,
        float* __restrict__ d) {
  // A [64 m, 64 k] K-major; B [64 k, N] as N / 64 MN-major slabs
  unsigned char* sa = aligned_smem();
  unsigned char* sb = sa + 64 * 128;
  for (int i = threadIdx.x; i < 64 * 64; i += 128)
    *reinterpret_cast<bf16*>(sa + swz(i / 64, i % 64)) = a[i];
  for (int i = threadIdx.x; i < 64 * N; i += 128) {
    const int k = i / N, n = i % N;
    *reinterpret_cast<bf16*>(sb + n / 64 * 64 * 128 + swz(k, n % 64)) = b[i];
  }
  wgmma::fence_proxy_async();
  __syncthreads();
  float acc[N / 2];
  wgmma::fence_operand(acc);
  wgmma::fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma::mma_ss<N, 0, 1>(
        acc, wgmma::desc_k128(wgmma::smem_addr(sa) + 32 * kk),
        wgmma::desc_sw128(wgmma::smem_addr(sb) + 2048 * kk, 64 * 128, 1024),
        kk > 0);
  wgmma::commit();
  wgmma::wait<0>();
  wgmma::fence_operand(acc);
  store_acc<N>(acc, d);
}

}  // namespace

// a: [64, 64] bf16, b: [64, N] bf16, d: [64, N] float32, all contiguous;
// N 64 or 128. Returns a cudaError_t.
extern "C" int wgmma_ss_mn_b_f32(const void* a, const void* b, void* d,
                                 int N, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* ab = static_cast<const bf16*>(a);
  const bf16* bb = static_cast<const bf16*>(b);
  float* df = static_cast<float*>(d);
  if (N == 64)
    ss_mn_b<64><<<1, 128, 1024 + 128 * 128, st>>>(ab, bb, df);
  else if (N == 128)
    ss_mn_b<128><<<1, 128, 1024 + 192 * 128, st>>>(ab, bb, df);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// a: [64, 64] bf16, b: [N, 64] bf16, d: [64, N] float32, all contiguous;
// N 64 or 128. Returns a cudaError_t.
extern "C" int wgmma_ss_kmajor_f32(const void* a, const void* b, void* d,
                                   int N, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* ab = static_cast<const bf16*>(a);
  const bf16* bb = static_cast<const bf16*>(b);
  float* df = static_cast<float*>(d);
  if (N == 64)
    ss_kmajor<64><<<1, 128, 1024 + 128 * 128, st>>>(ab, bb, df);
  else if (N == 128)
    ss_kmajor<128><<<1, 128, 1024 + 192 * 128, st>>>(ab, bb, df);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// a: [64, 64] bf16, b: [64, N] bf16, d: [64, N] float32, all contiguous;
// N 64 or 128. Returns a cudaError_t.
extern "C" int wgmma_rs_f32(const void* a, const void* b, void* d, int N,
                            void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* ab = static_cast<const bf16*>(a);
  const bf16* bb = static_cast<const bf16*>(b);
  float* df = static_cast<float*>(d);
  if (N == 64)
    rs<64><<<1, 128, 1024 + 64 * 128, st>>>(ab, bb, df);
  else if (N == 128)
    rs<128><<<1, 128, 1024 + 128 * 128, st>>>(ab, bb, df);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
