// Region-membership kernels for NVIDIA Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of
// massivedatans_tpu/ops/pallas_neighbors.py:
//
//   count_within_pallas            -> mdt_count_within
//   bootstrapped_sq_radius_pallas  -> mdt_bootstrap_radius
//
// What bounds them on this card: neither is a matrix product worth tensor
// cores (ndim <= 8, and the work is compare-and-reduce, not multiply-add
// chains), and at the main-path shapes (256 points x 1664 members x 3 dims,
// or 1664 x 1664 x 10 bootstrap rounds) the whole input is a few tens of KB.
// They are bound by launch latency and, for the radius, by the
// per-thread arithmetic of the O(M^2 * nb) loop, not by bytes. The design
// therefore keeps everything in registers and shared memory, reads each
// input once per block, and writes one word per point (count) or one word in
// total (radius).
//
// Arithmetic: squared distances are explicit differences summed over the
// coordinates in order k = 0..ndim-1, in fp32 with round-to-nearest
// intrinsics (__fsub_rn/__fmul_rn/__fadd_rn). The intrinsics stop nvcc from
// contracting d*d + acc into an FMA, so every distance is bitwise the same as
// the plain PyTorch versions in ops/neighbors.py compute, and the two agree
// exactly, not only up to a tie band. No TF32 and no tensor cores anywhere.
//
// Launchers have a plain C interface (pointers, sizes, a cudaStream_t passed
// as void*), launch on the caller's stream, allocate nothing, do not
// synchronise, and return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxNdim = 8;        // the wrappers reject ndim > 8
constexpr int kNbMax = 32;         // the wrapper rejects nbootstraps > 32
constexpr float kPosBig = 1e30f;   // "no in-bag neighbour yet" sentinel

// count_within: a block owns kCountThreads points (one per thread) and one
// span of kCountSpan members, staged once in shared memory. Spans of the
// member axis go to gridDim.y, so a small point batch (256 at the main path)
// still spreads over several SMs; the per-span counts are summed with one
// integer atomicAdd per point and span (exact, order-free). The member loop
// is latency-bound (a shared load and a dependent sub/mul/add chain per
// member, one warp per scheduler), so spans are short: at 256 x 1664 the grid
// is 2 x 26 blocks, each thread walking 64 members.
constexpr int kCountThreads = 128;
constexpr int kCountSpan = 64;

__global__ void count_within_kernel(const float* __restrict__ points, int n,
                                    const float* __restrict__ members,
                                    const uint8_t* __restrict__ mask, int m,
                                    int ndim,
                                    const float* __restrict__ radius,
                                    int* __restrict__ out) {
  __shared__ float s_mem[kCountSpan * kMaxNdim];
  __shared__ uint8_t s_mask[kCountSpan];

  const int base = blockIdx.y * kCountSpan;
  const int span = min(kCountSpan, m - base);
  for (int t = threadIdx.x; t < span * ndim; t += blockDim.x) {
    s_mem[t] = members[(size_t)base * ndim + t];
  }
  for (int t = threadIdx.x; t < span; t += blockDim.x) {
    s_mask[t] = mask[base + t];
  }
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  // r^2 is formed here from the device scalar (as jnp.square(radius) in the
  // TPU kernel): reading radius on the host would sync every proposal round
  const float r = radius[0];
  const float r2 = __fmul_rn(r, r);
  float p[kMaxNdim];
#pragma unroll
  for (int k = 0; k < kMaxNdim; ++k) {
    p[k] = (k < ndim) ? points[(size_t)i * ndim + k] : 0.f;
  }
  int cnt = 0;
  for (int j = 0; j < span; ++j) {
    const float* mj = s_mem + j * ndim;
    float d2 = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxNdim; ++k) {
      if (k < ndim) {
        const float d = __fsub_rn(p[k], mj[k]);
        d2 = __fadd_rn(d2, __fmul_rn(d, d));
      }
    }
    // strict <, as cneighbors.c:95-119 and the TPU kernel
    cnt += (d2 < r2 && s_mask[j] != 0) ? 1 : 0;
  }
  if (cnt) atomicAdd(out + i, cnt);
}

// bootstrapped radius: a block owns kRadiusRows rows. Lane l of warp c owns
// row l and columns c, c + kRadiusSplit, ... of each shared-memory tile, and
// keeps nb running minima (one per bootstrap round) in registers. Splitting
// the columns over the warps keeps each thread's dependent loop short (it is
// latency-bound, like count_within). The nb in-bag flags of each column are
// packed into one 32-bit mask when the tile is staged. At the end the warps'
// minima are merged through shared memory (min is exact in any order), warp 0
// folds each row's rounds into one value and reduces it, and one atomicMax on
// the int bit pattern of the non-negative float merges the blocks. Blocks run
// in no order; this replaces the TPU kernel's sequential grid carry.
constexpr int kRadiusRows = 32;   // one row per lane
constexpr int kRadiusSplit = 8;   // warps per block, each a slice of columns
constexpr int kRadiusThreads = kRadiusRows * kRadiusSplit;
constexpr int kRadiusTile = 256;

__global__ void bootstrap_radius_kernel(const float* __restrict__ w,
                                        const uint8_t* __restrict__ mask,
                                        const uint8_t* __restrict__ inbag,
                                        int m, int ndim, int nb,
                                        float* __restrict__ out) {
  __shared__ float s_w[kRadiusTile * kMaxNdim];
  __shared__ uint32_t s_bag[kRadiusTile];
  __shared__ float s_near[kNbMax * kRadiusThreads];

  const int lane = threadIdx.x & 31;
  const int slice = threadIdx.x >> 5;
  const int i = blockIdx.x * kRadiusRows + lane;
  const bool active = i < m;
  float p[kMaxNdim];
#pragma unroll
  for (int k = 0; k < kMaxNdim; ++k) {
    p[k] = (active && k < ndim) ? w[(size_t)i * ndim + k] : 0.f;
  }
  float nearest[kNbMax];
#pragma unroll
  for (int b = 0; b < kNbMax; ++b) nearest[b] = kPosBig;

  for (int base = 0; base < m; base += kRadiusTile) {
    const int tile = min(kRadiusTile, m - base);
    __syncthreads();  // previous tile fully consumed
    for (int t = threadIdx.x; t < tile * ndim; t += blockDim.x) {
      s_w[t] = w[(size_t)base * ndim + t];
    }
    for (int t = threadIdx.x; t < tile; t += blockDim.x) {
      uint32_t bits = 0;
      for (int b = 0; b < nb; ++b) {
        bits |= (inbag[(size_t)b * m + base + t] != 0 ? 1u : 0u) << b;
      }
      s_bag[t] = bits;
    }
    __syncthreads();
    if (active) {
      for (int j = slice; j < tile; j += kRadiusSplit) {
        const uint32_t bag = s_bag[j];
        if (bag == 0) continue;  // column in no bag: never a neighbour
        const float* wj = s_w + j * ndim;
        float d2 = 0.f;
#pragma unroll
        for (int k = 0; k < kMaxNdim; ++k) {
          if (k < ndim) {
            const float d = __fsub_rn(p[k], wj[k]);
            d2 = __fadd_rn(d2, __fmul_rn(d, d));
          }
        }
#pragma unroll
        for (int b = 0; b < kNbMax; ++b) {
          if (b < nb && ((bag >> b) & 1u)) nearest[b] = fminf(nearest[b], d2);
        }
      }
    }
  }

#pragma unroll
  for (int b = 0; b < kNbMax; ++b) {
    if (b < nb) s_near[b * kRadiusThreads + threadIdx.x] = nearest[b];
  }
  __syncthreads();
  if (slice != 0) return;

  float rmax = 0.f;
  if (active && mask[i] != 0) {
    uint32_t mine = 0;
    for (int b = 0; b < nb; ++b) {
      mine |= (inbag[(size_t)b * m + i] != 0 ? 1u : 0u) << b;
    }
    for (int b = 0; b < nb; ++b) {
      if ((mine >> b) & 1u) continue;
      float v = s_near[b * kRadiusThreads + lane];
      for (int s = 1; s < kRadiusSplit; ++s) {
        v = fminf(v, s_near[b * kRadiusThreads + s * 32 + lane]);
      }
      // out-of-bag row; a round whose bag is empty leaves nearest at BIG
      // and contributes 0 (pallas_neighbors.py:152-153)
      rmax = fmaxf(rmax, v >= kPosBig ? 0.f : v);
    }
  }

  for (int off = 16; off > 0; off >>= 1) {
    rmax = fmaxf(rmax, __shfl_down_sync(0xffffffffu, rmax, off));
  }
  if (lane == 0) {
    // non-negative floats order like their int bit patterns; out is zeroed
    atomicMax(reinterpret_cast<int*>(out), __float_as_int(rmax));
  }
}

}  // namespace

extern "C" {

// out: int32[n], zeroed by the caller. radius: one float on the device.
int mdt_count_within(const void* points, int n, const void* members,
                     const void* mask, int m, int ndim, const void* radius,
                     void* out, void* stream) {
  if (n > 0 && m > 0) {
    dim3 grid((n + kCountThreads - 1) / kCountThreads,
              (m + kCountSpan - 1) / kCountSpan);
    count_within_kernel<<<grid, kCountThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(points), n,
        static_cast<const float*>(members),
        static_cast<const uint8_t*>(mask), m, ndim,
        static_cast<const float*>(radius), static_cast<int*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// out: one float, zeroed by the caller. inbag: uint8[nb, m].
int mdt_bootstrap_radius(const void* w, const void* mask, const void* inbag,
                         int m, int ndim, int nb, void* out, void* stream) {
  if (m > 0 && nb > 0) {
    const int grid = (m + kRadiusRows - 1) / kRadiusRows;
    bootstrap_radius_kernel<<<grid, kRadiusThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(w), static_cast<const uint8_t*>(mask),
        static_cast<const uint8_t*>(inbag), m, ndim, nb,
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
