// Fused Bernoulli-logit GLMM log-likelihood and both gradients, batched over
// chains, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel mamba_tpu/ops/fused_glmm.py::_kernel (a Pallas
// kernel launched by _fused_call_batched).  For every chain c it computes
//
//   l[i,g]     = sum_p Xt[p,i,g] * beta[c,p] + b[c,g]
//   lp[c]      = sum_{i,g} y[i,g] * l[i,g] - softplus(l[i,g])
//   gb[c,g]    = sum_i (y[i,g] - sigmoid(l[i,g]))
//   gbeta[c,p] = sum_{i,g} (y[i,g] - sigmoid(l[i,g])) * Xt[p,i,g]
//
// in one pass; softplus and sigmoid share one exp(-|l|), and the logits never
// reach device memory.
//
// What bounds it on an H100: at the GLMM slice (C = 1024 chains, G = 10,000
// groups, n = 10 observations, P = 4) reading b and writing gb move
// 2 x 41 MB per call, about 25 us at 3.35 TB/s, while Xt (1.6 MB) and y
// (0.4 MB) stay in L2.  Each element of b is used n times, so one call
// evaluates 102 M (exp, log1p, reciprocal) triples: the FP32 and special-
// function pipes, not memory, should set the pace.  Measured at that shape
// on an NVIDIA H100 80GB HBM3 (power limit 700 W): 0.615 ms per call, against
// 5.90 ms for the plain torch version in float32 — instruction issue, not
// memory, bounds this first version (PERF.md).
//
// Design (a first, simple kernel):
//  - Grid (group chunks x chain blocks).  A block of TPB threads owns TPB
//    consecutive groups, one per thread, for CB chains.
//  - The block stages its chunk of Xt and y, and its chains' beta rows, in
//    shared memory once, and reuses them for all of its chains.  Loads are
//    coalesced: neighbouring threads read neighbouring groups.
//  - A thread writes gb[c,g] directly: that sum runs over its own i only.
//  - lp and gbeta are summed by warp shuffles, then over the block's warps in
//    a fixed order, into per-(chunk, chain) partials; a second kernel sums
//    the partials over chunks in chunk order.  No float atomics, so every
//    result reproduces bit for bit from run to run.
//  - float32 FMA on the CUDA cores and no tensor cores: TF32 products would
//    carry the absolute error that made the TPU's bf16 contraction miss the
//    cancelling near-mode gradient.  expf/log1pf are the accurate library
//    versions (the library is built without --use_fast_math).
//  - The ragged group edge is masked; nothing is padded.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int TPB = 128;           // threads per block = groups per chunk
constexpr int WARPS = TPB / 32;
constexpr int CB = 32;             // chains per block
constexpr int MAX_P = 8;           // fixed effects held in registers

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(TPB)
glmm_partials_kernel(const float* __restrict__ Xt, const float* __restrict__ y,
                     const float* __restrict__ betas,
                     const float* __restrict__ bs, float* __restrict__ gb,
                     float* __restrict__ partials, int P, int n, int G,
                     int C) {
  extern __shared__ float smem[];
  const int Q = P + 1;
  float* xs = smem;                  // [P * n][TPB]
  float* ys = xs + P * n * TPB;      // [n][TPB]
  float* bet = ys + n * TPB;         // [CB][P]
  float* red = bet + CB * P;         // [CB][WARPS][Q]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int chunk = blockIdx.x;
  const int g = chunk * TPB + tid;
  const bool valid = g < G;
  const int c0 = blockIdx.y * CB;
  const int nc = min(CB, C - c0);

  for (int k = 0; k < P * n; ++k)    // k = p * n + i
    xs[k * TPB + tid] = valid ? Xt[(size_t)k * G + g] : 0.f;
  for (int i = 0; i < n; ++i)
    ys[i * TPB + tid] = valid ? y[(size_t)i * G + g] : 0.f;
  for (int k = tid; k < nc * P; k += TPB)
    bet[k] = betas[(size_t)c0 * P + k];
  __syncthreads();

  for (int cl = 0; cl < nc; ++cl) {
    const int c = c0 + cl;
    float lp = 0.f;
    float gbeta[MAX_P];
#pragma unroll
    for (int p = 0; p < MAX_P; ++p) gbeta[p] = 0.f;
    if (valid) {
      const float bcg = bs[(size_t)c * G + g];
      float gbs = 0.f;
      for (int i = 0; i < n; ++i) {
        float l = bcg;
#pragma unroll
        for (int p = 0; p < MAX_P; ++p)
          if (p < P) l = fmaf(xs[(p * n + i) * TPB + tid], bet[cl * P + p], l);
        const float yi = ys[i * TPB + tid];
        const float e = expf(-fabsf(l));
        const float softplus = fmaxf(l, 0.f) + log1pf(e);
        const float q = 1.f / (1.f + e);
        const float sig = l >= 0.f ? q : 1.f - q;
        lp += yi * l - softplus;
        const float r = yi - sig;
        gbs += r;
#pragma unroll
        for (int p = 0; p < MAX_P; ++p)
          if (p < P) gbeta[p] = fmaf(r, xs[(p * n + i) * TPB + tid], gbeta[p]);
      }
      gb[(size_t)c * G + g] = gbs;
    }
    lp = warp_sum(lp);
#pragma unroll
    for (int p = 0; p < MAX_P; ++p)
      if (p < P) gbeta[p] = warp_sum(gbeta[p]);
    if (lane == 0) {
      float* dst = red + (cl * WARPS + warp) * Q;
      dst[0] = lp;
#pragma unroll
      for (int p = 0; p < MAX_P; ++p)
        if (p < P) dst[1 + p] = gbeta[p];
    }
  }
  __syncthreads();
  for (int k = tid; k < nc * Q; k += TPB) {
    const int cl = k / Q;
    const int q = k - cl * Q;
    float s = 0.f;
    for (int w = 0; w < WARPS; ++w) s += red[(cl * WARPS + w) * Q + q];
    partials[((size_t)chunk * C + c0 + cl) * Q + q] = s;
  }
}

// Sums the per-chunk partials in chunk order: one thread per (chain, output).
__global__ void glmm_finish_kernel(const float* __restrict__ partials,
                                   float* __restrict__ lp,
                                   float* __restrict__ gbeta, int P, int C,
                                   int chunks) {
  const int Q = P + 1;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= C * Q) return;
  float s = 0.f;
  for (int j = 0; j < chunks; ++j) s += partials[(size_t)j * C * Q + k];
  const int c = k / Q;
  const int q = k - c * Q;
  if (q == 0)
    lp[c] = s;
  else
    gbeta[(size_t)c * P + q - 1] = s;
}

int num_chunks(int G) { return (G + TPB - 1) / TPB; }

}  // namespace

extern "C" {

// Floats of scratch the caller allocates for the per-chunk partials.
long long fused_glmm_scratch_floats(int P, int G, int C) {
  return (long long)num_chunks(G) * C * (P + 1);
}

// All pointers are float32 device memory, C-contiguous:
//   Xt (P, n, G), y (n, G), betas (C, P), bs (C, G)      inputs
//   lp (C), gbeta (C, P), gb (C, G)                        outputs
//   partials: fused_glmm_scratch_floats(P, G, C) floats   scratch
// Launches on `stream` without synchronizing and returns the cudaError_t of
// the launches (0 on success).
int fused_glmm_loglik_grads(const float* Xt, const float* y,
                            const float* betas, const float* bs, float* lp,
                            float* gbeta, float* gb, float* partials, int P,
                            int n, int G, int C, void* stream) {
  if (P < 1 || P > MAX_P || n < 1 || G < 1 || C < 1)
    return (int)cudaErrorInvalidValue;
  const int chunks = num_chunks(G);
  const int cblocks = (C + CB - 1) / CB;
  if (cblocks > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)(P + 1) * n * TPB + CB * P +
                                       (size_t)CB * WARPS * (P + 1));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        glmm_partials_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  glmm_partials_kernel<<<dim3(chunks, cblocks), TPB, smem, s>>>(
      Xt, y, betas, bs, gb, partials, P, n, G, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int outs = C * (P + 1);
  glmm_finish_kernel<<<(outs + 255) / 256, 256, 0, s>>>(partials, lp, gbeta,
                                                         P, C, chunks);
  return (int)cudaGetLastError();
}

}  // extern "C"
