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
// What bounds it on an H100, at the main path's shape (C = 1024 chains,
// G = 10,000 groups, n = 10 observations, P = 4; 102.4 M observations a call;
// ops/fused_glmm.py::glmm_bound_ms computes these floors for any shape):
//   memory            b read and gb written once, 2 x 41 MB, Xt and y 2 MB:
//                     84 MB at 3.35 TB/s                              25 us
//   float32           4P + 12 operations an observation, 2.87 GFLOP at
//                     67 TFLOP/s                                      43 us
//   special functions this kernel takes three MUFU results an observation
//                     (ex2, lg2, rcp); 132 SMs give 16 a clock each   73 us
// Three is this design's count, not the least: log(t) on (1, 2] can be a
// polynomial of about seven FMAs, which leaves two MUFU results (49 us) and
// 42 float32 operations an observation (64 us).  The bound is the cheaper
// form's largest floor: 64 us, set by float32.  The polynomial was not
// taken, because the issue slots are what this kernel feels: an observation
// costs 3 MUFU instructions, which hold their pipe for 24 clocks a warp, and
// 22.6 other instructions (11 FFMA among them) of which a warp scheduler
// issues one a clock: 78 us for the call, and six more instructions would
// make it about 97 us.  So the design spends instructions on nothing but the observation.
//
// Design:
//  - Two main kernels behind one C function, picked by shape.
//    glmm_reg_kernel<P, n> is compiled for the shape the models use (P = 4,
//    n = 10).  Every other shape (P <= 8, any n that fits shared memory) takes
//    glmm_generic_kernel, which stages the covariates in shared memory and
//    reads P and n at run time.
//  - glmm_reg_kernel: a thread owns one group g and keeps that group's
//    Xt[:, :, g] and y[:, g] (P n + n = 50 floats) in registers for all the
//    chains its block walks, so the loop over observations reads no memory at
//    all.  It walks the chains R = 4 at a time; the R n observations of a tile
//    are independent straight-line code, so their exp -> rcp / lg2 sequences
//    overlap inside one thread.  The next tile's b is loaded before this
//    tile's arithmetic starts.  beta rows are staged in shared memory once a
//    block and read as one 16-byte broadcast per chain.
//  - Arithmetic: e = ex2.approx(-log2(e) |l|), t = 1 + e, rcp.approx(t) and
//    lg2.approx(t) with t in (1, 2], where lg2.approx has an absolute error of
//    2^-22.  sigmoid(l) for l < 0 is e / t, not 1 - 1 / t, so it keeps its
//    relative accuracy in the tail.  Both contractions are float32 FMA on the
//    CUDA cores: no tensor cores, no TF32, whose absolute error would swamp
//    the cancelling near-mode gradient.
//  - Reductions.  A thread writes gb[c,g] itself: that sum runs over its own
//    observations.  lp and gbeta are summed over groups: per tile a thread
//    stores its R (P + 1) partials into its warp's tile of shared memory, and
//    the first R (P + 1) lanes each sum one row of 32 in a fixed order with
//    eight 16-byte reads.  That is about 1 instruction an observation where
//    P + 1 warp shuffles per chain cost 5, and it needs no block-wide barrier.
//    At its end the block adds its warps' rows in warp order and stores one
//    row of partials per (group chunk, chain); glmm_finish_kernel sums them
//    over the chunks in chunk order.  No float atomics anywhere, so every
//    result reproduces bit for bit from run to run.
//  - Two launches.  A one-launch form (the last block of a chain split to
//    arrive, found by an integer counter after a __threadfence(), sums that
//    split's partials) measured 3 us slower on the card than the second
//    launch costs, so it was not kept.
//  - Chains per block are chosen on the host: about TARGET_CB, so that
//    the grid is four waves of the blocks the card holds at once, and such
//    that the last wave is full (pick_chains_per_block).  Fewer, longer
//    blocks run in step: their loads at the start and their stores at the end
//    then leave the SMs idle together.
//  - The ragged group edge is masked, a ragged chain tile repeats its last
//    chain and stores nothing for the repeats; nothing is padded.
//
// Measured at the main path's shape on an NVIDIA H100 80GB HBM3 (power limit
// 700.00 W, SM clock 1980 MHz), CUDA events over 20 launches:
// 0.129 ms a call, 50% of the bound, against 0.608 ms for the kernel this
// one replaces and 5.97 ms for the plain torch version in float32.  126
// registers, no spills, 4 blocks an SM.  Halving the observations takes off
// 44 us, so the arithmetic runs at 88 us for the call and about 40 us go to
// what does not scale with it: the blocks' first loads and last stores, the
// per-chain work, the second launch (PERF.md).

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int TPB = 128;           // threads per block = groups per chunk
constexpr int WARPS = TPB / 32;
constexpr int MIN_BLOCKS = 512 / TPB;  // per SM: 128 registers a thread
constexpr int R = 4;               // chains a thread walks at a time
constexpr int TARGET_CB = 48;      // chains per block to aim for
constexpr int MAX_P = 8;           // fixed effects the generic kernel unrolls
constexpr int GENERIC_CB = 32;     // chains per block of the generic kernel
constexpr int MAX_SPLITS = 65535;  // chain splits of one launch (grid.y)
constexpr int ROW = 36;            // floats per row of a warp's reduction
                                   // tile: 32 lanes, padded so that rows stay
                                   // 16-byte aligned and the row sums' float4
                                   // reads meet no bank conflict

__device__ __forceinline__ float ex2_approx(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ float lg2_approx(float x) {
  float r;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// One observation with logit l and response y: adds y l - softplus(l) to lp
// and returns y - sigmoid(l).
__device__ __forceinline__ float glmm_term(float l, float y, float& lp) {
  const float e = ex2_approx(-1.4426950408889634f * fabsf(l));   // exp(-|l|)
  const float t = 1.f + e;
  lp = fmaf(y, l, lp);
  lp -= fmaxf(l, 0.f);
  lp = fmaf(-0.6931471805599453f, lg2_approx(t), lp);            // log(1 + e)
  return fmaf(-rcp_approx(t), l >= 0.f ? 1.f : e, y);  // sigmoid(l < 0) = e / t
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// The end of both main kernels.  `wrows` holds one row of nc * Q sums per
// warp, `wstride` floats apart; the block adds them in warp order into its
// row of `partials` (chunks, C, Q).
__device__ __forceinline__ void store_partials(const float* wrows, int wstride,
                                               float* __restrict__ partials,
                                               int Q, int C, int c0, int nc) {
  __syncthreads();                   // every warp's row is complete
  float* dst = partials + ((size_t)blockIdx.x * C + c0) * Q;
  for (int k = threadIdx.x; k < nc * Q; k += TPB) {
    float s = wrows[k];
    for (int w = 1; w < WARPS; ++w) s += wrows[w * wstride + k];
    dst[k] = s;
  }
}

// Shapes known at compile time: covariates and responses in registers.
// Grid (group chunks, chain splits); a block owns TPB groups, one a thread,
// and the `cb` chains of its split.  Dynamic shared memory:
// reg_kernel_smem(P, cb).
template <int P, int N>
__global__ void __launch_bounds__(TPB, MIN_BLOCKS)
glmm_reg_kernel(const float* __restrict__ Xt, const float* __restrict__ y,
                const float* __restrict__ betas, const float* __restrict__ bs,
                float* __restrict__ gb, float* __restrict__ partials, int G,
                int C, int cb) {
  constexpr int Q = P + 1;
  constexpr int V = R * Q;           // sums a thread holds per chain tile
  static_assert(V <= 32, "one lane sums one row of the warp's tile");
  static_assert(R * P % 4 == 0, "the tiles stay 16-byte aligned behind bet");
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* bet = smem;                                  // [cb][P]
  float* tile = bet + cb * P + warp * (V * ROW);      // [V][ROW], this warp's
  float* wrows = bet + cb * P + WARPS * (V * ROW);    // [WARPS][cb * Q]
  const int g = blockIdx.x * TPB + tid;
  const bool valid = g < G;
  const int c0 = blockIdx.y * cb;
  const int nc = min(cb, C - c0);

  for (int k = tid; k < nc * P; k += TPB) bet[k] = betas[(size_t)c0 * P + k];
  float x[P][N], yv[N];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int i = 0; i < N; ++i)
      x[p][i] = valid ? Xt[((size_t)p * N + i) * G + g] : 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) yv[i] = valid ? y[(size_t)i * G + g] : 0.f;
  // b of the chains t0 .. t0 + R - 1; a ragged tile repeats the last chain
  const float* bcol = bs + (size_t)c0 * G + g;
  auto load_b = [&](float (&b)[R], int t0) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      b[r] = valid ? bcol[(size_t)min(t0 + r, nc - 1) * G] : 0.f;
  };
  float bnext[R];
  load_b(bnext, 0);
  __syncthreads();                   // bet is staged

  for (int t0 = 0; t0 < nc; t0 += R) {
    float b[R];
#pragma unroll
    for (int r = 0; r < R; ++r) b[r] = bnext[r];
    if (t0 + R < nc) load_b(bnext, t0 + R);      // in flight during this tile
    float acc[R][Q];                 // [r][0] lp, [r][1 + p] gbeta
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int q = 0; q < Q; ++q) acc[r][q] = 0.f;
    if (valid) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int cl = min(t0 + r, nc - 1);
        float beta[P];               // a warp-uniform read: one broadcast
        if constexpr (P == 4) {
          const float4 v = *reinterpret_cast<const float4*>(bet + cl * 4);
          beta[0] = v.x, beta[1] = v.y, beta[2] = v.z, beta[3] = v.w;
        } else {
#pragma unroll
          for (int p = 0; p < P; ++p) beta[p] = bet[cl * P + p];
        }
        float gbs = 0.f;
#pragma unroll
        for (int i = 0; i < N; ++i) {
          float l = b[r];
#pragma unroll
          for (int p = 0; p < P; ++p) l = fmaf(x[p][i], beta[p], l);
          const float res = glmm_term(l, yv[i], acc[r][0]);
          gbs += res;
#pragma unroll
          for (int p = 0; p < P; ++p)
            acc[r][1 + p] = fmaf(res, x[p][i], acc[r][1 + p]);
        }
        if (t0 + r < nc) gb[(size_t)(c0 + cl) * G + g] = gbs;
      }
    }
    // transposed sum over the warp's groups: lane v sums row v
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int q = 0; q < Q; ++q) tile[(r * Q + q) * ROW + lane] = acc[r][q];
    __syncwarp();
    if (lane < V) {
      const float4* row = reinterpret_cast<const float4*>(tile + lane * ROW);
      float4 s = row[0];             // four running sums: a short chain of adds
#pragma unroll
      for (int k = 1; k < 8; ++k) {
        const float4 a = row[k];
        s.x += a.x, s.y += a.y, s.z += a.z, s.w += a.w;
      }
      // lane = r * Q + q, so (t0 + r) * Q + q = t0 * Q + lane
      if (t0 + lane / Q < nc)
        wrows[warp * (cb * Q) + t0 * Q + lane] = (s.x + s.y) + (s.z + s.w);
    }
    __syncwarp();
  }
  store_partials(wrows, cb * Q, partials, Q, C, c0, nc);
}

// Any P <= MAX_P and any n: covariates and responses staged in shared memory,
// GENERIC_CB chains a block, P + 1 warp shuffles per chain.  Dynamic shared
// memory: generic_kernel_smem(P, n).
__global__ void __launch_bounds__(TPB)
glmm_generic_kernel(const float* __restrict__ Xt, const float* __restrict__ y,
                    const float* __restrict__ betas,
                    const float* __restrict__ bs, float* __restrict__ gb,
                    float* __restrict__ partials, int P, int n, int G, int C) {
  extern __shared__ __align__(16) float smem[];
  const int Q = P + 1;
  float* xs = smem;                          // [P * n][TPB]
  float* ys = xs + P * n * TPB;              // [n][TPB]
  float* bet = ys + n * TPB;                 // [GENERIC_CB][P]
  float* wrows = bet + GENERIC_CB * P;       // [WARPS][GENERIC_CB * Q]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = blockIdx.x * TPB + tid;
  const bool valid = g < G;
  const int c0 = blockIdx.y * GENERIC_CB;
  const int nc = min(GENERIC_CB, C - c0);

  for (int k = 0; k < P * n; ++k)            // k = p * n + i
    xs[k * TPB + tid] = valid ? Xt[(size_t)k * G + g] : 0.f;
  for (int i = 0; i < n; ++i)
    ys[i * TPB + tid] = valid ? y[(size_t)i * G + g] : 0.f;
  for (int k = tid; k < nc * P; k += TPB)
    bet[k] = betas[(size_t)c0 * P + k];
  __syncthreads();

  for (int cl = 0; cl < nc; ++cl) {
    const size_t c = c0 + cl;
    float lp = 0.f;
    float gbeta[MAX_P];
#pragma unroll
    for (int p = 0; p < MAX_P; ++p) gbeta[p] = 0.f;
    if (valid) {
      const float b = bs[c * G + g];
      float gbs = 0.f;
      for (int i = 0; i < n; ++i) {
        float l = b;
#pragma unroll
        for (int p = 0; p < MAX_P; ++p)
          if (p < P) l = fmaf(xs[(p * n + i) * TPB + tid], bet[cl * P + p], l);
        const float res = glmm_term(l, ys[i * TPB + tid], lp);
        gbs += res;
#pragma unroll
        for (int p = 0; p < MAX_P; ++p)
          if (p < P)
            gbeta[p] = fmaf(res, xs[(p * n + i) * TPB + tid], gbeta[p]);
      }
      gb[c * G + g] = gbs;
    }
    lp = warp_sum(lp);
#pragma unroll
    for (int p = 0; p < MAX_P; ++p)
      if (p < P) gbeta[p] = warp_sum(gbeta[p]);
    if (lane == 0) {
      float* dst = wrows + warp * (GENERIC_CB * Q) + cl * Q;
      dst[0] = lp;
#pragma unroll
      for (int p = 0; p < MAX_P; ++p)
        if (p < P) dst[1 + p] = gbeta[p];
    }
  }
  store_partials(wrows, GENERIC_CB * Q, partials, Q, C, c0, nc);
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
#pragma unroll 8
  for (int j = 0; j < chunks; ++j) s += partials[(size_t)j * C * Q + k];
  const int c = k / Q;
  const int q = k - c * Q;
  if (q == 0)
    lp[c] = s;
  else
    gbeta[(size_t)c * P + q - 1] = s;
}

int num_chunks(int G) { return (G + TPB - 1) / TPB; }

size_t reg_kernel_smem(int P, int cb) {
  return sizeof(float) *
         ((size_t)cb * P + (size_t)(P + 1) * WARPS * (R * ROW + cb));
}

size_t generic_kernel_smem(int P, int n) {
  return sizeof(float) * ((size_t)(P + 1) * n * TPB + GENERIC_CB * P +
                          (size_t)WARPS * GENERIC_CB * (P + 1));
}

// Blocks of glmm_reg_kernel<4, 10> the current device holds at once.
int resident_blocks(int* out) {
  static int cache[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (cache[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, glmm_reg_kernel<4, 10>, TPB,
        reg_kernel_smem(4, TARGET_CB));
    if (err != cudaSuccess) return (int)err;
    cache[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  *out = cache[dev];
  return 0;
}

// Chains per block of glmm_reg_kernel: near TARGET_CB, a multiple of R,
// and such that the grid's last wave of resident blocks is full.  All blocks
// of a launch do the same work, so a last wave that is partly full leaves
// SMs idle for a whole block's time.
int pick_chains_per_block(int chunks, int C, int resident) {
  long long splits = (C + TARGET_CB - 1) / TARGET_CB;
  const long long waves = (chunks * splits + resident - 1) / resident;
  const long long fill = waves * resident / chunks;
  if (fill > splits) splits = fill;
  if (splits > MAX_SPLITS) splits = MAX_SPLITS;
  const int cb = (int)((C + splits - 1) / splits);
  return (cb + R - 1) / R * R;
}

struct Plan {
  bool reg;          // glmm_reg_kernel, else glmm_generic_kernel
  int cb;            // chains per block
  int splits;        // grid.y
  int resident;      // blocks the device holds at once (reg kernel only)
};

int make_plan(int P, int n, int G, int C, Plan* plan) {
  if (P < 1 || P > MAX_P || n < 1 || G < 1 || C < 1)
    return (int)cudaErrorInvalidValue;
  plan->reg = P == 4 && n == 10;     // what glmm_reg_kernel is compiled for
  plan->resident = 0;
  if (plan->reg) {
    const int err = resident_blocks(&plan->resident);
    if (err != 0) return err;
    plan->cb = pick_chains_per_block(num_chunks(G), C, plan->resident);
  } else {
    plan->cb = GENERIC_CB;
  }
  plan->splits = (C + plan->cb - 1) / plan->cb;
  if (plan->splits > MAX_SPLITS ||
      (plan->reg && reg_kernel_smem(P, plan->cb) > 48 * 1024))
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

extern "C" {

// Floats of scratch the caller allocates for the per-chunk partials.
long long fused_glmm_scratch_floats(int P, int G, int C) {
  return (long long)num_chunks(G) * C * (P + 1);
}

// How a call of this shape would run on the current device: out[0] 1 for
// glmm_reg_kernel and 0 for glmm_generic_kernel, out[1] chains per block,
// out[2] blocks in the grid, out[3] blocks the device holds at once (0 for
// the generic kernel).  Returns a cudaError_t.
int fused_glmm_plan(int P, int n, int G, int C, int* out) {
  Plan plan;
  const int err = make_plan(P, n, G, C, &plan);
  if (err != 0) return err;
  out[0] = plan.reg;
  out[1] = plan.cb;
  out[2] = num_chunks(G) * plan.splits;
  out[3] = plan.resident;
  return 0;
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
  Plan plan;
  cudaError_t err = (cudaError_t)make_plan(P, n, G, C, &plan);
  if (err != cudaSuccess) return (int)err;
  const int chunks = num_chunks(G);
  const dim3 grid(chunks, plan.splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (plan.reg) {
    glmm_reg_kernel<4, 10><<<grid, TPB, reg_kernel_smem(P, plan.cb), s>>>(
        Xt, y, betas, bs, gb, partials, G, C, plan.cb);
  } else {
    const size_t smem = generic_kernel_smem(P, n);
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(glmm_generic_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    glmm_generic_kernel<<<grid, TPB, smem, s>>>(Xt, y, betas, bs, gb, partials,
                                                P, n, G, C);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int outs = C * (P + 1);
  glmm_finish_kernel<<<(outs + 255) / 256, 256, 0, s>>>(partials, lp, gbeta, P,
                                                         C, chunks);
  return (int)cudaGetLastError();
}

}  // extern "C"
