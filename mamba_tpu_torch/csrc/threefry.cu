// Chain-batched threefry2x32 draws for NVIDIA Hopper (sm_90a).
//
// Replaces no Pallas kernel: on the TPU, XLA fuses jax.random's threefry
// into the programs that draw.  The port keys every chain as the JAX package
// does (ops/random.py), and in plain torch one threefry2x32 is well over a
// hundred integer elementwise launches, so every draw, split and fold_in of
// the port is one launch of this kernel.
//
// For key row b of B (two uint32 words held in int64, rows `key_stride`
// apart) and element e of n per key it computes:
//   - the row's key, folded first with fold_in(key, d) = threefry(key, (0, d))
//     where a fold is given (a constant, or one int64 per row on the device,
//     which a captured body may advance in place);
//   - the counter of element e: e itself, or, given an index list of m
//     entries into a last dim of D, (e / m) * D + index[e % m];
//   - threefry2x32 of the key at the counter (hi, lo) = (ctr >> 32, ctr),
//     jax_threefry_partitionable's layout;
//   - what `kind` asks for: the folded key (0), both words (1), b1 ^ b2 (2),
//     b1 << 32 | b2 (3), a uniform (4) or a normal (5) in float32 or float64.
//     A float32 uniform is ((b1 ^ b2) >> 9 | 0x3f800000) as a float minus 1,
//     a float64 one the top 52 bits of b1 << 32 | b2 under 0x3ff0...; a scaled
//     uniform is max(lo, u * (hi - lo) + lo) and a normal sqrt(2) erfinv of
//     the uniform on [nextafter(-1, 0), 1).  Every product and sum is rounded
//     on its own (__fmul_rn, __fadd_rn), so the results equal the plain torch
//     version's bit for bit; erfinv is the CUDA math library's, which torch's
//     own CUDA erfinv also calls.
//
// A block takes one contiguous chunk of the elements (row-major over the key
// rows).  Its threads first read, and fold, each key row the chunk spans
// once into shared memory; then each thread walks its elements 256 apart,
// stepping its (row, element) pair without a division.  So a folded draw
// costs one hash an element plus one a key row of the chunk, not two an
// element.
//
// What bounds it: it reads 16 bytes a key row and writes 4 or 8 bytes an
// element, and does about 78 32-bit integer operations a hash (20 rounds
// of add, rotate and xor, 5 key injections).  At a rats NUTS momentum draw
// (1024 x 62 float32) that is 0.26 MB, 0.08 us at 3.35 TB/s, and 5 M
// integer operations, which 132 SMs at 64 integer lanes a clock do in about
// 0.3 us: so a launch costs what any launch costs, a few microseconds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ void threefry2x32(uint32_t k1, uint32_t k2,
                                             uint32_t& x1, uint32_t& x2) {
  const uint32_t ks[3] = {k1, k2, k1 ^ k2 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x1 += ks[0];
  x2 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x1 += x2;
      x2 = x1 ^ rotl(x2, rot[i % 2][j]);
    }
    x1 += ks[(i + 1) % 3];
    x2 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
}

enum Kind { FOLDED = 0, WORDS = 1, BITS32 = 2, BITS64 = 3, UNIFORM = 4,
            NORMAL = 5 };

__device__ __forceinline__ float uniform32(uint32_t b1, uint32_t b2, bool scaled,
                                           float lo, float span) {
  const float f = __uint_as_float(((b1 ^ b2) >> 9) | 0x3F800000u) - 1.0f;
  return scaled ? fmaxf(lo, __fadd_rn(__fmul_rn(f, span), lo)) : f;
}

__device__ __forceinline__ double uniform64(uint32_t b1, uint32_t b2,
                                            bool scaled, double lo,
                                            double span) {
  const unsigned long long m = ((unsigned long long)b1 << 20) | (b2 >> 12);
  const double f = __longlong_as_double(
                       (long long)(m | 0x3FF0000000000000ull)) - 1.0;
  return scaled ? fmax(lo, __dadd_rn(__dmul_rn(f, span), lo)) : f;
}

constexpr int kThreads = 256;
// key rows a block holds in shared memory (8 KB); a chunk that spans more
// (a few numbers a key) folds each element's row itself
constexpr int kMaxRows = 1024;

__global__ void threefry_kernel(const long long* __restrict__ keys,
                                long long key_stride, long long B,
                                const long long* __restrict__ fold,
                                long long fold_value, long long fold_stride,
                                long long n, const long long* __restrict__ index,
                                long long m, long long D, int kind, int f64,
                                double lo, double hi, long long chunk,
                                void* __restrict__ out) {
  __shared__ uint32_t row_keys[kMaxRows][2];
  const long long total = kind == FOLDED ? B : B * n;
  const long long start = (long long)blockIdx.x * chunk;
  if (start >= total) return;
  const long long end = start + chunk < total ? start + chunk : total;
  const bool scaled = kind == NORMAL || lo != 0.0 || hi != 1.0;
  const float lo32 = (float)lo, span32 = __fsub_rn((float)hi, (float)lo);
  const double span64 = __dsub_rn(hi, lo);
  // the row's key, folded where a fold is given
  auto row_key = [&](long long b, uint32_t& k1, uint32_t& k2) {
    k1 = (uint32_t)keys[b * key_stride];
    k2 = (uint32_t)keys[b * key_stride + 1];
    if (fold_stride >= 0) {
      uint32_t f1 = 0;
      uint32_t f2 = (uint32_t)(fold ? fold[b * fold_stride] : fold_value);
      threefry2x32(k1, k2, f1, f2);
      k1 = f1;
      k2 = f2;
    }
  };
  if (kind == FOLDED) {
    long long* o = static_cast<long long*>(out);
    for (long long t = start + threadIdx.x; t < end; t += kThreads) {
      uint32_t k1, k2;
      row_key(t, k1, k2);
      o[2 * t] = k1;
      o[2 * t + 1] = k2;
    }
    return;
  }
  const long long b0 = start / n;
  const long long rows = (end - 1) / n - b0 + 1;
  const bool held = rows <= kMaxRows;  // the same for the whole block
  if (held) {
    for (int i = threadIdx.x; i < rows; i += kThreads)
      row_key(b0 + i, row_keys[i][0], row_keys[i][1]);
    __syncthreads();
  }
  long long t = start + threadIdx.x;
  if (t >= end) return;
  long long b = t / n, e = t - b * n;
  const long long rows_step = kThreads / n, e_step = kThreads - rows_step * n;
  for (; t < end; t += kThreads) {
    uint32_t k1, k2;
    if (held) {
      k1 = row_keys[b - b0][0];
      k2 = row_keys[b - b0][1];
    } else {
      row_key(b, k1, k2);
    }
    const long long ctr = index ? (e / m) * D + index[e % m] : e;
    uint32_t x1 = (uint32_t)((unsigned long long)ctr >> 32);
    uint32_t x2 = (uint32_t)ctr;
    threefry2x32(k1, k2, x1, x2);
    switch (kind) {
      case WORDS: {
        long long* o = static_cast<long long*>(out);
        o[2 * t] = x1;
        o[2 * t + 1] = x2;
        break;
      }
      case BITS32:
        static_cast<long long*>(out)[t] = (long long)(x1 ^ x2);
        break;
      case BITS64:
        static_cast<long long*>(out)[t] =
            (long long)(((unsigned long long)x1 << 32) | x2);
        break;
      case UNIFORM:
        if (f64)
          static_cast<double*>(out)[t] = uniform64(x1, x2, scaled, lo, span64);
        else
          static_cast<float*>(out)[t] = uniform32(x1, x2, scaled, lo32, span32);
        break;
      case NORMAL:
        if (f64)
          static_cast<double*>(out)[t] = __dmul_rn(
              erfinv(uniform64(x1, x2, true, lo, span64)), 1.4142135623730951);
        else
          static_cast<float*>(out)[t] = __fmul_rn(
              erfinvf(uniform32(x1, x2, true, lo32, span32)), 1.41421356f);
        break;
    }
    // the next element, kThreads on: rows_step rows and e_step elements
    e += e_step;
    b += rows_step;
    if (e >= n) {
      e -= n;
      ++b;
    }
  }
}

}  // namespace

extern "C" {

// keys: B rows of two words (int64), row b at keys + b * key_stride (0: one
//   key for every row), device memory.
// fold: fold_stride < 0 no fold; else fold_in by fold[b * fold_stride] when
//   fold is not null (device int64), or by fold_value.
// n: elements per key; index/m/D: the counters of an index draw (index null
//   for a plain range).  kind: Kind above.  f64: float64 output, else float32.
// lo, hi: the uniform's range (a normal's: nextafter(-1, 0) and 1).
// Output row-major: element e of key b at b * n + e.
// Launches on `stream` without synchronizing; returns the cudaError_t.
int threefry_draw(const long long* keys, long long key_stride, long long B,
                  const long long* fold, long long fold_value,
                  long long fold_stride, long long n, const long long* index,
                  long long m, long long D, int kind, int f64, double lo,
                  double hi, void* out, void* stream) {
  const long long total = kind == FOLDED ? B : B * n;
  if (total <= 0) return 0;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  const long long chunk = (total + blocks - 1) / blocks;
  blocks = (total + chunk - 1) / chunk;
  threefry_kernel<<<(unsigned)blocks, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      keys, key_stride, B, fold, fold_value, fold_stride, n, index, m, D,
      kind, f64, lo, hi, chunk, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
