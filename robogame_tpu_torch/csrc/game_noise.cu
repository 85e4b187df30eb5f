// Per-game standard normals from Philox4x32-10, the whole batch in one
// launch: the draw kernel of the port's stochastic steps.
//
// Replaces no Pallas kernel.  The JAX package draws its games' noise with
// threefry under vmap as XLA ops (physics/pallas_step.py::_noise_plane and
// _rnoise_plane, physics/sweep.py::populate_noise and repropagation_noise,
// physics/engine.py's draws); the port draws the stream that
// physics/noise.py defines, whose plain version (game_normals_plain) is the
// yardstick of this kernel: the same words bitwise, the normals to the last
// bits of log and sin/cos.
//
// Thread t computes Philox block j = t % n_blocks of game b = t / n_blocks:
// counter (j, counter_b + 1, substream, it), key (seed_b low word, high
// word); its four words give 4 f32 normals (two Box-Muller pairs of 32-bit
// uniforms) or 2 f64 normals (one pair of 53-bit uniforms), computed in f64
// and written straight to out[b, per * j ...].  Neighbouring threads write
// neighbouring normals.
//
// Bound: the bytes written (the keys are 16 bytes a game): at B=2048, G=50
// one stochastic K1 step draws 2048 x 101 x 16 f32 = 13.2 MB, about 4 us
// at 3.35 TB/s.  Each block also costs ten rounds of two 32x32->64 integer
// products and a Box-Muller pair or two in f64 (log, sqrt, sin, cos), work
// that no bound counts here; the design keeps it to one pass with no
// memory traffic but the keys and the normals.  Built with -fmad=false, so
// every f64 product and sum is the plain version's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
constexpr uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
constexpr double TWO_PI = 6.283185307179586;   // 2.0 * math.pi
constexpr double P32 = 0x1p-32;
constexpr double P53 = 0x1p-53;
constexpr int THREADS = 256;

__device__ __forceinline__ void philox(uint32_t c[4], uint32_t k0,
                                       uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += W0;
      k1 += W1;
    }
    const uint64_t p0 = (uint64_t)M0 * c[0];
    const uint64_t p1 = (uint64_t)M1 * c[2];
    const uint32_t n0 = (uint32_t)(p1 >> 32) ^ c[1] ^ k0;
    const uint32_t n2 = (uint32_t)(p0 >> 32) ^ c[3] ^ k1;
    c[0] = n0;
    c[1] = (uint32_t)p1;
    c[2] = n2;
    c[3] = (uint32_t)p0;
  }
}

// (r cos 2 pi u2, r sin 2 pi u2), r = sqrt(-2 log u1), in the plain
// version's order of operations
__device__ __forceinline__ void box_muller(double u1, double u2, double* a,
                                           double* b) {
  const double r = sqrt(-2.0 * log(u1));
  const double theta = TWO_PI * u2;
  *a = r * cos(theta);
  *b = r * sin(theta);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
game_normals_kernel(const long long* __restrict__ keys, T* __restrict__ out,
                    int B, int n, int n_blocks, uint32_t substream,
                    uint32_t it) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= (long long)B * n_blocks) return;
  const int b = (int)(t / n_blocks);
  const int j = (int)(t - (long long)b * n_blocks);
  const uint64_t seed = (uint64_t)keys[2 * b];
  const uint32_t ctr = (uint32_t)((uint64_t)keys[2 * b + 1] + 1u);
  uint32_t c[4] = {(uint32_t)j, ctr, substream, it};
  philox(c, (uint32_t)seed, (uint32_t)(seed >> 32));
  T* o = out + (long long)b * n;
  if (sizeof(T) == 4) {
    double z[4];
    box_muller((double)c[0] * P32 + P32, (double)c[1] * P32, &z[0], &z[1]);
    box_muller((double)c[2] * P32 + P32, (double)c[3] * P32, &z[2], &z[3]);
#pragma unroll
    for (int l = 0; l < 4; ++l)
      if (4 * j + l < n) o[4 * j + l] = (T)z[l];
  } else {
    const uint64_t hi = ((uint64_t)c[0] << 21) | (c[1] >> 11);
    const uint64_t lo = ((uint64_t)c[2] << 21) | (c[3] >> 11);
    double z[2];
    box_muller((double)hi * P53 + P53, (double)lo * P53, &z[0], &z[1]);
    o[2 * j] = (T)z[0];
    if (2 * j + 1 < n) o[2 * j + 1] = (T)z[1];
  }
}

// the raw words of the same blocks, for holding the generator to its
// plain version bitwise: out (B, n_blocks, 4) uint32
__global__ void __launch_bounds__(THREADS)
game_words_kernel(const long long* __restrict__ keys,
                  uint32_t* __restrict__ out, int B, int n_blocks,
                  uint32_t substream, uint32_t it) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= (long long)B * n_blocks) return;
  const int b = (int)(t / n_blocks);
  const int j = (int)(t - (long long)b * n_blocks);
  const uint64_t seed = (uint64_t)keys[2 * b];
  const uint32_t ctr = (uint32_t)((uint64_t)keys[2 * b + 1] + 1u);
  uint32_t c[4] = {(uint32_t)j, ctr, substream, it};
  philox(c, (uint32_t)seed, (uint32_t)(seed >> 32));
#pragma unroll
  for (int l = 0; l < 4; ++l) out[4 * t + l] = c[l];
}

}  // namespace

extern "C" int rg_game_words(const long long* keys, void* out, int B,
                             int n_blocks, int substream, int it,
                             void* stream) {
  const long long threads = (long long)B * n_blocks;
  if (threads == 0) return 0;
  const unsigned grid = (unsigned)((threads + THREADS - 1) / THREADS);
  game_words_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      keys, (uint32_t*)out, B, n_blocks, (uint32_t)substream, (uint32_t)it);
  return (int)cudaGetLastError();
}

// Launches the draw on `stream` and returns the CUDA error of the launch
// (0 when it was accepted).  `keys` is device memory (B, 2) int64
// [seed, counter]; `out` device memory (B, n) of f32 (f64 == 0) or f64.
extern "C" int rg_game_normals(const long long* keys, void* out, int B, int n,
                               int substream, int it, int f64,
                               void* stream) {
  const int per = f64 ? 2 : 4;
  const int n_blocks = (n + per - 1) / per;
  const long long threads = (long long)B * n_blocks;
  if (threads == 0) return 0;
  const unsigned grid = (unsigned)((threads + THREADS - 1) / THREADS);
  cudaStream_t st = (cudaStream_t)stream;
  if (f64)
    game_normals_kernel<double><<<grid, THREADS, 0, st>>>(
        keys, (double*)out, B, n, n_blocks, (uint32_t)substream,
        (uint32_t)it);
  else
    game_normals_kernel<float><<<grid, THREADS, 0, st>>>(
        keys, (float*)out, B, n, n_blocks, (uint32_t)substream,
        (uint32_t)it);
  return (int)cudaGetLastError();
}
