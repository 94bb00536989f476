// Fused Gram accumulation and composed-precision inverse, one CTA per
// feature block (n <= 128; blocks of 129..1024 take the large route at the
// end of this file).
//
// Replaces the Pallas TPU kernel repro/kernels/fused_gram_solve.py
// (_kernel, called from fused_gram_inv). For activations a (T, nb, n),
// fp32 or bf16, and each block i, on n <= 128 as given:
//   G_i   = (a_hi^T a_hi + a_hi^T a_lo + a_lo^T a_hi) / T   (a = a[:, i, :])
//   lam_i = rel_damp * tr(G_i) / n + 1e-8
//   out_i = composed inverse of G_i + lam_i I   (composed_inv.cuh)
// every product a sum of bf16 partial products on the tensor cores with
// fp32 accumulation. The Gram never goes to device memory. For bf16 input
// a_lo is exactly zero, so only a_hi^T a_hi is formed (the two skipped
// partials add exact zeros).
//
// Unlike the TPU kernel, n is not padded to 128 with a lam-damped tail: the
// padded block is block-diagonal with the same norms, so its top-left
// inverse is the unpadded one; here the tail is zero in shared memory only,
// as in neumann_inv.cu. Ragged T: the last token tile is zero-filled, which
// adds nothing to the Gram.
//
// Bound: operations. Per block, 3 partial (n x T) (T x n) Gram products and
// the 127 partial 128^3 GEMMs of the inverse at the K-FAC counts 20/4/2;
// at the main path's largest A leaf (T 2048, nb 528, n 128) that is
// 106 + 281 GFLOP (0.39 ms at 989 TFLOP/s) against 554 MB (0.17 ms).
// Design: until the inverse starts, its 192 KB of tiles are free. The CTA
// streams its block's (64, n) token tiles through a ring of four staging
// tiles (the X and W tiles' space) with cp.async, 16-byte pieces where n
// and the base allow (4-byte ones else; element by element for bf16 rows
// that are not 4-byte aligned), three tiles in flight behind the one being
// used. Each staged tile is split to swizzled hi/lo slices in one of two
// slice pairs (the A_H / A_L tiles' space) and accumulated with wgmma,
// tile^T as an MN-major left operand and tile as the right one; the split
// of tile i+1 runs while the products of tile i are in flight. The Gram is
// divided by T in the accumulator registers, its trace reduced with warp
// shuffles, lam added on the diagonal, and the damped Gram split into the
// A_H / A_L tiles, where composed_inverse takes over. One CTA per SM;
// splitting T across CTAs for few-block, many-token calls is later work.
//
// Blocks of 129..1024 (the reference's whole domain): a block's Gram no
// longer fits one CTA (a 256 block's fp32 Gram is 256 KB against 227 KB a
// CTA may have), so above 128 the Gram passes through device memory, where
// the TPU kept it in VMEM. Per chunk of blocks, into a workspace the caller
// allocates:
//   fused_gram_inv_split   each block's (T, n) activations (rows nb n
//                          apart in a) into slices, block after block, rows
//                          slice_stride(n) apart (a TMA-legal layout: a's
//                          own rows need not lie on 16 bytes, n = 129 puts
//                          none there): hi and lo of fp32 activations, hi
//                          alone of bf16 ones (exact: their lo is zero);
//   fused_gram_inv_gram    G_i = sum of the hi/lo partials of a_i^T a_i,
//                          one batched product of hilo_tma.cuh over the
//                          chunk's blocks, depth T: the left operand block
//                          i's slices read as stored (T x n: a_i^T stored
//                          k x m), the right the same slices; three
//                          partials for fp32, L_H R_H alone for bf16 (the
//                          two left out add exact zeros);
//   fused_gram_inv_finish  G_i / T (a division, as the plain version
//                          divides) and lam_i = rel_damp tr / n + 1e-8, the
//                          trace summed in the one-CTA kernel's order;
// then the caller runs neumann_inv's large route on (G_i, lam_i)
// (kernels/fused_gram_solve.py). A cluster holding the Gram in distributed
// shared memory, and T split across CTAs for calls with few blocks and many
// tokens, are later work.
#include "composed_inv.cuh"
#include "hilo_tma.cuh"

namespace {

using composed::NP;
using composed::THREADS;
using wgmma::Acc;
using wgmma::bf16;

constexpr int BT = 64;                      // tokens a tile
constexpr int STAGES = 4;                   // staging ring
constexpr int SLICE_ELEMS = BT * NP;        // one (64, 128) staged tile
constexpr int SLICE_BYTES = wgmma::tile_bytes<BT>();  // one slice, 16 KB

// how load_tile moves a row (chosen on the host from n and the base)
enum { LOAD_ELEM = 0, LOAD_4 = 1, LOAD_16 = 2 };

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// This thread's share of a token tile: pieces of e elements (16 or 4
// bytes' worth, or 1), q = n / e of them a row, column col0 of rows row0,
// row0 + step, ... (step = rows a pass; threads past step * q idle).
struct Share {
  int e, col0, row0, step;
};

__device__ __forceinline__ Share share(int mode, int n, int elem_bytes) {
  Share s;
  s.e = mode == LOAD_16 ? 16 / elem_bytes : mode == LOAD_4 ? 4 / elem_bytes
                                                           : 1;
  const int q = n / s.e;
  s.step = THREADS / q;
  s.row0 = threadIdx.x / q;
  s.col0 = (threadIdx.x - s.row0 * q) * s.e;
  return s;
}

// Start copying this thread's share of rows x n of src (row stride
// row_stride) into the staging tile st (row stride NP), as one copy group.
template <class T>
__device__ __forceinline__ void load_tile(const T* __restrict__ src,
                                          size_t row_stride, int rows,
                                          int mode, const Share& sh, T* st) {
  if (sh.row0 < sh.step) {
    for (int i = sh.row0; i < rows; i += sh.step) {
      T* d = st + i * NP + sh.col0;
      const T* g = src + i * row_stride + sh.col0;
      if (mode == LOAD_16)
        hilo::cp_async16(d, g);
      else if (mode == LOAD_4)
        hilo::cp_async4(d, g);
      else
        *d = *g;
    }
  }
  cp_async_commit();
}

// Split the staged tile (rows x n valid) into swizzled hi/lo slices H and L,
// zero outside rows x n (whatever the staging tile holds there).
__device__ __forceinline__ void split_tile(const float* st, int rows, int n,
                                           uint32_t H, uint32_t L) {
  for (int idx = threadIdx.x; idx < BT * NP / 4; idx += THREADS) {
    const int i = idx >> 5;
    const int j = (idx & 31) << 2;
    const float4 q = *reinterpret_cast<const float4*>(st + i * NP + j);
    const bool in = i < rows;
    uint32_t h0, l0, h1, l1;
    hilo::split2(in && j < n ? q.x : 0.f, in && j + 1 < n ? q.y : 0.f, h0,
                 l0);
    hilo::split2(in && j + 2 < n ? q.z : 0.f, in && j + 3 < n ? q.w : 0.f,
                 h1, l1);
    const uint32_t o = wgmma::swz<BT>(i, j);
    wgmma::st_shared(H + o, make_uint2(h0, h1));
    wgmma::st_shared(L + o, make_uint2(l0, l1));
  }
}

// bf16 input: the hi slice is the value itself, the lo slice zero (unused).
__device__ __forceinline__ void split_tile(const bf16* st, int rows, int n,
                                           uint32_t H, uint32_t) {
  for (int idx = threadIdx.x; idx < BT * NP / 8; idx += THREADS) {
    const int i = idx >> 4;
    const int j = (idx & 15) << 3;
    const uint4 q = *reinterpret_cast<const uint4*>(st + i * NP + j);
    uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = j + 2 * e;
      w[e] &= i >= rows  ? 0u
              : c + 1 < n ? 0xFFFFFFFFu
              : c < n     ? 0x0000FFFFu
                          : 0u;
    }
    wgmma::st_shared(H + wgmma::swz<BT>(i, j),
                     make_uint4(w[0], w[1], w[2], w[3]));
  }
}

// acc += tile^T tile over the slices H, L of one token tile: 3 partials,
// or with LO false (bf16 input) only H^T H; committed, not waited for.
template <bool LO>
__device__ __forceinline__ void gram_mma(Acc& acc, uint32_t H, uint32_t L) {
  const int wg = threadIdx.x >> 7;
  wgmma::fence_operand(acc);
  wgmma::fence();
#pragma unroll 1
  for (int ks = 0; ks < BT / 16; ++ks) {
    const uint64_t ah = wgmma::desc_mn_t<BT>(H, wg, ks);
    const uint64_t bh = wgmma::desc_mn<BT>(H, ks);
    wgmma::mma<1, 1>(acc, ah, bh, 1);
    if (LO) {
      wgmma::mma<1, 1>(acc, ah, wgmma::desc_mn<BT>(L, ks), 1);
      wgmma::mma<1, 1>(acc, wgmma::desc_mn_t<BT>(L, wg, ks), bh, 1);
    }
  }
  wgmma::commit();
}

template <class T>
__global__ void __launch_bounds__(THREADS, 1)
fused_gram_inv_kernel(const T* __restrict__ a, float* __restrict__ out,
                      int t_tok, int nb, int n, float rel_damp, int ns_iters,
                      int taylor_terms, int refine_steps, int mode) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const composed::Tiles s = composed::carve(smem);
  // Gram phase: two slice pairs (H0, L0, H1, L1) in the A_H / A_L tiles'
  // space, the staging ring in the X and W tiles'
  const uint32_t slices = s.AH;
  T* ring = reinterpret_cast<T*>(s.base + 2 * composed::TILE_BYTES);
  const size_t row_stride = static_cast<size_t>(nb) * n;
  const T* src = a + static_cast<size_t>(blockIdx.x) * n;
  const int n_tiles = (t_tok + BT - 1) / BT;
  const Share sh = share(mode, n, sizeof(T));

  // every thread commits one copy group per tile index, empty past the end
  auto fetch = [&](int i) {
    if (i < n_tiles)
      load_tile(src + static_cast<size_t>(i) * BT * row_stride, row_stride,
                min(BT, t_tok - i * BT), mode, sh,
                ring + (i % STAGES) * SLICE_ELEMS);
    else
      cp_async_commit();
  };

  Acc acc;
#pragma unroll
  for (int j = 0; j < 64; ++j) acc[j] = 0.f;
  for (int i = 0; i < STAGES - 1; ++i) fetch(i);
  for (int i = 0; i < n_tiles; ++i) {
    fetch(i + STAGES - 1);           // its stage was split in iteration i-1
    hilo::cp_async_wait<STAGES - 1>();
    __syncthreads();                 // tile i staged; products of i-2 done
    const uint32_t H = slices + (i & 1) * 2 * SLICE_BYTES;
    const uint32_t L = H + SLICE_BYTES;
    split_tile(ring + (i % STAGES) * SLICE_ELEMS, min(BT, t_tok - i * BT), n,
               H, L);
    wgmma::fence_smem();
    __syncthreads();                 // slices of tile i whole
    gram_mma<sizeof(T) == 4>(acc, H, L);
    wgmma::wait<1>();                // products of tile i-1 done
    wgmma::fence_operand(acc);
  }
  wgmma::wait<0>();
  wgmma::fence_operand(acc);
  __syncthreads();                   // every slice read: A_H / A_L free

  // G = acc / T; lam = rel_damp * tr(G) / n + 1e-8 on the diagonal
  const float tf = static_cast<float>(t_tok);
  wgmma::for_each(acc, [&](int r, int c, float& v) {
    v = v / tf;
    if (r == c && r < n) s.red[r] = v;
  });
  __syncthreads();
  if (threadIdx.x < 32) {
    float tr = 0.f;
    for (int k = threadIdx.x; k < n; k += 32) tr += s.red[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      tr += __shfl_xor_sync(0xffffffffu, tr, o);
    if (threadIdx.x == 0)
      s.red[2 * NP] = rel_damp * tr / static_cast<float>(n) + 1e-8f;
  }
  __syncthreads();
  const float lam = s.red[2 * NP];
  wgmma::for_each(acc, [&](int r, int c, float& v) {
    if (r == c && r < n) v += lam;
  });
  composed::store_split(acc, s.AH, s.AL);
  __syncthreads();
  composed::inverse(s, n, ns_iters, taylor_terms, refine_steps,
                    out + static_cast<size_t>(blockIdx.x) * n * n);
}

template <class T>
int launch(const T* a, float* out, int t_tok, int nb, int n, float rel_damp,
           int ns_iters, int taylor_terms, int refine_steps, void* stream) {
  if (n < 1 || n > NP || t_tok < 1 || nb < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  // every row starts at (t nb + i) n elements from a: 16-byte pieces need
  // n a multiple of 16 bytes' worth and a 16-byte aligned base, 4-byte
  // pieces the same for 4 bytes
  const uintptr_t base = reinterpret_cast<uintptr_t>(a);
  constexpr int E16 = 16 / sizeof(T), E4 = 4 / sizeof(T);
  const int mode = n % E16 == 0 && base % 16 == 0 ? LOAD_16
                   : n % E4 == 0 && base % 4 == 0 ? LOAD_4
                                                   : LOAD_ELEM;
  cudaError_t err = cudaFuncSetAttribute(
      fused_gram_inv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      composed::SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_gram_inv_kernel<T><<<nb, THREADS, composed::SMEM_BYTES,
                             static_cast<cudaStream_t>(stream)>>>(
      a, out, t_tok, nb, n, rel_damp, ns_iters, taylor_terms, refine_steps,
      mode);
  return static_cast<int>(cudaGetLastError());
}

constexpr int FINISH_THREADS = 256;

// G /= T in place and lam = rel_damp * tr(G) / n + 1e-8, one CTA a block.
__global__ void __launch_bounds__(FINISH_THREADS)
gram_finish_kernel(float* __restrict__ g, float* __restrict__ lam, int n,
                   int t_tok, float rel_damp) {
  __shared__ float diag[1024];
  float* gb = g + static_cast<size_t>(blockIdx.x) * n * n;
  const float tf = static_cast<float>(t_tok);
  for (int idx = threadIdx.x; idx < n * n; idx += FINISH_THREADS) {
    const float v = gb[idx] / tf;
    gb[idx] = v;
    if (idx % (n + 1) == 0) diag[idx / (n + 1)] = v;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    float tr = 0.f;
    for (int k = threadIdx.x; k < n; k += 32) tr += diag[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      tr += __shfl_xor_sync(0xffffffffu, tr, o);
    if (threadIdx.x == 0)
      lam[blockIdx.x] = rel_damp * tr / static_cast<float>(n) + 1e-8f;
  }
}

}  // namespace

// Large route: `blocks` blocks of rows x cols activations at src (block
// b's row r at src + b bstride + r ld elements; fp32, or bf16 with bf16_in
// and lo null) into their slices at hi and lo, rows ld16 apart.
extern "C" int fused_gram_inv_split(const void* src, int bf16_in,
                                    long long blocks, int rows, int cols,
                                    long long bstride, long long ld,
                                    void* hi, void* lo, int ld16,
                                    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  bf16* h = static_cast<bf16*>(hi);
  if (bf16_in)
    return htma::split_launch(static_cast<const bf16*>(src), blocks, rows,
                              cols, bstride, ld, ld16, h,
                              static_cast<bf16*>(lo), st);
  return htma::split_launch(static_cast<const float*>(src), blocks, rows,
                            cols, bstride, ld, ld16, h,
                            static_cast<bf16*>(lo), st);
}

// The Gram's forms: its left operand stored k x m (a_i^T as a_i), three
// partials (fp32 activations) or one (bf16).
constexpr int GRAM_FORMS =
    htma::form_bit(true, false, 3) | htma::form_bit(true, false, 1);

// Large route: the chunk's Grams (epilogue STORE).
extern "C" int fused_gram_inv_gram(const htma::Params* p, void* stream) {
  if (!p || p->epi != htma::STORE)
    return static_cast<int>(cudaErrorInvalidValue);
  return htma::launch<GRAM_FORMS>(*p, static_cast<cudaStream_t>(stream));
}

// Large route: g (nb, n, n) /= t_tok in place, lam (nb,) its damping.
extern "C" int fused_gram_inv_finish(float* g, float* lam, int nb, int n,
                                     int t_tok, float rel_damp,
                                     void* stream) {
  if (nb < 1 || n < 1 || n > 1024 || t_tok < 1 || !g || !lam)
    return static_cast<int>(cudaErrorInvalidValue);
  gram_finish_kernel<<<nb, FINISH_THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(g, lam, n, t_tok,
                                                            rel_damp);
  return static_cast<int>(cudaGetLastError());
}

// Launch on `stream` for contiguous a (T, nb, n) and out (nb, n, n);
// returns the cudaError_t of the launch (0 = success).
extern "C" int fused_gram_inv_f32_launch(const float* a, float* out, int t_tok,
                                         int nb, int n, float rel_damp,
                                         int ns_iters, int taylor_terms,
                                         int refine_steps, void* stream) {
  return launch(a, out, t_tok, nb, n, rel_damp, ns_iters, taylor_terms,
                refine_steps, stream);
}

extern "C" int fused_gram_inv_bf16_launch(const bf16* a, float* out,
                                          int t_tok, int nb, int n,
                                          float rel_damp, int ns_iters,
                                          int taylor_terms, int refine_steps,
                                          void* stream) {
  return launch(a, out, t_tok, nb, n, rel_damp, ns_iters, taylor_terms,
                refine_steps, stream);
}

extern "C" const char* fused_gram_inv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
