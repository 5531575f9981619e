// What csrc/shade.cu (one bounce of shading, forward) and csrc/shade_grad.cu
// (its backward) share: the float3 helpers that repeat the torch ops of
// ops/shade.py in their order, the argument block of a bounce, and the
// texture lookup of models/textures.py::sample_texture.  csrc/trace.cu (the
// hit record) uses the helpers.
//
// Every helper rounds as its torch counterpart on the card does: dot3 as
// (x*x' + y*y') + z*z', cross3 with one multiply a term, safe_normalize as
// v * (1 / sqrt(max(v.v, 1e-18))), clamp_min propagating NaN as torch's
// does.  The library is built with --fmad=false, so no multiply and add
// contract.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// Material and texture tags (models/scene.py).
constexpr int kDiffuse = 0;
constexpr int kReflective = 1;
constexpr int kRefractive = 2;
constexpr int kConstant = 3;
constexpr int kTexture = 4;
constexpr int kTexEdges = 1;
constexpr int kTexChecker = 2;
constexpr int kTexBitmap = 3;

// The table row a texture lookup reads (texture_pick).
constexpr int kPickA = 0;      // tex_color_a[x]
constexpr int kPickB = 1;      // tex_color_b[x]
constexpr int kPickAtlas = 2;  // atlas[texel]

constexpr int kThreads = 256;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 load3(const float* __restrict__ p, int64_t i) {
  return V3{p[3 * i], p[3 * i + 1], p[3 * i + 2]};
}

__device__ __forceinline__ void store3(float* __restrict__ p, int64_t i,
                                       V3 v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}

__device__ __forceinline__ V3 add(V3 a, V3 b) {
  return V3{a.x + b.x, a.y + b.y, a.z + b.z};
}

__device__ __forceinline__ V3 sub(V3 a, V3 b) {
  return V3{a.x - b.x, a.y - b.y, a.z - b.z};
}

__device__ __forceinline__ V3 scale(float s, V3 v) {
  return V3{s * v.x, s * v.y, s * v.z};
}

__device__ __forceinline__ V3 neg(V3 v) { return V3{-v.x, -v.y, -v.z}; }

__device__ __forceinline__ float dot3(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

__device__ __forceinline__ V3 cross3(V3 a, V3 b) {
  return V3{a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x};
}

// torch's clamp_min on the card: NaN stays NaN.
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

// min(max(v, lo), hi), as torch's clamp of an integer tensor.
__device__ __forceinline__ int64_t clamp(int64_t v, int64_t lo, int64_t hi) {
  const int64_t m = v < lo ? lo : v;
  return m > hi ? hi : m;
}

__device__ __forceinline__ V3 safe_normalize(V3 v) {
  const float inv =
      1.0f / sqrtf(clamp_min(dot3(v, v), static_cast<float>(1e-18)));
  return scale(inv, v);
}

// A p + s * d origin, as torch makes `p + s * d` (the product first).
__device__ __forceinline__ V3 offset(V3 p, float s, V3 d) {
  return add(p, scale(s, d));
}

// Everything shade_bounce_kernel reads and writes; mirrored field by field
// by ops/shade.py::BounceArgs (ctypes).  Row arrays are contiguous: (n,),
// (n, 3), uvs (n, 3, 2), rnd_gi (n, gi, 2).
struct BounceArgs {
  // The hit record and the incoming rays.
  const bool* mask;
  const int* tag;
  const float* weight;
  const float* d_in;
  const float* position;
  const float* hit_n;
  const float* face_n;
  const bool* smooth;
  const float* ior;
  const float* albedo;
  const int* tex;
  const float* u;
  const float* v;
  const float* w;
  const float* uvs;
  const float* factor;    // (n,), or null where no row needed light
  const float* rnd_coin;  // (n,) under roulette
  const float* rnd_gi;    // (n, gi, 2) where gi > 0
  // The scene's texture tables.
  const int* tex_tag;
  const float* tex_color_a;
  const float* tex_color_b;
  const float* tex_param;
  const int* tex_offset;
  const int* tex_width;
  const int* tex_height;
  const float* atlas;
  // Outputs: contrib (n, 3); children (n * k, ...) in slot order (null in
  // the backward, which writes none of them).
  float* contrib;
  float* child_o;
  float* child_d;
  float* child_w;
  bool* child_bg;
  int64_t n;
  int64_t atlas_rows;
  int gi;        // diffuse GI rays a hit
  int k;         // child slots a row (1 under roulette)
  int roulette;  // 1: one child picked by rnd_coin; 0: the K split slots
  // Scalars as torch rounds them to float32.
  float direct_scale;     // 1 / (gi + 1), double then float
  float gi_count;         // gi
  float gi_inv;           // 1.0f / (float)(gi + 1): torch's x / (gi + 1)
  float pi;               // pi
  float two_pi;           // 2 pi
  float reflection_bias;
  float refraction_bias;
};

// Which table row models/textures.py::sample_texture reads for row i of
// texture `x` (kPickA, kPickB, or kPickAtlas with the texel in *texel).
// Its float -> int casts truncate, as in C++, and the checker takes the
// truncated remainder; int32 adds wrap as torch's do.
__device__ int texture_pick(const BounceArgs& a, int64_t i, int x,
                            int64_t* texel) {
  const int tag = a.tex_tag[x];
  const float u = a.u[i], v = a.v[i], w = a.w[i];
  const float param = a.tex_param[x];
  const float* uv = a.uvs + 6 * i;
  const float fu = w * uv[0] + u * uv[2] + v * uv[4];
  const float fv = w * uv[1] + u * uv[3] + v * uv[5];
  if (tag == kTexEdges)
    return (u < param || v < param || w < param) ? kPickA : kPickB;
  if (tag == kTexChecker) {
    const float sq = clamp_min(param, static_cast<float>(1e-20));
    const int u2 = static_cast<int>(fu / sq);
    const int v2 = static_cast<int>(fv / sq);
    const int sum = static_cast<int>(static_cast<unsigned>(u2) +
                                     static_cast<unsigned>(v2));
    return sum % 2 == 0 ? kPickA : kPickB;
  }
  if (tag == kTexBitmap) {
    const int th = a.tex_height[x], tw = a.tex_width[x];
    const int row = static_cast<int>(
        clamp(static_cast<int>((1.0f - fv) * static_cast<float>(th)), 0,
              th - 1));
    const int col = static_cast<int>(
        clamp(static_cast<int>(fu * static_cast<float>(tw)), 0, tw - 1));
    const unsigned at = static_cast<unsigned>(a.tex_offset[x]) +
                        static_cast<unsigned>(row) * static_cast<unsigned>(tw) +
                        static_cast<unsigned>(col);
    *texel = clamp(static_cast<int>(at), 0, a.atlas_rows - 1);
    return kPickAtlas;
  }
  return kPickA;
}

// models/textures.py::sample_texture for one row of texture `x`.
__device__ V3 sample_texture(const BounceArgs& a, int64_t i, int x) {
  int64_t texel = 0;
  const int pick = texture_pick(a, i, x, &texel);
  if (pick == kPickA) return load3(a.tex_color_a, x);
  if (pick == kPickB) return load3(a.tex_color_b, x);
  return load3(a.atlas, texel);
}

inline unsigned blocks(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace
