// Shared pieces of the select kernels (mt_select.cu, sweep_select.cu,
// kd_select.cu; fast_select.cu takes the keys and the staging helpers):
// the Moller-Trumbore pair tests, the packed (t, id) merge key and the
// cp.async staging helpers.  One copy of the arithmetic, so the kernels' winners cannot
// drift apart.
//
// Every arithmetic step is one IEEE operation in the order of the plain
// torch versions (ops/intersect.py::mt_pairs, ops/intersect_sweep.py::
// _mt_merge); the library is built with --fmad=false and IEEE division, so
// nothing is contracted and winners match bit for bit.
//
// Packed keys (ops/select_keys.py holds the same functions in torch):
// key = (float bits of t) << 32 | id.  For t >= +0.0 the float bits order
// as unsigned integers, so the integer min over keys is the lexicographic
// (t, id) min the plain versions compute.  Candidates always have
// t > eps >= 0 (the wrappers refuse eps < 0); seeds clamp t_max at +0.0,
// since -0.0 and negative floats would not order as integers.  A seed
// carries id IMAX, so "won" is "id != IMAX"; key 0 marks a ray an any-hit
// query has decided.

#pragma once

#include <cuda_runtime.h>

namespace srt {

constexpr float kBig = 3.4e38f;
constexpr unsigned kIMax = 2147483647u;

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

struct Tri {
  float v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z;
};

// Triangle l of SoA rows that are `stride` floats apart.
__device__ __forceinline__ Tri load_tri(const float* rows, int stride, int l) {
  return Tri{rows[l],              rows[stride + l],     rows[2 * stride + l],
             rows[3 * stride + l], rows[4 * stride + l], rows[5 * stride + l],
             rows[6 * stride + l], rows[7 * stride + l], rows[8 * stride + l]};
}

__device__ __forceinline__ Ray load_ray(const float* o, const float* d,
                                        size_t r) {
  return Ray{o[3 * r], o[3 * r + 1], o[3 * r + 2],
             d[3 * r], d[3 * r + 1], d[3 * r + 2]};
}

// Closest-hit tests with the IEEE division (mt_pairs): det against eps
// (culling keeps det > eps), u in [0, 1], v >= 0, u + v <= 1, t > eps.
// Sets t and returns true when every test passes.
__device__ __forceinline__ bool mt_accept(const Ray& r, const Tri& q,
                                          float eps, int cull, float& t) {
  const float px = r.dy * q.e2z - r.dz * q.e2y;
  const float py = r.dz * q.e2x - r.dx * q.e2z;
  const float pz = r.dx * q.e2y - r.dy * q.e2x;
  const float det = q.e1x * px + q.e1y * py + q.e1z * pz;
  if (!(cull ? det > eps : fabsf(det) > eps)) return false;
  const float inv_det = 1.0f / det;

  const float tvx = r.ox - q.v0x, tvy = r.oy - q.v0y, tvz = r.oz - q.v0z;
  const float u = (tvx * px + tvy * py + tvz * pz) * inv_det;
  if (!(u >= 0.f && u <= 1.f)) return false;

  const float qx = tvy * q.e1z - tvz * q.e1y;
  const float qy = tvz * q.e1x - tvx * q.e1z;
  const float qz = tvx * q.e1y - tvy * q.e1x;
  const float v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
  if (!(v >= 0.f && u + v <= 1.f)) return false;

  t = (q.e2x * qx + q.e2y * qy + q.e2z * qz) * inv_det;
  return t > eps;
}

// The sweep's division-free any-hit test (_mt_merge, any_hit): the same
// accepts on the numerators scaled by sign(det), inside the inclusive
// window [eps, window].
__device__ __forceinline__ bool mt_accept_window(const Ray& r, const Tri& q,
                                                 float eps, int cull,
                                                 float window) {
  const float px = r.dy * q.e2z - r.dz * q.e2y;
  const float py = r.dz * q.e2x - r.dx * q.e2z;
  const float pz = r.dx * q.e2y - r.dy * q.e2x;
  const float det = q.e1x * px + q.e1y * py + q.e1z * pz;
  if (!(cull ? det > eps : fabsf(det) > eps)) return false;

  const float tvx = r.ox - q.v0x, tvy = r.oy - q.v0y, tvz = r.oz - q.v0z;
  const float u_num = tvx * px + tvy * py + tvz * pz;
  const float qx = tvy * q.e1z - tvz * q.e1y;
  const float qy = tvz * q.e1x - tvx * q.e1z;
  const float qz = tvx * q.e1y - tvy * q.e1x;
  const float v_num = r.dx * qx + r.dy * qy + r.dz * qz;
  const float t_num = q.e2x * qx + q.e2y * qy + q.e2z * qz;

  const float sgn = det >= 0.f ? 1.f : -1.f;
  const float adet = det * sgn;
  const float us = u_num * sgn, vs = v_num * sgn, ts = t_num * sgn;
  return us >= 0.f && us <= adet && vs >= 0.f && us + vs <= adet &&
         ts > eps * adet && ts <= window * adet;
}

__device__ __forceinline__ unsigned long long pack_key(float t, unsigned id) {
  return (static_cast<unsigned long long>(__float_as_uint(t)) << 32) | id;
}

__device__ __forceinline__ float key_t(unsigned long long key) {
  return __uint_as_float(static_cast<unsigned>(key >> 32));
}

__device__ __forceinline__ unsigned key_id(unsigned long long key) {
  return static_cast<unsigned>(key);
}

// A read that sees other blocks' atomicMin results (bypasses L1).
__device__ __forceinline__ unsigned long long load_key(
    const unsigned long long* p) {
  return __ldcg(p);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace srt
