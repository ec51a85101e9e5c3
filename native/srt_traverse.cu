// Closest-hit traversal of the WBVH8 implicit heap on an NVIDIA GPU,
// one thread per ray, called from JAX through the XLA FFI.
//
// This is the per-ray form of the reference's innermost call,
// rtcIntersect1 (trace_ray.hpp:22): each thread walks the tree with its
// own trail of pending-sibling masks and runs closest-hit
// Moller-Trumbore at the leaves. It reads the same `bvh_nodes` table
// that ops/wbvh.py:traverse8 walks (the Morton implicit heap: children
// of node i are 8i+1..8i+8, internal rows pack the 8 child boxes
// component-major, leaf rows pack K triangles component-major) and
// follows the same visit order, tests and arithmetic, so traverse8 is
// its plain twin. The library is built with -fmad=false so that no
// multiply-add is contracted, and it takes its reciprocals as XLA does
// (rcp below), so both return bit-identical t and the same closest
// hit, ties included.
//
// Build: make -C native cuda  (-> native/build/libsrt_traverse.so)

#include <cuda_runtime.h>

#include <cstdint>
#include <string>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr float kBig = 3.0e38f;     // ops/intersect.py BIG
constexpr float kTnear = 1e-4f;     // ops/intersect.py TNEAR
constexpr float kDetEps = 1e-12f;   // ops/intersect.py _DET_EPS
// The trail keeps one 8-bit pending mask per tree level in a uint64.
constexpr int kMaxDepth = 8;
constexpr int kBlock = 128;

// XLA lowers an f32 `1 / x` on the GPU to rcp.approx.f32 (the PTX it
// emits for traverse8 shows it); the same instruction here keeps the
// two walks' t bit-identical, ties included.
__device__ __forceinline__ float rcp(float x) {
  float r;
  asm("rcp.approx.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ float inv_dir(float d) {
  return fabsf(d) > 1e-20f ? rcp(d) : 1e20f;
}

// N floats of one table row into registers, as 16-byte loads where
// the row stride keeps them aligned.
template <int N, bool kVec>
__device__ __forceinline__ void load_row(const float* row, float (&out)[N]) {
  if constexpr (kVec && N % 4 == 0) {
    const float4* r4 = reinterpret_cast<const float4*>(row);
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 q = __ldg(r4 + i);
      out[4 * i + 0] = q.x;
      out[4 * i + 1] = q.y;
      out[4 * i + 2] = q.z;
      out[4 * i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = __ldg(row + i);
  }
}

template <int K>
__global__ void traverse8_kernel(const float* __restrict__ nodes,
                                 const float* __restrict__ ox_,
                                 const float* __restrict__ oy_,
                                 const float* __restrict__ oz_,
                                 const float* __restrict__ dx_,
                                 const float* __restrict__ dy_,
                                 const float* __restrict__ dz_,
                                 const bool* __restrict__ active,
                                 float* __restrict__ t_out,
                                 int32_t* __restrict__ tri_out,
                                 float* __restrict__ u_out,
                                 float* __restrict__ v_out, int64_t n_rays,
                                 int32_t ni) {
  constexpr int W = (9 * K > 48) ? 9 * K : 48;  // wbvh.plan row width
  const int64_t r = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (r >= n_rays) return;

  float t = kBig, u = 0.0f, v = 0.0f;
  int32_t tri = -1;
  if (active[r]) {
    const float ox = ox_[r], oy = oy_[r], oz = oz_[r];
    const float dx = dx_[r], dy = dy_[r], dz = dz_[r];
    const float ix = inv_dir(dx), iy = inv_dir(dy), iz = inv_dir(dz);
    const uint32_t oct = (dx < 0.0f ? 4u : 0u) | (dy < 0.0f ? 2u : 0u) |
                         (dz < 0.0f ? 1u : 0u);
    uint32_t cur = 0;
    int level = 0;
    uint64_t trail = 0;  // bits [8l, 8l+8) = pending children at level l

    while (true) {
      const float* row = nodes + (int64_t)cur * W;
      uint32_t pm = 0;
      const bool is_leaf = cur >= (uint32_t)ni;
      if (!is_leaf) {
        float b[48];
        load_row<48, W % 4 == 0>(row, b);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float t1x = (b[0 + j] - ox) * ix;
          const float t1y = (b[8 + j] - oy) * iy;
          const float t1z = (b[16 + j] - oz) * iz;
          const float t2x = (b[24 + j] - ox) * ix;
          const float t2y = (b[32 + j] - oy) * iy;
          const float t2z = (b[40 + j] - oz) * iz;
          const float tmin = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)),
                                   fminf(t1z, t2z));
          const float tmax = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)),
                                   fmaxf(t1z, t2z));
          const bool hit = (tmax >= fmaxf(tmin, kTnear)) && (tmin < t);
          pm |= (hit ? 1u : 0u) << (j ^ oct);
        }
      } else {
        float c[9 * K];
        load_row<9 * K, W % 4 == 0>(row, c);
        float best = kBig, bu = 0.0f, bv = 0.0f;
        int kb = 0;
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const float v0x = c[0 * K + j], v0y = c[1 * K + j];
          const float v0z = c[2 * K + j], e1x = c[3 * K + j];
          const float e1y = c[4 * K + j], e1z = c[5 * K + j];
          const float e2x = c[6 * K + j], e2y = c[7 * K + j];
          const float e2z = c[8 * K + j];
          const float px = dy * e2z - dz * e2y;
          const float py = dz * e2x - dx * e2z;
          const float pz = dx * e2y - dy * e2x;
          const float det = e1x * px + e1y * py + e1z * pz;
          const bool ok_det = fabsf(det) > kDetEps;
          const float inv_det = ok_det ? rcp(det) : 0.0f;
          const float tx = ox - v0x, ty = oy - v0y, tz = oz - v0z;
          const float uu = (tx * px + ty * py + tz * pz) * inv_det;
          const float qx = ty * e1z - tz * e1y;
          const float qy = tz * e1x - tx * e1z;
          const float qz = tx * e1y - ty * e1x;
          const float vv = (dx * qx + dy * qy + dz * qz) * inv_det;
          const float tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
          const bool ok = ok_det && uu >= 0.0f && vv >= 0.0f &&
                          uu + vv <= 1.0f && tt > kTnear;
          // first index of the minimum, like traverse8's argmin
          if (ok && tt < best) {
            best = tt;
            kb = j;
            bu = uu;
            bv = vv;
          }
        }
        if (best < t) {
          t = best;
          tri = (int32_t)(cur - (uint32_t)ni) * K + kb;
          u = bu;
          v = bv;
        }
      }

      if (pm != 0) {  // descend to the nearest-octant pending child
        const uint32_t p = __ffs(pm) - 1;
        trail |= (uint64_t)(pm & (pm - 1)) << (8 * level);
        cur = cur * 8 + 1 + (p ^ oct);
        ++level;
        continue;
      }
      if (trail == 0) break;  // nothing pending anywhere: done
      // pop the deepest level with pending siblings
      const int dstar = (63 - __clzll((long long)trail)) >> 3;
      const uint32_t pmb = (uint32_t)(trail >> (8 * dstar)) & 0xFFu;
      const uint32_t p = __ffs(pmb) - 1;
      trail &= ~((uint64_t)0xFF << (8 * dstar));
      trail |= (uint64_t)(pmb & (pmb - 1)) << (8 * dstar);
      for (int s = level - dstar; s > 0; --s) cur = (cur - 1) >> 3;
      cur = cur * 8 + 1 + (p ^ oct);
      level = dstar + 1;
    }
  }
  t_out[r] = t;
  tri_out[r] = tri;
  u_out[r] = u;
  v_out[r] = v;
}

template <int K>
void launch(cudaStream_t stream, int64_t blocks, const float* nodes,
            const float* const* ray, const bool* active, float* t,
            int32_t* tri, float* u, float* v, int64_t n, int32_t ni) {
  traverse8_kernel<K><<<blocks, kBlock, 0, stream>>>(
      nodes, ray[0], ray[1], ray[2], ray[3], ray[4], ray[5], active, t, tri,
      u, v, n, ni);
}

ffi::Error Traverse8(cudaStream_t stream, ffi::Buffer<ffi::F32> nodes,
                     ffi::Buffer<ffi::F32> ox, ffi::Buffer<ffi::F32> oy,
                     ffi::Buffer<ffi::F32> oz, ffi::Buffer<ffi::F32> dx,
                     ffi::Buffer<ffi::F32> dy, ffi::Buffer<ffi::F32> dz,
                     ffi::Buffer<ffi::PRED> active,
                     ffi::ResultBuffer<ffi::F32> t,
                     ffi::ResultBuffer<ffi::S32> tri,
                     ffi::ResultBuffer<ffi::F32> u,
                     ffi::ResultBuffer<ffi::F32> v, int64_t num_internal,
                     int64_t leaf_size, int64_t depth) {
  if (depth > kMaxDepth) {
    return ffi::Error::InvalidArgument(
        "srt_traverse8: tree depth " + std::to_string(depth) +
        " exceeds the kernel's " + std::to_string(kMaxDepth));
  }
  const auto dims = nodes.dimensions();
  const int64_t width = dims.size() == 2 ? dims[1] : -1;
  const int64_t want = 9 * leaf_size > 48 ? 9 * leaf_size : 48;
  if (width != want) {
    return ffi::Error::InvalidArgument(
        "srt_traverse8: node rows are " + std::to_string(width) +
        " floats wide, leaf_size " + std::to_string(leaf_size) + " needs " +
        std::to_string(want));
  }
  const int64_t n = ox.element_count();
  if (n == 0) return ffi::Error::Success();
  const int64_t blocks = (n + kBlock - 1) / kBlock;
  const float* ray[6] = {ox.typed_data(), oy.typed_data(), oz.typed_data(),
                         dx.typed_data(), dy.typed_data(), dz.typed_data()};
  const int32_t ni = (int32_t)num_internal;
  auto args = [&](auto fn) {
    fn(stream, blocks, nodes.typed_data(), ray, active.typed_data(),
       t->typed_data(), tri->typed_data(), u->typed_data(), v->typed_data(),
       n, ni);
  };
  switch (leaf_size) {
    case 1: args(launch<1>); break;
    case 2: args(launch<2>); break;
    case 3: args(launch<3>); break;
    case 4: args(launch<4>); break;
    case 5: args(launch<5>); break;
    case 6: args(launch<6>); break;
    case 7: args(launch<7>); break;
    case 8: args(launch<8>); break;
    default:
      return ffi::Error::InvalidArgument(
          "srt_traverse8: leaf_size must be 1..8, got " +
          std::to_string(leaf_size));
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return ffi::Error::Internal(std::string("srt_traverse8 launch: ") +
                                cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(SrtTraverse8, Traverse8,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()   // nodes
                                  .Arg<ffi::Buffer<ffi::F32>>()   // ox
                                  .Arg<ffi::Buffer<ffi::F32>>()   // oy
                                  .Arg<ffi::Buffer<ffi::F32>>()   // oz
                                  .Arg<ffi::Buffer<ffi::F32>>()   // dx
                                  .Arg<ffi::Buffer<ffi::F32>>()   // dy
                                  .Arg<ffi::Buffer<ffi::F32>>()   // dz
                                  .Arg<ffi::Buffer<ffi::PRED>>()  // active
                                  .Ret<ffi::Buffer<ffi::F32>>()   // t
                                  .Ret<ffi::Buffer<ffi::S32>>()   // tri
                                  .Ret<ffi::Buffer<ffi::F32>>()   // u
                                  .Ret<ffi::Buffer<ffi::F32>>()   // v
                                  .Attr<int64_t>("num_internal")
                                  .Attr<int64_t>("leaf_size")
                                  .Attr<int64_t>("depth"));
