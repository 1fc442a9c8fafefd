// SIFT detection of one octave: the DoG extrema, then each kept extremum's
// subpixel refinement and rejection tests, as two kernels.
//
// Replaces no TPU kernel: the JAX package's detector
// (ssrlcv_tpu/features/detector.py) is XLA operations.  Plain version:
// ssrlcv_tpu_torch/features/detector.py::find_keypoints_octave_plain, then
// check_descriptor_border, which in eager PyTorch is about 800 launches an
// octave and builds ~60 float32 Newton fields over every interior voxel of
// the DoG, of which only the extrema (about 1 %) are ever read.
//
// Between the two kernels the wrapper (features/detect_kernel.py) compacts
// the extrema flags with torch.nonzero, the octave's one host wait, which
// keeps the plain order (DoG slice, then row-major pixel) and the first
// ``capacity`` extrema.
//
//  1. detect_extrema_kernel, one thread per interior pixel (y, x), walking
//     the D DoG slices: a slice's 3x3 maximum and minimum, then for each
//     slice b in 1..D-2 the flag
//       no NaN among the 27 values, and (v >= every value or v <= every
//       value), and |v| >= t (the 0.8 x noise prefilter),
//     v = dog_raw[b, y, x].  The plain version compares v with the 3x3x3
//     torch.maximum / torch.minimum (NaN-propagating, exact), so ties count
//     as extrema and a NaN anywhere in the window clears the flag, here too.
//  2. detect_keypoints_kernel, one thread per capacity slot: gathers the
//     slot's extremum, runs refine_keypoints' Newton attempts at its own
//     position (no dense field is built), then remove_noise, remove_edges
//     and check_descriptor_border, and writes every SSKeyPoints field of the
//     slot, the empty slots' too.
//
// Arithmetic, bit-identical to the plain chain.  Every elementwise tensor
// operation of the plain version is one separately rounded operation here,
// in the same order (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn, which
// nvcc never contracts into fused multiply-adds); torch.round is rintf; a
// tensor divided by a Python number is a multiply by its float32
// reciprocal (/ 4.0 is * 0.25); 1.0 / det is reciprocal, a correctly
// rounded division; a Python number meets a tensor as its float32 value;
// torch.pow(float, tensor) is powf of the float32 base.
//
// What bounds it on the H100: bytes.  The extrema kernel reads the D
// slices of dog_raw once from device memory (neighbouring threads share
// their 3x3 windows through L1) and writes a byte a voxel of the D-2
// interior slices; the keypoint kernel reads a few 3x3x3 neighbourhoods a
// slot, under 0.1 % of the DoG.  At octave -1 of a 2048^2 frame (4096^2,
// D = 5) that is 336 MB + 50 MB, 0.115 ms at 3.35 TB/s.
#include "common.cuh"

namespace {

constexpr int kMaxSlices = 64;       // detect_kernel.MAX_SLICES
constexpr int kExtX = 32, kExtY = 8; // extrema kernel: a warp along a row
constexpr int kSlotThreads = 128;

struct Sigmas {
  float v[kMaxSlices];  // the DoG slices' sigmas as float32
};

struct Params {
  float noise;        // remove_noise: |intensity| >= noise
  float edge;         // remove_edges: edgeness > edge is rejected
  float sigma_min;    // refined sigma = sigma_min * blur_mult^(blur + o2)
  float blur_mult;
  float lambda_desc;  // check_descriptor_border: w = sigma * lambda_desc * inv_pw
  float inv_pw;
  int subpixel, attempts, border;
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

__global__ void __launch_bounds__(kExtX * kExtY)
detect_extrema_kernel(const float* __restrict__ dog, uint8_t* __restrict__ flags, int d, int h,
                      int w, float thr) {
  const int x = blockIdx.x * kExtX + threadIdx.x + 1;
  const int y = blockIdx.y * kExtY + threadIdx.y + 1;
  if (x > w - 2 || y > h - 2) return;
  const size_t plane = static_cast<size_t>(h) * w;
  const size_t iplane = static_cast<size_t>(h - 2) * (w - 2);
  const size_t pix = static_cast<size_t>(y - 1) * (w - 2) + (x - 1);
  const float* corner = dog + static_cast<size_t>(y - 1) * w + (x - 1);
  // 3x3 statistics of the two slices before slice s; c1: slice s-1's centre
  float mx0 = 0.0f, mn0 = 0.0f, mx1 = 0.0f, mn1 = 0.0f, c1 = 0.0f;
  bool nan0 = false, nan1 = false;
  for (int s = 0; s < d; ++s) {
    const float* q = corner + s * plane;
    float mx = __ldg(q), mn = mx;
    bool nan = mx != mx;
#pragma unroll
    for (int k = 1; k < 9; ++k) {
      const float v = __ldg(q + (k / 3) * w + (k % 3));
      nan |= v != v;
      mx = v > mx ? v : mx;
      mn = v < mn ? v : mn;
    }
    const float c = __ldg(q + w + 1);
    if (s >= 2) {
      // slice s-1 is the centre; a NaN clears the flag, so the ordered
      // comparisons below never meet one
      const float wmax = fmaxf(fmaxf(mx0, mx1), mx);
      const float wmin = fminf(fminf(mn0, mn1), mn);
      const bool ext = !(nan0 || nan1 || nan) && (c1 >= wmax || c1 <= wmin) && fabsf(c1) >= thr;
      flags[(s - 2) * iplane + pix] = ext ? 1 : 0;
    }
    mx0 = mx1; mn0 = mn1; nan0 = nan1;
    mx1 = mx; mn1 = mn; nan1 = nan; c1 = c;
  }
}

struct Newton {
  float o0, o1, o2, ghg;
};

// detector._dense_newton_fields at one interior voxel (slice b, row y,
// column x), operation for operation: the reference's diagonal Hessian
// H00 = -(g0 - 2m), the off-diagonals -((a - b - c + d) / 4), the offset
// adj(H) g / det and gHg = g . (H g)
__device__ Newton newton_at(const float* __restrict__ dn, int w, size_t plane, int b, int y,
                            int x) {
  const float* mid = dn + b * plane + static_cast<size_t>(y) * w + x;
  const float* up = mid + plane;
  const float* lo = mid - plane;
  auto at = [w](const float* p, int dy, int dx) { return __ldg(p + dy * w + dx); };
  const float m = at(mid, 0, 0);
  const float g0 = sub(at(mid, 0, 1), at(mid, 0, -1));
  const float g1 = sub(at(mid, 1, 0), at(mid, -1, 0));
  const float g2 = sub(at(up, 0, 0), at(lo, 0, 0));
  const float m2 = mul(2.0f, m);
  const float h00 = -sub(g0, m2);
  const float h11 = -sub(g1, m2);
  const float h22 = -sub(g2, m2);
  const float h01 =
      -mul(add(sub(sub(at(mid, 1, 1), at(mid, -1, 1)), at(mid, 1, -1)), at(mid, -1, -1)), 0.25f);
  const float h02 =
      -mul(add(sub(sub(at(up, 0, 1), at(lo, 0, 1)), at(up, 0, -1)), at(lo, 0, -1)), 0.25f);
  const float h12 =
      -mul(add(sub(sub(at(up, 1, 0), at(lo, 1, 0)), at(up, -1, 0)), at(lo, -1, 0)), 0.25f);
  const float det = add(sub(mul(h00, sub(mul(h11, h22), mul(h12, h12))),
                            mul(h01, sub(mul(h01, h22), mul(h12, h02)))),
                        mul(h02, sub(mul(h01, h12), mul(h11, h02))));
  const float inv_det = fabsf(det) > 0.0f ? __fdiv_rn(1.0f, det) : __int_as_float(0x7f800000);
  const float a00 = sub(mul(h11, h22), mul(h12, h12));
  const float a01 = sub(mul(h02, h12), mul(h01, h22));
  const float a02 = sub(mul(h01, h12), mul(h02, h11));
  const float a11 = sub(mul(h00, h22), mul(h02, h02));
  const float a12 = sub(mul(h01, h02), mul(h00, h12));
  const float a22 = sub(mul(h00, h11), mul(h01, h01));
  Newton t;
  t.o0 = mul(add(add(mul(a00, g0), mul(a01, g1)), mul(a02, g2)), inv_det);
  t.o1 = mul(add(add(mul(a01, g0), mul(a11, g1)), mul(a12, g2)), inv_det);
  t.o2 = mul(add(add(mul(a02, g0), mul(a12, g1)), mul(a22, g2)), inv_det);
  const float p0 = add(add(mul(h00, g0), mul(h01, g1)), mul(h02, g2));
  const float p1 = add(add(mul(h01, g0), mul(h11, g1)), mul(h12, g2));
  const float p2 = add(add(mul(h02, g0), mul(h12, g1)), mul(h22, g2));
  t.ghg = add(add(mul(g0, p0), mul(g1, p1)), mul(g2, p2));
  return t;
}

// detector.remove_edges' edgeness tr^2 / det of the 2x2 Hessian at one
// voxel (the off-diagonal not divided by 4, as the reference)
__device__ float edgeness_at(const float* __restrict__ dn, int w, size_t plane, int b, int y,
                             int x) {
  const float* c = dn + b * plane + static_cast<size_t>(y) * w + x;
  auto at = [c, w](int dy, int dx) { return __ldg(c + dy * w + dx); };
  const float m2 = mul(-2.0f, at(0, 0));
  const float h00 = add(add(m2, at(0, 1)), at(0, -1));
  const float h11 = add(add(m2, at(1, 0)), at(-1, 0));
  const float h01 = add(sub(sub(at(1, 1), at(-1, 1)), at(1, -1)), at(-1, -1));
  const float tr = add(h00, h11);
  const float det = sub(mul(h00, h11), mul(h01, h01));
  return __fdiv_rn(mul(tr, tr), det);
}

// refine_keypoints' move: -1, 0 or +1 where |o| > 0.5 (NaN: 0)
__device__ __forceinline__ int step(float o) {
  return fabsf(o) > 0.5f ? (o > 0.0f ? 1 : -1) : 0;
}

__global__ void __launch_bounds__(kSlotThreads)
detect_keypoints_kernel(const float* __restrict__ raw, const float* __restrict__ dn,
                        const int64_t* __restrict__ found, int n, int cap, int d, int h, int w,
                        const __grid_constant__ Sigmas sig, const __grid_constant__ Params p,
                        int64_t* __restrict__ out_blur, float* __restrict__ out_loc,
                        float* __restrict__ out_int, float* __restrict__ out_sigma,
                        float* __restrict__ out_theta, uint8_t* __restrict__ out_mask) {
  const int i = blockIdx.x * kSlotThreads + threadIdx.x;
  if (i >= cap) return;
  const size_t plane = static_cast<size_t>(h) * w;
  // detect_extrema: an empty slot reads index 0, i.e. (1, 1, 1), with
  // intensity 0 and the mask clear
  const bool valid = i < n;
  const int64_t idx = valid ? found[i] : 0;
  const int64_t per = static_cast<int64_t>(h - 2) * (w - 2);
  int b = static_cast<int>(idx / per) + 1;
  const int64_t rem = idx % per;
  int y = static_cast<int>(rem / (w - 2)) + 1;
  int x = static_cast<int>(rem % (w - 2)) + 1;
  float inten = valid ? raw[b * plane + static_cast<size_t>(y) * w + x] : 0.0f;
  float sigma = sig.v[b];
  float lx = static_cast<float>(x), ly = static_cast<float>(y);
  bool discard = !valid;

  if (p.subpixel) {
    // refine_keypoints: each attempt either accepts the offset (done) or
    // moves one voxel; a move off the interior discards the slot
    bool done = !valid;
    for (int a = 0; a < p.attempts && !done; ++a) {
      const Newton t = newton_at(dn, w, plane, b, y, x);
      const bool accept = isfinite(t.o0) && isfinite(t.o1) && isfinite(t.o2) &&
                          fabsf(t.o0) <= 0.5f && fabsf(t.o1) <= 0.5f && fabsf(t.o2) <= 0.5f;
      if (accept) {
        const float nlx = add(static_cast<float>(x), t.o0);
        const float nly = add(static_cast<float>(y), t.o1);
        const int nx = static_cast<int>(rintf(nlx));
        const int ny = static_cast<int>(rintf(nly));
        const bool on_border = nx <= 0 || ny <= 0 || nx >= w - 1 || ny >= h - 1;
        if (!on_border)
          inten = sub(dn[b * plane + static_cast<size_t>(ny) * w + nx], mul(0.5f, t.ghg));
        sigma = mul(p.sigma_min, powf(p.blur_mult, add(static_cast<float>(b), t.o2)));
        x = nx;
        y = ny;
        lx = nlx;
        ly = nly;
        discard = on_border;
        done = true;
      } else {
        x += step(t.o0);
        y += step(t.o1);
        b += step(t.o2);
        lx = static_cast<float>(x);
        ly = static_cast<float>(y);
        done = discard = b >= d - 1 || b <= 0 || x <= 0 || y <= 0 || x >= w - 1 || y >= h - 1;
      }
    }
    discard = discard || !done;
  }
  bool keep = !discard;
  if (keep && p.subpixel) keep = fabsf(inten) >= p.noise;  // remove_noise
  if (keep) {                                              // remove_edges
    const int ex = clampi(static_cast<int>(rintf(lx)), 1, w - 2);
    const int ey = clampi(static_cast<int>(rintf(ly)), 1, h - 2);
    keep = !(edgeness_at(dn, w, plane, b, ey, ex) > p.edge);
  }
  if (keep && p.border) {  // check_descriptor_border
    const float ww = mul(mul(sigma, p.lambda_desc), p.inv_pw);
    keep = sub(lx, ww) >= 0.0f && sub(ly, ww) >= 0.0f &&
           add(lx, ww) < static_cast<float>(w - 1) && add(ly, ww) < static_cast<float>(h - 1);
  }
  out_blur[i] = b;
  out_loc[2 * i] = lx;
  out_loc[2 * i + 1] = ly;
  out_int[i] = inten;
  out_sigma[i] = sigma;
  out_theta[i] = -1.0f;
  out_mask[i] = keep ? 1 : 0;
}

}  // namespace

// dog_raw: (d, h, w) contiguous float32; flags: (d-2, h-2, w-2) bytes,
// 1 where the interior voxel is an extremum of at least |thr|.  One launch.
extern "C" int ssrlcv_detect_extrema(const void* dog_raw, void* flags, int d, int h, int w,
                                     float thr, void* stream) {
  if (d < 3 || h < 3 || w < 3) return 0;
  const dim3 grid((w - 2 + kExtX - 1) / kExtX, (h - 2 + kExtY - 1) / kExtY);
  detect_extrema_kernel<<<grid, dim3(kExtX, kExtY), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dog_raw), static_cast<uint8_t*>(flags), d, h, w, thr);
  return static_cast<int>(cudaGetLastError());
}

// dog_raw, dog_norm: (d, h, w) contiguous float32; found: the first n
// extrema's flat interior indices (int64, torch.nonzero's order); sigmas:
// d float32 on the host; the outputs hold ``cap`` slots: blur int64, loc
// (cap, 2), intensity, sigma, theta float32, mask bytes.  One launch.
extern "C" int ssrlcv_detect_keypoints(const void* dog_raw, const void* dog_norm,
                                       const void* found, int n, int cap, int d, int h, int w,
                                       const void* sigmas, float noise, float edge,
                                       float sigma_min, float blur_mult, float lambda_desc,
                                       float inv_pw, int subpixel, int attempts, int border,
                                       void* blur, void* loc, void* intensity, void* sigma,
                                       void* theta, void* mask, void* stream) {
  if (d > kMaxSlices || n > cap) return static_cast<int>(cudaErrorInvalidValue);
  if (cap == 0) return 0;
  Sigmas s;
  for (int k = 0; k < kMaxSlices; ++k) s.v[k] = k < d ? static_cast<const float*>(sigmas)[k] : 0.0f;
  Params p{noise, edge, sigma_min, blur_mult, lambda_desc, inv_pw, subpixel, attempts, border};
  detect_keypoints_kernel<<<(cap + kSlotThreads - 1) / kSlotThreads, kSlotThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dog_raw), static_cast<const float*>(dog_norm),
      static_cast<const int64_t*>(found), n, cap, d, h, w, s, p, static_cast<int64_t*>(blur),
      static_cast<float*>(loc), static_cast<float*>(intensity), static_cast<float*>(sigma),
      static_cast<float*>(theta), static_cast<uint8_t*>(mask));
  return static_cast<int>(cudaGetLastError());
}
