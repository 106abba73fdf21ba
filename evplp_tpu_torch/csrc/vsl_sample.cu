// VSL 3-strategy MIS sample loop over a group of records, for Hopper
// (sm_90a).
//
// Replaces the JAX package's Pallas kernel
// evplp_tpu/integrators/vsl_kernel.py:_kernel (entry vsl_sample_group),
// which computes the same function for 128-lane pixel blocks on a TPU.
// This kernel runs one thread per pixel.  The thread walks the group's G
// records in order, skips a record whose gate bit is clear, and for a gated
// record draws its OWN count of samples, s < min(num, 101) (the TPU's SIMD
// loop runs to the block's largest count and masks the rest; the draws are
// a pure function of (pixel id ^ seed0, record id, s ^ seed1, tag), so both
// give the same sum).  Each sample evaluates the uniform-cone, eye-BRDF and
// light-BRDF strategies with the reference's pdf quirks; the record adds
// acc / max(num, 1) to the thread's total, which is written once as (N, 3).
// No atomics: the result is deterministic.  The group's record table
// (G x 24 floats) is staged in shared memory once per block.
//
// The math is the plain PyTorch version's
// (evplp_tpu_torch/integrators/vsl.py:_sample_step) op for op: the same
// formulas in the same order, dots summed ((x + y) + z), normalize as
// v * (1 / sqrt(max(dot, 1e-20))), the accurate sinf / cosf / powf / sqrtf,
// IEEE division, and -fmad=false so that no multiply-add is fused.  The lobe
// choice (u < p) and the cone tests (dot > cos_half) then see the same
// values in both.  pcg4d runs in native uint32 and converts as the port's
// core/rng.uniform4 does: (v >> 8) -> int -> float * 2^-24.
//
// What bounds it on an H100: operations.  Its bytes are about 100 B per
// pixel per group (16 pixel planes, id, gate, and G cos_half and count
// planes in; 3 floats out), against about 8 sin/cos, 4 pow and a dozen
// sqrt and divisions per sample, much of it on the special function units.
// Per-pixel counts diverge inside a warp; warp-level record culling,
// register pressure and sorting pixels by count are the ways to cut it.
//
// C interface: the wrapper allocates the output, launches on PyTorch's
// current stream, and checks the returned cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;
constexpr int kMaxGroup = 32;
constexpr int kRecF = 24;
constexpr int kMaxSamples = 101;
// Python doubles rounded to float, as PyTorch rounds its scalar operands
constexpr float kInvPi = static_cast<float>(0.3183098861837907);
constexpr float kTwoPi = static_cast<float>(6.283185307179586);
constexpr float kHalfInvPi = static_cast<float>(0.5 * 0.3183098861837907);
constexpr float kEpsCos = static_cast<float>(1e-6);
constexpr float kEpsRefl = static_cast<float>(1e-6);
constexpr float kEpsNorm = static_cast<float>(1e-20);
constexpr float kEpsSel = static_cast<float>(1e-8);
constexpr float kEpsCone = static_cast<float>(1e-9);
constexpr float kEpsLight = static_cast<float>(1e-8);
constexpr float kEpsSa = static_cast<float>(1e-12);
constexpr float kSelMax = static_cast<float>(0.999999);
constexpr float kInv24 = static_cast<float>(1.0 / 16777216.0);

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) {
  V3 r;
  r.x = x;
  r.y = y;
  r.z = z;
  return r;
}
__device__ __forceinline__ V3 neg(V3 a) { return v3(-a.x, -a.y, -a.z); }
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return (a.x * b.x + a.y * b.y) + a.z * b.z;
}
__device__ __forceinline__ V3 scale(V3 a, float s) {
  return v3(a.x * s, a.y * s, a.z * s);
}
__device__ __forceinline__ V3 normalize(V3 a) {
  return scale(a, 1.0f / sqrtf(fmaxf(dot(a, a), kEpsNorm)));
}
// GLSL reflect: i - (2 * dot(i, n)) * n
__device__ __forceinline__ V3 reflect(V3 i, V3 n) {
  const float d2 = 2.0f * dot(i, n);
  return v3(i.x - d2 * n.x, i.y - d2 * n.y, i.z - d2 * n.z);
}
// Duff et al. branchless basis (mathutil.orthonormal_basis), then
// (l.x * x + l.y * y) + l.z * z
__device__ __forceinline__ V3 from_local(V3 l, V3 z) {
  const float sign = z.z >= 0.0f ? 1.0f : -1.0f;
  const float a = -1.0f / (sign + z.z);
  const float b = (z.x * z.y) * a;
  const V3 x = v3(1.0f + ((sign * z.x) * z.x) * a, sign * b, (-sign) * z.x);
  const V3 y = v3(b, sign + (z.y * z.y) * a, -z.y);
  return v3((l.x * x.x + l.y * y.x) + l.z * z.x,
            (l.x * x.y + l.y * y.y) + l.z * z.y,
            (l.x * x.z + l.y * y.z) + l.z * z.z);
}
// brdf.phong_eval_f's kernel on c = max(dot(out, r), 0)
__device__ __forceinline__ float phong_f(float c, float ns) {
  const float val = ((ns + 2.0f) * powf(c, ns)) * kHalfInvPi;
  return c > kEpsCos ? val : 0.0f;
}
// brdf.phong_pdf_w on c = max(dot(w, normalize(r)), 0)
__device__ __forceinline__ float phong_pdf(float c, float ns, float ks0) {
  const float val = ((ns + 1.0f) * kHalfInvPi) * powf(c, ns);
  return (c > kEpsCos && ks0 > kEpsRefl) ? val : 0.0f;
}

__device__ __forceinline__ uint32_t lcg(uint32_t v) {
  return v * 1664525u + 1013904223u;
}

// pcg4d (Jarzynski & Olano) -> four U[0,1) floats with 24-bit mantissas
__device__ __forceinline__ void uniform4(uint32_t x, uint32_t y, uint32_t z,
                                         uint32_t w, float u[4]) {
  x = lcg(x);
  y = lcg(y);
  z = lcg(z);
  w = lcg(w);
  x += y * w;
  y += z * x;
  z += x * y;
  w += y * z;
  x ^= x >> 16;
  y ^= y >> 16;
  z ^= z >> 16;
  w ^= w >> 16;
  x += y * w;
  y += z * x;
  z += x * y;
  w += y * z;
  u[0] = static_cast<float>(static_cast<int>(x >> 8)) * kInv24;
  u[1] = static_cast<float>(static_cast<int>(y >> 8)) * kInv24;
  u[2] = static_cast<float>(static_cast<int>(z >> 8)) * kInv24;
  u[3] = static_cast<float>(static_cast<int>(w >> 8)) * kInv24;
}

// One side of a shading pair: position-independent BRDF state.
struct Surf {
  V3 n, kd, ks;
  float ns;
  V3 r;   // raw reflect(-inc, n): the phong sampling axis
  V3 rn;  // normalize(r): the phong pdf axis
  float p_l;  // lambert selection probability
};

// brdf.sample_combined: lobe by u_sel < p_l, lambert around n, phong
// around the raw reflect axis; weight = (kd | (ns+2)/(ns+1) cos_n ks) *
// 1/p.  Returns the direction; w receives the lobe weight.
__device__ __forceinline__ V3 sample_combined(const Surf& s, float u_sel,
                                              float ua, float ub, V3* w) {
  const bool chose_l = u_sel < s.p_l;
  // lambert: square_to_cosine_hemisphere
  const float rl = sqrtf(fmaxf(1.0f - ua, 0.0f));
  const float phil = kTwoPi * ub;
  const V3 dir_l = from_local(
      v3(cosf(phil) * rl, sinf(phil) * rl, sqrtf(fmaxf(ua, 0.0f))), s.n);
  // phong: square_to_power_cosine
  const float cos_t = powf(ua, 1.0f / (s.ns + 1.0f));
  const float sin_t = sqrtf(fmaxf(1.0f - cos_t * cos_t, 0.0f));
  const V3 dir_p = from_local(
      v3(sin_t * cosf(phil), sin_t * sinf(phil), cos_t), s.r);
  const float cos_n = fmaxf(dot(dir_p, s.n), 0.0f);
  const float wp = ((s.ns + 2.0f) / (s.ns + 1.0f)) * cos_n;
  const float inv_prob = chose_l ? 1.0f / fmaxf(s.p_l, kEpsSel)
                                 : 1.0f / fmaxf(1.0f - s.p_l, kEpsSel);
  if (chose_l) {
    *w = v3(s.kd.x * inv_prob, s.kd.y * inv_prob, s.kd.z * inv_prob);
    return dir_l;
  }
  *w = v3((wp * s.ks.x) * inv_prob, (wp * s.ks.y) * inv_prob,
          (wp * s.ks.z) * inv_prob);
  return dir_p;
}

// kd / pi + ks * phong_f(max(dot(out, r), 0))
__device__ __forceinline__ V3 combined_f(const Surf& s, float c) {
  const float pf = phong_f(c, s.ns);
  return v3(s.kd.x * kInvPi + s.ks.x * pf, s.kd.y * kInvPi + s.ks.y * pf,
            s.kd.z * kInvPi + s.ks.z * pf);
}

// lambert_pdf_w_nopi(n, w) * p + phong_pdf_w(n, w, inc) * q, for a unit w
__device__ __forceinline__ float pdf_mix(const Surf& s, V3 w, float p,
                                         float q) {
  return fmaxf(dot(s.n, w), 0.0f) * p +
         phong_pdf(fmaxf(dot(w, s.rn), 0.0f), s.ns, s.ks.x) * q;
}

__device__ __forceinline__ float p_select(V3 kd, V3 ks) {
  const float ml = fmaxf(fmaxf(kd.x, kd.y), kd.z);
  const float mp = fmaxf(fmaxf(ks.x, ks.y), ks.z);
  return ml / fmaxf(ml + mp, kEpsNorm);
}

__global__ void __launch_bounds__(kBlock)
vsl_sample_kernel(const float* __restrict__ pix, const int* __restrict__ pid,
                  const int* __restrict__ gates,
                  const float* __restrict__ cos_half_g,
                  const int* __restrict__ counts,
                  const float* __restrict__ table, int group, int n,
                  uint32_t seed0, uint32_t seed1, int rec_base,
                  float* __restrict__ out) {
  __shared__ float rec_s[kMaxGroup * kRecF];
  for (int k = threadIdx.x; k < group * kRecF; k += blockDim.x) {
    rec_s[k] = table[k];
  }
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  const V3 p = v3(pix[0 * n + i], pix[1 * n + i], pix[2 * n + i]);
  Surf e;  // the eye-side shading point
  e.n = v3(pix[3 * n + i], pix[4 * n + i], pix[5 * n + i]);
  e.kd = v3(pix[6 * n + i], pix[7 * n + i], pix[8 * n + i]);
  e.ks = v3(pix[9 * n + i], pix[10 * n + i], pix[11 * n + i]);
  e.ns = pix[12 * n + i];
  const V3 wi10 = v3(pix[13 * n + i], pix[14 * n + i], pix[15 * n + i]);
  e.r = reflect(neg(wi10), e.n);
  e.rn = normalize(e.r);
  e.p_l = p_select(e.kd, e.ks);
  const bool black1 = fmaxf(fmaxf(e.kd.x, e.kd.y), e.kd.z) +
                          fmaxf(fmaxf(e.ks.x, e.ks.y), e.ks.z) <=
                      kEpsRefl;
  const int gate_bits = gates[i];
  const uint32_t c0 = static_cast<uint32_t>(pid[i]) ^ seed0;

  V3 total = v3(0.0f, 0.0f, 0.0f);
  for (int g = 0; g < group; ++g) {
    if (((gate_bits >> g) & 1) == 0) continue;
    const float* rec = rec_s + g * kRecF;
    const V3 rpos = v3(rec[0], rec[1], rec[2]);
    Surf l;  // the light-side record
    l.n = v3(rec[3], rec[4], rec[5]);
    const V3 flux = v3(rec[9], rec[10], rec[11]);
    l.kd = v3(rec[12], rec[13], rec[14]);
    l.ks = v3(rec[15], rec[16], rec[17]);
    l.ns = rec[18];
    const bool black2 = rec[19] > 0.5f;
    l.r = v3(rec[20], rec[21], rec[22]);
    l.rn = normalize(l.r);
    l.p_l = rec[23];

    // vsl._record_ctx
    const V3 v12 = v3(rpos.x - p.x, rpos.y - p.y, rpos.z - p.z);
    const float dist = sqrtf(fmaxf(dot(v12, v12), kEpsNorm));
    const V3 nv12 = v3(v12.x / dist, v12.y / dist, v12.z / dist);
    const float cos_half = cos_half_g[g * n + i];
    const float solid_angle = kTwoPi * (1.0f - cos_half);
    const float inv_sa = 1.0f / fmaxf(solid_angle, kEpsSa);
    const int num = counts[g * n + i];
    const int steps = num < kMaxSamples ? num : kMaxSamples;
    const uint32_t c1 = static_cast<uint32_t>(rec_base + g);

    V3 acc = v3(0.0f, 0.0f, 0.0f);
    for (int s = 0; s < steps; ++s) {
      const uint32_t c2 = static_cast<uint32_t>(s) ^ seed1;
      float ua[4], ub[4];
      uniform4(c0, c1, c2, 0u, ua);
      uniform4(c0, c1, c2, 1u, ub);

      // ---- strategy 1: uniform cone ----
      const float phi = kTwoPi * ua[0];
      const float z = 1.0f - ua[1] * (1.0f - cos_half);
      const float sl = sqrtf(fmaxf(1.0f - z * z, 0.0f));
      const V3 w12c =
          normalize(from_local(v3(cosf(phi) * sl, sinf(phi) * sl, z), nv12));
      const float cc =
          fmaxf(dot(e.n, w12c), 0.0f) * fmaxf(-dot(l.n, w12c), 0.0f);
      const V3 f2 = combined_f(l, fmaxf(dot(neg(w12c), l.r), 0.0f));
      const V3 f1 =
          combined_f(e, fmaxf(dot(wi10, reflect(neg(w12c), e.n)), 0.0f));
      const V3 wcn = normalize(w12c);
      const float pdf_b1 = pdf_mix(e, wcn, e.p_l, 1.0f - e.p_l);
      const float pdf_b2 = pdf_mix(l, neg(wcn), e.p_l, 1.0f);
      const float w_cone =
          inv_sa / fmaxf((pdf_b1 + pdf_b2) + inv_sa, kEpsNorm);
      V3 c_cone = v3(0.0f, 0.0f, 0.0f);
      if (cc > kEpsCone && !black1) {
        const float ca = cc * solid_angle;
        c_cone = v3(w_cone * (((flux.x * ca) * f1.x) * f2.x),
                    w_cone * (((flux.y * ca) * f1.y) * f2.y),
                    w_cone * (((flux.z * ca) * f1.z) * f2.z));
      }

      // ---- strategy 2: eye-side BRDF sampling ----
      V3 lw1;
      const V3 w12b =
          sample_combined(e, fminf(ua[2], kSelMax), ua[3], ub[0], &lw1);
      const bool in_cone1 = dot(w12b, nv12) > cos_half;
      const float cos1b = fmaxf(dot(e.n, w12b), 0.0f);
      const float cos2b = fmaxf(-dot(l.n, w12b), 0.0f);
      const V3 f2b = combined_f(l, fmaxf(dot(neg(w12b), l.r), 0.0f));
      const V3 wbn = normalize(w12b);
      const float pdf_b1b = pdf_mix(e, wbn, e.p_l, 1.0f - e.p_l);
      const float pdf_b2b = pdf_mix(l, neg(wbn), e.p_l, 1.0f);
      const float w_b1 =
          pdf_b1b / fmaxf((pdf_b1b + pdf_b2b) + inv_sa, kEpsNorm);
      V3 c_b1 = v3(0.0f, 0.0f, 0.0f);
      if (in_cone1 && cos1b > kEpsCone && !black1) {
        c_b1 = v3(w_b1 * (((flux.x * cos2b) * lw1.x) * f2b.x),
                  w_b1 * (((flux.y * cos2b) * lw1.y) * f2b.y),
                  w_b1 * (((flux.z * cos2b) * lw1.z) * f2b.z));
      }

      // ---- strategy 3: light-side BRDF sampling ----
      V3 lw2;
      const V3 w21 =
          sample_combined(l, fminf(ub[1], kSelMax), ub[2], ub[3], &lw2);
      const bool in_cone2 = -dot(w21, nv12) > cos_half;
      const float cos2c = fmaxf(dot(l.n, w21), 0.0f);
      const V3 f1c = combined_f(e, fmaxf(dot(wi10, reflect(w21, e.n)), 0.0f));
      const V3 w21n = normalize(w21);
      const float pdf_b1c = pdf_mix(e, neg(w21n), e.p_l, 1.0f - e.p_l);
      // quirk: the shading point's p_l and the unweighted phong term
      const float pdf_b2c = pdf_mix(l, w21n, e.p_l, 1.0f);
      const float w_b2 =
          pdf_b2c / fmaxf((pdf_b1c + pdf_b2c) + inv_sa, kEpsNorm);
      V3 c_b2 = v3(0.0f, 0.0f, 0.0f);
      if (in_cone2 && cos2c > kEpsLight && !black1 && !black2) {
        c_b2 = v3(w_b2 * (((flux.x * cos2c) * lw2.x) * f1c.x),
                  w_b2 * (((flux.y * cos2c) * lw2.y) * f1c.y),
                  w_b2 * (((flux.z * cos2c) * lw2.z) * f1c.z));
      }

      acc = v3(acc.x + ((c_cone.x + c_b1.x) + c_b2.x),
               acc.y + ((c_cone.y + c_b1.y) + c_b2.y),
               acc.z + ((c_cone.z + c_b1.z) + c_b2.z));
    }
    const float count = fmaxf(static_cast<float>(num), 1.0f);
    total = v3(total.x + acc.x / count, total.y + acc.y / count,
               total.z + acc.z / count);
  }
  out[3 * i] = total.x;
  out[3 * i + 1] = total.y;
  out[3 * i + 2] = total.z;
}

}  // namespace

extern "C" int evplp_vsl_sample_group(const void* pix, const void* pid,
                                      const void* gates, const void* cos_half,
                                      const void* counts, const void* table,
                                      int group, int n, uint32_t seed0,
                                      uint32_t seed1, int rec_base, void* out,
                                      void* stream) {
  if (group < 1 || group > kMaxGroup) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (n + kBlock - 1) / kBlock;
  vsl_sample_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pix), static_cast<const int*>(pid),
      static_cast<const int*>(gates), static_cast<const float*>(cos_half),
      static_cast<const int*>(counts), static_cast<const float*>(table), group,
      n, seed0, seed1, rec_base, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
