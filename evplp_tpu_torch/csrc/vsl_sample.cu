// VSL 3-strategy MIS sample loop over a group of records, for Hopper
// (sm_90a).
//
// Replaces the JAX package's Pallas kernel
// evplp_tpu/integrators/vsl_kernel.py:_kernel (entry vsl_sample_group),
// which computes the same function for 128-lane pixel blocks on a TPU: for
// every gated (record, pixel) pair, s < min(num, 101) samples of the
// uniform-cone, eye-BRDF and light-BRDF strategies with the reference's pdf
// quirks, acc / max(num, 1) per pair with acc summed in sample order,
// summed over the group's G records in record order and written once as
// (N, 3).  The draws are pcg4d counters on (pixel id ^ seed0, record id,
// s ^ seed1, tag), so any thread may take any sample, and skipped work
// shifts no draw.
//
// What bounds it on an H100: operations.  Its bytes are about 100 B per
// pixel per group; a sample is some 330 float operations on box_field's
// inputs, many of them accurate sinf / cosf / powf / sqrtf and IEEE
// divisions in long dependent chains.  A one-thread-per-pixel loop was far
// from that bound: a warp paid, record by record, for the largest count of
// its 32 pixels while lanes whose gate bit was clear idled; a pair of up to
// 101 samples ran them one after another on one thread, long after the
// rest of its block was done; and every sample evaluated all three
// strategies and both lobes, although the two BRDF strategies' guards hold
// on ~2% of samples (a BRDF-sampled direction has to fall into the VSL's
// narrow cone) and most of box_field's surfaces have no phong lobe.
//
// What the design does about it.
//  * Pair lists.  A block takes 256 consecutive pixels and stages in shared
//    memory each pixel's and each record's shading side (Side: the BRDF
//    state with the sample loop's per-surface invariants computed once).
//    A block-wide scan of the gate bits lists the block's gated (record,
//    pixel) pairs, record-major; pairs of a black pixel are left out, since
//    every strategy's guard rejects them and they add +0.  A counting sort
//    in shared memory orders the list by sample count, longest first.
//  * Long pairs take a warp.  A pair of more than kWarpPairSteps samples
//    is worked by a whole warp, 32 samples at a time, and every lane adds
//    the 32 contributions in sample order (shuffles).  The other pairs go
//    32 to a warp, one thread a pair, in chunks taken from a shared
//    counter, so that a warp's lanes take similar counts.
//  * Lazy work.  Each strategy's BRDF values, pdfs and MIS weight are
//    computed only inside its guard (a failing guard added +0.0f); each BRDF
//    strategy builds only the chosen lobe's direction (both lobes share the
//    warp to the sphere and the basis, so a warp whose lanes chose both
//    pays for one) and its weight only inside the guard; strategy 3 is
//    skipped for a black record.  A phong value is skipped where
//    ks == (0, 0, 0) exactly (ks * pf is then +0 for the finite pf >= 0 of
//    ns >= 0), a phong pdf where ks.x <= 1e-6 (the reference's pdf gates on
//    the red channel alone).
//  * Each pair's estimate goes to a shared slot [g][pixel]; after a
//    barrier, thread p sums its pixel's gated slots in the order
//    g = 0 .. G-1 from 0, the plain version's order, and writes out once.
//    No atomics on data: the result is deterministic.
//
// Every skip gives the bits of the full computation, and so does every
// reordering of work.  The math is the plain PyTorch version's
// (evplp_tpu_torch/integrators/vsl.py:_sample_step) op for op: the same
// formulas in the same order, dots summed ((x + y) + z), normalize as
// v * (1 / sqrt(max(dot, 1e-20))), the accurate sinf / cosf / powf / sqrtf,
// IEEE division, and -fmad=false so that no multiply-add is fused; each
// hoisted invariant is the expression it replaces.  pcg4d runs in native
// uint32 and converts as the port's core/rng.uniform4 does:
// (v >> 8) -> int -> float * 2^-24.
//
// C interface: the wrapper allocates the output, launches on PyTorch's
// current stream, and checks the returned cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
constexpr int kMaxGroup = 32;
constexpr int kRecF = 24;
constexpr int kMaxSamples = 101;
// A pair of more samples than this takes a whole warp; kMaxSamples or
// more: none does
constexpr int kWarpPairSteps = 24;
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

// Side.flags
constexpr int kBlack = 1;        // both lobes black (is_black)
constexpr int kNoPhongF = 2;     // ks == (0, 0, 0): no phong value
constexpr int kNoPhongPdf = 4;   // ks.x <= 1e-6: no phong pdf

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

__device__ __forceinline__ uint32_t lcg(uint32_t v) {
  return v * 1664525u + 1013904223u;
}

// pcg4d (Jarzynski & Olano) -> four U[0,1) floats with 24-bit mantissas
__device__ __forceinline__ float4 uniform4(uint32_t x, uint32_t y, uint32_t z,
                                           uint32_t w) {
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
  return make_float4(static_cast<float>(static_cast<int>(x >> 8)) * kInv24,
                     static_cast<float>(static_cast<int>(y >> 8)) * kInv24,
                     static_cast<float>(static_cast<int>(z >> 8)) * kInv24,
                     static_cast<float>(static_cast<int>(w >> 8)) * kInv24);
}

// One side of a shading pair, the pixel's surface or a record, with the
// sample loop's per-surface invariants.  31 words: an odd stride, so a warp
// that reads one field of 32 pixels touches 32 banks.
struct Side {
  V3 pos;
  V3 n, kd, ks;
  V3 aux;         // pixel: wi10 (toward the eye); record: flux * invPiR2
  V3 r;           // the phong sampling axis, raw reflect(-inc, n)
  V3 rn;          // normalize(r): the phong pdf axis
  float ns;
  float ns2;      // ns + 2
  float inv_ns1;  // 1 / (ns + 1)
  float w_fac;    // (ns + 2) / (ns + 1)
  float pdf_fac;  // (ns + 1) * kHalfInvPi
  float p_l;      // lambert selection probability
  float q_l;      // 1 - p_l
  float inv_pl;   // 1 / max(p_l, 1e-8)
  float inv_pp;   // 1 / max(1 - p_l, 1e-8)
  int flags;      // kBlack | kNoPhongF | kNoPhongPdf
};
static_assert(sizeof(Side) == 31 * 4, "Side must keep an odd word stride");

// The invariants of a side whose n, kd, ks, ns, r and p_l are set.
__device__ __forceinline__ void finish_side(Side& s, bool black) {
  s.rn = normalize(s.r);
  s.ns2 = s.ns + 2.0f;
  s.inv_ns1 = 1.0f / (s.ns + 1.0f);
  s.w_fac = (s.ns + 2.0f) / (s.ns + 1.0f);
  s.pdf_fac = (s.ns + 1.0f) * kHalfInvPi;
  s.q_l = 1.0f - s.p_l;
  s.inv_pl = 1.0f / fmaxf(s.p_l, kEpsSel);
  s.inv_pp = 1.0f / fmaxf(1.0f - s.p_l, kEpsSel);
  const bool no_f = s.ks.x == 0.0f && s.ks.y == 0.0f && s.ks.z == 0.0f;
  s.flags = (black ? kBlack : 0) | (no_f ? kNoPhongF : 0) |
            (s.ks.x > kEpsRefl ? 0 : kNoPhongPdf);
}

// brdf.phong_eval_f's kernel on c = max(dot(out, axis), 0), and 0 where
// the side has no phong lobe
__device__ __forceinline__ float phong_f(const Side& s, V3 out, V3 axis) {
  if (s.flags & kNoPhongF) return 0.0f;
  const float c = fmaxf(dot(out, axis), 0.0f);
  return c > kEpsCos ? (s.ns2 * powf(c, s.ns)) * kHalfInvPi : 0.0f;
}

// kd / pi + ks * pf
__device__ __forceinline__ V3 combined_f(const Side& s, float pf) {
  return v3(s.kd.x * kInvPi + s.ks.x * pf, s.kd.y * kInvPi + s.ks.y * pf,
            s.kd.z * kInvPi + s.ks.z * pf);
}

// lambert_pdf_w_nopi(n, w) * p + phong_pdf_w(n, w, inc) * q, for a unit w;
// phong_pdf_w is max(dot(w, rn), 0)^ns (ns + 1) / 2pi, gated on ks.x
__device__ __forceinline__ float pdf_mix(const Side& s, V3 w, float p,
                                         float q) {
  float ph = 0.0f;
  if (!(s.flags & kNoPhongPdf)) {
    const float c = fmaxf(dot(w, s.rn), 0.0f);
    ph = c > kEpsCos ? s.pdf_fac * powf(c, s.ns) : 0.0f;
  }
  return fmaxf(dot(s.n, w), 0.0f) * p + ph * q;
}

// brdf.sample_combined's direction for the lobe already chosen: lambert
// around n (square_to_cosine_hemisphere), phong around the raw reflect axis
// (square_to_power_cosine).  Both lobes share the warp and basis: the local
// direction is (cos(phi) * r_xy, sin(phi) * r_xy, z) for either.
__device__ __forceinline__ V3 sample_dir(const Side& s, bool chose_l,
                                         float ua, float ub) {
  float z, r_xy;
  if (chose_l) {
    z = sqrtf(fmaxf(ua, 0.0f));
    r_xy = sqrtf(fmaxf(1.0f - ua, 0.0f));
  } else {
    z = powf(ua, s.inv_ns1);
    r_xy = sqrtf(fmaxf(1.0f - z * z, 0.0f));
  }
  const float phi = kTwoPi * ub;
  return from_local(v3(cosf(phi) * r_xy, sinf(phi) * r_xy, z),
                    chose_l ? s.n : s.r);
}

// brdf.sample_combined's weight: (kd | (ns+2)/(ns+1) cos_n ks) * 1/p
__device__ __forceinline__ V3 lobe_weight(const Side& s, bool chose_l,
                                          V3 dir) {
  if (chose_l) {
    return v3(s.kd.x * s.inv_pl, s.kd.y * s.inv_pl, s.kd.z * s.inv_pl);
  }
  const float wp = s.w_fac * fmaxf(dot(dir, s.n), 0.0f);
  return v3((wp * s.ks.x) * s.inv_pp, (wp * s.ks.y) * s.inv_pp,
            (wp * s.ks.z) * s.inv_pp);
}

// vsl._record_ctx of one pair.  7 words: an odd stride.
struct PairCtx {
  V3 nv12;
  float cos_half, omc, solid_angle, inv_sa;  // omc = 1 - cos_half
};

__device__ __forceinline__ PairCtx pair_ctx(const Side& e, const Side& l,
                                            float cos_half) {
  PairCtx c;
  const V3 v12 = v3(l.pos.x - e.pos.x, l.pos.y - e.pos.y, l.pos.z - e.pos.z);
  const float dist = sqrtf(fmaxf(dot(v12, v12), kEpsNorm));
  c.nv12 = v3(v12.x / dist, v12.y / dist, v12.z / dist);
  c.cos_half = cos_half;
  c.omc = 1.0f - cos_half;
  c.solid_angle = kTwoPi * c.omc;
  c.inv_sa = 1.0f / fmaxf(c.solid_angle, kEpsSa);
  return c;
}

// strategy 1, the uniform cone: its contribution, +0 where its guard fails
__device__ __forceinline__ V3 cone_strategy(const Side& e, const Side& l,
                                            const PairCtx& c, float4 ua) {
  const float phi = kTwoPi * ua.x;
  const float z = 1.0f - ua.y * c.omc;
  const float sl = sqrtf(fmaxf(1.0f - z * z, 0.0f));
  const V3 w12c =
      normalize(from_local(v3(cosf(phi) * sl, sinf(phi) * sl, z), c.nv12));
  const float cc = fmaxf(dot(e.n, w12c), 0.0f) * fmaxf(-dot(l.n, w12c), 0.0f);
  if (!(cc > kEpsCone)) return v3(0.0f, 0.0f, 0.0f);
  const V3 f2 = combined_f(l, phong_f(l, neg(w12c), l.r));
  const V3 f1 = combined_f(e, phong_f(e, e.aux, reflect(neg(w12c), e.n)));
  const V3 wcn = normalize(w12c);
  const float pdf_b1 = pdf_mix(e, wcn, e.p_l, e.q_l);
  const float pdf_b2 = pdf_mix(l, neg(wcn), e.p_l, 1.0f);
  const float w_cone =
      c.inv_sa / fmaxf((pdf_b1 + pdf_b2) + c.inv_sa, kEpsNorm);
  const float ca = cc * c.solid_angle;
  return v3(w_cone * (((l.aux.x * ca) * f1.x) * f2.x),
            w_cone * (((l.aux.y * ca) * f1.y) * f2.y),
            w_cone * (((l.aux.z * ca) * f1.z) * f2.z));
}

// strategy 2's direction, eye-side BRDF sampling; *hit = its guard
__device__ __forceinline__ V3 eye_dir(const Side& e, const PairCtx& c,
                                      float4 ua, float4 ub, bool* chose,
                                      bool* hit) {
  *chose = fminf(ua.z, kSelMax) < e.p_l;
  const V3 w12b = sample_dir(e, *chose, ua.w, ub.x);
  *hit = dot(w12b, c.nv12) > c.cos_half &&
         fmaxf(dot(e.n, w12b), 0.0f) > kEpsCone;
  return w12b;
}

// strategy 3's direction, light-side BRDF sampling; *hit = its guard but
// for the record's blackness
__device__ __forceinline__ V3 light_dir(const Side& l, const PairCtx& c,
                                        float4 ub, bool* chose, bool* hit) {
  *chose = fminf(ub.y, kSelMax) < l.p_l;
  const V3 w21 = sample_dir(l, *chose, ub.z, ub.w);
  *hit = -dot(w21, c.nv12) > c.cos_half &&
         fmaxf(dot(l.n, w21), 0.0f) > kEpsLight;
  return w21;
}

// strategy 2's contribution where its guard holds
__device__ __forceinline__ V3 eye_strategy(const Side& e, const Side& l,
                                           const PairCtx& c, bool chose1,
                                           V3 w12b) {
  const V3 lw1 = lobe_weight(e, chose1, w12b);
  const float cos2b = fmaxf(-dot(l.n, w12b), 0.0f);
  const V3 f2b = combined_f(l, phong_f(l, neg(w12b), l.r));
  const V3 wbn = normalize(w12b);
  const float pdf_b1b = pdf_mix(e, wbn, e.p_l, e.q_l);
  const float pdf_b2b = pdf_mix(l, neg(wbn), e.p_l, 1.0f);
  const float w_b1 = pdf_b1b / fmaxf((pdf_b1b + pdf_b2b) + c.inv_sa, kEpsNorm);
  return v3(w_b1 * (((l.aux.x * cos2b) * lw1.x) * f2b.x),
            w_b1 * (((l.aux.y * cos2b) * lw1.y) * f2b.y),
            w_b1 * (((l.aux.z * cos2b) * lw1.z) * f2b.z));
}

// strategy 3's contribution where its guard holds
__device__ __forceinline__ V3 light_strategy(const Side& e, const Side& l,
                                             const PairCtx& c, bool chose2,
                                             V3 w21) {
  const float cos2c = fmaxf(dot(l.n, w21), 0.0f);
  const V3 lw2 = lobe_weight(l, chose2, w21);
  const V3 f1c = combined_f(e, phong_f(e, e.aux, reflect(w21, e.n)));
  const V3 w21n = normalize(w21);
  const float pdf_b1c = pdf_mix(e, neg(w21n), e.p_l, e.q_l);
  // quirk: the shading point's p_l and the unweighted phong term
  const float pdf_b2c = pdf_mix(l, w21n, e.p_l, 1.0f);
  const float w_b2 = pdf_b2c / fmaxf((pdf_b1c + pdf_b2c) + c.inv_sa, kEpsNorm);
  return v3(w_b2 * (((l.aux.x * cos2c) * lw2.x) * f1c.x),
            w_b2 * (((l.aux.y * cos2c) * lw2.y) * f1c.y),
            w_b2 * (((l.aux.z * cos2c) * lw2.z) * f1c.z));
}

// One sample's contribution ((cone + eye BRDF) + light BRDF), each +0
// where its guard fails.  Its 8 uniforms are two pcg4d draws on
// (c0, c1, s ^ seed1, tag).
__device__ __forceinline__ V3 sample_contribution(const Side& e,
                                                  const Side& l,
                                                  const PairCtx& c,
                                                  uint32_t c0, uint32_t c1,
                                                  uint32_t seed1, int s) {
  const uint32_t c2 = static_cast<uint32_t>(s) ^ seed1;
  const float4 ua = uniform4(c0, c1, c2, 0u);
  const float4 ub = uniform4(c0, c1, c2, 1u);
  const V3 cone = cone_strategy(e, l, c, ua);
  bool chose, hit;
  V3 eye = v3(0.0f, 0.0f, 0.0f);
  const V3 w12b = eye_dir(e, c, ua, ub, &chose, &hit);
  if (hit) eye = eye_strategy(e, l, c, chose, w12b);
  V3 light = v3(0.0f, 0.0f, 0.0f);
  if (!(l.flags & kBlack)) {
    const V3 w21 = light_dir(l, c, ub, &chose, &hit);
    if (hit) light = light_strategy(e, l, c, chose, w21);
  }
  return v3((cone.x + eye.x) + light.x, (cone.y + eye.y) + light.y,
            (cone.z + eye.z) + light.z);
}

// One gated pair's estimate acc / max(num, 1), acc summed over its samples
// s < min(num, 101) in order
__device__ __forceinline__ V3 pair_estimate(const Side& e, const Side& l,
                                            uint32_t c0, uint32_t c1,
                                            uint32_t seed1, float cos_half,
                                            int num) {
  const PairCtx c = pair_ctx(e, l, cos_half);
  const int steps = num < kMaxSamples ? num : kMaxSamples;
  V3 acc = v3(0.0f, 0.0f, 0.0f);
  for (int s = 0; s < steps; ++s) {
    const V3 part = sample_contribution(e, l, c, c0, c1, seed1, s);
    acc = v3(acc.x + part.x, acc.y + part.y, acc.z + part.z);
  }
  const float count = fmaxf(static_cast<float>(num), 1.0f);
  return v3(acc.x / count, acc.y / count, acc.z / count);
}

// Dynamic shared memory of a block for a group of g records: the pixels'
// and records' sides, the estimates [g][3][pixel], the draws' pixel
// counters, the scan's per-(record, warp) offsets with the pair count and
// the chunk counter, the count sort's bins, and the pair list
// (record << 7 | pixel) with its sorted copy.
__host__ __device__ constexpr size_t smem_bytes(int g) {
  return sizeof(Side) * (kBlock + g) + sizeof(float) * 3 * kBlock * g +
         sizeof(uint32_t) * kBlock +
         sizeof(int) * (g * kWarps + 4 + kMaxSamples + 1) +
         2 * sizeof(uint16_t) * kBlock * g;
}

// The sample steps of a listed pair, min(num, 101) and at least 0
__device__ __forceinline__ int pair_steps(const int* __restrict__ counts,
                                          int entry, int block0, int n) {
  const int num = counts[(entry / kBlock) * n + block0 + entry % kBlock];
  return num < 0 ? 0 : (num < kMaxSamples ? num : kMaxSamples);
}

// 80 registers at most: ptxas's own choice spilled, and this cap does not
__global__ void __maxnreg__(80)
vsl_sample_kernel(const float* __restrict__ pix, const int* __restrict__ pid,
                  const int* __restrict__ gates,
                  const float* __restrict__ cos_half_g,
                  const int* __restrict__ counts,
                  const float* __restrict__ table, int group, int n,
                  uint32_t seed0, uint32_t seed1, int rec_base,
                  float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  Side* px_s = reinterpret_cast<Side*>(smem);
  Side* rec_s = px_s + kBlock;
  float* est_s = reinterpret_cast<float*>(rec_s + group);
  uint32_t* c0_s = reinterpret_cast<uint32_t*>(est_s + 3 * kBlock * group);
  int* base_s = reinterpret_cast<int*>(c0_s + kBlock);
  int* pairs_s = base_s + group * kWarps;
  int* next_s = pairs_s + 1;   // the next chunk of 32 short pairs
  int* long_s = next_s + 1;    // the next long pair
  int* n_long_s = long_s + 1;  // long pairs
  int* bins_s = n_long_s + 1;
  uint16_t* list_s = reinterpret_cast<uint16_t*>(bins_s + kMaxSamples + 1);
  uint16_t* sorted_s = list_s + kBlock * group;

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int i = blockIdx.x * kBlock + t;

  // ---- stage the records' and the pixels' sides ----
  if (t < group) {
    const float* rec = table + t * kRecF;
    Side& s = rec_s[t];
    s.pos = v3(rec[0], rec[1], rec[2]);
    s.n = v3(rec[3], rec[4], rec[5]);
    s.aux = v3(rec[9], rec[10], rec[11]);
    s.kd = v3(rec[12], rec[13], rec[14]);
    s.ks = v3(rec[15], rec[16], rec[17]);
    s.ns = rec[18];
    s.r = v3(rec[20], rec[21], rec[22]);
    s.p_l = rec[23];
    finish_side(s, rec[19] > 0.5f);
  }
  // the gate bits of the group's records, none for a black pixel
  uint32_t mask = 0u;
  if (i < n) {
    Side& s = px_s[t];
    s.pos = v3(pix[0 * n + i], pix[1 * n + i], pix[2 * n + i]);
    s.n = v3(pix[3 * n + i], pix[4 * n + i], pix[5 * n + i]);
    s.kd = v3(pix[6 * n + i], pix[7 * n + i], pix[8 * n + i]);
    s.ks = v3(pix[9 * n + i], pix[10 * n + i], pix[11 * n + i]);
    s.ns = pix[12 * n + i];
    s.aux = v3(pix[13 * n + i], pix[14 * n + i], pix[15 * n + i]);
    s.r = reflect(neg(s.aux), s.n);
    const float ml = fmaxf(fmaxf(s.kd.x, s.kd.y), s.kd.z);
    const float mp = fmaxf(fmaxf(s.ks.x, s.ks.y), s.ks.z);
    s.p_l = ml / fmaxf(ml + mp, kEpsNorm);
    const bool black1 = ml + mp <= kEpsRefl;
    finish_side(s, black1);
    c0_s[t] = static_cast<uint32_t>(pid[i]) ^ seed0;
    const uint32_t all = group < 32 ? (1u << group) - 1u : 0xffffffffu;
    mask = black1 ? 0u : static_cast<uint32_t>(gates[i]) & all;
  }

  // ---- the list of gated pairs, record-major: count per (record, warp),
  // scan, scatter ----
  for (int g = 0; g < group; ++g) {
    const uint32_t b = __ballot_sync(0xffffffffu, (mask >> g) & 1u);
    if (lane == 0) base_s[g * kWarps + warp] = __popc(b);
  }
  __syncthreads();
  if (warp == 0) {  // lane g scans record g's warps
    int c[kWarps];
    int sum = 0;
    for (int w = 0; w < kWarps; ++w) {
      c[w] = lane < group ? base_s[lane * kWarps + w] : 0;
      sum += c[w];
    }
    int incl = sum;
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    int run = incl - sum;
    for (int w = 0; w < kWarps && lane < group; ++w) {
      base_s[lane * kWarps + w] = run;
      run += c[w];
    }
    if (lane == 31) {
      *pairs_s = incl;
      *next_s = 0;
      *long_s = 0;
      *n_long_s = 0;
    }
  }
  __syncthreads();
  for (int g = 0; g < group; ++g) {
    const bool on = (mask >> g) & 1u;
    const uint32_t b = __ballot_sync(0xffffffffu, on);
    if (on) {
      list_s[base_s[g * kWarps + warp] + __popc(b & ((1u << lane) - 1u))] =
          static_cast<uint16_t>(g * kBlock + t);
    }
  }
  __syncthreads();

  const int pairs = *pairs_s;
  const int block0 = blockIdx.x * kBlock;
  // ---- the counting sort, longest first: bin b holds the pairs of
  // 101 - b samples ----
  {
    for (int b = t; b <= kMaxSamples; b += kBlock) bins_s[b] = 0;
    __syncthreads();
    for (int k = t; k < pairs; k += kBlock) {
      atomicAdd(&bins_s[kMaxSamples - pair_steps(counts, list_s[k], block0,
                                                 n)], 1);
    }
    __syncthreads();
    if (warp == 0) {  // lane l scans bins 4l .. 4l+3
      int c[4];
      int sum = 0;
      for (int j = 0; j < 4; ++j) {
        const int b = 4 * lane + j;
        c[j] = b <= kMaxSamples ? bins_s[b] : 0;
        sum += c[j];
      }
      int incl = sum;
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += v;
      }
      int run = incl - sum;
      for (int j = 0; j < 4; ++j) {
        const int b = 4 * lane + j;
        if (b <= kMaxSamples) bins_s[b] = run;
        // the pairs of more than kWarpPairSteps samples come first
        if (b == kMaxSamples - kWarpPairSteps && b > 0) *n_long_s = run;
        run += c[j];
      }
    }
    __syncthreads();
    for (int k = t; k < pairs; k += kBlock) {
      const int entry = list_s[k];
      const int b = kMaxSamples - pair_steps(counts, entry, block0, n);
      sorted_s[atomicAdd(&bins_s[b], 1)] = static_cast<uint16_t>(entry);
    }
    __syncthreads();
  }
  const uint16_t* work_s = sorted_s;

  // ---- the long pairs, one warp each: the lanes take 32 samples at a
  // time, and every lane adds them in order ----
  const int n_long = *n_long_s;
  for (;;) {
    int k = 0;
    if (lane == 0) k = atomicAdd(long_s, 1);
    k = __shfl_sync(0xffffffffu, k, 0);
    if (k >= n_long) break;
    const int entry = work_s[k];
    const int g = entry / kBlock;
    const int p = entry % kBlock;
    const int ip = block0 + p;
    const Side& e = px_s[p];
    const Side& l = rec_s[g];
    const PairCtx c = pair_ctx(e, l, cos_half_g[g * n + ip]);
    const int num = counts[g * n + ip];
    const int steps = num < kMaxSamples ? num : kMaxSamples;
    V3 acc = v3(0.0f, 0.0f, 0.0f);
    for (int s0 = 0; s0 < steps; s0 += 32) {
      V3 part = v3(0.0f, 0.0f, 0.0f);
      if (s0 + lane < steps) {
        part = sample_contribution(e, l, c, c0_s[p],
                                   static_cast<uint32_t>(rec_base + g), seed1,
                                   s0 + lane);
      }
      const int m = steps - s0 < 32 ? steps - s0 : 32;
      for (int q = 0; q < m; ++q) {
        acc = v3(acc.x + __shfl_sync(0xffffffffu, part.x, q),
                 acc.y + __shfl_sync(0xffffffffu, part.y, q),
                 acc.z + __shfl_sync(0xffffffffu, part.z, q));
      }
    }
    if (lane == 0) {
      const float count = fmaxf(static_cast<float>(num), 1.0f);
      est_s[(g * 3 + 0) * kBlock + p] = acc.x / count;
      est_s[(g * 3 + 1) * kBlock + p] = acc.y / count;
      est_s[(g * 3 + 2) * kBlock + p] = acc.z / count;
    }
  }

  // ---- the other pairs, 32 a warp, one thread a pair ----
  const int chunks = (pairs - n_long + 31) / 32;
  for (;;) {
    int chunk = 0;
    if (lane == 0) chunk = atomicAdd(next_s, 1);
    chunk = __shfl_sync(0xffffffffu, chunk, 0);
    if (chunk >= chunks) break;
    const int k = n_long + chunk * 32 + lane;
    if (k < pairs) {
      const int entry = work_s[k];
      const int g = entry / kBlock;
      const int p = entry % kBlock;
      const int ip = block0 + p;
      const V3 est = pair_estimate(
          px_s[p], rec_s[g], c0_s[p], static_cast<uint32_t>(rec_base + g),
          seed1, cos_half_g[g * n + ip], counts[g * n + ip]);
      est_s[(g * 3 + 0) * kBlock + p] = est.x;
      est_s[(g * 3 + 1) * kBlock + p] = est.y;
      est_s[(g * 3 + 2) * kBlock + p] = est.z;
    }
  }
  __syncthreads();

  // ---- each pixel's sum over its gated records, record 0 first ----
  if (i >= n) return;
  V3 total = v3(0.0f, 0.0f, 0.0f);
  for (int g = 0; g < group; ++g) {
    if (((mask >> g) & 1u) == 0u) continue;
    total = v3(total.x + est_s[(g * 3 + 0) * kBlock + t],
               total.y + est_s[(g * 3 + 1) * kBlock + t],
               total.z + est_s[(g * 3 + 2) * kBlock + t]);
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
  const size_t smem = smem_bytes(group);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        vsl_sample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int grid = (n + kBlock - 1) / kBlock;
  vsl_sample_kernel<<<grid, kBlock, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pix), static_cast<const int*>(pid),
      static_cast<const int*>(gates), static_cast<const float*>(cos_half),
      static_cast<const int*>(counts), static_cast<const float*>(table), group,
      n, seed0, seed1, rec_base, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
