// One lane of the coalescence RHS (B3), the fused per-level RHS (B4) and of
// the whole SSPRK33 step (B1), shared by the table-driven kernels (fused_coalescence.cu) and the
// kernels generated per configuration (gen_kernels.cuh): the configuration
// type `C` is either `Config<T>` or a compiled-in one (coal_body.cuh).
//
// The whole step's z-coupling (level i takes the flux of level i+1, zero
// influx at each column's top) goes through a stencil object:
//
// - SmemStencil: the flux row written to shared memory, one __syncthreads(),
//   the neighbour read, a second barrier before the row is rewritten. The
//   block holds whole columns (blocks of cols * nz threads);
// - ShflStencil<nz>: for nz a power of two of at most 32 a column is one
//   warp segment, and level i takes F[i+1] by __shfl_down_sync within it:
//   no shared memory and no barrier. The counterpart of the Pallas body's
//   one-lane roll with its top-of-column mask (pallas_coalescence.py:
//   965-978). Every lane of the warp takes part: lanes past B run on zeros
//   and their results are dropped.

#pragma once

#include "coal_body.cuh"

namespace cloudy {

template <typename T> struct SmemStencil {
  T* sh;
  int t, nt;
  __device__ __forceinline__ void put(int o, T f) const { sh[o * nt + t] = f; }
  __device__ __forceinline__ void sync() const { __syncthreads(); }
  __device__ __forceinline__ T up(int o, T, bool top) const {
    return top ? T(0) : sh[o * nt + t + 1];
  }
  // sh is rewritten by the next evaluation
  __device__ __forceinline__ void done() const { __syncthreads(); }
};

template <int kWidth> struct ShflStencil {
  static_assert(kWidth >= 2 && kWidth <= 32 && (kWidth & (kWidth - 1)) == 0,
                "a column is a power-of-two warp segment");
  template <typename T> __device__ __forceinline__ void put(int, T) const {}
  __device__ __forceinline__ void sync() const {}
  template <typename T>
  __device__ __forceinline__ T up(int, T f, bool top) const {
    const T fu = __shfl_down_sync(0xffffffffu, f, 1, kWidth);  // every lane
    return top ? T(0) : fu;
  }
  __device__ __forceinline__ void done() const {}
};

// The coalescence RHS (B3) on lane `lane` < B: normalized moments
// [n_tot, B] -> tendencies [n_tot, B].
template <bool kArms, bool kRef, class C, typename T>
__device__ __forceinline__ void coal_lane(const C& c, const T* __restrict__ mom,
                                          T* __restrict__ out, long long B,
                                          long long lane) {
  T m[C::kNtot], acc[C::kNtot], params[C::kModes][3];
#pragma unroll
  for (int o = 0; o < C::kNtot; ++o)
    if (o < c.n_tot) m[o] = mom[o * B + lane];
  coal_body<kArms, kRef>(c, m, acc, params);
#pragma unroll
  for (int o = 0; o < C::kNtot; ++o)
    if (o < c.n_tot) out[o * B + lane] = acc[o];
}

// The fused per-level RHS on lane `lane` < B: physical moments [n_tot, B]
// -> [2 n_tot, B], the physical coalescence tendencies (clip, normalize,
// empty-cell mask, denormalize) over the physical sedimentation fluxes.
template <bool kArms, bool kRef, class C, typename T>
__device__ __forceinline__ void rhs_lane(const C& c, const T* __restrict__ mom,
                                         T* __restrict__ out, long long B,
                                         long long lane) {
  const T eps = Lim<T>::eps();
  T r[C::kNtot], acc[C::kNtot], flux[C::kNtot], params[C::kModes][3];
  bool empty = true;
#pragma unroll
  for (int o = 0; o < C::kNtot; ++o) {
    if (o < c.n_tot) {
      r[o] = vmax(mom[o * B + lane], T(0)) * c.inv_norm[o];  // clip, normalize
      empty = empty && (r[o] < eps);
    }
  }
  coal_body<kArms, kRef>(c, r, acc, params);
  sedi_flux<kArms, kRef>(c, params, flux);
#pragma unroll
  for (int o = 0; o < C::kNtot; ++o) {
    if (o < c.n_tot) {
      out[o * B + lane] = (empty ? T(0) : acc[o]) * c.norm[o];
      out[(c.n_tot + o) * B + lane] = flux[o] * c.norm[o];
    }
  }
}

// One RHS evaluation of the whole step on this lane's state y -> rows.
// Every thread of the block (SmemStencil) or of the warp (ShflStencil)
// calls it.
template <bool kArms, bool kScale, bool kRef, class C, class St, typename T>
__device__ __forceinline__ void step_rhs(const C& c, const St& st, const T* y,
                                         T* rows, bool top, T s) {
  const T eps = Lim<T>::eps();
  T r[C::kNtot], acc[C::kNtot], flux[C::kNtot], params[C::kModes][3];
  bool empty = true;
#pragma unroll
  for (int o = 0; o < C::kNtot; ++o) {
    if (o < c.n_tot) {
      r[o] = vmax(y[o], T(0)) * c.inv_norm[o];  // clip negatives, normalize
      empty = empty && (r[o] < eps);
    }
  }
  coal_body<kArms, kRef>(c, r, acc, params);
  sedi_flux<kArms, kRef>(c, params, flux);
#pragma unroll
  for (int o = 0; o < C::kNtot; ++o) {
    if (o < c.n_tot) {
      flux[o] = flux[o] * c.norm[o];
      st.put(o, flux[o]);
    }
  }
  st.sync();
#pragma unroll
  for (int o = 0; o < C::kNtot; ++o) {
    if (o < c.n_tot) {
      T coal = (empty ? T(0) : acc[o]) * c.norm[o];
      if (kScale) coal = coal * s;
      const T f_up = st.up(o, flux[o], top);
      rows[o] = coal - (f_up - flux[o]) * c.inv_dz;
    }
  }
  st.done();
}

// The whole SSPRK33 step of one lane: state in, three RHS evaluations and
// the RK combinations, state out. `active`: lane < B (an inactive lane runs
// on zeros to keep the stencil's barriers or shuffles uniform and writes
// nothing). `kLoop` runs the three evaluations as a loop over one inlined
// copy of the body instead of three copies: the same operations on the
// same values.
template <bool kArms, bool kScale, bool kRef, bool kLoop, class C, class St,
          typename T>
__device__ __forceinline__ void step_lane(const C& c, const St& st,
                                          const T* __restrict__ mom,
                                          T* __restrict__ out, long long B,
                                          long long lane, bool active,
                                          bool top, T s) {
  const T dt = c.dt;
  T y[C::kNtot], u1[C::kNtot], u2[C::kNtot], f[C::kNtot];
#pragma unroll
  for (int o = 0; o < C::kNtot; ++o)
    if (o < c.n_tot) y[o] = active ? mom[o * B + lane] : T(0);

  if constexpr (kLoop) {
    // u2 carries each stage's input: y, then u1, then u2
#pragma unroll
    for (int o = 0; o < C::kNtot; ++o)
      if (o < c.n_tot) u2[o] = y[o];
#pragma unroll 1
    for (int stage = 0; stage < 3; ++stage) {
      step_rhs<kArms, kScale, kRef>(c, st, u2, f, top, s);
      if (stage == 0) {
#pragma unroll
        for (int o = 0; o < C::kNtot; ++o)
          if (o < c.n_tot) u2[o] = y[o] + dt * f[o];
      } else if (stage == 1) {
#pragma unroll
        for (int o = 0; o < C::kNtot; ++o)
          if (o < c.n_tot) u2[o] = T(0.75) * y[o] + T(0.25) * (u2[o] + dt * f[o]);
      }
    }
  } else {
    step_rhs<kArms, kScale, kRef>(c, st, y, f, top, s);
#pragma unroll
    for (int o = 0; o < C::kNtot; ++o)
      if (o < c.n_tot) u1[o] = y[o] + dt * f[o];
    step_rhs<kArms, kScale, kRef>(c, st, u1, f, top, s);
#pragma unroll
    for (int o = 0; o < C::kNtot; ++o)
      if (o < c.n_tot) u2[o] = T(0.75) * y[o] + T(0.25) * (u1[o] + dt * f[o]);
    step_rhs<kArms, kScale, kRef>(c, st, u2, f, top, s);
  }
  if (!active) return;
#pragma unroll
  for (int o = 0; o < C::kNtot; ++o) {
    if (o >= c.n_tot) continue;
    // with the SFU forms (`Sfu`) the third is a product by the constant's
    // reciprocal, rounded once: no divide
    if constexpr (Sfu<C>::value)
      out[o * B + lane] = y[o] * T(1.0 / 3.0) + c.two_thirds * (u2[o] + dt * f[o]);
    else
      out[o * B + lane] = y[o] / T(3) + c.two_thirds * (u2[o] + dt * f[o]);
  }
}

}  // namespace cloudy
