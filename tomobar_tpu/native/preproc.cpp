// Native host-side preprocessing for tomobar_tpu.
//
// The accelerator owns the reconstruction math (XLA/Pallas); this module owns the
// host-side raw-data path that feeds it — the role CUDA/C++ plays in the
// reference's stack (ToMoBAR's own normaliser is numpy,
// tomobar/supp/suppTools.py:187-264, but it feeds from HTTomo's native IO
// layer; here the fused multicore path is part of the framework itself).
//
// normalise_f32: fused flat/dark normalisation + optional -log transform,
//   out[z,a,t] = cliplog( clip(data - dark, >=0 -> 1) / clip(flat - dark) )
// one pass over the data, no temporaries, OpenMP across projections.
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC preproc.cpp -o libpreproc.so

#include <cmath>
#include <cstdint>

#if defined(_OPENMP)
#include <omp.h>
#endif

extern "C" {

// data:  (n_outer, n_inner) raw projections, row-major float32
// flat:  (n_inner,) reduced flat field (mean/median already applied)
// dark:  (n_inner,) reduced dark field
// out:   (n_outer, n_inner)
// log_transform: 0/1
// The (detY, angles, detX) <-> (angles, detY, detX) distinction is handled
// by the caller choosing n_outer/n_inner and pre-broadcast flats/darks.
void normalise_f32(const float* data, const float* flat, const float* dark,
                   float* out, int64_t n_outer, int64_t n_inner,
                   int32_t log_transform) {
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
  for (int64_t i = 0; i < n_outer; ++i) {
    const float* drow = data + i * n_inner;
    float* orow = out + i * n_inner;
    for (int64_t j = 0; j < n_inner; ++j) {
      float denom = flat[j] - dark[j];
      if (denom <= 0.0f) denom = 1.0f;
      float nomin = drow[j] - dark[j];
      if (nomin < 0.0f) nomin = 1.0f;
      float v = nomin / denom;
      if (log_transform) {
        // reference semantics (suppTools.py:252-258): -log on positive
        // values, then the `< 0 -> 0` mask runs on the LOGGED array, so
        // transmissions > 1 (negative absorption) clamp to zero
        v = (v > 0.0f) ? -logf(v) : 0.0f;
        if (v < 0.0f) v = 0.0f;
      }
      orow[j] = v;
    }
  }
}

// Per-projection [min, max, mean] statistics used by the autocropper ROI
// analysis — one pass, OpenMP across projections.
void proj_stats_f32(const float* data, int64_t n_proj, int64_t n_pix,
                    float* mins, float* maxs, float* means) {
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
  for (int64_t i = 0; i < n_proj; ++i) {
    const float* row = data + i * n_pix;
    float mn = row[0], mx = row[0];
    double acc = 0.0;
    for (int64_t j = 0; j < n_pix; ++j) {
      float v = row[j];
      if (v < mn) mn = v;
      if (v > mx) mx = v;
      acc += v;
    }
    mins[i] = mn;
    maxs[i] = mx;
    means[i] = (float)(acc / (double)n_pix);
  }
}

int32_t n_threads() {
#if defined(_OPENMP)
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
