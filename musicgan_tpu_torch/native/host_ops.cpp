// Native host-side ingest kernel: fused magn/phase/bark/minmax/chunk-pack.
//
// The TPU-native framework keeps device compute in XLA/Pallas; the host
// ingest tail (reference create_dataset.py:13-64 -> audio/functions.py:65-94)
// is the one hot CPU path, and the numpy mirror in audio/ingest.py spends
// most of its time in many full-array passes (SIMD atan2/abs, a float64
// phase-difference pipeline with several temporaries, in-place
// normalization sweeps, a layout transpose, a packing copy).  This kernel
// fuses the whole post-FFT tail into one streaming pass over the
// FRAME-MAJOR spectrogram — the layout the batched rfft produces — so the
// 40+ MB bin-major transpose the numpy path pays never happens.
//
// The kernel is exposed TWO ways with identical arithmetic:
//   * one-shot  mg_magn_phase_pack(z, T, ...)      — whole spectrogram;
//   * streaming mg_pack_begin / mg_pack_frames / mg_pack_finish — the
//     caller feeds frame blocks as it produces them (window multiply +
//     rfft per block stay cache-resident instead of materializing two
//     ~40 MB temporaries), and per-track memory is bounded regardless of
//     track length.  The one-shot entry is the streaming API driven with
//     a single block, so parity tests on either pin both.
//
// Every stage is shaped for the auto-vectorizer (verified with
// -fopt-info-vec):
//
//   per frame t (row of z, contiguous):
//     stage A (f32, vector): magnitude sqrt(re^2+im^2)*bark and phase
//         atan2(im,re) over all bins.  atan2 is a branchless degree-11
//         minimax polynomial (measured max err ~1.7e-6 rad — so a phase
//         DIFFERENCE of two approximated angles can err ~3.4e-6 rad,
//         inside but only ~2x under the ~6e-6 rad parity budget vs the
//         numpy mirror; don't tighten tolerances against this bound
//         without re-measuring.  Observed consequence on PURE TONES: a
//         phase diff landing within that error of ±pi can wrap to the
//         OPPOSITE sign vs numpy — one bin of a 60 s 440 Hz tone showed
//         a post-normalization diff of 2.0.  Benign: -pi and +pi are
//         the same point on the circle, and min-max normalization keeps
//         the value in range; random/musical signals sit measure-zero
//         on this edge), exact at the IEEE axes
//         (atan2(+-0,-0)=+-pi, atan2(0,+0)=0), which the sign-flip wrap
//         edge depends on.
//     stage B (f64, vector, branchless): wrapped first difference of the
//         float32 phase vs the carried previous frame, with identical
//         semantics to ingest._phase_diff_np: |d| < pi kept untouched;
//         otherwise np.mod(d+pi, 2pi) - pi via the exact floor identity
//         (floor is in {-1,0,1} for |d| <= 2pi, recovered by range tests
//         instead of a divide+floor — bit-identical, and it vectorizes:
//         the divide+floor form compiled scalar and was the kernel's
//         single hottest loop), and a -pi wrap of a positive jump maps
//         to +pi.  Diff, wrap, carry update and the f32 store are ONE
//         fused pass (the old 3-loop + f64 scratch round-trip form also
//         defeated the vectorizer via the type-punned scratch buffer).
//     stage C (vector): per-track min/max via per-lane accumulators
//         (plain conditional reductions don't vectorize), over ALL
//         frames including the leading `t % n_vec` trimmed ones — the
//         reference normalizes before trimming.
//     stage D: rows land in a 16-frame staging block; full blocks flush
//         as contiguous 64 B runs per bin (a blocked transpose) instead
//         of 4 B scattered stores into the packed
//         (chunk, channel, bin, frame) output.
//   final pass (vector): in-place min-max -> [-1, 1] with the same
//         float32 op order as the numpy mirror
//         (a -= mn; a *= f32(2/(mx-mn)); a -= 1).  On AVX-512 the
//         rewrite uses streaming (non-temporal) stores: the out planes
//         far exceed cache, so skipping read-for-ownership cuts the
//         pass's DRAM traffic by a third (NT stores in the stage-D
//         flush were measured SLOWER — they evict lines this pass
//         still wants — so only the final write streams).
//
//   The kernel is DRAM-bound on the bench host (compute ablates to
//   ~20% of runtime); the fixes above took it from 52 ms to 34 ms for
//   a 60 s track (min-of-20, bit-identical output).
//
// Build: g++ -O3 -march=native -fno-math-errno -shared -fPIC (see build.py).
// Python binding: ctypes (musicgan_tpu/native/__init__.py).

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#ifdef __AVX512F__
#include <immintrin.h>
#endif

namespace {

constexpr int64_t kBlock = 16;  // frames staged per transpose flush
constexpr int kLanes = 16;      // min/max accumulator lanes

// Branchless atan2f: minimax atan(a) on [0,1] + quadrant fixups.
// Auto-vectorizes (no libm calls, no branches — ternaries become blends).
inline float fast_atan2(float y, float x) {
    const float ax = std::fabs(x), ay = std::fabs(y);
    const float mx = ax > ay ? ax : ay;
    const float mn = ax > ay ? ay : ax;
    const float a = mn / (mx > 0.0f ? mx : 1.0f);  // atan2(0,0) -> 0, not NaN
    const float s = a * a;
    float r = ((((-0.0117212f * s + 0.0526533f) * s - 0.1164329f) * s
                + 0.1935435f) * s - 0.3326235f) * s + 0.9999773f;
    r *= a;
    r = ay > ax ? 1.5707963267948966f - r : r;
    // signbit, not (x < 0): atan2(+-0, -0.0) = +-pi like IEEE/numpy
    r = std::signbit(x) ? 3.14159265358979323846f - r : r;
    return std::copysign(r, y);
}

inline void lane_minmax(const float* v, int64_t n, float* lo, float* hi) {
    // elementwise per-lane accumulation vectorizes; n is a multiple of
    // kLanes here (n_bins = 512) but handle any n for generality
    int64_t b = 0;
    for (; b + kLanes <= n; b += kLanes) {
        for (int j = 0; j < kLanes; ++j) {
            const float x = v[b + j];
            lo[j] = x < lo[j] ? x : lo[j];
            hi[j] = x > hi[j] ? x : hi[j];
        }
    }
    for (; b < n; ++b) {
        const float x = v[b];
        lo[0] = x < lo[0] ? x : lo[0];
        hi[0] = x > hi[0] ? x : hi[0];
    }
}

// Streaming pack state: everything the per-frame loop carries between
// blocks.  One allocation; the float scratch lives directly after the
// struct.
struct PackState {
    int64_t T, ld, n_bins, n_vec;
    int64_t trim;        // leading frames dropped after normalization
    int64_t t;           // global frame cursor (0 .. T)
    int64_t blk_fill, blk_k0;
    float mlo[kLanes], mhi[kLanes], plo[kLanes], phi_[kLanes];
    float* phi_prev;     // (n_bins)
    float* mrow;         // (n_bins)
    float* prow;         // (n_bins)
    float* mblk;         // (n_bins, kBlock)
    float* pblk;         // (n_bins, kBlock)
    float* bark;         // (n_bins) copy — caller's buffer may not outlive us
};

// The staging buffers are passed IN (not read via st->mblk/st->pblk):
// the caller writes them through __restrict__-qualified locals, and a
// read through an unrelated pointer inside that restrict scope would be
// undefined behavior the inliner may "optimize" into reading stale data.
void flush_block(const float* mblk, const float* pblk,
                 int64_t n_bins, int64_t n_vec,
                 float* out, int64_t fill, int64_t k0) {
    // (n_bins, kBlock) staging -> out[c][ch][b][v0 .. v0+fill)
    const int64_t chan_stride = n_bins * n_vec;
    const int64_t c = k0 / n_vec, v0 = k0 % n_vec;
    float* mbase = out + c * 2 * chan_stride + v0;
    float* pbase = mbase + chan_stride;
    if (fill == kBlock) {
        for (int64_t b = 0; b < n_bins; ++b) {
            std::memcpy(mbase + b * n_vec, mblk + b * kBlock,
                        kBlock * sizeof(float));
            std::memcpy(pbase + b * n_vec, pblk + b * kBlock,
                        kBlock * sizeof(float));
        }
    } else {
        for (int64_t b = 0; b < n_bins; ++b) {
            std::memcpy(mbase + b * n_vec, mblk + b * kBlock,
                        fill * sizeof(float));
            std::memcpy(pbase + b * n_vec, pblk + b * kBlock,
                        fill * sizeof(float));
        }
    }
}

}  // namespace

extern "C" {

// Begin a streaming pack over T total frames (the trim geometry needs the
// final count up front).  bark is copied.  Returns NULL on bad geometry
// or allocation failure; free with mg_pack_finish or mg_pack_free.
void* mg_pack_begin(int64_t T, int64_t ld, int64_t n_bins,
                    const float* bark, int64_t n_vec) {
    const int64_t td = T - 1;
    if (td < n_vec || n_vec <= 0 || n_bins <= 0 || n_bins > ld) return nullptr;
    const int64_t scratch = (4 * n_bins + 2 * n_bins * kBlock);
    void* mem = std::malloc(sizeof(PackState) + scratch * sizeof(float));
    if (!mem) return nullptr;
    PackState* st = static_cast<PackState*>(mem);
    float* f = reinterpret_cast<float*>(st + 1);
    st->T = T; st->ld = ld; st->n_bins = n_bins; st->n_vec = n_vec;
    st->trim = td % n_vec;
    st->t = 0;
    st->blk_fill = 0; st->blk_k0 = 0;
    st->phi_prev = f;
    st->mrow = f + n_bins;
    st->prow = f + 2 * n_bins;
    st->mblk = f + 3 * n_bins;
    st->pblk = st->mblk + n_bins * kBlock;
    st->bark = st->pblk + n_bins * kBlock;
    std::memcpy(st->bark, bark, n_bins * sizeof(float));
    for (int j = 0; j < kLanes; ++j) {
        st->mlo[j] = st->plo[j] = INFINITY;
        st->mhi[j] = st->phi_[j] = -INFINITY;
    }
    return st;
}

void mg_pack_free(void* handle) { std::free(handle); }

// Feed the next T_block frames (rows of the frame-major complex64
// spectrogram, interleaved re/im, leading dimension st->ld).  out is the
// FULL output buffer — writes land positionally, so the caller passes the
// same pointer every time.  Returns 0 on success, -1 on overfeed.
int mg_pack_frames(void* handle, const float* z, int64_t T_block,
                   float* out) {
    PackState* st = static_cast<PackState*>(handle);
    if (st->t + T_block > st->T) return -1;
    const int64_t n_bins = st->n_bins, ld = st->ld, n_vec = st->n_vec;
    const int64_t trim = st->trim;
    const double pi = 3.14159265358979323846;
    const double two_pi = 2.0 * pi;
    // restrict-qualified locals: all scratch is carved from one
    // allocation, so without it the vectorizer versions every loop with
    // runtime aliasing checks
    float* __restrict__ phi_prev = st->phi_prev;
    float* __restrict__ mrow = st->mrow;
    float* __restrict__ prow = st->prow;
    float* __restrict__ mblk = st->mblk;
    float* __restrict__ pblk = st->pblk;
    const float* __restrict__ bark = st->bark;
    float mlo[kLanes], mhi[kLanes], plo[kLanes], phi_[kLanes];
    std::memcpy(mlo, st->mlo, sizeof(mlo));
    std::memcpy(mhi, st->mhi, sizeof(mhi));
    std::memcpy(plo, st->plo, sizeof(plo));
    std::memcpy(phi_, st->phi_, sizeof(phi_));
    int64_t blk_fill = st->blk_fill, blk_k0 = st->blk_k0;

    for (int64_t r = 0; r < T_block; ++r) {
        const int64_t t = st->t + r;       // global frame index
        const float* row = z + 2 * r * ld;
        if (t == 0) {
            // first frame seeds the phase carry; produces no output row
            for (int64_t b = 0; b < n_bins; ++b) {
                phi_prev[b] = fast_atan2(row[2 * b + 1], row[2 * b]);
            }
            continue;
        }
        // stage A (f32 vector): magnitude + raw phase
        for (int64_t b = 0; b < n_bins; ++b) {
            const float re = row[2 * b], im = row[2 * b + 1];
            mrow[b] = std::sqrt(re * re + im * im) * bark[b];
            prow[b] = fast_atan2(im, re);
        }
        // stage B (f64 vector, branchless): wrapped diff + carry, one
        // fused pass.  d lies in (-2pi, 2pi) (difference of two atan2
        // results), so shifted = d + pi lies in (-pi, 3pi) and
        // floor(shifted / two_pi) is in {-1, 0, 1}; the range tests
        // recover that floor exactly — a correctly-rounded quotient
        // cannot cross 0 or 1, since the nearest representable doubles
        // below those boundaries still round down (verified bit-exact
        // vs the divide+floor form across the parity suite).
        for (int64_t b = 0; b < n_bins; ++b) {
            const float p_new = prow[b];
            const double d = (double)p_new - (double)phi_prev[b];
            phi_prev[b] = p_new;
            const double shifted = d + pi;
            const double fl =
                shifted < 0.0 ? -1.0 : (shifted >= two_pi ? 1.0 : 0.0);
            double dm = shifted - two_pi * fl - pi;
            dm = (dm == -pi && d > 0.0) ? pi : dm;
            prow[b] = (float)((d < pi && d > -pi) ? d : dm);
        }
        // stage C (vector): per-track min/max over ALL frames
        lane_minmax(mrow, n_bins, mlo, mhi);
        lane_minmax(prow, n_bins, plo, phi_);

        // stage D: stage the frame column; flush full blocks contiguously
        const int64_t k = (t - 1) - trim;
        if (k >= 0) {
            if (blk_fill == 0) blk_k0 = k;
            for (int64_t b = 0; b < n_bins; ++b) {
                mblk[b * kBlock + blk_fill] = mrow[b];
                pblk[b * kBlock + blk_fill] = prow[b];
            }
            ++blk_fill;
            // flush at block capacity or at a chunk boundary (n_vec may
            // not be a multiple of kBlock in tests)
            if (blk_fill == kBlock || (k + 1) % n_vec == 0) {
                flush_block(mblk, pblk, n_bins, n_vec, out,
                            blk_fill, blk_k0);
                blk_fill = 0;
            }
        }
    }
    st->t += T_block;
    std::memcpy(st->mlo, mlo, sizeof(mlo));
    std::memcpy(st->mhi, mhi, sizeof(mhi));
    std::memcpy(st->plo, plo, sizeof(plo));
    std::memcpy(st->phi_, phi_, sizeof(phi_));
    st->blk_fill = blk_fill; st->blk_k0 = blk_k0;
    return 0;
}

// Flush the partial staging block, min-max normalize out in place, and
// free the state.  Returns 0 on success, -1 if fewer than T frames were
// fed.
int mg_pack_finish(void* handle, float* out) {
    PackState* st = static_cast<PackState*>(handle);
    if (st->t != st->T) { std::free(st); return -1; }
    if (st->blk_fill > 0) {
        flush_block(st->mblk, st->pblk, st->n_bins, st->n_vec, out,
                    st->blk_fill, st->blk_k0);
    }

    float m_min = st->mlo[0], m_max = st->mhi[0];
    float p_min = st->plo[0], p_max = st->phi_[0];
    for (int j = 1; j < kLanes; ++j) {
        m_min = st->mlo[j] < m_min ? st->mlo[j] : m_min;
        m_max = st->mhi[j] > m_max ? st->mhi[j] : m_max;
        p_min = st->plo[j] < p_min ? st->plo[j] : p_min;
        p_max = st->phi_[j] > p_max ? st->phi_[j] : p_max;
    }
    const int64_t n_chunks = (st->T - 1) / st->n_vec;
    const int64_t chan_stride = st->n_bins * st->n_vec;
    const int64_t chunk_stride = 2 * chan_stride;
    std::free(st);

    // final: normalize in place, float32 op order matching the numpy mirror
    const float m_scale = (float)(2.0 / (double)(m_max - m_min));
    const float p_scale = (float)(2.0 / (double)(p_max - p_min));
    for (int64_t c = 0; c < n_chunks; ++c) {
        float* mp = out + c * chunk_stride;
        float* pp = mp + chan_stride;
#ifdef __AVX512F__
        // streaming stores skip read-for-ownership on the large out
        // planes; fmsub keeps the contracted rounding g++ already uses
        // for the scalar form below (-ffp-contract), so both paths are
        // bit-identical
        if (chan_stride % 16 == 0 &&
            (reinterpret_cast<uintptr_t>(mp) & 63) == 0) {
            const __m512 mmn = _mm512_set1_ps(m_min);
            const __m512 msc = _mm512_set1_ps(m_scale);
            const __m512 pmn = _mm512_set1_ps(p_min);
            const __m512 psc = _mm512_set1_ps(p_scale);
            const __m512 one = _mm512_set1_ps(1.0f);
            for (int64_t j = 0; j < chan_stride; j += 16) {
                _mm512_stream_ps(mp + j, _mm512_fmsub_ps(
                    _mm512_sub_ps(_mm512_load_ps(mp + j), mmn), msc, one));
            }
            for (int64_t j = 0; j < chan_stride; j += 16) {
                _mm512_stream_ps(pp + j, _mm512_fmsub_ps(
                    _mm512_sub_ps(_mm512_load_ps(pp + j), pmn), psc, one));
            }
            continue;
        }
#endif
        for (int64_t j = 0; j < chan_stride; ++j) {
            mp[j] = (mp[j] - m_min) * m_scale - 1.0f;
        }
        for (int64_t j = 0; j < chan_stride; ++j) {
            pp[j] = (pp[j] - p_min) * p_scale - 1.0f;
        }
    }
#ifdef __AVX512F__
    _mm_sfence();  // order NT stores before the caller reads `out`
#endif
    return 0;
}

// z:    (T, ld) complex64, row-major, interleaved re/im (frame-major, the
//       batched-rfft layout); only the first n_bins columns are used (the
//       caller drops the Nyquist bin by passing n_bins = ld - 1).
// bark: (n_bins,) float32 per-bin magnitude weight
// out:  (n_chunks, 2, n_bins, n_vec) float32, n_chunks = (T-1)/n_vec
// Returns 0 on success, -1 on bad geometry, -2 on allocation failure.
// One-shot wrapper over the streaming API (single block): both entries
// share every arithmetic path.
int mg_magn_phase_pack(const float* z, int64_t T, int64_t ld, int64_t n_bins,
                       const float* bark, int64_t n_vec, float* out) {
    void* st = mg_pack_begin(T, ld, n_bins, bark, n_vec);
    if (!st) {
        // distinguish geometry from allocation like the old contract
        const int64_t td = T - 1;
        if (td < n_vec || n_vec <= 0 || n_bins <= 0 || n_bins > ld) return -1;
        return -2;
    }
    if (mg_pack_frames(st, z, T, out) != 0) {
        mg_pack_free(st);
        return -1;
    }
    return mg_pack_finish(st, out);
}

}  // extern "C"
