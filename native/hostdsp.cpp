// Native host-side DSP engine for tetraear_tpu.
//
// The device (GPU) does the dense math; these are the host runtime's hot
// byte/bit loops, where the Python interpreter cost dominates:
//
//   * crc16_ccitt        — the reference's bitwise CRC (poly 0x1021,
//                          init 0xFFFF, MSB-first; tetraear/core/
//                          protocol.py:331-347 semantics)
//   * soft_crc_check     — reference _check_crc: <=budget bit errors on
//                          the forward OR reversed payload (protocol.py:
//                          292-329), degenerate all-0/all-1 rejected
//   * soft_crc_check_batch — the same over (F, D) frame batches (the
//                          host decode path's per-frame gate)
//   * sc16q11_to_cf32    — BladeRF SC16-Q11 interleaved int16 -> float32
//                          I/Q pairs scaled by 1/2048 (io/capture.py:95)
//   * fm_discriminator   — angle(x[n] * conj(x[n-1])) / pi * 0.5, the
//                          raw-audio "buzz" monitor (ui/modern.py:
//                          2047-2068 analogue in ui/capture_loop.py)
//
// Exposed with C linkage for the ctypes loader (utils/native_dsp.py);
// every entry point has a pure-Python fallback so behavior is identical
// without the toolchain.

#include <cmath>
#include <cstdint>

extern "C" {

uint16_t crc16_ccitt(const uint8_t *bits, long n) {
    uint32_t crc = 0xFFFF;
    for (long i = 0; i < n; ++i) {
        crc ^= (uint32_t)(bits[i] & 1) << 15;
        if (crc & 0x8000)
            crc = ((crc << 1) ^ 0x1021) & 0xFFFF;
        else
            crc = (crc << 1) & 0xFFFF;
    }
    return (uint16_t)crc;
}

static int crc_err_count(const uint8_t *payload, long m,
                         const uint8_t *received, int reversed_order) {
    uint32_t crc = 0xFFFF;
    if (reversed_order) {
        for (long i = m - 1; i >= 0; --i) {
            crc ^= (uint32_t)(payload[i] & 1) << 15;
            crc = (crc & 0x8000) ? ((crc << 1) ^ 0x1021) & 0xFFFF
                                 : (crc << 1) & 0xFFFF;
        }
    } else {
        crc = crc16_ccitt(payload, m);
    }
    int errs = 0;
    for (int s = 0; s < 16; ++s) {
        int bit = (crc >> (15 - s)) & 1;
        errs += (bit != (received[s] & 1));
    }
    return errs;
}

int soft_crc_check(const uint8_t *data, long n, int budget) {
    if (n < 16) return 0;
    long ones = 0;
    for (long i = 0; i < n; ++i) ones += data[i] & 1;
    if (ones == 0 || ones == n) return 0;
    const uint8_t *received = data + (n - 16);
    if (crc_err_count(data, n - 16, received, 0) <= budget) return 1;
    if (crc_err_count(data, n - 16, received, 1) <= budget) return 1;
    return 0;
}

void soft_crc_check_batch(const uint8_t *frames, long f, long d,
                          int budget, uint8_t *out) {
    for (long i = 0; i < f; ++i)
        out[i] = (uint8_t)soft_crc_check(frames + i * d, d, budget);
}

void sc16q11_to_cf32(const int16_t *in, long n_pairs, float *out) {
    const float scale = 1.0f / 2048.0f;
    for (long i = 0; i < 2 * n_pairs; ++i)
        out[i] = (float)in[i] * scale;
}

// audio[i] = angle(x[i+1] * conj(x[i])) / pi * 0.5 over interleaved
// float32 I/Q; writes n-1 samples.
void fm_discriminator(const float *iq, long n, float *out) {
    const float inv_pi_half = 0.5f / (float)M_PI;
    for (long i = 0; i + 1 < n; ++i) {
        float ar = iq[2 * i], ai = iq[2 * i + 1];
        float br = iq[2 * i + 2], bi = iq[2 * i + 3];
        // b * conj(a)
        float re = br * ar + bi * ai;
        float im = bi * ar - br * ai;
        out[i] = atan2f(im, re) * inv_pi_half;
    }
}

}  // extern "C"
