// Shared LIF epilogue of the port's tick kernels (lif_step.cu, tick_fused.cu,
// and later the event kernels).
//
// Replaces repro/kernels/lif_step.py::_lif_epilogue. One thread owns one
// neuron of one batch row: the synaptic sum arrives in a register, the update
// runs in registers, and only v', r', y' leave the SM.
//
// Rounding: every operation below is an explicit round-to-nearest intrinsic
// (__fadd_rn, __fmul_rn, __fsub_rn), which the compiler never contracts into
// an FMA, in the reference's association order:
//   fixed_leak: ((v + syn) + i_bias) - sign(v) * min(leak * active, |v|)
//   euler:      (1 - leak) * v + gain * (syn + i_bias)
// so each result rounds exactly as the plain PyTorch twin's separate
// elementwise ops do. The sources are also compiled with --fmad=false.
#pragma once

namespace repro_torch {

enum LifMode : int { kFixedLeak = 0, kEuler = 1 };

// The six per-neuron parameter rows of one slot, already offset to the slot.
struct LifRows {
  const float* v_th;
  const float* leak;
  const int* r_ref;
  const float* gain;
  const float* i_bias;
  const float* v_reset;
};

// jnp.sign: 0 at +0 and -0 (copysignf would give +-1 there).
__device__ __forceinline__ float lif_sign(float v) {
  return static_cast<float>((v > 0.0f) - (v < 0.0f));
}

// One neuron's tick: syn is the synaptic sum with the drive already added.
__device__ __forceinline__ void lif_epilogue(int mode, float syn, float v, int r,
                                             const LifRows& p, int n, float* v_new,
                                             int* r_new, float* y) {
  float v_tilde;
  if (mode == kEuler) {
    v_tilde = __fadd_rn(__fmul_rn(__fsub_rn(1.0f, p.leak[n]), v),
                        __fmul_rn(p.gain[n], __fadd_rn(syn, p.i_bias[n])));
  } else {
    const float active = (v != 0.0f) ? 1.0f : 0.0f;
    const float leak_step = fminf(__fmul_rn(p.leak[n], active), fabsf(v));
    v_tilde = __fsub_rn(__fadd_rn(__fadd_rn(v, syn), p.i_bias[n]),
                        __fmul_rn(lif_sign(v), leak_step));
  }
  const bool spiked = (v_tilde >= p.v_th[n]) && (r == 0);
  const bool hold = spiked || (r > 0);
  *v_new = hold ? p.v_reset[n] : v_tilde;
  *r_new = spiked ? p.r_ref[n] : max(r - 1, 0);
  *y = spiked ? 1.0f : 0.0f;
}

}  // namespace repro_torch
