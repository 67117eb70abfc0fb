// The exact fixed-point `cossin` NCO as a device function (reference
// src/cossin.rs:14-67), bit-identical to `ops.trig.cossin` and to the
// TPU kernels' in-kernel `trig.cossin` (idsp_tpu/ops/trig.py:114, the
// octant fold, the 7-bit LUT, first-order interpolation, the unmap).
//
// On the TPU the 128-entry lookup was a compare/select chain of 128
// steps per sample; here it is one load from a copy of the table in
// shared memory.  The caller copies `kCosSinLut` there once per block
// (`load_cossin_lut`): the 32 lanes of a warp index it at up to 32
// different words, which shared memory serves in one pass (at most one
// word per bank), where the constant cache would serialize them.
//
// Every intermediate fits in int32 (|p| <= 2^14, |dphi| <= 12868, the
// LUT halves below 2^17); the sums that `ops.trig.cossin` forms in int64
// and wraps are formed here in uint32, where wrapping is defined.
#pragma once

#include <cstdint>

namespace idsp {

// luts.cossin_table() (build.rs:8-41): cos excess in the low 16 bits,
// sin in the high 16 (held equal to it by the CPU tests)
static __constant__ uint32_t kCosSinLut[128] = {
    0x00C9FFFDu, 0x025BFFF8u, 0x03EDFFEFu, 0x057FFFE0u,
    0x0711FFCCu, 0x08A3FFB3u, 0x0A35FF96u, 0x0BC7FF73u,
    0x0D58FF4Cu, 0x0EEAFF1Fu, 0x107BFEEEu, 0x120DFEB8u,
    0x139EFE7Du, 0x152EFE3Du, 0x16BFFDF8u, 0x184FFDAEu,
    0x19E0FD5Fu, 0x1B70FD0Bu, 0x1CFFFCB2u, 0x1E8FFC55u,
    0x201EFBF2u, 0x21ACFB8Bu, 0x233BFB1Fu, 0x24C9FAAEu,
    0x2657FA38u, 0x27E4F9BDu, 0x2971F93Du, 0x2AFEF8B8u,
    0x2C8AF82Fu, 0x2E16F7A1u, 0x2FA1F70Du, 0x312CF675u,
    0x32B6F5D8u, 0x3440F537u, 0x35CAF490u, 0x3753F3E5u,
    0x38DBF335u, 0x3A63F280u, 0x3BEAF1C6u, 0x3D71F107u,
    0x3EF7F044u, 0x407CEF7Bu, 0x4201EEAFu, 0x4385EDDDu,
    0x4509ED06u, 0x468CEC2Bu, 0x480EEB4Bu, 0x498FEA66u,
    0x4B10E97Du, 0x4C90E88Fu, 0x4E10E79Cu, 0x4F8EE6A4u,
    0x510CE5A8u, 0x5289E4A7u, 0x5405E3A1u, 0x5581E297u,
    0x56FBE188u, 0x5875E075u, 0x59EEDF5Cu, 0x5B66DE40u,
    0x5CDDDD1Eu, 0x5E53DBF8u, 0x5FC9DACDu, 0x613DD99Eu,
    0x62B1D86Au, 0x6423D732u, 0x6595D5F5u, 0x6706D4B4u,
    0x6875D36Eu, 0x69E4D224u, 0x6B51D0D5u, 0x6CBECF81u,
    0x6E29CE29u, 0x6F94CCCDu, 0x70FDCB6Cu, 0x7266CA07u,
    0x73CDC89Eu, 0x7533C730u, 0x7698C5BDu, 0x77FCC446u,
    0x795EC2CBu, 0x7AC0C14Cu, 0x7C20BFC8u, 0x7D7FBE40u,
    0x7EDDBCB4u, 0x803ABB23u, 0x8195B98Eu, 0x82EFB7F5u,
    0x8448B657u, 0x85A0B4B6u, 0x86F6B310u, 0x884BB166u,
    0x899FAFB7u, 0x8AF1AE05u, 0x8C42AC4Eu, 0x8D92AA94u,
    0x8EE0A8D5u, 0x902DA712u, 0x9179A54Bu, 0x92C3A380u,
    0x940CA1B1u, 0x95539FDEu, 0x96999E07u, 0x97DD9C2Bu,
    0x99209A4Cu, 0x9A629869u, 0x9BA29682u, 0x9CE19497u,
    0x9E1E92A9u, 0x9F5990B6u, 0xA0938EBFu, 0xA1CB8CC5u,
    0xA3028AC7u, 0xA43788C5u, 0xA56B86BFu, 0xA69D84B6u,
    0xA7CE82A8u, 0xA8FD8097u, 0xAA2A7E82u, 0xAB557C6Au,
    0xAC7F7A4Eu, 0xADA8782Eu, 0xAECE760Bu, 0xAFF373E4u,
    0xB11671B9u, 0xB2386F8Bu, 0xB3586D5Au, 0xB4766B24u};

constexpr int kCosSinLutSize = 128;

// Copy the LUT into the block's shared array `lut`; every thread of the
// block calls it, before any thread reads `lut`.
__device__ __forceinline__ void load_cossin_lut(uint32_t* lut) {
  for (int i = threadIdx.x; i < kCosSinLutSize; i += blockDim.x)
    lut[i] = kCosSinLut[i];
  __syncthreads();
}

struct CosSin {
  int32_t cos, sin;  // amplitude ~(2^31 - 2^15)
};

// (cos, sin) of the wrapping 32-bit phase (i32::MIN = -pi), `lut` the
// block's shared copy of kCosSinLut
__device__ __forceinline__ CosSin cossin(const uint32_t* lut,
                                         uint32_t phase) {
  constexpr int kAlignMsb = 15;  // 32 - 16 - 1
  constexpr int kDepth = 7;
  constexpr int32_t kPi4 = 51471;  // pi/4 in Q16, truncated
  // fold the octants with phase inversion: !phase when bit 29 is set
  const uint32_t ph = (phase & (1u << 29)) ? ~phase : phase;
  // the in-octant angle on kDepth + kAlignMsb bits
  const uint32_t p22 = ((ph & 0x1FFFFFFFu) << 3) >> (32 - kDepth - kAlignMsb);
  const uint32_t idx = p22 >> kAlignMsb;
  // about the LUT entry's midpoint
  const int32_t p = static_cast<int32_t>(p22 & ((1u << kAlignMsb) - 1)) -
                    (1 << (kAlignMsb - 1));
  const int32_t dphi = (p * kPi4) >> 16;
  const uint32_t packed = lut[idx];
  const int32_t c0 = static_cast<int32_t>(packed & 0xFFFFu) + (1 << 16);
  const int32_t s0 = static_cast<int32_t>(packed >> 16);
  const int32_t dcos = (s0 * dphi) >> kDepth;
  const int32_t dsin = (c0 * dphi) >> (kDepth + 1);
  uint32_t cs = (static_cast<uint32_t>(c0) << (kAlignMsb - 1)) -
                static_cast<uint32_t>(dcos);
  uint32_t sn = (static_cast<uint32_t>(s0) << kAlignMsb) +
                static_cast<uint32_t>(dsin);
  // unmap the octants (gray-ish decode of the top three bits)
  const uint32_t g = phase ^ (phase >> 1);
  if (g & (1u << 29)) {
    const uint32_t s = cs;
    cs = sn;
    sn = s;
  }
  if (g & (1u << 30)) cs = 0u - cs;
  if (g & (1u << 31)) sn = 0u - sn;
  return CosSin{static_cast<int32_t>(cs), static_cast<int32_t>(sn)};
}

}  // namespace idsp
