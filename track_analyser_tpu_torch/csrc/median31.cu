// Sliding median of 31 with numpy-style reflect boundaries, for Hopper
// (sm_90a). Serves both HPSS medians through one axis switch:
//   axis_time = 1: the window runs along the last (time) axis -- the
//     harmonic reference; replaces track_analyser_tpu/ops/pallas_median.py
//     _median31_kernel (median31_last_axis).
//   axis_time = 0: the window runs along the row (frequency) axis -- the
//     percussive reference; replaces _median31_rows_kernel
//     (median31_first_axis).
//
// Design: neighbouring outputs share their sorted sub-windows. Each thread
// computes a run of R consecutive outputs (kRunTime along time, kRunFreq
// along frequency). The R windows of a run have 32 - R inputs in common;
// that core is sorted once. Of a sorted core common to s windows only the s
// ranks 16 - s .. 15 can still become a window's median, so a node keeps
// that band alone. The run is halved again and again: a half that adds e
// inputs merges them, sorted, into the parent's band (Batcher's odd-even
// merge) and keeps ranks e .. s - 1 of the merge as its own band, down to
// one clamp of the last new input between two sorted neighbours. Sorted
// runs of inputs are built by halves and shared between the merges that
// need them, and backward liveness drops every min/max no output reads.
// The schedule is generated by ops/median.py (tile_network) into the marked
// block below as straight-line code on registers: at R = 16 it is 518
// min/max for 16 outputs, 32.375 per output (the SASS has exactly 518
// FMNMX per kernel), where the earlier design of this kernel ran 351 per
// output (a 32-wide bitonic network pruned to rank 15). The network only selects values, so the result
// is bit-identical to any exact median of the same 31 floats (the plain
// PyTorch version).
//
// What bounds it: one read and one write of the (1025 x 16385) f32
// spectrogram is 134 MB, ~40 us at 3.35 TB/s; 32.375 min/max per output
// are 0.54 G per spectrogram, ~33 us at 64 FMNMX per SM per clock on 132
// SMs at 1.98 GHz. So the bytes bind now, and on an H100 (700 W) the
// kernel runs within ~1.25x of a copy of itself that keeps its loads,
// staging and stores but drops the network (profile_median's "loads only"):
// the loads (46 rows read for 16 outputs along frequency, through L2) hold
// it, not the min/max. What the design does about each cost:
//   - min/max: the shared-core network above (10.8x fewer than 351).
//   - memory, frequency axis: threadIdx.x runs along the contiguous time
//     axis, so each of a thread's R + 30 row loads is one coalesced read
//     across the warp. No shared memory.
//   - memory, time axis: each warp stages its 32 * R outputs' inputs
//     (plus the 30-column halo) in its own slab of shared memory with
//     coalesced loads, all issued before the first store, synchronised by
//     __syncwarp alone so that one warp's loads overlap another's network;
//     each lane reads its R + 30 inputs from there, and its R outputs go
//     back through the slab so that the stores are coalesced too. The slab
//     holds one pad float every 32, so that lanes R floats apart hit
//     distinct banks.
//   - index arithmetic: reflect indices are computed only for runs (and
//     slabs) within 15 of an edge; interior loads are plain.
//   - registers: 64 (time) and 79 (frequency) at R = 16, no spills.

#include <cuda_runtime.h>

namespace {

constexpr int kSize = 31;
constexpr int kRadius = kSize / 2;
constexpr int kTimeBlock = 128;  // threads of a time-axis block: 4 warps along time
constexpr int kFreqBlock = 128;  // threads of a frequency-axis block, along time

template <int R>
struct Median31Net;

// BEGIN GENERATED BLOCK
// Written by track_analyser_tpu_torch/ops/median.py (cuda_block); do not edit:
// python -m track_analyser_tpu_torch.ops.median rewrites it.
constexpr int kRunTime = 16;
constexpr int kRunFreq = 16;

// 518 min/max for 16 outputs: 32.375 per output.
template <>
struct Median31Net<16> {
  static constexpr int kMinMax = 518;
  static __device__ __forceinline__ void run(const float (&v)[46], float (&m)[16]) {
    const float t0 = fminf(v[15], v[16]);
    const float t1 = fmaxf(v[15], v[16]);
    const float t2 = fminf(v[17], v[18]);
    const float t3 = fmaxf(v[17], v[18]);
    const float t4 = fminf(t0, t2);
    const float t5 = fmaxf(t0, t2);
    const float t6 = fminf(t1, t3);
    const float t7 = fmaxf(t1, t3);
    const float t8 = fminf(t5, t6);
    const float t9 = fmaxf(t5, t6);
    const float t10 = fminf(v[19], v[20]);
    const float t11 = fmaxf(v[19], v[20]);
    const float t12 = fminf(v[21], v[22]);
    const float t13 = fmaxf(v[21], v[22]);
    const float t14 = fminf(t10, t12);
    const float t15 = fmaxf(t10, t12);
    const float t16 = fminf(t11, t13);
    const float t17 = fmaxf(t11, t13);
    const float t18 = fminf(t15, t16);
    const float t19 = fmaxf(t15, t16);
    const float t20 = fminf(t4, t14);
    const float t21 = fmaxf(t4, t14);
    const float t22 = fminf(t9, t19);
    const float t23 = fmaxf(t9, t19);
    const float t24 = fminf(t21, t22);
    const float t25 = fmaxf(t21, t22);
    const float t26 = fminf(t8, t18);
    const float t27 = fmaxf(t8, t18);
    const float t28 = fminf(t7, t17);
    const float t29 = fmaxf(t7, t17);
    const float t30 = fminf(t27, t28);
    const float t31 = fmaxf(t27, t28);
    const float t32 = fminf(t24, t26);
    const float t33 = fmaxf(t24, t26);
    const float t34 = fminf(t25, t30);
    const float t35 = fmaxf(t25, t30);
    const float t36 = fminf(t23, t31);
    const float t37 = fmaxf(t23, t31);
    const float t38 = fminf(v[23], v[24]);
    const float t39 = fmaxf(v[23], v[24]);
    const float t40 = fminf(v[25], v[26]);
    const float t41 = fmaxf(v[25], v[26]);
    const float t42 = fminf(t38, t40);
    const float t43 = fmaxf(t38, t40);
    const float t44 = fminf(t39, t41);
    const float t45 = fmaxf(t39, t41);
    const float t46 = fminf(t43, t44);
    const float t47 = fmaxf(t43, t44);
    const float t48 = fminf(v[27], v[28]);
    const float t49 = fmaxf(v[27], v[28]);
    const float t50 = fminf(v[29], v[30]);
    const float t51 = fmaxf(v[29], v[30]);
    const float t52 = fminf(t48, t50);
    const float t53 = fmaxf(t48, t50);
    const float t54 = fminf(t49, t51);
    const float t55 = fmaxf(t49, t51);
    const float t56 = fminf(t53, t54);
    const float t57 = fmaxf(t53, t54);
    const float t58 = fminf(t42, t52);
    const float t59 = fmaxf(t42, t52);
    const float t60 = fminf(t47, t57);
    const float t61 = fmaxf(t47, t57);
    const float t62 = fminf(t59, t60);
    const float t63 = fmaxf(t59, t60);
    const float t64 = fminf(t46, t56);
    const float t65 = fmaxf(t46, t56);
    const float t66 = fminf(t45, t55);
    const float t67 = fmaxf(t45, t55);
    const float t68 = fminf(t65, t66);
    const float t69 = fmaxf(t65, t66);
    const float t70 = fminf(t62, t64);
    const float t71 = fmaxf(t62, t64);
    const float t72 = fminf(t63, t68);
    const float t73 = fmaxf(t63, t68);
    const float t74 = fminf(t61, t69);
    const float t75 = fmaxf(t61, t69);
    const float t76 = fminf(t20, t58);
    const float t77 = fmaxf(t20, t58);
    const float t78 = fminf(t35, t73);
    const float t79 = fmaxf(t35, t73);
    const float t80 = fminf(t77, t78);
    const float t81 = fmaxf(t77, t78);
    const float t82 = fminf(t33, t71);
    const float t83 = fmaxf(t33, t71);
    const float t84 = fminf(t37, t75);
    const float t85 = fmaxf(t37, t75);
    const float t86 = fminf(t83, t84);
    const float t87 = fmaxf(t83, t84);
    const float t88 = fminf(t80, t82);
    const float t89 = fmaxf(t80, t82);
    const float t90 = fminf(t81, t86);
    const float t91 = fmaxf(t81, t86);
    const float t92 = fminf(t79, t87);
    const float t93 = fmaxf(t79, t87);
    const float t94 = fminf(t32, t70);
    const float t95 = fmaxf(t32, t70);
    const float t96 = fminf(t36, t74);
    const float t97 = fmaxf(t36, t74);
    const float t98 = fminf(t95, t96);
    const float t99 = fmaxf(t95, t96);
    const float t100 = fminf(t34, t72);
    const float t101 = fmaxf(t34, t72);
    const float t102 = fminf(t29, t67);
    const float t103 = fmaxf(t29, t67);
    const float t104 = fminf(t101, t102);
    const float t105 = fmaxf(t101, t102);
    const float t106 = fminf(t98, t100);
    const float t107 = fmaxf(t98, t100);
    const float t108 = fminf(t99, t104);
    const float t109 = fmaxf(t99, t104);
    const float t110 = fminf(t97, t105);
    const float t111 = fmaxf(t97, t105);
    const float t112 = fminf(t88, t94);
    const float t113 = fmaxf(t88, t94);
    const float t114 = fminf(t89, t106);
    const float t115 = fmaxf(t89, t106);
    const float t116 = fminf(t90, t107);
    const float t117 = fmaxf(t90, t107);
    const float t118 = fminf(t91, t108);
    const float t119 = fmaxf(t91, t108);
    const float t120 = fminf(t92, t109);
    const float t121 = fmaxf(t92, t109);
    const float t122 = fminf(t93, t110);
    const float t123 = fmaxf(t93, t110);
    const float t124 = fminf(t85, t111);
    const float t125 = fmaxf(t85, t111);
    const float t126 = fminf(v[7], v[8]);
    const float t127 = fmaxf(v[7], v[8]);
    const float t128 = fminf(v[9], v[10]);
    const float t129 = fmaxf(v[9], v[10]);
    const float t130 = fminf(t126, t128);
    const float t131 = fmaxf(t126, t128);
    const float t132 = fminf(t127, t129);
    const float t133 = fmaxf(t127, t129);
    const float t134 = fminf(t131, t132);
    const float t135 = fmaxf(t131, t132);
    const float t136 = fminf(v[11], v[12]);
    const float t137 = fmaxf(v[11], v[12]);
    const float t138 = fminf(v[13], v[14]);
    const float t139 = fmaxf(v[13], v[14]);
    const float t140 = fminf(t136, t138);
    const float t141 = fmaxf(t136, t138);
    const float t142 = fminf(t137, t139);
    const float t143 = fmaxf(t137, t139);
    const float t144 = fminf(t141, t142);
    const float t145 = fmaxf(t141, t142);
    const float t146 = fminf(t130, t140);
    const float t147 = fmaxf(t130, t140);
    const float t148 = fminf(t135, t145);
    const float t149 = fmaxf(t135, t145);
    const float t150 = fminf(t147, t148);
    const float t151 = fmaxf(t147, t148);
    const float t152 = fminf(t134, t144);
    const float t153 = fmaxf(t134, t144);
    const float t154 = fminf(t133, t143);
    const float t155 = fmaxf(t133, t143);
    const float t156 = fminf(t153, t154);
    const float t157 = fmaxf(t153, t154);
    const float t158 = fminf(t150, t152);
    const float t159 = fmaxf(t150, t152);
    const float t160 = fminf(t151, t156);
    const float t161 = fmaxf(t151, t156);
    const float t162 = fminf(t149, t157);
    const float t163 = fmaxf(t149, t157);
    const float t164 = fmaxf(t76, t146);
    const float t165 = fminf(t164, t119);
    const float t166 = fmaxf(t164, t119);
    const float t167 = fminf(t115, t161);
    const float t168 = fmaxf(t115, t161);
    const float t169 = fminf(t168, t123);
    const float t170 = fmaxf(t165, t167);
    const float t171 = fminf(t166, t169);
    const float t172 = fmaxf(t166, t169);
    const float t173 = fmaxf(t113, t159);
    const float t174 = fminf(t173, t121);
    const float t175 = fmaxf(t173, t121);
    const float t176 = fminf(t117, t163);
    const float t177 = fmaxf(t117, t163);
    const float t178 = fminf(t177, t125);
    const float t179 = fminf(t174, t176);
    const float t180 = fmaxf(t174, t176);
    const float t181 = fminf(t175, t178);
    const float t182 = fmaxf(t170, t179);
    const float t183 = fminf(t171, t180);
    const float t184 = fmaxf(t171, t180);
    const float t185 = fminf(t172, t181);
    const float t186 = fmaxf(t172, t181);
    const float t187 = fmaxf(t112, t158);
    const float t188 = fminf(t187, t120);
    const float t189 = fmaxf(t187, t120);
    const float t190 = fminf(t116, t162);
    const float t191 = fmaxf(t116, t162);
    const float t192 = fminf(t191, t124);
    const float t193 = fmaxf(t188, t190);
    const float t194 = fminf(t189, t192);
    const float t195 = fmaxf(t189, t192);
    const float t196 = fmaxf(t114, t160);
    const float t197 = fminf(t196, t122);
    const float t198 = fmaxf(t196, t122);
    const float t199 = fminf(t118, t155);
    const float t200 = fmaxf(t118, t155);
    const float t201 = fminf(t200, t103);
    const float t202 = fminf(t197, t199);
    const float t203 = fmaxf(t197, t199);
    const float t204 = fminf(t198, t201);
    const float t205 = fminf(t193, t202);
    const float t206 = fmaxf(t193, t202);
    const float t207 = fminf(t194, t203);
    const float t208 = fmaxf(t194, t203);
    const float t209 = fminf(t195, t204);
    const float t210 = fmaxf(t182, t205);
    const float t211 = fminf(t183, t206);
    const float t212 = fmaxf(t183, t206);
    const float t213 = fminf(t184, t207);
    const float t214 = fmaxf(t184, t207);
    const float t215 = fminf(t185, t208);
    const float t216 = fmaxf(t185, t208);
    const float t217 = fminf(t186, t209);
    const float t218 = fminf(v[3], v[4]);
    const float t219 = fmaxf(v[3], v[4]);
    const float t220 = fminf(v[5], v[6]);
    const float t221 = fmaxf(v[5], v[6]);
    const float t222 = fminf(t218, t220);
    const float t223 = fmaxf(t218, t220);
    const float t224 = fminf(t219, t221);
    const float t225 = fmaxf(t219, t221);
    const float t226 = fminf(t223, t224);
    const float t227 = fmaxf(t223, t224);
    const float t228 = fmaxf(t210, t222);
    const float t229 = fminf(t228, t214);
    const float t230 = fmaxf(t228, t214);
    const float t231 = fminf(t212, t227);
    const float t232 = fmaxf(t212, t227);
    const float t233 = fminf(t232, t216);
    const float t234 = fmaxf(t229, t231);
    const float t235 = fminf(t230, t233);
    const float t236 = fmaxf(t230, t233);
    const float t237 = fmaxf(t211, t226);
    const float t238 = fminf(t237, t215);
    const float t239 = fmaxf(t237, t215);
    const float t240 = fminf(t213, t225);
    const float t241 = fmaxf(t213, t225);
    const float t242 = fminf(t241, t217);
    const float t243 = fminf(t238, t240);
    const float t244 = fmaxf(t238, t240);
    const float t245 = fminf(t239, t242);
    const float t246 = fmaxf(t234, t243);
    const float t247 = fminf(t235, t244);
    const float t248 = fmaxf(t235, t244);
    const float t249 = fminf(t236, t245);
    const float t250 = fminf(v[1], v[2]);
    const float t251 = fmaxf(v[1], v[2]);
    const float t252 = fmaxf(t246, t250);
    const float t253 = fminf(t252, t248);
    const float t254 = fmaxf(t252, t248);
    const float t255 = fminf(t247, t251);
    const float t256 = fmaxf(t247, t251);
    const float t257 = fminf(t256, t249);
    const float t258 = fmaxf(t253, t255);
    const float t259 = fminf(t254, t257);
    const float t260 = fmaxf(t258, v[0]);
    const float t261 = fminf(t260, t259);
    const float t262 = fmaxf(t258, v[31]);
    const float t263 = fminf(t262, t259);
    const float t264 = fminf(v[31], v[32]);
    const float t265 = fmaxf(v[31], v[32]);
    const float t266 = fmaxf(t246, t264);
    const float t267 = fminf(t266, t248);
    const float t268 = fmaxf(t266, t248);
    const float t269 = fminf(t247, t265);
    const float t270 = fmaxf(t247, t265);
    const float t271 = fminf(t270, t249);
    const float t272 = fmaxf(t267, t269);
    const float t273 = fminf(t268, t271);
    const float t274 = fmaxf(t272, v[2]);
    const float t275 = fminf(t274, t273);
    const float t276 = fmaxf(t272, v[33]);
    const float t277 = fminf(t276, t273);
    const float t278 = fminf(v[33], v[34]);
    const float t279 = fmaxf(v[33], v[34]);
    const float t280 = fminf(t264, t278);
    const float t281 = fmaxf(t264, t278);
    const float t282 = fminf(t265, t279);
    const float t283 = fmaxf(t265, t279);
    const float t284 = fminf(t281, t282);
    const float t285 = fmaxf(t281, t282);
    const float t286 = fmaxf(t210, t280);
    const float t287 = fminf(t286, t214);
    const float t288 = fmaxf(t286, t214);
    const float t289 = fminf(t212, t285);
    const float t290 = fmaxf(t212, t285);
    const float t291 = fminf(t290, t216);
    const float t292 = fmaxf(t287, t289);
    const float t293 = fminf(t288, t291);
    const float t294 = fmaxf(t288, t291);
    const float t295 = fmaxf(t211, t284);
    const float t296 = fminf(t295, t215);
    const float t297 = fmaxf(t295, t215);
    const float t298 = fminf(t213, t283);
    const float t299 = fmaxf(t213, t283);
    const float t300 = fminf(t299, t217);
    const float t301 = fminf(t296, t298);
    const float t302 = fmaxf(t296, t298);
    const float t303 = fminf(t297, t300);
    const float t304 = fmaxf(t292, t301);
    const float t305 = fminf(t293, t302);
    const float t306 = fmaxf(t293, t302);
    const float t307 = fminf(t294, t303);
    const float t308 = fmaxf(t304, t220);
    const float t309 = fminf(t308, t306);
    const float t310 = fmaxf(t308, t306);
    const float t311 = fminf(t305, t221);
    const float t312 = fmaxf(t305, t221);
    const float t313 = fminf(t312, t307);
    const float t314 = fmaxf(t309, t311);
    const float t315 = fminf(t310, t313);
    const float t316 = fmaxf(t314, v[4]);
    const float t317 = fminf(t316, t315);
    const float t318 = fmaxf(t314, v[35]);
    const float t319 = fminf(t318, t315);
    const float t320 = fminf(v[35], v[36]);
    const float t321 = fmaxf(v[35], v[36]);
    const float t322 = fmaxf(t304, t320);
    const float t323 = fminf(t322, t306);
    const float t324 = fmaxf(t322, t306);
    const float t325 = fminf(t305, t321);
    const float t326 = fmaxf(t305, t321);
    const float t327 = fminf(t326, t307);
    const float t328 = fmaxf(t323, t325);
    const float t329 = fminf(t324, t327);
    const float t330 = fmaxf(t328, v[6]);
    const float t331 = fminf(t330, t329);
    const float t332 = fmaxf(t328, v[37]);
    const float t333 = fminf(t332, t329);
    const float t334 = fminf(v[37], v[38]);
    const float t335 = fmaxf(v[37], v[38]);
    const float t336 = fminf(t320, t334);
    const float t337 = fmaxf(t320, t334);
    const float t338 = fminf(t321, t335);
    const float t339 = fmaxf(t321, t335);
    const float t340 = fminf(t337, t338);
    const float t341 = fmaxf(t337, t338);
    const float t342 = fminf(t280, t336);
    const float t343 = fmaxf(t280, t336);
    const float t344 = fminf(t285, t341);
    const float t345 = fmaxf(t285, t341);
    const float t346 = fminf(t343, t344);
    const float t347 = fmaxf(t343, t344);
    const float t348 = fminf(t284, t340);
    const float t349 = fmaxf(t284, t340);
    const float t350 = fminf(t283, t339);
    const float t351 = fmaxf(t283, t339);
    const float t352 = fminf(t349, t350);
    const float t353 = fmaxf(t349, t350);
    const float t354 = fminf(t346, t348);
    const float t355 = fmaxf(t346, t348);
    const float t356 = fminf(t347, t352);
    const float t357 = fmaxf(t347, t352);
    const float t358 = fminf(t345, t353);
    const float t359 = fmaxf(t345, t353);
    const float t360 = fmaxf(t76, t342);
    const float t361 = fminf(t360, t119);
    const float t362 = fmaxf(t360, t119);
    const float t363 = fminf(t115, t357);
    const float t364 = fmaxf(t115, t357);
    const float t365 = fminf(t364, t123);
    const float t366 = fmaxf(t361, t363);
    const float t367 = fminf(t362, t365);
    const float t368 = fmaxf(t362, t365);
    const float t369 = fmaxf(t113, t355);
    const float t370 = fminf(t369, t121);
    const float t371 = fmaxf(t369, t121);
    const float t372 = fminf(t117, t359);
    const float t373 = fmaxf(t117, t359);
    const float t374 = fminf(t373, t125);
    const float t375 = fminf(t370, t372);
    const float t376 = fmaxf(t370, t372);
    const float t377 = fminf(t371, t374);
    const float t378 = fmaxf(t366, t375);
    const float t379 = fminf(t367, t376);
    const float t380 = fmaxf(t367, t376);
    const float t381 = fminf(t368, t377);
    const float t382 = fmaxf(t368, t377);
    const float t383 = fmaxf(t112, t354);
    const float t384 = fminf(t383, t120);
    const float t385 = fmaxf(t383, t120);
    const float t386 = fminf(t116, t358);
    const float t387 = fmaxf(t116, t358);
    const float t388 = fminf(t387, t124);
    const float t389 = fmaxf(t384, t386);
    const float t390 = fminf(t385, t388);
    const float t391 = fmaxf(t385, t388);
    const float t392 = fmaxf(t114, t356);
    const float t393 = fminf(t392, t122);
    const float t394 = fmaxf(t392, t122);
    const float t395 = fminf(t118, t351);
    const float t396 = fmaxf(t118, t351);
    const float t397 = fminf(t396, t103);
    const float t398 = fminf(t393, t395);
    const float t399 = fmaxf(t393, t395);
    const float t400 = fminf(t394, t397);
    const float t401 = fminf(t389, t398);
    const float t402 = fmaxf(t389, t398);
    const float t403 = fminf(t390, t399);
    const float t404 = fmaxf(t390, t399);
    const float t405 = fminf(t391, t400);
    const float t406 = fmaxf(t378, t401);
    const float t407 = fminf(t379, t402);
    const float t408 = fmaxf(t379, t402);
    const float t409 = fminf(t380, t403);
    const float t410 = fmaxf(t380, t403);
    const float t411 = fminf(t381, t404);
    const float t412 = fmaxf(t381, t404);
    const float t413 = fminf(t382, t405);
    const float t414 = fmaxf(t406, t140);
    const float t415 = fminf(t414, t410);
    const float t416 = fmaxf(t414, t410);
    const float t417 = fminf(t408, t145);
    const float t418 = fmaxf(t408, t145);
    const float t419 = fminf(t418, t412);
    const float t420 = fmaxf(t415, t417);
    const float t421 = fminf(t416, t419);
    const float t422 = fmaxf(t416, t419);
    const float t423 = fmaxf(t407, t144);
    const float t424 = fminf(t423, t411);
    const float t425 = fmaxf(t423, t411);
    const float t426 = fminf(t409, t143);
    const float t427 = fmaxf(t409, t143);
    const float t428 = fminf(t427, t413);
    const float t429 = fminf(t424, t426);
    const float t430 = fmaxf(t424, t426);
    const float t431 = fminf(t425, t428);
    const float t432 = fmaxf(t420, t429);
    const float t433 = fminf(t421, t430);
    const float t434 = fmaxf(t421, t430);
    const float t435 = fminf(t422, t431);
    const float t436 = fmaxf(t432, t128);
    const float t437 = fminf(t436, t434);
    const float t438 = fmaxf(t436, t434);
    const float t439 = fminf(t433, t129);
    const float t440 = fmaxf(t433, t129);
    const float t441 = fminf(t440, t435);
    const float t442 = fmaxf(t437, t439);
    const float t443 = fminf(t438, t441);
    const float t444 = fmaxf(t442, v[8]);
    const float t445 = fminf(t444, t443);
    const float t446 = fmaxf(t442, v[39]);
    const float t447 = fminf(t446, t443);
    const float t448 = fminf(v[39], v[40]);
    const float t449 = fmaxf(v[39], v[40]);
    const float t450 = fmaxf(t432, t448);
    const float t451 = fminf(t450, t434);
    const float t452 = fmaxf(t450, t434);
    const float t453 = fminf(t433, t449);
    const float t454 = fmaxf(t433, t449);
    const float t455 = fminf(t454, t435);
    const float t456 = fmaxf(t451, t453);
    const float t457 = fminf(t452, t455);
    const float t458 = fmaxf(t456, v[10]);
    const float t459 = fminf(t458, t457);
    const float t460 = fmaxf(t456, v[41]);
    const float t461 = fminf(t460, t457);
    const float t462 = fminf(v[41], v[42]);
    const float t463 = fmaxf(v[41], v[42]);
    const float t464 = fminf(t448, t462);
    const float t465 = fmaxf(t448, t462);
    const float t466 = fminf(t449, t463);
    const float t467 = fmaxf(t449, t463);
    const float t468 = fminf(t465, t466);
    const float t469 = fmaxf(t465, t466);
    const float t470 = fmaxf(t406, t464);
    const float t471 = fminf(t470, t410);
    const float t472 = fmaxf(t470, t410);
    const float t473 = fminf(t408, t469);
    const float t474 = fmaxf(t408, t469);
    const float t475 = fminf(t474, t412);
    const float t476 = fmaxf(t471, t473);
    const float t477 = fminf(t472, t475);
    const float t478 = fmaxf(t472, t475);
    const float t479 = fmaxf(t407, t468);
    const float t480 = fminf(t479, t411);
    const float t481 = fmaxf(t479, t411);
    const float t482 = fminf(t409, t467);
    const float t483 = fmaxf(t409, t467);
    const float t484 = fminf(t483, t413);
    const float t485 = fminf(t480, t482);
    const float t486 = fmaxf(t480, t482);
    const float t487 = fminf(t481, t484);
    const float t488 = fmaxf(t476, t485);
    const float t489 = fminf(t477, t486);
    const float t490 = fmaxf(t477, t486);
    const float t491 = fminf(t478, t487);
    const float t492 = fmaxf(t488, t138);
    const float t493 = fminf(t492, t490);
    const float t494 = fmaxf(t492, t490);
    const float t495 = fminf(t489, t139);
    const float t496 = fmaxf(t489, t139);
    const float t497 = fminf(t496, t491);
    const float t498 = fmaxf(t493, t495);
    const float t499 = fminf(t494, t497);
    const float t500 = fmaxf(t498, v[12]);
    const float t501 = fminf(t500, t499);
    const float t502 = fmaxf(t498, v[43]);
    const float t503 = fminf(t502, t499);
    const float t504 = fminf(v[43], v[44]);
    const float t505 = fmaxf(v[43], v[44]);
    const float t506 = fmaxf(t488, t504);
    const float t507 = fminf(t506, t490);
    const float t508 = fmaxf(t506, t490);
    const float t509 = fminf(t489, t505);
    const float t510 = fmaxf(t489, t505);
    const float t511 = fminf(t510, t491);
    const float t512 = fmaxf(t507, t509);
    const float t513 = fminf(t508, t511);
    const float t514 = fmaxf(t512, v[14]);
    const float t515 = fminf(t514, t513);
    const float t516 = fmaxf(t512, v[45]);
    const float t517 = fminf(t516, t513);
    m[0] = t261;
    m[1] = t263;
    m[2] = t275;
    m[3] = t277;
    m[4] = t317;
    m[5] = t319;
    m[6] = t331;
    m[7] = t333;
    m[8] = t445;
    m[9] = t447;
    m[10] = t459;
    m[11] = t461;
    m[12] = t501;
    m[13] = t503;
    m[14] = t515;
    m[15] = t517;
  }
};
// END GENERATED BLOCK

__device__ __forceinline__ int reflect_index(int i, int n) {
  if (i >= 0 && i < n) return i;
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  i %= period;
  if (i < 0) i += period;
  return i < n ? i : period - i;
}

// Shared-memory slot of slab element i: one pad float every 32.
__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

// Window along time. Each warp owns 32 * R consecutive outputs of one row
// and a slab of shared memory for them, synchronised by __syncwarp alone,
// so one warp's loads overlap another's network. Block: kTimeBlock
// threads, warps side by side along the row; grid: (rows * tiles, batch).
template <int R>
__global__ void __launch_bounds__(kTimeBlock)
median31_kernel_time(const float* __restrict__ x, float* __restrict__ y, int rows, int cols, int tiles) {
  constexpr int kWarps = kTimeBlock / 32;
  constexpr int kOut = 32 * R;
  constexpr int kIn = kOut + 2 * kRadius;
  __shared__ float slabs[kWarps][kIn + kIn / 32 + 1];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x / tiles;
  const int c0 = ((blockIdx.x - row * tiles) * kWarps + warp) * kOut;
  if (c0 >= cols) return;  // the whole warp: past the row's end
  float* slab = slabs[warp];
  const size_t offset = (static_cast<size_t>(blockIdx.y) * rows + row) * cols;
  const float* line = x + offset;
  const int first = c0 - kRadius;
  // All of a lane's loads are issued before the first store to the slab.
  constexpr int kLoads = (kIn + 31) / 32;
  float staged[kLoads];
  if (first >= 0 && first + kIn <= cols) {
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int i = lane + 32 * k;
      if (i < kIn) staged[k] = __ldg(line + first + i);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int i = lane + 32 * k;
      if (i < kIn) staged[k] = __ldg(line + reflect_index(first + i, cols));
    }
  }
#pragma unroll
  for (int k = 0; k < kLoads; ++k) {
    const int i = lane + 32 * k;
    if (i < kIn) slab[padded(i)] = staged[k];
  }
  __syncwarp();

  const int base = lane * R;
  const bool active = c0 + base < cols;
  float m[R];
  if (active) {
    float v[R + 2 * kRadius];
#pragma unroll
    for (int k = 0; k < R + 2 * kRadius; ++k) v[k] = slab[padded(base + k)];
    Median31Net<R>::run(v, m);
  }
  __syncwarp();  // every lane has read its inputs
  if (active) {
#pragma unroll
    for (int j = 0; j < R; ++j) slab[padded(base + j)] = m[j];
  }
  __syncwarp();
  const int n = min(kOut, cols - c0);
  float* out = y + offset + c0;
  for (int i = lane; i < n; i += 32) out[i] = slab[padded(i)];
}

// Window along frequency. Block: kFreqBlock threads along time, one run
// of R rows each; grid: (column blocks * runs, batch).
template <int R>
__global__ void __launch_bounds__(kFreqBlock)
median31_kernel_freq(const float* __restrict__ x, float* __restrict__ y, int rows, int cols, int col_blocks) {
  const int run = blockIdx.x / col_blocks;
  const int t = (blockIdx.x - run * col_blocks) * kFreqBlock + threadIdx.x;
  if (t >= cols) return;
  const int f0 = run * R;
  const size_t plane = static_cast<size_t>(rows) * cols;
  const float* src = x + blockIdx.y * plane + t;
  const size_t stride = static_cast<size_t>(cols);

  float v[R + 2 * kRadius];
  if (f0 >= kRadius && f0 + R + kRadius <= rows) {
    // Interior: every row of the run's windows is in range.
    const float* w = src + static_cast<size_t>(f0 - kRadius) * stride;
#pragma unroll
    for (int k = 0; k < R + 2 * kRadius; ++k) v[k] = __ldg(w + k * stride);
  } else {
#pragma unroll
    for (int k = 0; k < R + 2 * kRadius; ++k) {
      v[k] = __ldg(src + static_cast<size_t>(reflect_index(f0 - kRadius + k, rows)) * stride);
    }
  }
  float m[R];
  Median31Net<R>::run(v, m);

  float* dst = y + blockIdx.y * plane + static_cast<size_t>(f0) * stride + t;
  if (f0 + R <= rows) {
#pragma unroll
    for (int j = 0; j < R; ++j) dst[j * stride] = m[j];
  } else {
    // The run crosses the axis end: store only the outputs that exist.
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (f0 + j < rows) dst[j * stride] = m[j];
    }
  }
}

}  // namespace

// x, y: contiguous f32 (batch, rows, cols). Launches on ``stream`` and
// returns cudaGetLastError() (0 on success); does not synchronise.
extern "C" int median31_launch(const float* x, float* y, int batch, int rows, int cols,
                               int axis_time, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (axis_time) {
    constexpr int kTile = kRunTime * kTimeBlock;  // outputs of a block
    const int tiles = (cols + kTile - 1) / kTile;
    const dim3 grid(rows * tiles, batch);
    median31_kernel_time<kRunTime><<<grid, kTimeBlock, 0, s>>>(x, y, rows, cols, tiles);
  } else {
    const int col_blocks = (cols + kFreqBlock - 1) / kFreqBlock;
    const dim3 grid(col_blocks * ((rows + kRunFreq - 1) / kRunFreq), batch);
    median31_kernel_freq<kRunFreq><<<grid, kFreqBlock, 0, s>>>(x, y, rows, cols, col_blocks);
  }
  return static_cast<int>(cudaGetLastError());
}
