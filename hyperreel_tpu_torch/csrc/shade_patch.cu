// The C entry point of the fused patch-blend + shade kernel (K3): the
// kernel and its design are in shade_patch.cuh, its instantiations in
// shade_patch_c<C>_r<R>.cu.

#include "shade_patch.cuh"

extern "C" int shade_patch_launch(const void* ptab, const float* pack,
                                  const float* rays, const float* ttab,
                                  float* out, int* viol,
                                  const ShadeParams* p, const PatchParams* q,
                                  void* stream) {
  const int S = q->S;
  if (S < 4 || S > 32 || (S & (S - 1)) || p->S != S || p->B != q->B ||
      p->C != q->C || p->weights || (!p->rgb && 2 * p->nd != p->C) ||
      !basis_built(p->rgb, p->nb) ||
      (q->R != 4 && q->R != 8) ||
      q->B % q->R || q->m0 < 0 || q->m0 > 2 || q->m1 < 0 || q->m1 > 2) {
    return (int)cudaErrorInvalidValue;
  }
  if (q->B == 0) return 0;
  const uint4* pt = static_cast<const uint4*>(ptab);
  cudaStream_t st = (cudaStream_t)stream;
  switch (q->C * 10 + q->R) {
    case 84: return (int)k3_launch_c8_r4(pt, pack, rays, ttab, out, viol, *p, *q, st);
    case 88: return (int)k3_launch_c8_r8(pt, pack, rays, ttab, out, viol, *p, *q, st);
    case 164: return (int)k3_launch_c16_r4(pt, pack, rays, ttab, out, viol, *p, *q, st);
    case 168: return (int)k3_launch_c16_r8(pt, pack, rays, ttab, out, viol, *p, *q, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int patch_params_size() { return (int)sizeof(PatchParams); }
