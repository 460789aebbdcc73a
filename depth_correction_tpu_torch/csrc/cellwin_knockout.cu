// Knockout probe of the cell-window forward kernel (P1) for Hopper (sm_90a),
// with a plain C interface loaded through ctypes by
// depth_correction_tpu_torch/ops/_kernels.py.
//
// Replaces the Pallas probe scripts/exp_cellwin_knockout.py:make_kernel,
// which re-times the TPU forward kernel with parts knocked out. Here the
// parts are those of K1 on this card (csrc/cellwin_fwd.cuh, the modes and
// what each one means): the membership test, the feature arithmetic, the
// accumulation, the per-slot select, the staging floor, and the warp's box
// cull that the Hopper body adds. Its plain
// torch version is cellwin_knockout_plain in
// depth_correction_tpu_torch/ops/cellwin_knockout.py.
//
// What bounds it on this card: K1's bound (csrc/cellwin.cu), instruction
// issue per remaining membership test and member; each mode removes one part
// of that work, so the time each mode saves attributes K1's time. The
// design is K1's own code, instantiated once per mode at compile time:
// `full` is the same template instance as K1 and is bit-equal to it.
// The TPU probe's dot1, kcat1 and kcat3 arrange the matrix unit's dot,
// which K1 on this card does not use; the tensor-core moment product is
// probed by csrc/moment_dot.cu (P2) and csrc/moment_window.cu (P3-P5).

#include <cuda_runtime.h>

#include "cellwin_fwd.cuh"

extern "C" {

// mode: 0 full, 1 no_d2, 2 no_feats, 3 no_dot, 4 no_mask, 5 empty, 6 no_cull. Launches
// on the caller's stream, does not synchronise, and returns
// cudaGetLastError() (cudaErrorInvalidValue for an unknown mode).
int dc_cellwin_knockout(int mode, const void* pts, const void* est, int m_pad,
                        const void* q_est, int mq_pad, const void* f_start,
                        const void* f_len, const void* f_ctr, int t1, int ns,
                        int row_cap, float r2, void* out, void* stream) {
  switch (mode) {
    case kFull:
      return launch_cellwin_fwd_mode<kFull>(pts, est, m_pad, q_est, mq_pad, f_start, f_len,
                                            f_ctr, t1, ns, row_cap, r2, out, stream);
    case kNoD2:
      return launch_cellwin_fwd_mode<kNoD2>(pts, est, m_pad, q_est, mq_pad, f_start, f_len,
                                            f_ctr, t1, ns, row_cap, r2, out, stream);
    case kNoFeats:
      return launch_cellwin_fwd_mode<kNoFeats>(pts, est, m_pad, q_est, mq_pad, f_start,
                                               f_len, f_ctr, t1, ns, row_cap, r2, out,
                                               stream);
    case kNoDot:
      return launch_cellwin_fwd_mode<kNoDot>(pts, est, m_pad, q_est, mq_pad, f_start, f_len,
                                             f_ctr, t1, ns, row_cap, r2, out, stream);
    case kNoMask:
      return launch_cellwin_fwd_mode<kNoMask>(pts, est, m_pad, q_est, mq_pad, f_start, f_len,
                                              f_ctr, t1, ns, row_cap, r2, out, stream);
    case kEmpty:
      return launch_cellwin_fwd_mode<kEmpty>(pts, est, m_pad, q_est, mq_pad, f_start, f_len,
                                             f_ctr, t1, ns, row_cap, r2, out, stream);
    case kNoCull:
      return launch_cellwin_fwd_mode<kNoCull>(pts, est, m_pad, q_est, mq_pad, f_start, f_len,
                                              f_ctr, t1, ns, row_cap, r2, out, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
