"""Kernels: B4 (csrc/mtip.cu, project_fft_kernel or project_dft_kernel,
then quadrature_kernel) against its bound: the frozen
kernel_work("inverse_real_project_fwd") at the cell's shapes once for each
iteration of the schedule that the window ran, over the device time of
those kernels, in %. The work is counted from the schedule, never from the
launches, so a kernel that merges or splits its launches meets the same
yardstick."""
from fxsbench.trace import B4_KERNELS, hand_kernel
from fxsbench.work import bound_s, kernel_work


def read(w):
    ops = [k for k in w.kernels if hand_kernel(k[0]) in B4_KERNELS]
    seconds = sum(e - s for _, s, e in ops) * 1e-6
    if not ops or seconds <= 0:
        return None
    sh = w.shapes
    work = kernel_work("inverse_real_project_fwd", sh["restarts"] * sh["n_q"],
                       sh["n_theta"], sh["n_phi"], sh["l_max"], n_q=sh["n_q"])
    return 100.0 * w.batch_iterations * bound_s(*work)[0] / seconds
