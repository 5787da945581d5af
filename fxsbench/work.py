"""The yardstick of the kernels' roofline shares: the operations and
bytes that one call needs, counted from its shapes whatever its algorithm,
and the published peaks of one NVIDIA H100 SXM (FP32 on the CUDA cores,
HBM3). Each input byte is read once and each output byte written once.
The Newton–Schulz work is counted on the settings' minimax schedule of
MINIMAX_STEPS quintic steps, never on the step count a program runs.
"""
from __future__ import annotations

import math

PEAK_FLOPS = 67e12     # FP32, CUDA cores
PEAK_BYTES = 3.35e12   # HBM3
MINIMAX_STEPS = 14     # ns_coefficients "minimax" at ns_sigma_min 1e-7


def bound_s(flop, nbytes):
    """→ (least seconds, "operations" or "bytes")."""
    t_op, t_by = flop / PEAK_FLOPS, nbytes / PEAK_BYTES
    return (t_op, "operations") if t_op >= t_by else (t_by, "bytes")


def kernel_work(name, rows, n_theta, n_phi, l_max, n_q=None,
                weights="plane"):
    """(FLOP, bytes) of one call of an SHT or fused-iteration kernel on
    `rows` rows (restarts × shells): each φ-transform of a θ line as an FFT
    (5·P·log2 P FLOP for complex data, half for real data or a real
    output), the Legendre stages over the (l, m) triangle only (4 FLOP per
    complex coefficient × real P̄ multiply-add; m ≥ 0 only for real
    fields), each input, Legendre table and output counted once. weights
    "grid": the (n_q, n_θ, n_φ) weight grid, not the plane."""
    R, T, P = rows, n_theta, n_phi
    n_m, n_l = 2 * l_max + 1, l_max + 1
    tri, tri_pos = n_l * n_l, n_l * (n_l + 1) // 2
    grid, coef = R * T * P, R * n_m * n_l
    leg = R * T * tri * 4
    leg_pos = R * T * tri_pos * 4
    cfft = R * T * 5 * P * math.log2(P)
    rfft = cfft / 2
    table, table_pos = T * tri * 4, T * tri_pos * 4
    w_plane = (n_q or 0) * T * (P if weights == "grid" else 1) * 4
    work = {
        "sht_forward": (cfft + leg, 8 * grid + 8 * coef + table),
        "sht_inverse": (leg + cfft, 8 * coef + 8 * grid + table),
        "sht_forward_real": (rfft + leg_pos,
                             4 * grid + 8 * coef + table_pos),
        "sht_inverse_real": (leg_pos + rfft,
                             8 * coef + 4 * grid + table_pos),
        "sht_forward_real_abs2": (3 * grid + rfft + leg_pos,
                                  8 * grid + 8 * coef + table_pos),
        "inverse_real_project_fwd": (leg_pos + rfft + cfft + leg,
                                     16 * coef + 8 * grid + w_plane
                                     + table + table_pos),
        "synthesize_update": (leg + cfft,
                              8 * coef + 17 * grid + w_plane + table),
        "inverse_real_project": (leg_pos + rfft,
                                 8 * coef + 16 * grid + w_plane
                                 + table_pos),
        "synthesize_abs2": (leg + cfft + 3 * grid + rfft + leg_pos,
                            16 * coef + 8 * grid + table + table_pos),
    }
    if name == "hankel_synthesize":
        b = R // n_q
        flop, nbytes = work["sht_inverse"]
        return (flop + b * n_q * n_q * tri * 8,
                nbytes + 8 * coef + n_q * n_q * n_l * 8)
    return work[name]


def crop_buckets(l_max):
    """[(l_lo, l_hi, h)]: orders 64(k−1)..min(64k−1, L−1) on the centred
    window of half-width min(64k−1, L−1), then (L, L, L)."""
    out, k = [], 1
    while 64 * (k - 1) <= l_max - 1:
        hi = min(64 * k - 1, l_max - 1)
        out.append((64 * (k - 1), hi, hi))
        k += 1
    return out + [(l_max, l_max, l_max)]


def ns_work(name, buckets, restarts, n_q, n_steps=MINIMAX_STEPS,
            n_cubic=0):
    """(FLOP, bytes) of one projection's polar ("polar_unitary") or fused
    projection ("fused_projection") calls over `buckets` [(l_lo, l_hi,
    h)], 8 FLOP a complex multiply-add: per quintic step A = X†X and A²
    (Hermitian, half computed) and X·(bA + cA²), 2c³ multiply-adds; per
    cubic step 1.5c³. The fused projection adds B = PD·I and V·W."""
    flop = nbytes = 0
    for (l_lo, l_hi, h) in buckets:
        g, c = restarts * (l_hi - l_lo + 1), 2 * h + 1
        steps = 2 * (n_steps - n_cubic) + 1.5 * n_cubic
        flop += g * steps * c ** 3 * 8
        if name == "polar_unitary":
            nbytes += 2 * g * c * c * 8
        else:
            flop += g * 2 * c * c * n_q * 8
            nbytes += 2 * g * n_q * c * 8 + 2 * (l_hi - l_lo + 1) \
                * n_q * c * 8 + (l_hi - l_lo + 1) * n_q * 4
    return flop, nbytes
