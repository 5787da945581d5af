"""The benchmark's plain reference of the reconstruct worker's phasing.

Plain PyTorch and NumPy, imported by nothing of the program and importing
nothing of it: the grids, the spherical harmonic and Hankel transforms, the
reciprocal (data) projection with its Newton–Schulz polar factor, the real
constraint, the shrink-wrap and the HIO/ER step, all worked out again from
the settings tree and the invariants that the benchmark made. It computes in
float64 (the judge) or in float32 with every matrix product's operands
rounded to TF32 (the control of `correct`).
"""
