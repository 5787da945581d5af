"""Command-line help texts of the fxs project: a copy of
`xframe_tpu.projects.fxs._argparser_` that names the GPU where it names
the device."""

PROJECT_DESCRIPTION = ("Fluctuation X-ray scattering (FXS) analysis toolkit: "
                       "cross-correlation, invariant extraction, MTIP phase "
                       "retrieval, and alignment/averaging.")

WORKER_HELP = {
    "correlate": (
        "compute angular cross-correlations",
        "Computes the averaged angular cross-correlation C(q1,q2,delta) of a "
        "set of diffraction patterns on the GPU (per-frame polar regridding, "
        "corrections, FFT-based CCF). Provide a settings name, e.g. "
        "`xframe-tpu-torch fxs correlate tutorial`."),
    "extract": (
        "extract rotational invariants",
        "Extracts the rotational invariants B_l(q1,q2) from an averaged "
        "cross-correlation dataset and computes the projection matrices V_l "
        "needed for phase retrieval (PSD enforcement, eigendecomposition)."),
    "reconstruct": (
        "run MTIP phase retrieval",
        "Reconstructs the single-particle electron density with the MTIP "
        "iterative phasing scheme (HIO/ER/RAAR + shrink-wrap), multi-start "
        "restarts of a chunk run as one batch on the GPU."),
    "average": (
        "align and average reconstructions",
        "SO(3)-aligns multiple reconstructions against a reference, averages "
        "them, and computes PRTF/FSC resolution metrics."),
    "simulate_ccd": (
        "simulate cross-correlations of simple shapes",
        "Testing/tutorial: synthesizes an averaged cross-correlation dataset "
        "C(q1,q2,delta) from analytic shape densities (spheres/cubes/"
        "tetrahedra) or a PDB model — no experimental data needed."),
}
