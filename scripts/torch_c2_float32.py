#!/usr/bin/env python3
"""How far the float32 first iteration of the reconstruct options' run (i)
sits from float64, in the JAX package and in the port, on the CPU.

    python3 scripts/torch_c2_float32.py [N L]      (default 64 32)

Runs the JAX chain simulate_ccd → extract (N_sim = max(48, 2N), L_sim =
max(14, L + 4), two spheres) in a temporary XFRAME_TPU_HOME, then both
reconstruct workers at N radial points and order L with the settings of
chip_smoke.py's phase `options` run (i): the auto-correlation support (the
port's B5 on its grid of weights) and linked ft-stab of delay 2, one
iteration from the JAX worker's densities and support, in float32 and in
precision float64. Prints, as JSON lines:

  * `whole`: each package's float32 error columns against its float64
    run (max relative distance), and the two float64 runs against each
    other;
  * `local`: each forward step of both packages in float32 on the float64
    run's inputs against the float64 step (relative L2): analysis, Hankel
    transform + synthesis, |ψ|² analysis;
  * `substituted`: the port's fused iteration in float64 with one step at
    a time in float32 (the inputs rounded, the output widened), the
    distance of the error columns to the float64 chain: which step
    carries the float32 gap.

Reads and writes nothing outside its temporary home; needs the JAX
package (CPU) and h5py.
"""
import copy
import json
import os
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import xframe_tpu as xf  # noqa: E402
from xframe_tpu.projects.fxs.reconstruct import ProjectWorker as JaxWorker  # noqa: E402,E501
from xframe_tpu_torch.convert import save_invariants  # noqa: E402
from xframe_tpu_torch.main import select_worker  # noqa: E402
from xframe_tpu_torch.settings import deep_update  # noqa: E402

G = (-3, -2, -1)
LINKED = {"ft_stab": "link_to_enforce_initial_support",
          "link_to_enforce_initial_support": {"delay": 2}}
OPTIONS = {"projections": {"real": {"projections": {"support": {
    "initial_support": {"type": "auto_correlation"}}}}},
    "main_loop": {"sub_loops": {"main": {"methods": {
        "HIO": dict(iterations=3, **LINKED),
        "ER": dict(iterations=3, **LINKED)}}}}}


def overrides(n, l_max, wide, inv_path=None):
    ov = {"structure_name": "c2", "dimensions": 3, "particle_radius": 50,
          "grid": {"n_radial_points": n, "max_order": l_max},
          "multi_start": {"n_reconstructions": 2, "seed": 7},
          "main_loop": {"sub_loops": {"order": ["main"], "main": {
              "iterations": 1, "order": ["HIO", "SW", "ER"],
              "methods": {"HIO": {"iterations": 3}, "SW": {"iterations": 1},
                          "ER": {"iterations": 3}}}}}}
    if wide:
        ov["precision"] = "float64"
    if inv_path:
        ov["input"] = {"invariants_path": inv_path}
    return deep_update(ov, copy.deepcopy(OPTIONS))


def rel(a, b):
    return float(np.max(np.abs(a - b) / np.abs(b)))


def emit(**kw):
    print(json.dumps(kw), flush=True)


def main(n, l_max):
    torch.set_num_threads(1)
    home = tempfile.mkdtemp()
    os.environ["XFRAME_TPU_HOME"] = home
    l_sim, n_sim = max(14, l_max + 4), max(48, 2 * n)
    xf.select_project("fxs", "simulate_ccd", overrides={
        "structure_name": "c2", "dimensions": 3,
        "grid": {"n_radial_points": n_sim, "max_order": l_sim,
                 "max_q": 0.5},
        "shapes": {"types": ["sphere", "sphere"],
                   "centers": [[0, 0, 0], [30, 1.2, 0.7]],
                   "sizes": [20, 14], "densities": [1.0, 0.7],
                   "random_orientation": [False, False]},
        "cross_correlation": {"method": "back_substitution",
                              "xray_wavelength": 1.23984}})
    xf.run()
    xf.select_project("fxs", "extract", overrides={
        "structure_name": "c2", "dimensions": 3, "max_order": l_sim})
    inv = xf.run()
    inv_path = os.path.join(home, "inv.npz")
    save_invariants(inv, inv_path)

    errors, jmods, tmods = {}, {}, {}
    for wide in (False, True):
        with jax.enable_x64(wide):
            xf.select_project("fxs", "reconstruct",
                              overrides=overrides(n, l_max, wide))
            jw = JaxWorker()
            jm, jft, jaux = jw.setup_mtip(inv)
            js = jw._build_schedule(jft)
            if not wide:
                rho0 = np.array(jaux["initial_density_batch"](7, 2))
                support = np.asarray(jaux["initial_support"])
            r0 = rho0.astype(np.complex128 if wide else np.complex64)
            e = jax.jit(lambda r: jm.run_batch(r, js[:1])[1])(r0)
            errors["jax", wide] = np.asarray(e, np.float64)[:, 0]
            jmods[wide] = jm
        tw = select_worker("fxs", "reconstruct",
                           overrides=overrides(n, l_max, wide, inv_path),
                           device="cpu")
        tm, tft, _ = tw.setup_mtip(tw._load_invariants())
        tm.set_initial_support(support)
        schedule = tw._build_schedule(tft)
        e = tm.run_batch(torch.as_tensor(r0), schedule[:1])[1]
        errors["torch", wide] = e.double().numpy()[:, 0]
        tmods[wide] = (tm, tft)
    emit(kind="whole", n=n, l_max=l_max,
         jax_float32_vs_float64=rel(errors["jax", False],
                                    errors["jax", True]),
         port_float32_vs_float64=rel(errors["torch", False],
                                     errors["torch", True]),
         float64_port_vs_jax=rel(errors["torch", True], errors["jax", True]),
         errors={f"{k[0]}_{'float64' if k[1] else 'float32'}": v.tolist()
                 for k, v in errors.items()})

    rho = rho0.astype(np.complex128)
    local = {}
    with jax.enable_x64(True):
        m64 = jmods[True]

        def steps64(r):
            c0 = m64.ft._analysis(r)
            psi = m64.ft._synthesis(m64.ft.hankel.forward(c0))
            return c0, psi, m64.sht.forward_real((psi * psi.conj()).real)
        ref = [np.asarray(x) for x in jax.vmap(steps64)(jnp.asarray(rho))]
    m32 = jmods[False]
    low = [jax.vmap(m32.ft._analysis),
           jax.vmap(lambda c: m32.ft._synthesis(m32.ft.hankel.forward(c))),
           jax.vmap(lambda p: m32.sht.forward_real((p * p.conj()).real))]
    local["jax"] = [float(np.linalg.norm(np.asarray(f(jnp.asarray(
        x, jnp.complex64))) - w) / np.linalg.norm(w))
        for f, x, w in zip(low, (rho, ref[0], ref[1]), ref)]
    (tm64, ft64), (tm32, ft32) = tmods[True], tmods[False]
    r = torch.as_tensor(rho)
    c0 = ft64._analysis(r)
    psi = ft64._synthesis(ft64.hankel.forward(c0))
    ref = [c0, psi, tm64.sht.forward_real((psi * psi.conj()).real)]
    got = [ft32._analysis(r.to(torch.complex64)),
           tm32._fi.hankel_synthesize_plain(c0.to(torch.complex64))[0],
           tm32.sht.forward_real_abs2(psi.to(torch.complex64))]
    local["port"] = [float(torch.linalg.norm(g.to(w.dtype) - w)
                           / torch.linalg.norm(w)) for g, w in zip(got, ref)]
    emit(kind="local", steps=["analysis", "hankel+synthesis",
                              "abs2 analysis"], **local)
    emit(kind="substituted", **substituted(tm32, tm64, ft32, ft64, schedule,
                                           rho))


def substituted(tm, tm64, tft, ft64, schedule, rho):
    """The port's fused iteration, one step at a time in float32."""
    fi, seg = tm._fi, schedule[0]
    tm.register_schedule_dynamics(schedule)
    st32 = tm.initial_state_batch(torch.as_tensor(rho).to(torch.complex64))
    st64 = tm64.initial_state_batch(torch.as_tensor(rho))
    gate = tm._ft_gate(st32, seg)
    beta = float(seg.betas[0])

    def down(x):
        if isinstance(x, tuple):
            return tuple(down(v) for v in x)
        return x.to({torch.complex128: torch.complex64,
                     torch.float64: torch.float32}.get(x.dtype, x.dtype))

    def up(x):
        if isinstance(x, tuple):
            return tuple(up(v) for v in x)
        return x.to({torch.complex64: torch.complex128,
                     torch.float32: torch.float64}.get(x.dtype, x.dtype))

    def anchor(p, rho):
        m = tm if p == 32 else tm64
        return m._anchor_scalar(*m._anchor_stats(rho))

    def analysis(p, rho):
        return (tft if p == 32 else ft64)._analysis(rho)

    def hsyn(p, c0):
        if p == 32:
            return fi.hankel_synthesize_plain(c0)
        cf = ft64.hankel.forward(c0)
        return ft64._synthesis(cf), cf

    def abs2(p, psi):
        return (tm if p == 32 else tm64).sht.forward_real_abs2(psi)

    def constraint(p, ilm):
        return (tm if p == 32 else tm64).rc(ilm)

    def project(p, c, psi):
        if p == 32:
            return fi.inverse_real_project_fwd_plain(c, psi)
        i_new = tm64.sht.inverse_real(c)
        inten = (psi * psi.conj()).real
        valid = (inten > 0) & (i_new >= 0)
        psi_p = psi * torch.sqrt(torch.where(
            valid, i_new / torch.where(valid, inten, 1.0), 0.0))
        d = psi - psi_p
        w = 1.0 if fi._w_rec is None else fi._w_rec.double()[..., None]
        return (tm64.sht.forward(psi_p),
                torch.sum(w * (d * d.conj()).real, dim=G),
                torch.sum(w * inten, dim=G))

    def hankel_inverse(p, c_p, cf):
        ft = tft if p == 32 else ft64
        g = torch.as_tensor(gate).to(cf.real.dtype).reshape(-1, 1, 1, 1)
        cfg = cf * g
        d = ft.hankel.inverse(c_p - cfg)
        d[..., 0, :, :] += ft.hankel.inverse_row0(cfg)
        return d

    def update(p, d, rho_in, c_phase):
        w = tm._k4_weights()
        if p == 32:
            return fi.synthesize_update_plain(
                d, rho_in, st32.support, w, beta, c_phase, method=seg.method,
                ft_stab=True, real_constraint=tm.real,
                fix_phase=tm.fix_global_phase, ft_gate=gate)[1:3]
        keep = torch.ones((rho_in.shape[-3], 1, 1), dtype=torch.float64)
        keep[0] = 0
        keep = keep * torch.as_tensor(gate).double().reshape(-1, 1, 1, 1)
        c = c_phase.reshape(-1, 1, 1, 1)
        rp = (tm64.sht.inverse(d) + rho_in * keep) * c
        out, _ = tm64.real(rp, st64.support != 0)
        w3 = w.double()
        w3 = w3[..., None] if w3.dim() == 2 else w3
        dd = rp - out
        return (torch.sum(w3 * (dd * dd.conj()).real, dim=G),
                torch.sum(w3 * (rp * rp.conj()).real, dim=G))

    steps = {"anchor": anchor, "analysis": analysis,
             "hankel+synthesis": hsyn, "abs2 analysis": abs2,
             "reciprocal constraint": constraint, "B4 plain": project,
             "gated Hankel inverse": hankel_inverse,
             "synthesize_update_plain": update}

    def chain(low):
        def run(name, *args):
            fn = steps[name]
            return up(fn(32, *down(args))) if name in low else fn(64, *args)
        rho = st64.rho
        c_phase = run("anchor", rho)
        psi, cf = run("hankel+synthesis", run("analysis", rho))
        c_p, rnum, rden = run("B4 plain", run(
            "reciprocal constraint", run("abs2 analysis", psi)), psi)
        num, den = run("synthesize_update_plain",
                       run("gated Hankel inverse", c_p, cf), rho, c_phase)
        return torch.stack([num / den, rnum / rden], -1).numpy()
    ref = chain(set())
    out = {"all_float32": rel(chain(set(steps)), ref)}
    out.update({name: rel(chain({name}), ref) for name in steps})
    return out


if __name__ == "__main__":
    args = [int(a) for a in sys.argv[1:3]] or [64, 32]
    main(*args)
