"""Batched L-BFGS relaxation that keeps its state on the device.

The port of ``nabladft_tpu/optimize/lbfgs.py`` (itself the on-device form of
the reference's host-side batchwise L-BFGS, nablaDFT/optimization/
optimizers.py:293-659). Positions, the Hessian history, rho and the
convergence masks stay on the batch's device for the whole relaxation; the
loop runs on the host and reads one flag a step (has every molecule
converged?), plus one a Moré–Thuente evaluation. The same inputs give the
JAX package's iterates within float32 rounding.

Semantics (as the JAX package):
  * converged(config) ⇔ max per-atom ‖F‖ < fmax; converged configs are
    frozen (their step is zeroed) while the rest of the batch continues;
  * the loop stops when all real molecules converge or `max_steps` is hit;
  * H0 = 1 (never updated), no damping (the reference's defaults, which
    no config changes), maxstep per-config renormalisation, rho = 1/(y·s)
    guarded at 1e-8;
  * a ring of `memory` history slots, written in place; the two-loop
    recursion visits only the min(iteration, memory) filled slots, in the
    JAX package's ring order (its unfilled slots carry rho = 0 and add
    exactly zero there);
  * line searches: "armijo" backtracking, "wolfe" fixed-trial strong-Wolfe
    bracketing, and "mt", the reference's MINPACK dcsrch with one lane per
    config (use ls_c1=0.23, ls_c2=0.46 to match the reference's calling
    convention, optimizers.py:654-655).

`relax_chunked` runs the loop in host-visible chunks for trajectories, and
`save_state` / `load_state` write and read the restart pickle in the JAX
package's format (a dict of numpy arrays under the `LBFGSState` field
names), so a state saved by either package resumes in the other.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from nabladft_tpu_torch.data.batch import MolBatch

EnergyForcesFn = Callable[[MolBatch], Tuple[torch.Tensor, torch.Tensor]]
# (batch) -> (energy [B], forces [B,A,3])

LINE_SEARCHES = ("off", "armijo", "wolfe", "mt")
H0 = 1.0  # initial inverse Hessian, 1/alpha at the reference's alpha = 1
DAMPING = 1.0  # step multiplier, the reference's damping = 1


class LBFGSState(NamedTuple):
    pos: torch.Tensor  # [B,A,3]
    energy: torch.Tensor  # [B]
    forces: torch.Tensor  # [B,A,3]
    r0: torch.Tensor  # [B,A,3] previous positions
    f0: torch.Tensor  # [B,A,3] previous forces
    s_hist: torch.Tensor  # [M,B,A,3]
    y_hist: torch.Tensor  # [M,B,A,3]
    rho: torch.Tensor  # [M,B]
    iteration: int  # host int: ring indices are Python's %, never negative
    converged: torch.Tensor  # [B] bool
    nsteps_to_converge: torch.Tensor  # [B] int32 (diagnostics)


class LBFGSResult(NamedTuple):
    pos: torch.Tensor
    energy: torch.Tensor
    forces: torch.Tensor
    converged: torch.Tensor
    nsteps: int  # total iterations executed
    nsteps_to_converge: torch.Tensor  # [B]


def _config_dot(a: torch.Tensor, b: torch.Tensor, node_mask: torch.Tensor) -> torch.Tensor:
    """Per-molecule dot product of flattened [B,A,3] arrays."""
    return (a * b * node_mask[..., None]).sum(dim=(1, 2))


def _max_force_sq(forces: torch.Tensor, node_mask: torch.Tensor) -> torch.Tensor:
    f2 = (forces * forces).sum(-1)
    return torch.where(node_mask, f2, 0.0).amax(-1)  # [B]


def _wolfe_search(compute, st, dr, node_mask, trials, c1, c2):
    """Vectorized strong-Wolfe bracketing search over the batch.

    Fixed `trials` function+gradient evaluations; per-molecule bracket
    [lo, hi] kept as masked vectors. Returns the accepted step multiplier
    per molecule.
    """
    b = st.energy.shape[0]
    kw = dict(dtype=dr.dtype, device=dr.device)
    dphi0 = _config_dot(-st.forces, dr, node_mask)  # [B] (≤ 0 descent)
    alpha = torch.ones(b, **kw)
    lo = torch.zeros(b, **kw)
    hi = torch.full((b,), float("inf"), **kw)
    best = torch.ones(b, **kw)
    found = torch.zeros(b, dtype=torch.bool, device=dr.device)
    fallback = torch.ones(b, **kw)  # best Armijo-only step seen
    fallback_ok = torch.zeros_like(found)
    alpha_min = torch.ones(b, **kw)  # smallest multiplier evaluated
    for _ in range(trials):
        e_t, f_t = compute(st.pos + alpha[:, None, None] * dr)
        dphi = _config_dot(-f_t, dr, node_mask)
        armijo = e_t <= st.energy + c1 * alpha * dphi0
        curv = dphi.abs() <= c2 * dphi0.abs()
        accept = armijo & curv & ~found
        best = torch.where(accept, alpha, best)
        found = found | accept
        fallback = torch.where(armijo & ~fallback_ok, alpha, fallback)
        fallback_ok = fallback_ok | armijo
        alpha_min = torch.minimum(alpha_min, alpha)
        # bracket update (strong-Wolfe zoom rules)
        shrink = ~armijo | (dphi > 0)  # overshoot -> bracket right end
        hi = torch.where(shrink & ~found, alpha, hi)
        lo = torch.where(armijo & (dphi < 0) & ~found, alpha, lo)
        finite = torch.isfinite(hi)
        bisect = 0.5 * (lo + torch.where(finite, hi, lo + 2.0))
        alpha = torch.where(finite, bisect, 2.0 * alpha)
    # no trial met even Armijo: every tried step overshot, so go on
    # backtracking with half the smallest multiplier tried
    return torch.where(found, best, torch.where(fallback_ok, fallback, 0.5 * alpha_min))


def _safe_div(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-30) -> torch.Tensor:
    return a / torch.where(b.abs() < eps, torch.where(b < 0, -eps, eps), b)


class _MTState(NamedTuple):
    """Per-config dcsrch state vectors (reference line_search.py save/step)."""

    stp: torch.Tensor       # current trial step (to be / just evaluated)
    old_stp: torch.Tensor   # previously evaluated step
    bracket: torch.Tensor   # bool
    stage: torch.Tensor     # int32 (1 or 2)
    ginit: torch.Tensor
    gtest: torch.Tensor
    gx: torch.Tensor
    gy: torch.Tensor
    finit: torch.Tensor
    fx: torch.Tensor
    fy: torch.Tensor
    stx: torch.Tensor
    sty: torch.Tensor
    stmin: torch.Tensor
    stmax: torch.Tensor
    width: torch.Tensor
    width1: torch.Tensor
    done: torch.Tensor      # bool: CONVERGENCE / WARNING / ERROR reached
    it: int                 # batched evaluations so far


def _dcstep(st: _MTState, fp, gp, stpmin, stpmax_p):
    """Vectorized MINPACK dcstep + dcsrch interval logic
    (reference line_search.py:343-489 update / :126-342 step tail).

    fp/gp: φ, φ' at st.stp. stpmin/stpmax_p are the evolving per-lane
    interval bounds (the reference's step() passes its current stmin/stmax
    into update()): they bound the case-3/4 extrapolation. Returns the
    state with the updated interval, and the next trial step (not yet
    maxstep-capped).
    """
    stx, sty, stp = st.stx, st.sty, st.stp
    fx, fy, gx, gy = st.fx, st.fy, st.gx, st.gy
    sign = gp * torch.sign(gx)

    d_sp = stp - stx
    theta = 3.0 * _safe_div(fx - fp, d_sp) + gx + gp
    s = torch.maximum(theta.abs(), torch.maximum(gx.abs(), gp.abs()))
    gam_sq = _safe_div(theta, s) ** 2 - _safe_div(gx, s) * _safe_div(gp, s)
    gamma = s * torch.sqrt(torch.clamp(gam_sq, min=0.0))

    case1 = fp > fx
    case2 = ~case1 & (sign < 0)
    case3 = ~case1 & ~case2 & (gp.abs() < gx.abs())

    # -- case 1: higher value -> bracketed; cubic vs mid(cubic, quadratic)
    g1 = torch.where(stp < stx, -gamma, gamma)
    p1 = (g1 - gx) + theta
    q1 = ((g1 - gx) + g1) + gp
    stpc1 = stx + _safe_div(p1, q1) * d_sp
    stpq1 = stx + 0.5 * _safe_div(gx, _safe_div(fx - fp, d_sp) + gx) * d_sp
    stpf1 = torch.where((stpc1 - stx).abs() < (stpq1 - stx).abs(), stpc1,
                        stpc1 + 0.5 * (stpq1 - stpc1))

    # -- case 2: lower value, opposite derivative signs -> bracketed
    g2 = torch.where(stp > stx, -gamma, gamma)
    p2 = (g2 - gp) + theta
    q2 = ((g2 - gp) + g2) + gx
    stpc2 = stp + _safe_div(p2, q2) * (stx - stp)
    stpq2 = stp + _safe_div(gp, gp - gx) * (stx - stp)
    stpf2 = torch.where((stpc2 - stp).abs() > (stpq2 - stp).abs(), stpc2, stpq2)

    # -- case 3: lower value, same sign, |g| decreasing
    g3 = torch.where(stp > stx, -gamma, gamma)
    p3 = (g3 - gp) + theta
    q3 = (g3 + (gx - gp)) + g3
    r3 = _safe_div(p3, q3)
    stpc3 = torch.where((r3 < 0.0) & (gamma != 0.0), stp + r3 * (stx - stp),
                        torch.where(stp > stx, stpmax_p, stpmin))
    stpq3 = stp + _safe_div(gp, gp - gx) * (stx - stp)
    stpf3_br = torch.where((stpc3 - stp).abs() < (stpq3 - stp).abs(), stpc3, stpq3)
    stpf3_br = torch.where(stp > stx, torch.minimum(stp + 0.66 * (sty - stp), stpf3_br),
                           torch.maximum(stp + 0.66 * (sty - stp), stpf3_br))
    stpf3_nb = torch.where((stpc3 - stp).abs() > (stpq3 - stp).abs(), stpc3, stpq3)
    stpf3_nb = torch.minimum(torch.maximum(stpf3_nb, stpmin), stpmax_p)
    stpf3 = torch.where(st.bracket, stpf3_br, stpf3_nb)

    # -- case 4: lower value, same sign, |g| not decreasing
    d_spy = sty - stp
    theta4 = 3.0 * _safe_div(fp - fy, d_spy) + gy + gp
    s4 = torch.maximum(theta4.abs(), torch.maximum(gy.abs(), gp.abs()))
    gam4 = s4 * torch.sqrt(torch.clamp(
        _safe_div(theta4, s4) ** 2 - _safe_div(gy, s4) * _safe_div(gp, s4), min=0.0))
    g4 = torch.where(stp > sty, -gam4, gam4)
    p4 = (g4 - gp) + theta4
    q4 = ((g4 - gp) + g4) + gy
    stpc4 = stp + _safe_div(p4, q4) * d_spy
    stpf4 = torch.where(st.bracket, stpc4, torch.where(stp > stx, stpmax_p, stpmin))

    stpf = torch.where(case1, stpf1, torch.where(case2, stpf2, torch.where(case3, stpf3, stpf4)))
    bracket = st.bracket | case1 | case2

    # interval endpoint update (line_search.py:471-487)
    opposite = sign < 0
    return st._replace(
        stx=torch.where(case1, stx, stp),
        sty=torch.where(case1, stp, torch.where(opposite, stx, sty)),
        fx=torch.where(case1, fx, fp),
        fy=torch.where(case1, fp, torch.where(opposite, fx, fy)),
        gx=torch.where(case1, gx, gp),
        gy=torch.where(case1, gp, torch.where(opposite, gx, gy)),
        bracket=bracket,
    ), stpf


def _mt_search(
    compute, st, p, node_mask, c1, c2, maxstep, max_iters,
    xtol=1e-14, xtrapl=1.1, xtrapu=4.0, stpmin=1e-8, stpmax=50.0,
):
    """Batched Moré–Thuente (MINPACK dcsrch) line search.

    Every config carries its dcsrch state as a [B] lane, and each iteration
    advances all lanes with one batched energy+forces evaluation, as the
    reference does (line_search.py:13-124 driver, :126-342 step, :343-489
    update). The loop reads one flag per evaluation (are all lanes done?).

    As in the JAX package: accepted lanes return min(1, maxstep/max-atom-
    step), the reference's determine_step_ override (line_search.py:104-
    107); each trial's step delta is maxstep-capped (determine_step,
    :490-498). Returns (steps [B], number of batched evaluations).
    """
    b = st.energy.shape[0]
    kw = dict(dtype=p.dtype, device=p.device)

    phi0 = st.energy
    derphi0 = _config_dot(-st.forces, p, node_mask)
    p_maxlen = torch.where(node_mask, torch.sqrt((p * p).sum(-1)), 0.0).amax(-1)  # [B]

    def determine_step(stp_new, stp_old):
        d = stp_new - stp_old
        over = d.abs() * p_maxlen >= maxstep
        d = torch.where(over, torch.sign(d) * _safe_div(torch.full_like(d, maxstep), p_maxlen),
                        d)
        return stp_old + d

    full_step = torch.where(p_maxlen >= maxstep,
                            _safe_div(torch.full_like(p_maxlen, maxstep), p_maxlen), 1.0)

    # START (line_search.py:127-192): error lanes (non-descent, i.e. frozen
    # configs with p = 0) are done at once and take the full step
    one = torch.ones(b, **kw)
    zero = torch.zeros(b, **kw)
    ms = _MTState(
        stp=determine_step(one, zero),
        old_stp=zero,
        bracket=torch.zeros(b, dtype=torch.bool, device=p.device),
        stage=torch.ones(b, dtype=torch.int32, device=p.device),
        ginit=derphi0,
        gtest=c1 * derphi0,
        gx=derphi0, gy=derphi0,
        finit=phi0, fx=phi0, fy=phi0,
        stx=zero, sty=zero,
        stmin=zero,
        stmax=one + xtrapu * one,
        width=torch.full((b,), stpmax - stpmin, **kw),
        width1=torch.full((b,), (stpmax - stpmin) / 0.5, **kw),
        done=derphi0 >= 0.0,
        it=0,
    )

    while ms.it < max_iters and not bool(ms.done.all()):
        e_t, f_t = compute(st.pos + ms.stp[:, None, None] * p)
        fp = e_t
        gp = _config_dot(-f_t, p, node_mask)

        ftest = ms.finit + ms.stp * ms.gtest
        stage = torch.where((ms.stage == 1) & (fp < ftest) & (gp >= 0.0), 2, ms.stage)

        warn = (
            (ms.bracket & ((ms.stp <= ms.stmin) | (ms.stp >= ms.stmax)))
            | (ms.bracket & (ms.stmax - ms.stmin <= xtol * ms.stmax))
            | ((ms.stp == stpmax) & (fp <= ftest) & (gp <= ms.gtest))
            | ((ms.stp == stpmin) & ((fp > ftest) | (gp >= ms.gtest)))
        )
        conv = (fp <= ftest) & (gp.abs() <= c2 * (-ms.ginit))
        newly_done = (warn | conv) & ~ms.done

        upd, stpf = _dcstep(ms._replace(stage=stage), fp, gp, ms.stmin, ms.stmax)
        stp_trial = determine_step(stpf, ms.stp)

        # bisection safeguard + interval bounds (line_search.py:288-320)
        use_bisect = upd.bracket & ((upd.sty - upd.stx).abs() >= 0.66 * ms.width1)
        stp_trial = torch.where(use_bisect, upd.stx + 0.5 * (upd.sty - upd.stx), stp_trial)
        width1 = torch.where(upd.bracket, ms.width, ms.width1)
        width = torch.where(upd.bracket, (upd.sty - upd.stx).abs(), ms.width)
        stmin = torch.where(upd.bracket, torch.minimum(upd.stx, upd.sty),
                            stp_trial + xtrapl * (stp_trial - upd.stx))
        stmax_n = torch.where(upd.bracket, torch.maximum(upd.stx, upd.sty),
                              stp_trial + xtrapu * (stp_trial - upd.stx))
        stp_trial = torch.clamp(stp_trial, stpmin, stpmax)
        # reference parity: line_search.py:314 reads `if (self.bracket and
        # stp < stmin or stp >= stmax)`, so Python's precedence applies the
        # stp >= stmax reset even unbracketed (MINPACK gates both on it)
        stall = (
            (upd.bracket & (stp_trial < stmin))
            | (stp_trial >= stmax_n)
            | (upd.bracket & (stmax_n - stmin < xtol * stmax_n))
        )
        stp_trial = torch.where(stall, upd.stx, stp_trial)

        keep = ms.done | newly_done

        def pick(old, new):
            return torch.where(keep, old, new)

        ms = _MTState(
            stp=pick(ms.stp, stp_trial),
            old_stp=pick(ms.old_stp, ms.stp),
            bracket=pick(ms.bracket, upd.bracket),
            stage=pick(ms.stage, stage),
            ginit=ms.ginit, gtest=ms.gtest,
            gx=pick(ms.gx, upd.gx),
            gy=pick(ms.gy, upd.gy),
            finit=ms.finit,
            fx=pick(ms.fx, upd.fx),
            fy=pick(ms.fy, upd.fy),
            stx=pick(ms.stx, upd.stx),
            sty=pick(ms.sty, upd.sty),
            stmin=pick(ms.stmin, stmin),
            stmax=pick(ms.stmax, stmax_n),
            width=pick(ms.width, width),
            width1=pick(ms.width1, width1),
            done=keep,
            it=ms.it + 1,
        )

    # accepted lanes take the reference's determine_step_ value
    # (line_search.py:104-107); lanes that ran out of iterations keep their
    # last trial step
    return torch.where(ms.done, full_step, ms.stp), ms.it


def _masked_compute(energy_forces_fn, batch: MolBatch, free: torch.Tensor):
    def compute(pos):
        e, f = energy_forces_fn(batch.replace(pos=pos))
        return e, f * free[..., None]

    return compute


def _free_atoms(batch: MolBatch, fixed_atoms_mask: Optional[torch.Tensor]) -> torch.Tensor:
    if fixed_atoms_mask is None:
        return batch.node_mask
    return batch.node_mask & ~fixed_atoms_mask.to(batch.node_mask.device)


def init_lbfgs_state(
    energy_forces_fn: EnergyForcesFn,
    batch: MolBatch,
    fmax: float,
    memory: int,
    fixed_atoms_mask: Optional[torch.Tensor] = None,
) -> LBFGSState:
    b, a = batch.z.shape
    compute = _masked_compute(energy_forces_fn, batch, _free_atoms(batch, fixed_atoms_mask))
    e_init, f_init = compute(batch.pos)
    conv0 = _max_force_sq(f_init, batch.node_mask) < fmax**2
    kw = dict(dtype=batch.pos.dtype, device=batch.pos.device)
    return LBFGSState(
        pos=batch.pos,
        energy=e_init,
        forces=f_init,
        r0=batch.pos,
        f0=f_init,
        s_hist=torch.zeros((memory, b, a, 3), **kw),
        y_hist=torch.zeros((memory, b, a, 3), **kw),
        rho=torch.zeros((memory, b), **kw),
        iteration=0,
        converged=conv0 | ~batch.graph_mask,
        nsteps_to_converge=torch.zeros(b, dtype=torch.int32, device=batch.pos.device),
    )


def _direction(st: LBFGSState, node_mask) -> torch.Tensor:
    """-H·g by the two-loop recursion (reference optimizers.py:485-506)
    over the filled history slots: newest → oldest, then oldest → newest."""
    it, m = st.iteration, st.rho.shape[0]
    n = min(it, m)
    q = -st.forces
    a_coef = {}
    for k in range(n):
        idx = (it - 1 - k) % m
        ai = st.rho[idx] * _config_dot(st.s_hist[idx], q, node_mask)
        q = q - ai[:, None, None] * st.y_hist[idx]
        a_coef[idx] = ai
    z = H0 * q
    for k in range(n):
        idx = (it - n + k) % m
        bi = st.rho[idx] * _config_dot(st.y_hist[idx], z, node_mask)
        z = z + st.s_hist[idx] * (a_coef[idx] - bi)[:, None, None]
    return -z


def _lbfgs_step(compute, batch: MolBatch, free, st: LBFGSState, fmax, maxstep, line_search,
                ls_trials, ls_c1, ls_c2) -> LBFGSState:
    node_mask, mol_mask = batch.node_mask, batch.graph_mask
    it, m = st.iteration, st.rho.shape[0]
    b = batch.z.shape[0]
    # -- history update (skipped at iteration 0; reference update(), :580),
    # in place: the state owns its ring
    if it > 0:
        s0 = st.pos - st.r0
        y0 = st.f0 - st.forces
        ys = _config_dot(y0, s0, node_mask)  # [B]
        slot = (it - 1) % m
        st.s_hist[slot] = s0
        st.y_hist[slot] = y0
        st.rho[slot] = torch.where(ys > 1e-8, 1.0 / torch.clamp(ys, min=1e-8), 1.0)

    # a named range for the profiler: the recursion's host time a step
    with torch.profiler.record_function("lbfgs.two_loop"):
        p = _direction(st, node_mask)
    # freeze converged configs and padding (reference :507)
    p = torch.where((st.converged | ~mol_mask)[:, None, None], 0.0, p)
    p = p * free[..., None]

    if line_search == "mt":
        # the search takes the raw direction (maxstep capping happens inside
        # via determine_step; damping does not apply); the reference's
        # tiny-direction rescale mutates pk in place (line_search.py:69-73),
        # so the position update uses the rescaled direction
        n_per = node_mask.sum(1).to(p.dtype)
        n_tot = node_mask.sum().to(p.dtype)
        p_size = torch.sqrt(torch.clamp(_config_dot(p, p, node_mask), min=1e-30))
        tiny = p_size <= torch.sqrt(n_per * 1e-10)
        p_mt = torch.where(tiny[:, None, None],
                           p * _safe_div(torch.sqrt(n_tot * 1e-10).expand_as(p_size),
                                         p_size)[:, None, None], p)
        # "mt" is adaptive; the cap of 100 evaluations only bounds
        # pathological searches (reference max_abs_step, line_search.py:35)
        step, _ = _mt_search(compute, st, p_mt, node_mask, ls_c1, ls_c2, maxstep, 100)
        dr = step[:, None, None] * p_mt
    else:
        # per-config maxstep normalisation (reference determine_step :556)
        steplen = torch.sqrt((p * p).sum(-1))  # [B,A]
        longest = torch.where(node_mask, steplen, 0.0).amax(-1)  # [B]
        scale = torch.where(longest >= maxstep, maxstep / torch.clamp(longest, min=1e-12), 1.0)
        dr = p * scale[:, None, None] * DAMPING
        if line_search == "armijo":
            # per-molecule backtracking: E(x+αp) ≤ E(x) + c1 α ∇E·p
            g_dot_p = _config_dot(-st.forces, dr, node_mask)  # [B]
            trial = torch.ones(b, dtype=dr.dtype, device=dr.device)
            best = torch.full((b,), 0.5 ** (ls_trials - 1), dtype=dr.dtype, device=dr.device)
            accepted = torch.zeros(b, dtype=torch.bool, device=dr.device)
            for _ in range(ls_trials):
                e_t, _ = compute(st.pos + trial[:, None, None] * dr)
                ok = e_t <= st.energy + ls_c1 * trial * g_dot_p
                best = torch.where(ok & ~accepted, trial, best)
                accepted = accepted | ok
                trial = trial * 0.5
            dr = dr * best[:, None, None]
        elif line_search == "wolfe":
            dr = dr * _wolfe_search(compute, st, dr, node_mask, ls_trials, ls_c1,
                                    ls_c2)[:, None, None]

    new_pos = st.pos + dr
    e, f = compute(new_pos)
    newly_conv = _max_force_sq(f, node_mask) < fmax**2
    nconv = torch.where(newly_conv & ~st.converged, it + 1, st.nsteps_to_converge)
    return st._replace(pos=new_pos, energy=e, forces=f, r0=st.pos, f0=st.forces,
                       iteration=it + 1, converged=st.converged | newly_conv,
                       nsteps_to_converge=nconv)


def _run_lbfgs(
    energy_forces_fn: EnergyForcesFn,
    batch: MolBatch,
    state: LBFGSState,
    stop_at: int,
    fmax: float,
    maxstep: float,
    fixed_atoms_mask: Optional[torch.Tensor],
    line_search: str,
    ls_trials: int,
    ls_c1: float,
    ls_c2: float,
) -> LBFGSState:
    """Iterate until `stop_at` or every molecule has converged; the one
    host read a step is that test. `state`'s history is updated in place."""
    if line_search not in LINE_SEARCHES:
        raise ValueError(f"line_search must be one of {LINE_SEARCHES}, got {line_search!r}")
    free = _free_atoms(batch, fixed_atoms_mask)
    compute = _masked_compute(energy_forces_fn, batch, free)
    st = state
    while st.iteration < stop_at and not bool(st.converged.all()):
        st = _lbfgs_step(compute, batch, free, st, fmax, maxstep, line_search, ls_trials,
                         ls_c1, ls_c2)
    return st


def _result(final: LBFGSState, mol_mask) -> LBFGSResult:
    return LBFGSResult(
        pos=final.pos,
        energy=final.energy,
        forces=final.forces,
        converged=final.converged & mol_mask,
        nsteps=final.iteration,
        nsteps_to_converge=final.nsteps_to_converge,
    )


def lbfgs_relax(
    energy_forces_fn: EnergyForcesFn,
    batch: MolBatch,
    fmax: float = 0.05,
    max_steps: int = 500,
    memory: int = 100,
    maxstep: float = 0.2,
    fixed_atoms_mask: Optional[torch.Tensor] = None,
    line_search: str = "off",  # off | armijo | wolfe | mt
    ls_trials: int = 4,
    ls_c1: float = 1e-4,
    ls_c2: float = 0.9,
) -> LBFGSResult:
    """Relax all molecules of a padded batch on its device.

    `fixed_atoms_mask` [B,A] (True = frozen) mirrors the reference's
    fixed-atom support (calculator.py fixed-atom masking).
    """
    state = init_lbfgs_state(energy_forces_fn, batch, fmax, memory, fixed_atoms_mask)
    final = _run_lbfgs(energy_forces_fn, batch, state, max_steps, fmax, maxstep,
                       fixed_atoms_mask, line_search, ls_trials, ls_c1, ls_c2)
    return _result(final, batch.graph_mask)


def relax_chunked(
    energy_forces_fn: EnergyForcesFn,
    batch: MolBatch,
    fmax: float = 0.05,
    max_steps: int = 500,
    interval: int = 10,
    on_chunk: Optional[Callable[[int, LBFGSState], None]] = None,
    resume_state: Optional[LBFGSState] = None,
    memory: int = 100,
    maxstep: float = 0.2,
    fixed_atoms_mask: Optional[torch.Tensor] = None,
    line_search: str = "off",
    ls_trials: int = 4,
    ls_c1: float = 1e-4,
    ls_c2: float = 0.9,
) -> Tuple[LBFGSResult, LBFGSState]:
    """Run the loop `interval` iterations at a time.

    After each chunk `on_chunk(iteration, state)` fires with the device
    state: the host-visible form of the reference's per-step trajectory
    dump and pickle restart (optimizers.py:269-290). Resume by passing the
    state from `load_state`.
    """
    state = resume_state
    if state is None:
        state = init_lbfgs_state(energy_forces_fn, batch, fmax, memory, fixed_atoms_mask)
        if on_chunk is not None:
            on_chunk(0, state)
    while state.iteration < max_steps and not bool(state.converged.all()):
        stop = min(state.iteration + interval, max_steps)
        state = _run_lbfgs(energy_forces_fn, batch, state, stop, fmax, maxstep,
                           fixed_atoms_mask, line_search, ls_trials, ls_c1, ls_c2)
        if on_chunk is not None:
            on_chunk(state.iteration, state)
    return _result(state, batch.graph_mask), state


def save_state(state: LBFGSState, path) -> None:
    """Pickle an L-BFGS state for restart (reference optimizers.py:283-290),
    as the JAX package writes it: a dict of numpy arrays, the iteration a
    0-d int32."""
    host = {k: (np.asarray(v, np.int32) if k == "iteration" else v.detach().cpu().numpy())
            for k, v in state._asdict().items()}
    Path(path).write_bytes(pickle.dumps(host))


def load_state(path, device=None) -> LBFGSState:
    """A state `save_state` (of either package) wrote, on `device`."""
    d = pickle.loads(Path(path).read_bytes())
    return LBFGSState(**{k: (int(v) if k == "iteration"
                             else torch.from_numpy(np.array(v)).to(device))
                         for k, v in d.items()})
