"""The port's L-BFGS, line searches, restart, MD, metrics and extxyz writer
against the JAX package's, on the CPU.

The same numpy inputs go through `nabladft_tpu.optimize` and
`nabladft_tpu_torch.optimize`; the analytic surfaces are the JAX tests'
(tests/optimize/test_lbfgs.py harmonic bonds, test_lbfgs_stress.py
Lennard-Jones from bad starts), written again in torch. Both packages run in
float32 (JAX's x64 is off, tests/conftest.py), so iterates agree to float32
rounding, amplified over the steps: each test states its tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nabladft_tpu.data.batch import MolBatch as JaxBatch
from nabladft_tpu.optimize import lbfgs as jl
from nabladft_tpu.optimize import md as jmd
from nabladft_tpu.optimize.metrics import optimization_metrics as jax_metrics
from nabladft_tpu.utils.xyz import write_extxyz as jax_write_extxyz
from nabladft_tpu_torch.data.batch import MolBatch
from nabladft_tpu_torch.optimize import lbfgs as tl
from nabladft_tpu_torch.optimize import md as tmd
from nabladft_tpu_torch.optimize.metrics import optimization_metrics
from nabladft_tpu_torch.utils.xyz import write_extxyz
from tests.optimize.test_lbfgs import harmonic_ef as jax_harmonic
from tests.optimize.test_lbfgs_stress import lj_ef as jax_lj


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: torch's intra-op threads would only contend with the
    other test workers' (pytest-xdist). Restored after this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


C1, C2 = 0.23, 0.46  # the reference's "mt" calling convention
# relaxation iterates, float32 in both packages: positions (Å), energies and
# forces relative to their scale, after up to tens of steps
POS_TOL = dict(rtol=1e-5, atol=2e-5)
E_TOL = dict(rtol=1e-5, atol=1e-5)
F_TOL = dict(rtol=1e-4, atol=1e-4)
# on the Lennard-Jones wall a position error of POS_TOL's 2e-5 moves the
# energy by |F|·|Δx| (forces up to ~25 after 8 steps) and the forces by
# |∂F/∂x|·|Δx| (stiffness up to ~10²)
LJ_TOL = (dict(rtol=1e-5, atol=5e-4), dict(rtol=1e-4, atol=5e-3))


# ---------------------------------------------------------------------------
# the JAX tests' surfaces in torch
# ---------------------------------------------------------------------------


def _pair_mask(mask):
    a = mask.shape[1]
    return mask[:, :, None] & mask[:, None, :] & ~torch.eye(a, dtype=torch.bool)


def _with_forces(energy):
    def fn(batch):
        mask = batch.node_mask
        with torch.enable_grad():
            pos = batch.pos.detach().requires_grad_(True)
            e = energy(pos, _pair_mask(mask))
            (g,) = torch.autograd.grad(e.sum(), pos)
        return e.detach(), -g * mask[..., None]

    return fn


def torch_harmonic(k=1.0, r0=1.5):
    def energy(pos, pm):
        diff = pos[:, :, None] - pos[:, None, :]
        d = torch.sqrt((diff**2).sum(-1) + 1e-12)
        return 0.5 * k * torch.where(pm, (d - r0) ** 2, 0.0).sum((1, 2))

    return _with_forces(energy)


def torch_lj(eps=1.0, sigma=1.0):
    def energy(pos, pm):
        diff = pos[:, :, None] - pos[:, None, :]
        d2 = (diff**2).sum(-1) + 1e-12
        inv6 = (sigma**2 / d2) ** 3
        return 0.5 * torch.where(pm, 4.0 * eps * (inv6**2 - inv6), 0.0).sum((1, 2))

    return _with_forces(energy)


def _arrays(pos, n_atoms):
    """Batch arrays for molecules of `n_atoms` real atoms (0 = a padded
    molecule) at `pos` [B,A,3]."""
    b, a = pos.shape[:2]
    node_mask = np.arange(a)[None, :] < np.asarray(n_atoms)[:, None]
    return dict(z=node_mask.astype(np.int32), pos=(pos * node_mask[..., None]).astype(np.float32),
                node_mask=node_mask, graph_mask=np.asarray(n_atoms) > 0,
                energy=np.zeros(b, np.float32), forces=np.zeros((b, a, 3), np.float32),
                mol_id=np.arange(b, dtype=np.int32))


def _batches(arrays):
    return (JaxBatch(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            MolBatch(**{k: torch.from_numpy(v.copy()) for k, v in arrays.items()}))


def harmonic_problem():
    rng = np.random.default_rng(0)
    arrays = _arrays(rng.uniform(-2, 2, (4, 5, 3)), [3, 4, 2, 0])
    return (arrays, jax_harmonic(), torch_harmonic(), dict(fmax=1e-3, max_steps=60, memory=10),
            (E_TOL, F_TOL))


def lj_problem():
    """The stress test's bad starts (a pair at 0.55 sigma, |F| ~ 1e4). From
    these starts the iteration amplifies float32 rounding about tenfold every
    two steps in either package (JAX against the port, no line search: 1e-8
    Å apart after step 1, 2e-6 after 8, 4e-3 after 20, ~1 Å after 30), so
    the parity run stops at 8 steps; the harmonic runs go to convergence."""
    rng = np.random.default_rng(1)
    pos = rng.uniform(-1.5, 1.5, (4, 6, 3))
    pos[:, 1] = pos[:, 0] + np.array([0.55, 0.0, 0.0])
    arrays = _arrays(pos, [6, 5, 6, 0])
    return (arrays, jax_lj(), torch_lj(), dict(fmax=0.05, max_steps=8, memory=5, maxstep=0.2),
            LJ_TOL)


PROBLEMS = {"harmonic": harmonic_problem, "lj": lj_problem}


def _fixed(arrays):
    """Atom 0 of molecule 1 frozen."""
    fixed = np.zeros_like(arrays["node_mask"])
    fixed[1, 0] = True
    return fixed


def _assert_results_match(jr, tr, tol=(E_TOL, F_TOL)):
    assert int(jr.nsteps) == tr.nsteps
    np.testing.assert_array_equal(tr.converged.numpy(), np.asarray(jr.converged))
    np.testing.assert_array_equal(tr.nsteps_to_converge.numpy(),
                                  np.asarray(jr.nsteps_to_converge))
    np.testing.assert_allclose(tr.pos.numpy(), np.asarray(jr.pos), **POS_TOL)
    np.testing.assert_allclose(tr.energy.numpy(), np.asarray(jr.energy), **tol[0])
    np.testing.assert_allclose(tr.forces.numpy(), np.asarray(jr.forces), **tol[1])


# ---------------------------------------------------------------------------
# lbfgs_relax, every line search
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ls", ["off", "armijo", "wolfe", "mt"])
@pytest.mark.parametrize("surface", ["harmonic", "lj"])
def test_lbfgs_relax_matches_jax(surface, ls):
    arrays, jfn, tfn, kw, tol = PROBLEMS[surface]()
    fixed = _fixed(arrays)
    kw = dict(kw, line_search=ls, ls_trials=5,
              **(dict(ls_c1=C1, ls_c2=C2) if ls == "mt" else {}))
    jb, tb = _batches(arrays)
    jr = jax.jit(lambda b: jl.lbfgs_relax(jfn, b, fixed_atoms_mask=jnp.asarray(fixed), **kw))(jb)
    tr = tl.lbfgs_relax(tfn, tb, fixed_atoms_mask=torch.from_numpy(fixed), **kw)
    _assert_results_match(jr, tr, tol)
    # the frozen atom and the padded molecule never move; every lane finite
    pos = tr.pos.numpy()
    np.testing.assert_array_equal(pos[1, 0], arrays["pos"][1, 0])
    np.testing.assert_array_equal(pos[3], arrays["pos"][3])
    assert np.isfinite(pos).all() and np.isfinite(tr.energy.numpy()).all()
    assert not tr.converged[3]
    if surface == "harmonic":  # the history ring wrapped and molecules converged
        assert tr.nsteps > kw["memory"] and int(tr.nsteps_to_converge.max()) > 0


def test_two_loop_visits_only_filled_slots():
    """The direction over the filled slots has the same bits as the JAX
    package's fixed-length recursion over all slots (the unfilled ones carry
    s = y = rho = 0), written with the same torch ops, before and after the
    ring wraps."""
    rng = np.random.default_rng(3)
    m, b, a = 6, 3, 4
    arrays = _arrays(rng.normal(size=(b, a, 3)), [4, 3, 4])
    node_mask = torch.from_numpy(arrays["node_mask"])
    t = torch.from_numpy
    for it in (0, 2, 6, 9):
        s = rng.normal(size=(m, b, a, 3)).astype(np.float32)
        y = rng.normal(size=(m, b, a, 3)).astype(np.float32)
        rho = rng.uniform(0.1, 1.0, (m, b)).astype(np.float32)
        filled = np.arange(m) < min(it, m)
        s[~filled], y[~filled], rho[~filled] = 0.0, 0.0, 0.0
        s, y, rho, g = t(s), t(y), t(rho), t(rng.normal(size=(b, a, 3)).astype(np.float32))
        st = tl.LBFGSState(None, None, -g, None, None, s, y, rho, it, None, None)
        got = tl._direction(st, node_mask)
        # nabladft_tpu/optimize/lbfgs.py's loop1 / loop2 over all m slots
        q, coef = g, torch.zeros(m, b)
        for k in range(m):
            i = (it - 1 - k) % m
            coef[i] = rho[i] * tl._config_dot(s[i], q, node_mask)
            q = q - coef[i][:, None, None] * y[i]
        z = tl.H0 * q
        for k in range(m):
            i = (it - m + k) % m
            z = z + s[i] * (coef[i] - rho[i] * tl._config_dot(y[i], z, node_mask))[:, None, None]
        assert torch.equal(got, -z), it


# ---------------------------------------------------------------------------
# the Moré–Thuente search, lane by lane
# ---------------------------------------------------------------------------


def _wells(b=8, a=4, seed=2):
    """Anharmonic wells E = Σ k|x-x*|² + q|x-x*|⁴ (tests/optimize/
    test_mt_linesearch.py), in float32, for both packages."""
    rng = np.random.default_rng(seed)
    x_star = rng.normal(size=(b, a, 3)).astype(np.float32)
    k = rng.uniform(0.5, 8.0, (b, 1, 1)).astype(np.float32)
    q = rng.uniform(0.0, 2.0, (b, 1, 1)).astype(np.float32)
    pos0 = (x_star + rng.normal(size=(b, a, 3)) * rng.uniform(0.2, 1.2, (b, 1, 1))).astype(
        np.float32)

    def make(xp, keep):
        xs, kk, qq = xp(x_star), xp(k), xp(q)

        def ef(pos):
            d = pos - xs
            r2 = keep((d * d).sum(-1))[..., None]
            return (kk * r2 + qq * r2 * r2)[..., 0].sum(-1), -(2 * kk + 4 * qq * r2) * d

        return ef

    return pos0, make(jnp.asarray, lambda x: x), make(torch.from_numpy, lambda x: x)


def test_mt_search_matches_jax_lane_by_lane():
    b, a = 8, 4
    pos0, jef, tef = _wells(b, a)
    node_mask = np.ones((b, a), bool)
    node_mask[6] = False  # a padded molecule
    e0, f0 = (np.asarray(x) for x in jef(jnp.asarray(pos0)))
    # assorted scales, one deliberately huge (the maxstep delta cap), one
    # frozen lane (p = 0: a converged molecule)
    scales = np.array([1.0, 0.1, 3.0, 20.0, 0.5, 1.0, 1.0, 0.0], np.float32)[:, None, None]
    p = (f0 * scales * node_mask[..., None]).astype(np.float32)
    zeros = np.zeros((1, b, a, 3), np.float32)
    jst = jl.LBFGSState(pos=pos0, energy=e0, forces=f0, r0=pos0, f0=f0, s_hist=zeros,
                        y_hist=zeros, rho=np.zeros((1, b), np.float32),
                        iteration=np.zeros((), np.int32), converged=np.zeros(b, bool),
                        nsteps_to_converge=np.zeros(b, np.int32))
    t = torch.from_numpy
    e0, f0 = e0.copy(), f0.copy()
    tst = tl.LBFGSState(t(pos0), t(e0), t(f0), t(pos0), t(f0), t(zeros), t(zeros),
                        torch.zeros(1, b), 0, torch.zeros(b, dtype=torch.bool),
                        torch.zeros(b, dtype=torch.int32))
    jsteps, jit = jl._mt_search(jef, jst, jnp.asarray(p), jnp.asarray(node_mask), C1, C2, 0.2,
                                100)
    tsteps, tit = tl._mt_search(tef, tst, t(p), t(node_mask), C1, C2, 0.2, 100)
    assert tit == int(jit) > 1
    np.testing.assert_allclose(tsteps.numpy(), np.asarray(jsteps), rtol=1e-6)
    assert np.isfinite(tsteps.numpy()).all()
    # lanes with no descent are done at once and take the full step
    np.testing.assert_array_equal(tsteps.numpy()[[6, 7]], [1.0, 1.0])
    # each lane alone takes the same step as in the batch
    for lane in range(b):
        pick = [lane]
        one = tl.LBFGSState(*(x[pick] if torch.is_tensor(x) and x.shape[:1] == (b,) else x
                              for x in tst))
        s1, _ = tl._mt_search(lambda pos: tuple(v[pick] for v in tef(
            torch.from_numpy(pos0).index_copy(0, torch.tensor(pick), pos))),
            one, t(p)[pick], t(node_mask)[pick], C1, C2, 0.2, 100)
        np.testing.assert_allclose(s1.numpy(), tsteps.numpy()[pick], rtol=1e-6)


# ---------------------------------------------------------------------------
# chunks and restart across the packages
# ---------------------------------------------------------------------------


def test_relax_chunked_equals_one_run():
    arrays, _, tfn, kw, _ = harmonic_problem()
    _, tb = _batches(arrays)
    ref = tl.lbfgs_relax(tfn, tb, **kw)
    seen = []
    res, state = tl.relax_chunked(tfn, tb, interval=7, on_chunk=lambda it, st: seen.append(it),
                                  **kw)
    assert seen[0] == 0 and seen == sorted(set(seen)) and seen[-1] == state.iteration
    assert res.nsteps == ref.nsteps
    for name in ("pos", "energy", "forces", "converged", "nsteps_to_converge"):
        assert torch.equal(getattr(res, name), getattr(ref, name)), name


@pytest.mark.parametrize("saver", ["jax", "torch"])
def test_saved_state_resumes_in_both_packages(saver, tmp_path):
    """A state saved mid-run by one package resumes in the port as in JAX,
    and both equal an uninterrupted run."""
    arrays, jfn, tfn, kw, _ = harmonic_problem()
    kw = dict(kw, max_steps=40)
    jb, tb = _batches(arrays)
    path = tmp_path / "restart.pkl"
    if saver == "jax":
        _, mid = jl.relax_chunked(jfn, jb, **dict(kw, max_steps=15), interval=15)
        jl.save_state(mid, path)
    else:
        _, mid = tl.relax_chunked(tfn, tb, **dict(kw, max_steps=15), interval=15)
        tl.save_state(mid, path)
    jres, _ = jl.relax_chunked(jfn, jb, interval=25, resume_state=jl.load_state(path), **kw)
    resumed = tl.load_state(path)
    assert resumed.iteration == 15 and resumed.s_hist.dtype == torch.float32
    tres, _ = tl.relax_chunked(tfn, tb, interval=25, resume_state=resumed, **kw)
    _assert_results_match(jres, tres)
    np.testing.assert_allclose(tres.pos.numpy(), tl.lbfgs_relax(tfn, tb, **kw).pos.numpy(),
                               **POS_TOL)


# ---------------------------------------------------------------------------
# metrics, extxyz, MD, normal modes
# ---------------------------------------------------------------------------


def test_optimization_metrics_match_jax():
    rng = np.random.default_rng(4)
    e0 = rng.normal(size=20)
    e_model = e0 - rng.uniform(-0.01, 0.05, 20)
    e_dft = e0 - rng.uniform(0.0, 0.05, 20)
    e_dft[3] = e0[3]  # a zero gap
    for dft in (None, e_dft):
        assert optimization_metrics(e0, e_model, dft) == jax_metrics(e0, e_model, dft)


@pytest.mark.parametrize("forces", [False, True])
def test_write_extxyz_is_byte_identical(tmp_path, forces):
    rng = np.random.default_rng(5)
    z = np.array([1, 6, 8, 54, 60])
    frames = [rng.normal(size=(5, 3)).astype(np.float32) for _ in range(3)]
    kw = dict(energies=[float("nan"), -1.25, 3.0e-7],
              forces=[rng.normal(size=(5, 3)) for _ in range(3)] if forces else None)
    jax_write_extxyz(tmp_path / "jax.extxyz", z, frames, **kw)
    write_extxyz(tmp_path / "torch.extxyz", z, frames, **kw)
    write_extxyz(tmp_path / "torch.extxyz", z, frames[:1], append=True)
    jax_write_extxyz(tmp_path / "jax.extxyz", z, frames[:1], append=True)
    assert (tmp_path / "torch.extxyz").read_bytes() == (tmp_path / "jax.extxyz").read_bytes()


def test_velocity_verlet_matches_jax():
    rng = np.random.default_rng(6)
    arrays = _arrays(rng.uniform(-1, 1, (2, 4, 3)) * 2, [3, 4])
    vel = (rng.normal(size=(2, 4, 3)) * 0.01 * arrays["node_mask"][..., None]).astype(np.float32)
    jb, tb = _batches(arrays)
    jfinal, jtraj = jmd.run_md(jax_harmonic(k=0.5), jb, n_steps=50, dt_fs=0.2,
                               initial_velocities=jnp.asarray(vel), record_every=5)
    tfinal, ttraj = tmd.run_md(torch_harmonic(k=0.5), tb, n_steps=50, dt_fs=0.2,
                               initial_velocities=torch.from_numpy(vel), record_every=5)
    assert ttraj["positions"].shape == jtraj["positions"].shape == (10, 2, 4, 3)
    np.testing.assert_allclose(ttraj["positions"], jtraj["positions"], **POS_TOL)
    np.testing.assert_allclose(ttraj["energy"], jtraj["energy"], **E_TOL)
    np.testing.assert_allclose(tfinal.vel.numpy(), np.asarray(jfinal.vel), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(ttraj["final_temperature"], jtraj["final_temperature"],
                               rtol=1e-4)


def test_normal_modes_dimer_match_jax():
    arrays = _arrays(np.array([[[0.0, 0, 0], [1.5, 0, 0]]]), [2])
    jb, tb = _batches(arrays)
    jf, jm = jmd.normal_modes(jax_harmonic(k=1.0), jb)
    tf, tm = tmd.normal_modes(torch_harmonic(k=1.0), tb)
    np.testing.assert_allclose(tf, jf, atol=1e-2)
    # the stretch: the only non-zero mode, at sqrt(4k/m)
    stretch = np.abs(tf[0]) > 1e-2
    assert stretch.sum() == 1
    np.testing.assert_allclose(tf[0][stretch], np.sqrt(4.0 / 1.008), rtol=1e-3)
    np.testing.assert_allclose(np.abs(tm[0][stretch]), np.abs(jm[0][stretch]), atol=1e-3)


def test_langevin_thermalizes():
    """tests/optimize/test_lbfgs.py's statistical check: a thermostatted
    run ends at a finite temperature of the right order."""
    arrays = _arrays(np.random.default_rng(7).uniform(-2, 2, (1, 5, 3)), [5])
    _, tb = _batches(arrays)
    final, traj = tmd.run_md(torch_harmonic(k=0.1), tb, n_steps=300, dt_fs=0.5,
                             temperature_K=300.0, friction=0.05,
                             generator=torch.Generator().manual_seed(1))
    assert np.isfinite(traj["positions"]).all()
    assert 10.0 < float(traj["final_temperature"][0]) < 3000.0
    # the same generator seed gives the same trajectory
    _, again = tmd.run_md(torch_harmonic(k=0.1), tb, n_steps=300, dt_fs=0.5,
                          temperature_K=300.0, friction=0.05,
                          generator=torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(again["positions"], traj["positions"])


def test_maxwell_boltzmann_temperature_and_drift():
    b, a = 64, 32
    arrays = _arrays(np.zeros((b, a, 3)), [a] * b)
    arrays["z"][:] = 6
    _, tb = _batches(arrays)
    vel = tmd.maxwell_boltzmann_velocities(torch.Generator().manual_seed(2), tb, 300.0)
    masses = tmd.atomic_masses(tb.z)
    drift = (vel * masses[..., None]).sum(1)
    assert float(drift.abs().max()) < 1e-6
    t = tmd.kinetic_temperature(vel, tb).numpy()
    # equipartition over 64 x 93 degrees of freedom: the mean within 3 %
    assert abs(t.mean() - 300.0) < 9.0, t.mean()
