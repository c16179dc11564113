"""Molecular dynamics and normal-mode analysis on the batch's device.

The port of ``nabladft_tpu/optimize/md.py`` (the reference's
PYGAseInterface, optimization/pyg_ase_interface.py:34-334: ASE Langevin /
VelocityVerlet MD, Maxwell–Boltzmann velocity init, normal modes by finite
differences) over padded batches: the trajectory stays on the device and
comes to the host once, at the end. Randomness comes from an explicit
`torch.Generator` where the JAX package takes a key.

Units: positions Å, energy Hartree (nablaDFT task units), masses in amu.
Time is in fs, converted to sqrt(amu·Å²/Hartree).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from nabladft_tpu_torch.data.ase_codec import ATOMIC_MASSES
from nabladft_tpu_torch.data.batch import MolBatch

# 1 fs in sqrt(amu Å² / Hartree) "natural" time units:
#   t_nat = sqrt(amu Å²/Eh) = 1.0327499e-15 s  ->  1 fs = 0.968287 t_nat
FS = 0.9682885864793366
# Boltzmann constant in Hartree / K
KB_HARTREE = 3.166811563e-6


class MDState(NamedTuple):
    pos: torch.Tensor  # [B,A,3] Å
    vel: torch.Tensor  # [B,A,3] Å / t_nat
    energy: torch.Tensor  # [B] potential energy
    forces: torch.Tensor  # [B,A,3]
    generator: torch.Generator  # the Langevin kicks' source


def atomic_masses(z: torch.Tensor) -> torch.Tensor:
    table = torch.as_tensor(ATOMIC_MASSES, dtype=torch.float32, device=z.device)
    return table[z.long().clamp(0, len(ATOMIC_MASSES) - 1)]


def _normal(generator: torch.Generator, shape, like: torch.Tensor) -> torch.Tensor:
    """Standard normal draws from `generator`, on `like`'s device."""
    return torch.randn(shape, generator=generator, device=generator.device,
                       dtype=like.dtype).to(like.device)


def maxwell_boltzmann_velocities(generator: torch.Generator, batch: MolBatch,
                                 temperature_K: float) -> torch.Tensor:
    """Gaussian velocities at T with zero center-of-mass drift
    (reference pyg_ase_interface.py:265 MaxwellBoltzmannDistribution)."""
    masses = atomic_masses(batch.z)  # [B,A]
    nmask = batch.node_mask[..., None].to(masses.dtype)
    std = torch.sqrt(KB_HARTREE * temperature_K / torch.clamp(masses, min=1e-6))
    vel = std[..., None] * _normal(generator, (*batch.z.shape, 3), masses)
    vel = vel * nmask
    # remove center-of-mass momentum
    mom = (vel * masses[..., None]).sum(1, keepdim=True)
    mtot = (masses * batch.node_mask).sum(1)[:, None, None]
    return vel - (mom / torch.clamp(mtot, min=1e-6)) * nmask


def kinetic_temperature(vel: torch.Tensor, batch: MolBatch) -> torch.Tensor:
    masses = atomic_masses(batch.z)
    ke = 0.5 * (masses[..., None] * vel * vel * batch.node_mask[..., None]).sum((1, 2))
    dof = 3.0 * torch.clamp(batch.node_mask.sum(1) - 1, min=1)
    return 2.0 * ke / (dof * KB_HARTREE)


def run_md(
    energy_forces_fn: Callable,
    batch: MolBatch,
    n_steps: int,
    dt_fs: float = 0.5,
    temperature_K: Optional[float] = None,
    friction: float = 0.002,
    generator: Optional[torch.Generator] = None,
    initial_velocities: Optional[torch.Tensor] = None,
    record_every: int = 1,
) -> Tuple[MDState, dict]:
    """Velocity-Verlet (temperature_K=None) or Langevin dynamics.

    Langevin follows ASE's integrator: friction γ in 1/t_nat, stochastic
    kicks at temperature T drawn from `generator` (seed 0 on the batch's
    device when None). Returns the final state and a trajectory dict of
    recorded pos/energy/temperature (host arrays, [n_rec, ...]).
    """
    if generator is None:
        generator = torch.Generator(device=batch.pos.device).manual_seed(0)
    dt = dt_fs * FS
    masses = torch.clamp(atomic_masses(batch.z)[..., None], min=1e-6)  # [B,A,1]
    nmask = batch.node_mask[..., None].to(batch.pos.dtype)

    if initial_velocities is not None:
        vel = initial_velocities
    elif temperature_K is not None:
        vel = maxwell_boltzmann_velocities(generator, batch, temperature_K)
    else:
        vel = torch.zeros_like(batch.pos)

    e, f = energy_forces_fn(batch)
    pos = batch.pos
    langevin = temperature_K is not None and friction != 0.0
    if langevin:
        sigma = torch.sqrt(2.0 * friction * KB_HARTREE * temperature_K / masses)
    traj_pos, traj_e = [], []
    for _ in range(n_steps):
        acc = f / masses
        if langevin:
            noise = _normal(generator, vel.shape, vel) * sigma * dt ** 0.5
            vel_half = vel + 0.5 * dt * (acc - friction * vel) + 0.5 * noise
        else:
            vel_half = vel + 0.5 * dt * acc
        pos = pos + dt * vel_half * nmask
        e, f = energy_forces_fn(batch.replace(pos=pos))
        if langevin:
            vel = vel_half + 0.5 * dt * (f / masses - friction * vel_half) + 0.5 * noise
        else:
            vel = vel_half + 0.5 * dt * f / masses
        vel = vel * nmask
        traj_pos.append(pos)
        traj_e.append(e)
    final = MDState(pos=pos, vel=vel, energy=e, forces=f, generator=generator)
    rec = slice(None, None, record_every)
    traj = {
        "positions": torch.stack(traj_pos)[rec].cpu().numpy(),
        "energy": torch.stack(traj_e)[rec].cpu().numpy(),
        "final_temperature": kinetic_temperature(vel, batch).cpu().numpy(),
    }
    return final, traj


def normal_modes(
    energy_forces_fn: Callable,
    batch: MolBatch,
    displacement: float = 0.01,
) -> Tuple[np.ndarray, np.ndarray]:
    """Vibrational analysis by central finite differences of forces
    (reference compute_normal_modes → ase.Vibrations,
    pyg_ase_interface.py:317-334).

    Returns (frequencies [B, 3A] in sqrt(Eh/amu)/Å, modes [B, 3A, A, 3]).
    Rows for padded atoms carry zero frequency.
    """
    b, a = batch.z.shape
    masses = atomic_masses(batch.z).cpu().numpy()
    nmask = batch.node_mask[..., None].to(batch.pos.dtype)

    def force_at(pos):
        return energy_forces_fn(batch.replace(pos=pos))[1]

    # displace every (atom, axis) in turn: the Hessian column by column
    cols = []
    for idx in range(3 * a):
        e = torch.zeros_like(batch.pos)
        e[:, idx // 3, idx % 3] = displacement
        f_plus = force_at(batch.pos + e * nmask)
        f_minus = force_at(batch.pos - e * nmask)
        cols.append(-(f_plus - f_minus) / (2 * displacement))  # [B,A,3] = dF/dx
    hess = torch.stack(cols).cpu().numpy().reshape(3 * a, b, 3 * a).transpose(1, 0, 2)
    # mass-weighted
    m = np.maximum(np.repeat(masses, 3, axis=1), 1e-6)  # [B, 3A]
    w = 1.0 / np.sqrt(m)
    hess_mw = hess * w[:, :, None] * w[:, None, :]
    hess_mw = 0.5 * (hess_mw + np.swapaxes(hess_mw, 1, 2))
    evals, evecs = np.linalg.eigh(hess_mw)
    freqs = np.sign(evals) * np.sqrt(np.abs(evals))
    modes = (evecs * w[:, :, None]).transpose(0, 2, 1).reshape(b, 3 * a, a, 3)
    return freqs, modes
