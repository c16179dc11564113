"""Conformational-optimization benchmark metrics.

The reference reports `optimization pct %` and `success pct %` tables
(README.md:705-778) but does not ship the metric code; these utilities
implement the paper's definitions (arXiv:2406.14347 §5.3):

  pct(mol)   = 100 · (E_init − E_model_final) / (E_init − E_dft_final)
               — percentage of the DFT relaxation energy gain recovered;
  pct_div    = fraction of molecules with pct outside [0, 100+δ]
               (diverged relaxations);
  success %  = fraction of molecules with |E_model_final − E_dft_final|
               below a threshold (default 1 kcal/mol ≈ 1.6e-3 Hartree).

NumPy only; the port's own copy of ``nabladft_tpu/optimize/metrics.py``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

KCAL_MOL_IN_HARTREE = 1.0 / 627.5094740631


def optimization_metrics(
    e_initial: np.ndarray,
    e_final_model: np.ndarray,
    e_final_dft: Optional[np.ndarray] = None,
    success_threshold: float = KCAL_MOL_IN_HARTREE,
    divergence_slack: float = 20.0,
) -> Dict[str, float]:
    e_initial = np.asarray(e_initial, np.float64)
    e_final_model = np.asarray(e_final_model, np.float64)
    out: Dict[str, float] = {
        "mean_energy_drop": float(np.mean(e_initial - e_final_model)),
        "n_molecules": int(len(e_initial)),
    }
    if e_final_dft is not None:
        e_final_dft = np.asarray(e_final_dft, np.float64)
        gap = e_initial - e_final_dft
        safe = np.where(np.abs(gap) > 1e-12, gap, np.inf)
        pct = 100.0 * (e_initial - e_final_model) / safe
        diverged = (pct < 0.0) | (pct > 100.0 + divergence_slack)
        success = np.abs(e_final_model - e_final_dft) < success_threshold
        out["optimization_pct"] = float(np.mean(pct[~diverged])) if (~diverged).any() else 0.0
        out["pct_div"] = float(np.mean(diverged) * 100.0)
        out["success_pct"] = float(np.mean(success) * 100.0)
    return out
