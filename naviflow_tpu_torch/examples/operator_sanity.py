"""Operator-equivalence sanity checks (reference
``main_scripts/matrix_free_sanity.py``).

Verifies that the matrix-free pressure operator equals the explicitly
assembled dense matrix, and reports the symmetry defect of each variant
(the reference operator is asymmetric at boundaries; the symmetric and
consistent variants are exactly symmetric).
"""

import argparse

import numpy as np
import torch

from naviflow_tpu_torch.ops.poisson import apply_poisson, poisson_coefficients
from naviflow_tpu_torch.postprocessing.result import to_numpy
from naviflow_tpu_torch.solvers.pressure import dense_poisson_matrix


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device: the card by default, 'cpu' for the CPU")
    return ap.parse_args(argv)


def run(args):
    """One row per operator variant: ``{'variant', 'ok', 'max_diff',
    'symmetry_defect'}``."""
    from naviflow_tpu_torch.core.state import resolve_device

    dev = resolve_device(args.device, "operator_sanity")
    nx = ny = 10
    n = nx * ny
    rng = np.random.default_rng(0)
    d_u = torch.as_tensor(rng.random((nx + 1, ny)) + 0.1, device=dev)
    d_v = torch.as_tensor(rng.random((nx, ny + 1)) + 0.1, device=dev)
    p = torch.as_tensor(rng.random((nx, ny)), device=dev)
    p_flat = to_numpy(p).T.reshape(-1)  # Fortran flatten (i fastest)

    rows = []
    for variant in ("reference", "symmetric", "consistent"):
        c = poisson_coefficients(d_u, d_v, dx=1.0, dy=1.0, rho=1.0, variant=variant)
        pin = variant == "reference"
        mf = to_numpy(apply_poisson(p, c, pinned=pin)).T.reshape(-1)
        A = to_numpy(dense_poisson_matrix(c, pin=pin))
        dense = A @ p_flat
        if not pin:
            # the unpinned dense matrix carries a ones/n gauge shift and an
            # identity floor on empty (corner) rows: undo both for comparison
            dense = dense - p_flat.mean()
            floored = np.abs(to_numpy(c.diag).T.reshape(-1)) < 1e-15
            dense[floored] -= p_flat[floored]
        diff = float(np.abs(mf - dense).max())
        ok = diff < (1e-10 if mf.dtype == np.float64 else 3e-5)
        x = rng.random(n)
        y = rng.random(n)
        B = A - (0 if pin else np.ones_like(A) / n)
        sym = abs(x @ (B @ y) - y @ (B @ x))
        print(f"{variant:10s}: matvec==dense {ok} (max diff {diff:.1e})   "
              f"|x'Ay - y'Ax| = {sym:.3e}")
        rows.append(dict(variant=variant, ok=ok, max_diff=diff, symmetry_defect=float(sym)))
    return rows


def main(argv=None):
    run(parse(argv))


if __name__ == "__main__":
    main()
