"""Driver scripts mirroring the reference's solver studies, on the port
(port of the repository's ``examples/``).

Run one as ``python -m naviflow_tpu_torch.examples.<name> [--device cpu]``.
Each script's ``run(args)`` solves and reports; its ``main`` then writes the
plots and profiles (matplotlib / h5py, imported when used).
"""
