"""Unstructured mesh — placeholder (port of
``naviflow_tpu/core/unstructured.py``).

Parity marker with the reference's ``preprocessing/mesh/unstructured.py``,
which is likewise a docstring-only placeholder.  The framework targets
structured grids; unstructured support would route through a
compressed-row adjacency and segment sums (``index_add_``).
"""


class UnstructuredMesh:  # pragma: no cover - placeholder, like the reference
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "Unstructured meshes are not implemented (the reference ships a "
            "placeholder as well); use StructuredMesh."
        )
