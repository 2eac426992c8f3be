"""Cylinder-flow validation — placeholder (port of
``naviflow_tpu/postprocessing/cylinder_flow.py``).

Parity marker with the reference's ``postprocessing/validation/
cylinder_flow.py``, which is likewise a docstring-only placeholder.
"""
