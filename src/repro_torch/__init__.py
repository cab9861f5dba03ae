"""PyTorch and CUDA port of the MPIC serving system.

A package of its own beside the JAX reference (``repro``), laid out like it
(``configs/``, ``models/``, ``kernels/``, ``cache/``, ``core/``,
``serving/``, ``data/``).  It imports ``torch`` and ``numpy``, never JAX or
the reference package.  Entry points run on the card (``device=None``) and
raise without one; ``device="cpu"`` runs the kernels' plain versions.
"""
