"""The JAX package's five examples (``examples/*.py``) on the port.

Each module runs as a script on the card (``python -m
nmf_tpu_torch.examples.basic_usage``; ``--device cpu`` for the CPU) and
has a ``main(argv=None, section=None) -> dict`` that prints the JAX
script's lines and returns every figure it prints, keyed by section, as
plain numbers and NumPy arrays.  ``NMF_TPU_EXAMPLE_QUICK=1`` shrinks the
sizes exactly as the JAX scripts do and changes no code path.

``section``, when given, is called with each section's name and must
return a context manager, entered around that section's work (a caller
counts the kernel launches of each section with it).

- ``basic_usage``: ``solve``, ``NMF(init="nndsvda")``, ``transform`` and
  ``write_matrix``.
- ``separation_demo``: ``separate`` on a synthesized drum-plus-tone clip.
- ``serving_pipeline``: train, ``save_transform``, ``load_transform``,
  ``stream_bin``, the quantized-input and masked artifacts.
- ``advanced_features``: the precision tiers, int8 X, live metrics, the
  streamed, strict, COO, tile-sparse, HALS, selection, serving,
  stability, online and semi-adaptive solves.
- ``distributed``: ``make_mesh``, ``solve_sharded``, ``solve_batched``
  over the mesh's ranks and a mesh serving artifact.
"""

__all__ = ["advanced_features", "basic_usage", "distributed", "separation_demo",
           "serving_pipeline"]
