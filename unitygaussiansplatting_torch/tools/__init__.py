"""Measurement tools: the counterparts of the JAX package's
``tools/measure_overlap.py`` (``measure_overlap``: the tile-overlap
statistics the pair budgets rest on, projected and binned on the card) and
``tools/measure_bc7.py`` (``measure_bc7``: BC7 texture quality, host numpy).
Each has ``main(argv=None)`` and runs as ``python -m
unitygaussiansplatting_torch.tools.<name>``."""
