"""The user-facing programs: the counterparts of the JAX package's
``examples/`` scripts, each a module with ``main(argv=None)`` (the JAX
script's command line plus ``--device``; CUDA unless ``--device cpu``) and a
``run(...)`` that takes the sizes as arguments.  Run one as
``python -m unitygaussiansplatting_torch.examples.<name>``.

- ``render_sphere`` (``examples/render_sphere.py``): the 20k-splat sphere
  over a background at 512x384;
- ``orbit`` (``examples/orbit.py``): a turntable of PNGs, 200k splats or a PLY;
- ``render_asset`` (``examples/render_asset.py``): .ply/.spz/.asset.json ->
  asset -> one frame, from the device asset or a host decode;
- ``train_splats`` (``examples/train_splats.py``): fit a perturbed cloud to
  one target image, 300 steps;
- ``train_full`` (``examples/train_full.py``): the full training loop,
  presets quick and r5.

Backend names map one for one: the JAX ``"pallas"`` is the port's
``"cuda"``, the JAX ``"jax"`` the port's ``"torch"``; a script that relied on
its package's default (``"jax"``) relies on the port's (``"cuda"``).

Where the port differs from the JAX scripts on purpose (each module's
docstring says more): ``train_full`` puts its held-out cameras at true
midpoints of the training ring (the JAX script's r5 "held-out" cameras are
training cameras) and takes its loss means over the real counts (the JAX
script divides by a hard-coded 10); ``orbit --ply`` renders the imported
cloud as it is (the JAX script calls a method the cloud does not have).
The measurement tools are in ``unitygaussiansplatting_torch.tools``.
"""
