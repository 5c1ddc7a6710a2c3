"""The benchmark's plain reference: a splat frame, its gradients, the 3DGS
loss and Adam, and the Medium asset codec, in plain PyTorch.

It imports nothing of the program (``unitygaussiansplatting_torch``) and
nothing of the JAX package, and takes nothing the program made: the harness
hands both sides the same seeded cloud, views and targets, and the
reference works out everything else again.  The formulas follow the
reference viewer's shaders as the port states them (a frozen copy of the
port's plain projection and shading); the composite, its gradients (by
autograd, in blocks of tiles) and the codec are written here.
"""
